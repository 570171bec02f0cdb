"""API parity: every public function, class and method of the JAX package
has a counterpart of the same name in the port's module at the same path,
taking every argument the JAX one takes (a class: its constructor's, the
fields of a flax module), and every name a JAX ``__init__.py`` exports is
exported by the port's.

Both packages are read with ``ast``; nothing is imported or run.  The
exceptions are listed below, each with its PyTorch counterpart or the
reason it has none; an exception that no longer matches the JAX package,
or whose name the port now has, fails the test so the lists stay true.
"""

import ast
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "multimodal_brain_pattern_identification_xai_tpu"
PORT = ROOT / "multimodal_brain_pattern_identification_xai_tpu_torch"

#: JAX module → the port's module, where the two files are named apart
MODULES = {
    "ops/pallas_iir.py": "ops/cuda_iir.py",
    "ops/pallas_specblock.py": "ops/cuda_specblock.py",
}

#: (JAX module, name) with no counterpart of that name in the port:
#: the PyTorch counterpart, or why there is none
NAMES = {
    ("models/layers.py", "max_pool"): "torch.nn.functional.max_pool2d",
    ("models/layers.py", "avg_pool"): "torch.nn.functional.avg_pool2d",
    ("models/layers.py", "batch_norm"): "models.layers.BatchNorm (a module)",
    ("models/layers.py", "log_softmax"): "torch.nn.functional.log_softmax",
    ("models/layers.py", "flatten_nchw"): "torch.Tensor.flatten(1) (the "
                                          "port's tensors are NCHW)",
    ("models/layers.py", "nchw_to_nhwc"): "torch.Tensor.permute(0, 2, 3, 1)",
    ("models/layers.py", "nhwc_to_nchw"): "torch.Tensor.permute(0, 3, 1, 2)",
    ("models/layers.py", "adaptive_avg_pool_1x1"): "torch.Tensor.mean(dim="
                                                   "(2, 3))",
    ("models/layers.py", "bilinear_interpolate_nhwc"):
        "models.layers.bilinear_resize (F.interpolate's bilinear, "
        "align_corners=False, no antialias)",
    ("models/diffeeg.py", "DiffEEG.setup"): "flax setup: nn.Module.__init__",
    ("models/fusion.py", "MultimodalModel.setup"): "flax setup: "
                                                   "nn.Module.__init__",
    ("models/diffeeg.py", "ResidualBlock.__call__"):
        "nn.Sequential.forward (the port's ResidualBlock is a Sequential)",
    ("ops/pallas_iir.py", "pallas_lfilter"): "ops.cuda_iir.sosfilt (and "
                                             "ops.iir.lfilter)",
    ("ops/pallas_iir.py", "pallas_lfilter_rolldec"): "ops.cuda_iir."
                                                     "sosfilt_rolldec",
    ("ops/pallas_iir.py", "pallas_filtfilt"): "ops.cuda_iir.filtfilt",
    ("ops/pallas_specblock.py", "choose_fused_config"):
        "picks a TPU MXU packing; the CUDA kernels pick their own tiles "
        "(ops.cuda_specblock)",
    ("ops/pallas_specblock.py", "fused_specblock_convpool_vjp"):
        "ops.cuda_specblock.fused_specblock_convpool is differentiable "
        "itself",
    ("ops/pallas_specblock.py", "pack_conv_weights"):
        "the TPU kernel's MXU packing; the CUDA kernels pack their weights "
        "in their wrappers",
    ("train/steps.py", "optax_global_norm"): "train.steps.global_norm",
    ("train/steps.py", "skip_nonfinite"): "train.state.apply_gradients("
                                          "finite=) and the step's "
                                          "torch.where",
}

#: (JAX module, name) whose counterpart exists but does not yet do what the
#: JAX one does
STUBS: Dict[Tuple[str, str], str] = {}

#: argument names of the JAX package's idioms and the port's counterpart
ARGS = {
    "key": "a torch.Generator argument (or torch's default generator)",
    "rng": "a torch.Generator argument",
    "variables": "the nn.Module holds its weights",
    "params": "the nn.Module holds its weights",
    "flax_params": "the importer's nn.Module argument",
    "flax_variables": "the importer's nn.Module argument",
    "apply_kwargs": "the module's own forward arguments",
    "intermediates": "forward hooks collect the attention weights",
    "abstract_state": "CheckpointManager restores into a live TrainState",
    "axis_name": "a torch.distributed process group of the DeviceMesh",
    "sharding": "tensors are placed with .to(device)",
    "devices": "make_mesh takes the torch device of the world",
    "train": "nn.Module.train() / .eval()",
    "fused_interpret": "Pallas interpret mode; the CUDA wrappers choose by "
                       "the tensor's device",
}

#: (JAX module, name) → {argument: the port's counterpart} for arguments
#: of one function or class only
NAME_ARGS = {
    ("train/state.py", "create_train_state"): {
        "sample_batch_args": "the port builds the module with its shapes; "
                             "nothing is traced"},
    ("train/state.py", "TrainState"): {
        "batch_stats": "the BatchNorm statistics are buffers of "
                       "TrainState.model",
        "ema_params": "TrainState.ema (flat) and TrainState.ema_params()"},
    ("models/eegnet.py", "EEGNetAttentionRegularized"): {
        "weight_decay": "a field nothing in the JAX package reads; the L2 "
                        "factor is the step's l2_lambda"},
    ("models/efficientnet.py", "EfficientNetB0"): {
        "width": "a field the JAX model never reads (B0's widths are "
                 "fixed)"},
    ("runtime/loader.py", "NativeBatchQueue"): {
        "n_workers": "runtime.loader.QUEUE_WORKERS (nothing sets it)",
        "capacity": "runtime.loader.QUEUE_CAPACITY (nothing sets it)"},
    ("xai/callbacks.py", "LimeEpochSnapshot"): {
        "model": "the snapshot reads trainer.state.model at each call"},
    ("ops/pallas_specblock.py", "fused_specblock_convpool"): {
        "pack_w": "the TPU kernel's MXU packing; the CUDA kernels pick "
                  "their own tiles",
        "strip_rows": "the TPU kernel's row strips; the CUDA kernels pick "
                      "their own tiles",
        "interpret": "Pallas interpret mode; the wrapper chooses by the "
                     "tensor's device"},
}


def _args(fn: ast.FunctionDef) -> List[str]:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _ctor(cls: ast.ClassDef) -> List[str]:
    """A class's constructor arguments: ``__init__``'s, else the annotated
    fields (a flax module or a dataclass)."""
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            return _args(node)
    return [n.target.id for n in cls.body if isinstance(n, ast.AnnAssign)
            and isinstance(n.target, ast.Name)]


def _bound(body) -> Dict[str, ast.AST]:
    """Every name a module or class body binds: defs, classes, assignments
    and imports."""
    out: Dict[str, ast.AST] = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out[(alias.asname or alias.name).split(".")[0]] = node
    return out


def _members(cls: ast.ClassDef, classes: Dict[str, ast.ClassDef]
             ) -> Dict[str, ast.AST]:
    """A class's members with those of its bases in the same module."""
    out: Dict[str, ast.AST] = {}
    for base in cls.bases:
        if isinstance(base, ast.Name) and base.id in classes:
            out.update(_members(classes[base.id], classes))
    out.update(_bound(cls.body))
    return out


def _resolve(node: ast.AST, classes: Dict[str, ast.ClassDef]
             ) -> Optional[ast.AST]:
    """``name = Other.method`` in a class body → that method's def."""
    if isinstance(node, ast.Assign) and isinstance(node.value, ast.Attribute) \
            and isinstance(node.value.value, ast.Name) \
            and node.value.value.id in classes:
        return _members(classes[node.value.value.id], classes).get(
            node.value.attr)
    return node


def _jax_api(tree: ast.Module) -> Dict[str, Tuple[str, List[str]]]:
    """Public names of a JAX module → (kind, arguments): functions,
    classes (constructor arguments) and their public methods (flax's
    ``__call__`` included)."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not node.name.startswith("_"):
            out[node.name] = ("function", _args(node))
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = ("class", _ctor(node))
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and (
                        not sub.name.startswith("_")
                        or sub.name == "__call__"):
                    out[f"{node.name}.{sub.name}"] = ("method", _args(sub))
    return out


def _modules() -> List[str]:
    return sorted(str(p.relative_to(JAX_PKG))
                  for p in JAX_PKG.rglob("*.py") if p.name != "__init__.py")


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(encoding="utf-8"))


def _missing(module: str) -> List[str]:
    """What the port's module lacks of the JAX module's API, allowlisted
    names and arguments left out."""
    jax_api = _jax_api(_parse(JAX_PKG / module))
    port_path = PORT / MODULES.get(module, module)
    if not port_path.exists():
        return [f"{module}: no port module {port_path.relative_to(ROOT)}"]
    tree = _parse(port_path)
    top = _bound(tree.body)
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    problems = []
    for name, (kind, args) in jax_api.items():
        if (module, name) in NAMES:
            continue
        if kind == "method":
            cls, meth = name.split(".")
            members = (_members(classes[cls], classes) if cls in classes
                       else {})
            node = members.get(meth)
            if node is None and meth == "__call__":
                node = members.get("forward")
            node = _resolve(node, classes) if node is not None else None
        else:
            node = top.get(name)
        if node is None:
            problems.append(f"{module}: {name} missing")
            continue
        if isinstance(node, ast.ClassDef):
            have = _ctor(node)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            have = _args(node)
        else:                       # an import or assignment: not checked
            continue
        extra = NAME_ARGS.get((module, name), {})
        lacking = [a for a in args if a not in have and a not in ARGS
                   and a not in extra]
        if lacking:
            problems.append(f"{module}: {name} lacks {lacking}")
    return problems


@pytest.mark.parametrize("module", _modules())
def test_module_has_every_public_name_and_argument(module):
    assert _missing(module) == []


def _exports(path: Path) -> List[str]:
    return [alias.asname or alias.name for node in _parse(path).body
            if isinstance(node, ast.ImportFrom) and node.level == 1
            for alias in node.names]


@pytest.mark.parametrize("init", sorted(
    str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("__init__.py")))
def test_package_exports_every_name(init):
    """What a JAX ``__init__.py`` imports from its submodules, the port's
    ``__init__.py`` binds too (allowlisted names aside)."""
    port_init = PORT / init
    assert port_init.exists(), init
    have = _bound(_parse(port_init).body)
    allowed = {name.split(".")[-1] for _, name in NAMES}
    lacking = [n for n in _exports(JAX_PKG / init)
               if n not in have and n not in allowed]
    assert lacking == []


def test_allowlists_match_the_packages():
    """Each exception names a public JAX name (an argument: one some JAX
    function takes) that the port does not have under that name (a stub:
    that it does have)."""
    apis = {m: _jax_api(_parse(JAX_PKG / m)) for m in _modules()}
    for (module, name) in NAMES:
        assert name in apis[module], (module, name)
        port = _bound(_parse(PORT / MODULES.get(module, module)).body)
        assert name.split(".")[-1] not in port or "." in name, (module, name)
    for (module, name) in STUBS:
        assert name in apis[module], (module, name)
        assert name in _bound(_parse(PORT / module).body), (module, name)
    taken = {a for api in apis.values() for _, args in api.values()
             for a in args}
    assert set(ARGS) <= taken, set(ARGS) - taken
    for (module, name), extra in NAME_ARGS.items():
        assert set(extra) <= set(apis[module][name][1]), (module, name)
    for reason in (*NAMES.values(), *STUBS.values(), *ARGS.values(),
                   *(r for e in NAME_ARGS.values() for r in e.values())):
        assert reason.strip()
