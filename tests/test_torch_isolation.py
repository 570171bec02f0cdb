"""The PyTorch port stands alone: it imports nothing of JAX, flax or the
JAX package, and its entry points never fall back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "multimodal_brain_pattern_identification_xai_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "multimodal_brain_pattern_identification_xai_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [REPO / "chip_smoke.py"] +
                         sorted((REPO / "scripts").glob("torch_*.py")) +
                         [REPO / "tests" / "torch_parallel_cases.py",
                          REPO / "tests" / "torch_jaxfree_rank.py",
                          REPO / "tests" / "torch_multicard_rank.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    for name in _imported_roots(path):
        assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_port_runs_with_jax_blocked():
    """In a fresh interpreter with jax, flax and the JAX package blocked in
    ``sys.modules``, import the port and run the serving entry on the CPU
    (a subprocess: the test session has already imported jax)."""
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.entry "
        "import entry\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch import "
        "xai\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.ops "
        "import augment, cuda_duty\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch import "
        "data, runtime, train\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch import "
        "diffusion\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.models "
        "import DiffEEG, DiffEEGLegacy\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.train "
        "import DiffEEGTrainer\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.ops "
        "import stft_log1p_interp\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.data "
        "import hms\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.models "
        "import wavenet\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.train "
        "import grid_search\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.runtime "
        "import loader\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.models "
        "import REGISTRY, build, deepconvnet, efficientnet, eegnet, vit\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.xai "
        "import channel_select, rollout\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.entry "
        "import train_branch, init_from_branches, dryrun_multichip\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch import "
        "parallel\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.parallel "
        "import dryrun, hosts, launch, mesh, seqparallel, tp, train\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.xai "
        "import sharded\n"
        "assert len(REGISTRY) == 15\n"
        "loader._lib()\n"
        "fwd, args = entry(device='cpu', batch=2, assume_finite=True)\n"
        "out = fwd(*args)\n"
        "assert out.shape == (2, 6) and bool(torch.isfinite(out).all())\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_parallel_ranks_run_with_jax_blocked():
    """A 2-rank gloo world runs ``make_parallel_train_step`` once with JAX
    blocked in the ranks (``torch_jaxfree_rank``): the port's parallel
    package, which starts each rank, loaded nothing of JAX; then jax,
    flax and the JAX package are blocked, the rest of the port loads and
    the step is finite and alike on both ranks."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.parallel import (
        launch)
    import torch_jaxfree_rank
    res = launch.spawn(torch_jaxfree_rank.dp_step_once, 2, "cpu")
    for r in res:
        assert r["loaded_before"] == [] and r["loaded_after"] == []
        assert not r["nonfinite"] and r["step"] == 1
    assert res[0]["loss"] == res[1]["loss"]


def test_multicard_rank_module_imports_with_jax_blocked():
    """The processes of ``test_torch_multicard.py`` import their functions
    from ``torch_multicard_rank``: it imports with jax, flax and the JAX
    package blocked, and loads none of them."""
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import torch_multicard_rank\n"
        "assert callable(torch_multicard_rank.build_once)\n"
        "print('ok')\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_port_imports_with_pandas_blocked(tmp_path):
    """The card's machine has no pandas: with pandas, pyarrow and JAX
    blocked, every module of the port imports, ``train.csv`` reads into
    its column table and the host library builds and gathers."""
    csv = tmp_path / "train.csv"
    csv.write_text("eeg_id,patient_id,expert_consensus\n5,1,GPD\n7,1,LPD\n")
    code = (
        "import importlib, pkgutil, sys\n"
        f"for m in {FORBIDDEN + ('pandas', 'pyarrow')!r}: "
        "sys.modules[m] = None\n"
        "import numpy as np\n"
        "import multimodal_brain_pattern_identification_xai_tpu_torch as pkg\n"
        "for info in pkgutil.walk_packages(pkg.__path__,\n"
        "                                   pkg.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch import "
        "data, runtime\n"
        f"meta = data.load_train_metadata({str(csv)!r})\n"
        "assert meta['eeg_id'].tolist() == [5, 7]\n"
        "x = np.ones((3, 2, 8), np.float32)\n"
        "assert runtime.gather_windows(x, np.array([2, 0])).shape == "
        "(2, 2, 8)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_entry_without_cuda_raises(monkeypatch):
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        entry)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


@pytest.mark.parametrize("name", ["train_entry", "train_multimodal",
                                  "train_diffeeg", "generate",
                                  "train_wavenet", "grid_search"])
def test_train_entries_without_cuda_raise(monkeypatch, tmp_path, name):
    """The training and generation entry points resolve to the card too:
    without one they raise before building anything, unless
    ``device="cpu"`` is given."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"train_entry": (), "train_wavenet": (str(tmp_path),) * 2,
            "grid_search": (str(tmp_path),) * 2}.get(name, (str(tmp_path),))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(entry, name)(*args)
    assert not any(tmp_path.iterdir())


def test_cli_without_cuda_exits_naming_the_device(monkeypatch, tmp_path,
                                                  capsys):
    """``predict --demo`` without a card and without ``--device cpu``
    stops before any work, naming the device; it does not run on the
    CPU."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["predict", "--demo", "--ckpt-dir",
                     str(tmp_path / "ck")]) != 0
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err
    assert not (tmp_path / "ck").exists()


def test_cli_runs_with_jax_and_pandas_blocked(tmp_path):
    """With jax, flax, the JAX package, pandas and pyarrow blocked, the
    port's command line imports and ``predict --demo --device cpu``
    writes its ``predictions.csv`` (the ``csv`` module, no pandas)."""
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN + ('pandas', 'pyarrow')!r}: "
        "sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch.cli "
        "import main\n"
        f"assert main(['predict', '--demo', '--device', 'cpu', "
        f"'--ckpt-dir', {str(tmp_path)!r}]) == 0\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    header = (tmp_path / "predictions.csv").read_text().splitlines()[0]
    assert header.startswith("eeg_id,p_Seizure,") and header.endswith(
        ",predicted_class")
