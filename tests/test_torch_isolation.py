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
                         sorted((REPO / "scripts").glob("torch_*.py")),
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


def test_entry_without_cuda_raises(monkeypatch):
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        entry)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


@pytest.mark.parametrize("name", ["train_entry", "train_multimodal",
                                  "train_diffeeg", "generate"])
def test_train_entries_without_cuda_raise(monkeypatch, tmp_path, name):
    """The training and generation entry points resolve to the card too:
    without one they raise before building anything, unless
    ``device="cpu"`` is given."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (str(tmp_path),) if name != "train_entry" else ()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(entry, name)(*args)
    assert not any(tmp_path.iterdir())
