"""The processes' side of ``tests/test_torch_multicard.py``: module-level
functions that a spawned process imports and runs.  This module imports
no jax (each process imports it again); importing it does nothing."""

from __future__ import annotations

import os
from collections import namedtuple
from pathlib import Path

import torch
import torch.distributed as dist

from multimodal_brain_pattern_identification_xai_tpu_torch.parallel import (
    launch)


Pair = namedtuple("Pair", "first second")


def flags_and_results(dev):
    """A rank of a gloo world: its numerics flags, and a result holding
    tensors inside a dict, a list, a tuple and a named tuple (one of them
    the output of an op on a tensor that requires grad)."""
    rank = dist.get_rank()
    w = torch.full((2,), float(rank), requires_grad=True)
    return {"flags": launch._flags(), "rank": rank,
            "nested": {"list": [w * 2, 3], "tuple": (torch.ones(1), "x"),
                       "size": torch.Size([2, 3]),
                       "named": Pair(torch.zeros(1), 5)}}


def build_once(tmp: str, index: int, barrier, nvcc: str, gxx: str,
               names: tuple, host_src: str) -> None:
    """One of several processes that build into ``tmp/build`` at once,
    with the given compilers: waits for the others at ``barrier``, builds
    ``names`` and the host source, calls the host library's ``answer``,
    and writes what it returned to ``tmp/done<index>``."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import _build
    _build.BUILD_DIR = Path(tmp) / "build"
    _build._nvcc = lambda: nvcc
    _build._gxx = lambda: gxx
    barrier.wait(timeout=60)
    _build.build(names)
    lib = _build.load_host(Path(host_src))
    with open(os.path.join(tmp, f"done{index}"), "w") as f:
        f.write(str(lib.answer()))
