"""Device mesh and placement rules (counterpart of the JAX package's
``parallel/mesh.py``).

Axes: ``data`` (batch, data parallelism), ``model`` (tensor-parallel dense
shards), ``seq`` (the time axis of long EEG).  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the initialised world
(:mod:`.launch` starts one): rank ``(d·model + m)·seq + s`` sits at
``(d, m, s)``, the order of the JAX mesh's ``reshape(data, model, seq)``.
A placement is a list of ``torch.distributed.tensor`` placements, one a
mesh axis, in the order ``(data, model, seq)``.
"""

from __future__ import annotations

import re
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from .. import config as C

if TYPE_CHECKING:       # torch.distributed.tensor takes a second to import
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Placement

AXES = ("data", "model", "seq")


def make_mesh(cfg: Optional[C.MeshConfig] = None,
              device: Optional[Union[str, torch.device]] = None
              ) -> DeviceMesh:
    """A ``(data, model, seq)`` mesh over the initialised world.  ``data =
    -1`` takes every rank the other axes leave; a shape whose product is
    not the world size raises ``ValueError``.  ``device`` (default: the
    default group's device type, ``cuda`` for NCCL, ``cpu`` for gloo)
    must match the process group's backend."""
    cfg = cfg or C.MeshConfig()
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: run under "
            "parallel.launch.spawn, or call initialize_multihost first")
    n = dist.get_world_size()
    model, seq = max(cfg.model, 1), max(cfg.seq, 1)
    data = cfg.data if cfg.data > 0 else n // (model * seq)
    if data * model * seq != n:
        raise ValueError(f"mesh {data}x{model}x{seq} != {n} devices")
    kind = ("cuda" if dist.get_backend() == "nccl" else "cpu"
            ) if device is None else torch.device(device).type
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(kind, (data, model, seq), mesh_dim_names=AXES)


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def data_slice(mesh: DeviceMesh, size: int, what: str = "batch") -> slice:
    """This rank's contiguous part of an axis of ``size`` split over
    ``data`` (``size`` must divide over it)."""
    n, i = axis_size(mesh, "data"), axis_index(mesh, "data")
    if size % n:
        raise ValueError(f"{what} {size} does not divide over a data axis "
                         f"of {n}")
    b = size // n
    return slice(i * b, (i + 1) * b)


def gather_data(t: torch.Tensor, mesh: DeviceMesh, dim: int = 0
                ) -> torch.Tensor:
    """The ``data`` ranks' parts of ``t`` concatenated along ``dim`` in
    rank order (the inverse of :func:`data_slice`), on every rank."""
    group = mesh.get_group("data")
    n = dist.get_world_size(group)
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def batch_sharding(mesh: DeviceMesh, ndim: int = 1,
                   seq_axis: Optional[int] = None) -> List[Placement]:
    """The leading (batch) axis sharded over ``data``; with ``seq_axis``,
    that axis over ``seq`` (long-EEG inputs).  ``ndim`` is the JAX
    signature's; a placement needs only the sharded axes."""
    from torch.distributed.tensor import Replicate, Shard
    del ndim
    return [Shard(0), Replicate(),
            Shard(seq_axis) if seq_axis is not None else Replicate()]


def replicate(mesh: DeviceMesh) -> List[Placement]:
    from torch.distributed.tensor import Replicate
    return [Replicate() for _ in AXES]


# Parameter path-patterns sharded over the ``model`` axis (tensor
# parallelism), as in the JAX package: large dense kernels split on their
# output features.  They name flax paths; :func:`flax_path` maps the
# port's parameter names onto them.
_TP_PATTERNS = (
    r".*fc1.*kernel", r".*dense1.*kernel", r".*classifier.*kernel",
    r".*output_0.*kernel", r".*linear1.*kernel", r".*mlp_0.*kernel",
)
#: the out-feature axis of a flax kernel (its last) in a torch weight:
#: ``Linear.weight`` is (out, in), ``ConvNd.weight`` (out, in, ...)
TORCH_OUT_AXIS = 0


def flax_path(name: str, ndim: int) -> str:
    """A torch parameter name as the flax path of the same weight:
    ``eeg_model.dense1.weight`` (2-D or more) → ``eeg_model/dense1/
    kernel``; a 1-D ``weight`` is a norm's ``scale``; ``bias`` stays; an
    index joins its container's name as flax names list members
    (``output.0.weight`` → ``output_0/kernel``)."""
    parts = []
    for p in name.split("."):
        if p.isdigit() and parts:
            parts[-1] += f"_{p}"
        else:
            parts.append(p)
    if parts[-1] == "weight":
        parts[-1] = "kernel" if ndim >= 2 else "scale"
    return "/".join(parts)


def param_shardings(mesh: DeviceMesh, model: nn.Module,
                    patterns: Sequence[str] = _TP_PATTERNS
                    ) -> Dict[str, List[Placement]]:
    """``{parameter name: placements}``: replicated, except a kernel of
    two or more axes whose flax path matches a pattern, which is sharded
    over ``model`` on its out-feature axis (the flax kernel's last axis,
    the torch weight's first)."""
    from torch.distributed.tensor import Replicate, Shard
    regexes = [re.compile(p) for p in patterns]
    out = {}
    for name, p in model.named_parameters():
        if p.dim() >= 2 and any(r.fullmatch(flax_path(name, p.dim()))
                                for r in regexes):
            out[name] = [Replicate(), Shard(TORCH_OUT_AXIS), Replicate()]
        else:
            out[name] = replicate(mesh)
    return out
