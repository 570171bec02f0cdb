"""One process a rank: how the port's parallel programs start.

JAX runs one program over many devices; torch runs one process a rank.
:func:`spawn` starts ``world`` ranks with ``torch.multiprocessing`` (the
``spawn`` start method), each of which joins one process group and calls
``fn(device, *args)``; every rank's return value comes back to the caller,
in rank order.

* The backend follows the device and nothing else: ``cuda`` → NCCL with
  one card a rank (rank r on ``cuda:r``; a world larger than the visible
  cards raises, naming both numbers), ``cpu`` → gloo with one intra-op
  thread a rank.  Nothing switches backend or device on failure.
* The ranks meet through a ``file://`` store in a fresh temporary
  directory, not a TCP port: several worlds can start at once on one
  host without colliding.
* A rank's exception is raised again in the caller as a ``RuntimeError``
  naming the rank, with the rank's traceback; the other ranks are ended.
* ``fn`` is pickled by reference: it must be a module-level function of a
  module that imports no jax (the child imports that module again).  The
  arguments go to a file that each rank reads once it runs: through the
  start-up pipe, more than its 64 KiB would start the ranks one after
  another, each waiting for the one before to import torch.
* Each spawned rank runs under the caller's numerics flags (cuDNN's
  TF32, determinism and benchmark switches, TF32 in matmuls), as a world
  of one in the calling process does: a fresh interpreter would start
  from PyTorch's defaults instead.
* The caller loads each rank's result onto the CPU (``map_location``):
  it opens no CUDA context on the ranks' cards.
* A world of one runs in the calling process (a process group of one
  rank, made and destroyed around the call): no child, no start-up cost.
  Where a process group of ``world`` ranks is already initialised (under
  ``torchrun`` after :func:`.hosts.initialize_multihost`, or inside a
  rank), ``fn`` runs in place on it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import traceback
from typing import Any, Callable, List, Sequence, Union

import torch
import torch.distributed as dist

#: the process-group backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
#: how long a collective may wait before the rank fails
TIMEOUT = datetime.timedelta(seconds=600)


def backend_for(device: Union[str, torch.device]) -> str:
    """``nccl`` for ``cuda``, ``gloo`` for ``cpu``; anything else raises."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {kind!r}")
    return BACKENDS[kind]


def check_world(world: int, device: Union[str, torch.device]) -> None:
    """Raise unless ``world`` ranks fit the device: at least one, and on
    ``cuda`` no more than the cards visible."""
    if world < 1:
        raise ValueError(f"a world needs at least one rank, not {world}")
    backend_for(device)
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
        if world > have:
            raise RuntimeError(
                f"a world of {world} ranks needs {world} CUDA devices "
                f"(NCCL takes one card a rank); {have} visible")


def _join(rank: int, world: int, kind: str, store: str) -> torch.device:
    """Join the process group as ``rank``; returns the rank's device."""
    if kind == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(
        BACKENDS[kind], init_method=f"file://{store}", rank=rank,
        world_size=world, timeout=TIMEOUT,
        device_id=dev if kind == "cuda" else None)
    return dev


#: the numerics switches (under ``torch.backends``) a spawned rank takes
#: from its caller
_FLAGS = ("cudnn.allow_tf32", "cudnn.deterministic", "cudnn.benchmark",
          "cuda.matmul.allow_tf32")


def _flag(name: str):
    """(the object holding flag ``name``, the attribute's name)."""
    *path, attr = name.split(".")
    obj = torch.backends
    for part in path:
        obj = getattr(obj, part)
    return obj, attr


def _flags() -> dict:
    """The caller's values of :data:`_FLAGS`."""
    return {name: getattr(*_flag(name)) for name in _FLAGS}


def _set_flags(flags: dict) -> None:
    for name in _FLAGS:
        setattr(*_flag(name), flags[name])


def _child(rank: int, fn: Callable, world: int, kind: str, tmp: str
           ) -> None:
    """A spawned rank: one intra-op thread on the CPU, the caller's flags,
    join, call ``fn`` on the arguments saved under ``tmp``, save its result
    (or the traceback) there, leave the group."""
    if kind == "cpu":
        torch.set_num_threads(1)
    try:
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            flags, args = pickle.load(f)
        _set_flags(flags)
        dev = _join(rank, world, kind, os.path.join(tmp, "store"))
        try:
            result = fn(dev, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))


def _failure(tmp: str, world: int, exc: BaseException) -> RuntimeError:
    """A RuntimeError naming the failed ranks, with each one's traceback
    (the rank ``torch.multiprocessing`` saw fail first leads)."""
    first = getattr(exc, "error_index", None)
    order = ([first] if first is not None else []) + [
        r for r in range(world) if r != first]
    parts = []
    for rank in order:
        path = os.path.join(tmp, f"rank{rank}.err")
        if os.path.exists(path):
            with open(path) as f:
                parts.append(f"rank {rank} of {world} failed:\n{f.read()}")
    if not parts:
        parts.append(f"rank {first} of {world} failed: {exc}")
    return RuntimeError("\n".join(parts))


def spawn(fn: Callable, world: int, device: Union[str, torch.device],
          args: Sequence[Any] = ()) -> List[Any]:
    """Run ``fn(rank_device, *args)`` on ``world`` ranks over ``device``'s
    backend; returns the ranks' results in rank order (see the module
    docstring for where the ranks run)."""
    kind = torch.device(device).type
    check_world(world, kind)
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"already initialised; cannot start a world of {world}")
        if dist.get_backend() != BACKENDS[kind]:
            raise RuntimeError(
                f"the initialised process group runs {dist.get_backend()}, "
                f"not {BACKENDS[kind]} for {kind}")
        dev = (torch.device("cuda", torch.cuda.current_device())
               if kind == "cuda" else torch.device("cpu"))
        return [fn(dev, *args)]
    with tempfile.TemporaryDirectory(prefix="world-") as tmp:
        if world == 1:
            dev = _join(0, 1, kind, os.path.join(tmp, "store"))
            try:
                return [fn(dev, *args)]
            finally:
                dist.destroy_process_group()
        import torch.multiprocessing as mp
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump((_flags(), tuple(args)), f)
        try:
            mp.start_processes(_child, args=(fn, world, kind, tmp),
                               nprocs=world, join=True,
                               start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise _failure(tmp, world, e) from None
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
