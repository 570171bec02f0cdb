"""Build and load the package's CUDA kernels and its C++ host library.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ``ctypes``.  Builds happen at first use, into ``_build/`` beside this
file (listed in ``.gitignore``); the library's file name carries a hash of
its source and of the headers in ``csrc/``, so an edited source or
header is rebuilt.  The host library (``runtime/hostloader.cpp``, no
CUDA) builds the same way with ``g++`` (:func:`load_host`).  A build
holds an ``flock`` on ``_build/lock`` from its check to its rename, so
the ranks of a parallel run that start on an empty ``_build/`` compile
each source once: the first takes the lock and builds, the others wait
and find the library (the kernel releases the lock of a process that
dies).  Nothing here runs at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

from . import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
              "-pthread")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ``nvcc``'s diagnostics of each build (``-Xptxas -v``: registers,
#: shared memory and spills per kernel), by source name
build_logs: Dict[str, str] = {}


@contextlib.contextmanager
def _locked():
    """This thread's lock, then the build directory's ``flock`` (other
    processes), held around a check-then-build."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "lock", "a") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host library cannot be built")
    return found


def _target(name: str) -> Path:
    """The library's path: a hash of the source, the headers beside it and
    the flags, so that an edit to any of them rebuilds."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one ``nvcc`` into a temporary file; returns (proc, tmp, out)."""
    out = _target(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: Path) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)      # atomic: no process loads a partial file


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no current library, one
    ``nvcc`` per source, all started together."""
    with _locked():
        todo = [n for n in names if n not in _libs and not _target(n).exists()]
        jobs = [(n, *_start(n)) for n in todo]
        for n, proc, tmp, out in jobs:
            _finish(n, proc, tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed.
    The first load is the span ``mbx.setup.kernels``, with the build (nvcc
    where the library is missing) its child ``mbx.setup.kernels.build``,
    so the span's self time is the load alone, cold or warm."""
    lib = _libs.get(name)
    if lib is None:
        with profiling.span("mbx.setup.kernels"):
            with profiling.span("mbx.setup.kernels.build"):
                build([name])
            with _lock:
                lib = _libs.get(name)
                if lib is None:
                    lib = ctypes.CDLL(str(_target(name)))
                    _libs[name] = lib
    return lib


def load_host(src: Path) -> ctypes.CDLL:
    """The loaded library of the C++ host source ``src``, built with
    ``g++ HOST_FLAGS`` into ``_build/`` at first use; the file name carries
    a hash of the source and the flags, so an edited source is rebuilt.
    Raises with the compiler's message when it cannot be built."""
    key = str(src)
    with _locked():
        lib = _libs.get(key)
        if lib is not None:
            return lib
        h = hashlib.sha256(src.read_bytes())
        h.update(" ".join(HOST_FLAGS).encode())
        out = BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"
        if not out.exists():
            gxx = _gxx()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run([gxx, *HOST_FLAGS, str(src), "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"g++ failed on {src.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = _libs[key] = ctypes.CDLL(str(out))
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
