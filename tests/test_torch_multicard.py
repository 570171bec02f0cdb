"""The start-up of the port's parallel programs on more than one card,
held on the CPU: ``initialize_multihost`` gives each process of a host a
card of its own, the caller loads a spawned rank's result onto the host,
a spawned rank runs under the caller's numerics flags, and processes that
start on an empty build directory compile each source once.  No card is
needed: the CUDA calls are monkeypatched, the worlds run over gloo and
the compilers are stand-in scripts."""

import multiprocessing
import os
import shutil
import stat
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from multimodal_brain_pattern_identification_xai_tpu_torch import _build
from multimodal_brain_pattern_identification_xai_tpu_torch.parallel import (
    hosts, launch)

import torch_multicard_rank as rank_fns


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("process_id,env,card", [
    (3, {}, 3),                                # no LOCAL_RANK: process_id
    (5, {}, 1),                                # modulo the 4 visible cards
    (3, {"LOCAL_RANK": "2"}, 2),               # the launcher's LOCAL_RANK
    (None, {"RANK": "6", "WORLD_SIZE": "8"}, 2),   # torchrun's RANK
])
def test_initialize_multihost_gives_each_process_its_card(
        monkeypatch, process_id, env, card):
    """With no ``LOCAL_RANK`` every process of a host used to take card 0,
    which NCCL refuses for two ranks; now rank mod the visible cards."""
    for k in ("LOCAL_RANK", "RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    chosen, joined = [], {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.update(kw, backend=backend))
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    address = None if process_id is None else "localhost:29511"
    assert hosts.initialize_multihost(address, 4 if address else None,
                                      process_id, device="cuda")
    assert chosen == [torch.device("cuda", card)]
    assert joined["device_id"] == torch.device("cuda", card)
    assert joined["backend"] == "nccl"
    if address:
        assert joined["init_method"] == "tcp://localhost:29511"
        assert (joined["world_size"], joined["rank"]) == (4, process_id)
    else:
        assert joined["init_method"] == "env://"


@pytest.fixture(scope="module")
def world():
    """One 2-rank gloo world, spawned with numerics flags that are not
    PyTorch's defaults (restored after); the ``map_location`` of each
    result's load in the caller."""
    saved, load = launch._flags(), torch.load
    maps = []

    def spy(*args, **kwargs):
        maps.append(kwargs.get("map_location"))
        return load(*args, **kwargs)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.load = spy
    try:
        want = launch._flags()
        res = launch.spawn(rank_fns.flags_and_results, 2, "cpu")
    finally:
        torch.load = load
        launch._set_flags(saved)
    return want, res, maps


def test_spawned_ranks_take_the_callers_flags(world):
    """A fresh interpreter starts from PyTorch's defaults; the ranks run
    as a world of one in the caller would."""
    want, res, _ = world
    assert want != launch._flags()
    assert [r["flags"] for r in res] == [want, want]


def test_rank_results_reach_the_caller_on_the_host(world):
    """The caller loads each rank's result onto the CPU (a rank on a card
    saves ``cuda:r`` tensors), inside containers of the types the rank
    returned."""
    _, res, maps = world
    assert maps == ["cpu", "cpu"]
    for rank, r in enumerate(res):
        n = r["nested"]
        tensors = [n["list"][0], n["tuple"][0], n["named"].first]
        assert all(t.device.type == "cpu" for t in tensors)
        assert torch.equal(n["list"][0], torch.full((2,), 2.0 * rank))
        assert n["list"][1] == 3 and n["tuple"][1] == "x"
        assert type(n["named"]) is rank_fns.Pair and n["named"].second == 5
        assert n["size"] == torch.Size([2, 3])


def _script(path: Path, body: str) -> str:
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_processes_on_an_empty_build_directory_compile_each_source_once(
        tmp_path):
    """Four processes start ``_build.build`` and ``load_host`` together on
    an empty build directory: the first to take the directory's lock
    compiles, the others wait and load its libraries.  The stand-in nvcc
    logs its source and writes a placeholder; the stand-in g++ logs and
    runs g++ on a one-function source."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host library with")
    log = tmp_path / "compiles.log"
    nvcc = _script(tmp_path / "nvcc", (
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        f'echo "nvcc $a" >> {log}\n'
        'sleep 0.5\n'
        'printf stub > "$out"\n'))
    gxx = _script(tmp_path / "gxx", (
        f'echo "g++" >> {log}\n'
        'sleep 0.5\n'
        f'exec {shutil.which("g++")} "$@"\n'))
    src = tmp_path / "answer.cpp"
    src.write_text('extern "C" int answer() { return 42; }\n')
    names = ("iir", "specblock", "duty")
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(4)
    procs = [ctx.Process(target=rank_fns.build_once,
                         args=(str(tmp_path), i, barrier, nvcc, gxx, names,
                               str(src)))
             for i in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert [p.exitcode for p in procs] == [0, 0, 0, 0]
    assert [(tmp_path / f"done{i}").read_text() for i in range(4)] == (
        ["42"] * 4)
    lines = sorted(log.read_text().split("\n")[:-1])
    assert lines == sorted(["g++"] + [
        f"nvcc {_build.CSRC / (n + '.cu')}" for n in names])
    built = sorted(p.name.split("-")[0] for p in
                   (tmp_path / "build").glob("*.so"))
    assert built == ["libanswer", "libduty", "libiir", "libspecblock"]
    assert not any(p.name.startswith("tmp") for p in
                   (tmp_path / "build").iterdir())
    assert os.path.exists(tmp_path / "build" / "lock")
