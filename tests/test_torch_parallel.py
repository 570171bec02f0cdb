"""The port's parallel layer (``_torch/parallel``: mesh, data-parallel
step, ``Trainer(mesh=...)``, ``DiffEEGTrainer(mesh=...)``, tensor
parallelism, the DP × TP × SP step, the multichip dry run, multi-process
start-up) against the JAX package's ``shard_map`` programs on the CPU.

One gloo world of 8 ranks (``parallel.launch.spawn``, module scope) runs
every case of this file (``torch_parallel_cases.parallel_world``); the
JAX side runs on the 8 virtual CPU devices of ``conftest.py``, on the
same inputs and weights.  Bounds are the JAX package's own tests'
(tests/test_parallel.py, tests/test_aux_components.py)."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import multimodal_brain_pattern_identification_xai_tpu.config as JC
from multimodal_brain_pattern_identification_xai_tpu import (
    models as jm, parallel as jp, train as jt)
from multimodal_brain_pattern_identification_xai_tpu.parallel import (
    dryrun as jdryrun, tp as jtp)
from multimodal_brain_pattern_identification_xai_tpu_torch import (
    models as tm)
from multimodal_brain_pattern_identification_xai_tpu_torch.parallel import (
    launch, seqparallel)

import torch_parallel_cases as cases

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wavenet_jax(rng):
    model = jm.DilatedInceptionWaveNet(block_layers=(3, 2), block_dims=(8, 8))
    x = rng.standard_normal((8, 64, 8)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 8)]
    tx = jt.state.make_optimizer(1e-2, optimizer="sgd")
    state = jt.create_train_state(model, (jnp.asarray(x),), tx,
                                  jax.random.PRNGKey(0))
    return state, x, y


def _dts_jax(rng):
    """The DP × TP × SP case of tests/test_aux_components.py:531-569."""
    enc = jp.LongEEGEncoder(n_channels=2, patch=4, d_model=8, depth=1,
                            n_heads=2)
    params = jdryrun.init_dp_tp_sp_params(jax.random.PRNGKey(0), enc,
                                          head_hidden=16)
    x = rng.standard_normal((4, 2, 32)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 4)]
    mesh = jp.make_mesh(JC.MeshConfig(data=2, model=2, seq=2))
    placed, xs, ys = jdryrun.place_inputs(mesh, params, x, y)
    new, loss = jdryrun.make_dp_tp_sp_train_step(mesh, enc, lr=1e-2)(
        placed, xs, ys)
    flat = {f"enc.{k}": v for k, v in seqparallel.jax_params_to_state_dict(
        params["enc"]).items()}
    flat_new = {f"enc.{k}": v for k, v in seqparallel.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, new["enc"])).items()}
    for k in ("k1", "b1", "k2", "b2"):
        flat[k] = np.asarray(params[k])
        flat_new[k] = np.asarray(new[k])
    return {k: np.asarray(v) for k, v in flat.items()}, x, y, \
        {k: np.asarray(v) for k, v in flat_new.items()}, float(loss)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs, the JAX package's results, and rank 0's results of the
    8-rank world."""
    rng = np.random.default_rng(42)
    wn_state, wn_x, wn_y = _wavenet_jax(rng)
    mesh = jp.make_mesh(JC.MeshConfig(data=4, model=2, seq=1))
    par = jp.make_parallel_train_step(mesh, wn_state, donate=False)
    jnew, jm_ = par(wn_state, jp.shard_batch(mesh, {"x": wn_x, "y": wn_y}),
                    jax.random.PRNGKey(1))
    eegnet = tm.EEGNet(samples=128, kern_length=8)
    de = tm.DiffEEG(n_channels=2, hidden=4)
    g = np.random.default_rng(3)
    tp_x = rng.standard_normal((4, 12)).astype(np.float32)
    tp_w = {"tp_k1": rng.standard_normal((12, 128)) * 0.1,
            "tp_b1": rng.standard_normal((128,)) * 0.1,
            "tp_k2": rng.standard_normal((128, 6)) * 0.1,
            "tp_b2": rng.standard_normal((6,)) * 0.1}
    tp_w = {k: v.astype(np.float32) for k, v in tp_w.items()}
    dts_params, dts_x, dts_y, dts_new, dts_loss = _dts_jax(rng)
    inputs = {
        "tmp": str(tmp_path_factory.mktemp("trainer")),
        "wavenet": {k: v.numpy() for k, v in tm.jax_variables_to_state_dict(
            {"params": wn_state.params}).items()},
        "wn_x": wn_x, "wn_y": wn_y,
        "eegnet": {k: v.numpy() for k, v in
                   tm.seeded_state_dict(eegnet, 0).items()},
        "eeg_x": rng.standard_normal((8, 1, 37, 128)).astype(np.float32),
        "eeg_y": np.eye(6, dtype=np.float32)[rng.integers(0, 6, 8)],
        "diffeeg": {k: v.numpy() for k, v in
                    tm.seeded_state_dict(de, 0).items()},
        "de_x": g.standard_normal((2, 2, 2, 64)).astype(np.float32),
        "de_y": np.eye(6, dtype=np.float32)[g.integers(0, 6, (2, 2))],
        "tp_x": tp_x, **tp_w,
        "dts_params": dts_params, "dts_x": dts_x, "dts_y": dts_y,
    }
    fn = shard_map(jtp.tp_mlp, mesh=jp.make_mesh(JC.MeshConfig(
        data=1, model=8, seq=1)), in_specs=(P(), P(None, "model"),
        P("model"), P("model", None), P()), out_specs=P(), check_vma=False)
    jax_res = {
        "dp_params": {k: v.numpy() for k, v in tm.jax_variables_to_state_dict(
            {"params": jnew.params}).items()},
        "dp_loss": float(jm_["loss"]),
        "tp": np.asarray(fn(*(jnp.asarray(a) for a in (
            tp_x, tp_w["tp_k1"], tp_w["tp_b1"], tp_w["tp_k2"],
            tp_w["tp_b2"])))),
        "dts_new": dts_new, "dts_loss": dts_loss,
    }
    res = launch.spawn(cases.parallel_world, 8, "cpu", (inputs,))
    return {"rank0": res[0], "ranks": res, "jax": jax_res, "inputs": inputs}


def _case(world, name):
    r = world["rank0"][name]
    assert not (isinstance(r, dict) and "error" in r), r.get("error")
    return r


def _all_close(got, want, rtol, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_world_ranks_in_order(world):
    assert [r["rank"] for r in world["ranks"]] == list(range(8))


def test_make_mesh_shapes(world):
    """(2, 2, 2) from data=-1, data=-1 alone takes all 8, the 3×2×2 error
    with the JAX message; rank r sits at ((r // 4), (r // 2) % 2, r % 2),
    the JAX mesh's reshape(data, model, seq) order."""
    for res in world["ranks"]:
        r = _case({"rank0": res}, "mesh_shapes")
        assert r["shape"] == (2, 2, 2)
        assert tuple(r["names"]) == ("data", "model", "seq")
        assert r["data8"] == 8
        assert r["message"] == "mesh 3x2x2 != 8 devices"
        k = r["rank"]
        assert r["coords"] == [k // 4, (k // 2) % 2, k % 2]


def test_dp_step_matches_single_device_and_jax(world):
    """The data-parallel SGD step on (4, 2, 1) against the single-device
    step (rtol 2e-4, atol 1e-5, tests/test_parallel.py:38-68) and against
    the JAX package's ``make_parallel_train_step`` on the same weights."""
    r = _case(world, "dp_step")
    assert abs(r["loss_single"] - r["loss_dp"]) < 1e-5
    _all_close(r["dp"], r["single"], 2e-4, 1e-5)
    assert abs(r["loss_dp"] - world["jax"]["dp_loss"]) < 1e-5
    _all_close(r["dp"], world["jax"]["dp_params"], 2e-4, 1e-5)


def test_replay_matches_mesh_step_with_dropout_and_bn(world):
    """``replay_dp_loss_single_device`` gives the mesh step's loss with
    dropout and BatchNorm (tests/test_parallel.py:71-99), and a plain
    full-batch forward does not; the replay leaves the running
    statistics alone."""
    r = _case(world, "replay")
    assert abs(r["mesh"] - r["replay"]) < 1e-5
    assert abs(r["plain"] - r["replay"]) > 1e-4
    assert r["buffers_kept"]


def test_parallel_step_nan_sentinel_skips_update(world):
    """A NaN in one rank's rows skips the update on every rank: params,
    optimizer state and BatchNorm statistics bitwise, the step counter
    advanced (tests/test_parallel.py:345-376); a finite batch updates."""
    r = _case(world, "nan_sentinel")
    assert r["nonfinite"] and r["step"] == 1
    assert r["params_kept"] and r["buffers_kept"] and r["opt_kept"]
    assert not r["good_nonfinite"] and r["good_changed"]


def test_trainer_with_mesh_matches_single_device(world):
    """``Trainer(mesh=...)`` against the single-device ``Trainer``
    (tests/test_parallel.py:126-167): history 1e-4, params 2e-4/1e-5; the
    snapshot rank 0 wrote restores into a fresh state; only rank 0
    writes."""
    r = _case(world, "trainer")
    assert abs(r["best_single"] - r["best_mesh"]) < 1e-4
    np.testing.assert_allclose(r["hist_mesh"], r["hist_single"], rtol=1e-4,
                               atol=1e-5)
    _all_close(r["mesh"], r["single"], 2e-4, 1e-5)
    _all_close(r["restored"], r["mesh"], 1e-6, 0)
    assert r["written"]
    assert not any(res["trainer"].get("written") for res in
                   world["ranks"][1:])
    assert sorted(os.listdir(Path(world["inputs"]["tmp"]) / "mesh")) == [
        "best-kldiv", "best-kldiv.json", "hyperparams.json", "last",
        "last.json", "step_1", "step_1.json", "step_2", "step_2.json"]


def test_diffeeg_trainer_mesh_matches_single_device(world):
    """``DiffEEGTrainer(mesh, decorrelate_shards=False)`` on the batch
    tiled over data=2 repeats the single-device trajectory
    (tests/test_parallel.py:170-213); decorrelated shards draw apart."""
    r = _case(world, "diffeeg")
    assert abs(r["loss_single"] - r["loss_dp"]) < 1e-5
    _all_close(r["dp"], r["single"], 2e-4, 1e-5)
    np.testing.assert_allclose(r["ema_dp"], r["ema_single"], rtol=2e-4,
                               atol=1e-5)
    assert np.isfinite(r["loss_decorrelated"])


def test_tp_mlp_matches_jax(world):
    """Column → ReLU → row over model=8 against the JAX ``shard_map``
    program (1e-4/1e-5), and its input and kernel gradients against the
    unsharded ones (``copy_in``'s all-reduce, no double count)."""
    r = _case(world, "tp_mlp")
    np.testing.assert_allclose(r["out"], world["jax"]["tp"], rtol=1e-4,
                               atol=1e-5)
    i = world["inputs"]
    ref = np.maximum(i["tp_x"] @ i["tp_k1"] + i["tp_b1"], 0) @ i["tp_k2"] \
        + i["tp_b2"]
    np.testing.assert_allclose(r["out"], ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r["gx"], r["gx_ref"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["gk1"], r["gk1_ref"], rtol=1e-5, atol=1e-6)


def test_dp_tp_sp_step_matches_jax_and_unsharded(world):
    """One DP × TP × SP SGD step on (2, 2, 2): the new parameters against
    the JAX step (replication checking on) and against the unsharded
    step, rtol 5e-4, atol 2e-5; the loss to 1e-5
    (tests/test_aux_components.py:531-569)."""
    r = _case(world, "dp_tp_sp")
    assert abs(r["loss"] - world["jax"]["dts_loss"]) < 1e-5
    assert abs(r["loss"] - r["ref_loss"]) < 1e-5
    _all_close(r["new"], world["jax"]["dts_new"], 5e-4, 2e-5)
    _all_close(r["new"], r["ref_new"], 5e-4, 2e-5)


def test_tp_param_shardings(world):
    """Dense kernels a TP pattern names are sharded over ``model`` on the
    torch weight's out-feature axis (dim 0); convolutions and buffers
    replicate; list indices map to flax's ``name_i``; a batch is sharded
    over ``data`` on its leading axis (and over ``seq`` on ``seq_axis``)."""
    r = _case(world, "shardings")
    assert r["dense1"] == "[Replicate(), Shard(dim=0), Replicate()]"
    assert r["conv1"] == "[Replicate(), Replicate(), Replicate()]"
    assert r["running_mean"] == r["conv1"]
    assert r["wavenet_output_0"] == r["dense1"]
    assert r["wavenet_output_2"] == r["conv1"]
    assert r["path"] == "wave_module_0/gated_tcns_1/gate/filters_2/kernel"
    assert r["batch"] == "[Shard(dim=0), Replicate(), Replicate()]"
    assert r["batch_seq"] == "[Shard(dim=0), Replicate(), Shard(dim=2)]"


def test_dryrun_multichip_on_eight_ranks(world):
    """``entry.dryrun_multichip(8, device="cpu")`` inside the world: the
    (2, 2, 2) step and the multimodal DP loss equal to the replay."""
    r = _case(world, "dryrun")
    assert tuple(r["mesh"]) == (2, 2, 2)
    assert np.isfinite(r["sp_loss"])
    assert abs(r["dp_loss"] - r["replay_loss"]) < 1e-4 * max(
        1.0, abs(r["replay_loss"]))


def test_spawn_names_the_failed_rank(monkeypatch):
    """A rank's exception comes back as a RuntimeError naming the rank
    and carrying its traceback; a world larger than the visible cards
    raises on cuda, naming both numbers, before any process starts."""
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 2 failed.*"
                                           r"ValueError: rank 1 fails"):
        launch.spawn(cases.fail_on_rank_one, 2, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="world of 2 ranks needs 2 CUDA "
                                           r"devices .*; 1 visible"):
        launch.spawn(cases.fail_on_rank_one, 2, "cuda")
    assert launch.backend_for("cuda") == "nccl"
    assert launch.backend_for("cpu") == "gloo"


_HOSTS = (
    "import sys, torch, torch.distributed as dist\n"
    "torch.set_num_threads(1)\n"
    "from multimodal_brain_pattern_identification_xai_tpu_torch.parallel "
    "import hosts\n"
    "assert hosts.initialize_multihost(device='cpu')\n"
    "t = torch.tensor([float(dist.get_rank() + 1)])\n"
    "dist.all_reduce(t)\n"
    "print(dist.get_world_size(), float(t[0]), hosts.is_primary())\n"
    "dist.destroy_process_group()\n")


def test_initialize_multihost_two_processes_from_env():
    """Two processes join through torchrun's environment variables
    (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``) over gloo; an
    all-reduce sums 1 + 2 on both; rank 0 alone is primary.  Without a
    cluster configured the call returns False."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank))
        procs.append(subprocess.Popen([sys.executable, "-c", _HOSTS],
                                      cwd=REPO, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert [o.split() for o, _ in outs] == [["2", "3.0", "True"],
                                           ["2", "3.0", "False"]]
    from multimodal_brain_pattern_identification_xai_tpu_torch.parallel \
        import hosts
    env = {k: os.environ.pop(k) for k in ("WORLD_SIZE", "MASTER_ADDR")
           if k in os.environ}
    try:
        assert hosts.initialize_multihost() is False
        assert hosts.is_primary()
    finally:
        os.environ.update(env)
