"""The ranks' side of the port's parallel tests: module-level functions
that ``parallel.launch.spawn`` runs on every rank of a gloo world.

This module imports no jax (each spawned rank imports it again): the test
files prepare every input, the JAX package's results included, as numpy
arrays, and each function here runs all of one file's cases on its rank
and returns ``{case: result}`` (numpy), a case that raised giving its
traceback under ``"error"``.  The tests compare rank 0's results.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch
import torch.distributed as dist

from multimodal_brain_pattern_identification_xai_tpu_torch import (
    config as C, entry, models as tm, parallel, train as tt, xai as txai)
from multimodal_brain_pattern_identification_xai_tpu_torch.parallel import (
    dryrun, mesh as mesh_lib, seqparallel, tp)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


def _run(cases, inputs, out):
    for name, fn in cases:
        try:
            out[name] = _np(fn(inputs))
        except Exception:                                  # noqa: BLE001
            out[name] = {"error": traceback.format_exc()}
    return out


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# --- test_torch_parallel ----------------------------------------------------

def fail_on_rank_one(dev):
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    return dist.get_rank()


def _mesh_shapes(_):
    m = parallel.make_mesh(C.MeshConfig(data=-1, model=2, seq=2), "cpu")
    m1 = parallel.make_mesh(C.MeshConfig(data=-1))
    try:
        parallel.make_mesh(C.MeshConfig(data=3, model=2, seq=2))
        err = None
    except ValueError as e:
        err = str(e)
    coords = [mesh_lib.axis_index(m, a) for a in mesh_lib.AXES]
    return {"shape": tuple(m.mesh.shape), "names": m.mesh_dim_names,
            "data8": mesh_lib.axis_size(m1, "data"), "message": err,
            "coords": coords, "rank": dist.get_rank()}


def _wavenet(inputs):
    model = tm.DilatedInceptionWaveNet(block_layers=(3, 2), block_dims=(8, 8))
    model.load_state_dict({k: _t(v) for k, v in inputs["wavenet"].items()})
    return model


def _dp_step(inputs):
    """One SGD step on (4, 2, 1), data parallel and on one device."""
    x, y = _t(inputs["wn_x"]), _t(inputs["wn_y"])
    mesh = parallel.make_mesh(C.MeshConfig(data=4, model=2, seq=1))
    single = tt.create_train_state(_wavenet(inputs),
                                   tt.make_optimizer(1e-2, optimizer="sgd"))
    dp = tt.create_train_state(_wavenet(inputs),
                               tt.make_optimizer(1e-2, optimizer="sgd"))
    key = torch.Generator().manual_seed(1)
    single, ma = tt.make_train_step()(single, {"x": x, "y": y}, key)
    step = parallel.make_parallel_train_step(mesh, dp, donate=False)
    dp, mb = step(dp, parallel.shard_batch(mesh, {"x": x, "y": y}), key)
    return {"single": _params(single.model), "dp": _params(dp.model),
            "loss_single": float(ma["loss"]), "loss_dp": float(mb["loss"])}


def _eegnet_state(inputs, optimizer="adam"):
    model = tm.EEGNet(samples=128, kern_length=8)
    model.load_state_dict({k: _t(v) for k, v in inputs["eegnet"].items()})
    return tt.create_train_state(model, tt.make_optimizer(
        1e-3, optimizer=optimizer))


def _replay(inputs):
    """Mesh loss against the single-device replay (dropout and BN)."""
    state = _eegnet_state(inputs)
    batch = {"x": _t(inputs["eeg_x"]), "y": _t(inputs["eeg_y"])}
    mesh = parallel.make_mesh(C.MeshConfig(data=4, model=2, seq=1))
    before = parallel.train.copy_state(state)
    step = parallel.make_parallel_train_step(mesh, state)
    key = torch.Generator().manual_seed(7)
    _, m = step(state, parallel.shard_batch(mesh, batch), key)
    bufs = [b.clone() for b in before.model.buffers()]
    replay = parallel.replay_dp_loss_single_device(before, batch, key, dp=4)
    plain = parallel.replay_dp_loss_single_device(before, batch, key, dp=1)
    kept = all(torch.equal(a, b) for a, b in zip(bufs,
                                                 before.model.buffers()))
    return {"mesh": float(m["loss"]), "replay": float(replay),
            "plain": float(plain), "buffers_kept": kept}


def _nan_sentinel(inputs):
    state = _eegnet_state(inputs)
    mesh = parallel.make_mesh(C.MeshConfig(data=4, model=2, seq=1))
    step = parallel.make_parallel_train_step(mesh, state, donate=False)
    x = inputs["eeg_x"].copy()
    x[0, 0, 0, :4] = np.nan
    p0, b0 = _params(state.model), [b.clone() for b in state.model.buffers()]
    opt0 = {k: v.clone() for k, v in state.opt_state.items()}
    bad = parallel.shard_batch(mesh, {"x": x, "y": inputs["eeg_y"]})
    state, m = step(state, bad, torch.Generator().manual_seed(1))
    out = {"nonfinite": bool(m["nonfinite"]), "step": state.step,
           "params_kept": all(torch.equal(p0[k], v) for k, v in
                              _params(state.model).items()),
           "buffers_kept": all(torch.equal(a, b) for a, b in
                               zip(b0, state.model.buffers())),
           "opt_kept": all(torch.equal(opt0[k], v)
                           for k, v in state.opt_state.items())}
    good = parallel.shard_batch(mesh, {"x": inputs["eeg_x"],
                                       "y": inputs["eeg_y"]})
    state, m = step(state, good, torch.Generator().manual_seed(1))
    out["good_nonfinite"] = bool(m["nonfinite"])
    out["good_changed"] = any(not torch.equal(p0[k], v) for k, v in
                              _params(state.model).items())
    return out


def _trainer(inputs):
    """Trainer(mesh) against the single-device Trainer, two epochs."""
    x, y = inputs["wn_x"], inputs["wn_y"]
    batches = [{"x": x, "y": y}]
    mesh = parallel.make_mesh(C.MeshConfig(data=4, model=2, seq=1))
    root = inputs["tmp"]

    def make(m, sub):
        state = tt.create_train_state(
            _wavenet(inputs), tt.make_optimizer(1e-2, optimizer="sgd"))
        cfg = tt.TrainerConfig(epochs=2, eval_metrics=("kldiv",))
        return tt.Trainer(state, cfg, ckpt_dir=f"{root}/{sub}", mesh=m)

    out = {}
    if dist.get_rank() == 0:
        t_single = make(None, "single")
        s_a, best_a, _ = t_single.train_eval(lambda: iter(batches),
                                             lambda: iter(batches))
        out.update(single=_params(s_a.model), best_single=best_a,
                   hist_single=t_single.history["train_loss"])
    dist.barrier()
    t_mesh = make(mesh, "mesh")
    s_b, best_b, _ = t_mesh.train_eval(lambda: iter(batches),
                                       lambda: iter(batches))
    fresh = tt.create_train_state(_wavenet(inputs),
                                  tt.make_optimizer(1e-2, optimizer="sgd"))
    restored = t_mesh.ckpt.load_best(fresh)
    out.update(mesh=_params(s_b.model), best_mesh=best_b,
               hist_mesh=t_mesh.history["train_loss"],
               restored=_params(restored.model),
               written=t_mesh.ckpt.write)
    return out


def _diffeeg(inputs):
    """DiffEEGTrainer(mesh, decorrelate_shards=False) on a batch tiled
    over the data axis against the single-device trainer."""
    def cfg(bs):
        return C.DiffEEGConfig(n_channels=2, input_length=64,
                               hidden_channels=4, n_diffusion_steps=6,
                               gradient_accumulate_every=2, batch_size=bs,
                               stft_n_fft=16, stft_noverlap=8)

    def model():
        m = tm.DiffEEG(n_channels=2, hidden=4)
        m.load_state_dict({k: _t(v) for k, v in inputs["diffeeg"].items()})
        return m

    mesh = parallel.make_mesh(C.MeshConfig(data=2, model=4, seq=1))
    single = tt.DiffEEGTrainer(model(), cfg(2), seed=0)
    dp = tt.DiffEEGTrainer(model(), cfg(4), seed=0, mesh=mesh,
                           decorrelate_shards=False)
    x, y = _t(inputs["de_x"]), _t(inputs["de_y"])
    xt, yt = torch.cat([x, x], 1), torch.cat([y, y], 1)
    for _ in range(2):
        la = single.train_step(x, y)["loss"]
        lb = dp.train_step(xt, yt)["loss"]
    dec = tt.DiffEEGTrainer(model(), cfg(4), seed=0, mesh=mesh)
    ld = dec.train_step(xt, yt)["loss"]
    return {"loss_single": float(la), "loss_dp": float(lb),
            "single": _params(single.model), "dp": _params(dp.model),
            "ema_single": single.state.ema, "ema_dp": dp.state.ema,
            "loss_decorrelated": float(ld)}


def _tp_mlp(inputs):
    mesh = parallel.make_mesh(C.MeshConfig(data=1, model=8, seq=1))
    g = mesh.get_group("model")
    i = mesh_lib.axis_index(mesh, "model")
    x = _t(inputs["tp_x"]).requires_grad_(True)
    k1, b1, k2, b2 = (_t(inputs[k]) for k in ("tp_k1", "tp_b1", "tp_k2",
                                              "tp_b2"))
    k1s = tp.shard_kernel_columns(k1, i, 8).clone().requires_grad_(True)
    b1s = b1[i * 16:(i + 1) * 16].clone().requires_grad_(True)
    k2s = tp.shard_kernel_rows(k2, i, 8).clone().requires_grad_(True)
    out = tp.tp_mlp(x, k1s, b1s, k2s, b2, group=g)
    gx, gk1 = torch.autograd.grad(out.square().sum(), (x, k1s))
    xr = _t(inputs["tp_x"]).requires_grad_(True)
    k1r = k1.clone().requires_grad_(True)
    ref = tp.tp_mlp(xr, k1r, b1, k2, b2)
    rx, rk1 = torch.autograd.grad(ref.square().sum(), (xr, k1r))
    return {"out": out, "gx": gx, "gk1": gk1,
            "gk1_ref": tp.shard_kernel_columns(rk1, i, 8), "gx_ref": rx}


def _full_params(local, mesh):
    """TP shards gathered over ``model`` into full parameters."""
    g = mesh.get_group("model")
    n = mesh_lib.axis_size(mesh, "model")
    out = dict(local)
    for k, dim in (("k1", 1), ("b1", 0), ("k2", 0)):
        parts = [torch.empty_like(local[k]) for _ in range(n)]
        dist.all_gather(parts, local[k].contiguous(), group=g)
        out[k] = torch.cat(parts, dim)
    return out


def _dp_tp_sp(inputs):
    """One DP × TP × SP step on (2, 2, 2) and the same step unsharded."""
    mesh = parallel.make_mesh(C.MeshConfig(data=2, model=2, seq=2))
    enc = parallel.LongEEGEncoder(n_channels=2, patch=4, d_model=8, depth=1,
                                  n_heads=2)
    params = {k: _t(v) for k, v in inputs["dts_params"].items()}
    x, y = inputs["dts_x"], inputs["dts_y"]
    local, xs, ys = dryrun.place_inputs(mesh, params, x, y)
    new, loss = dryrun.make_dp_tp_sp_train_step(mesh, enc, lr=1e-2)(
        local, xs, ys)
    # the unsharded gradients: the same program with no groups
    ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    pooled = torch.func.functional_call(
        enc, {k[4:]: v for k, v in ps.items() if k.startswith("enc.")},
        (_t(x),))
    logits = tp.tp_mlp(pooled, ps["k1"], ps["b1"], ps["k2"], ps["b2"])
    ref_loss = -(torch.log_softmax(logits, -1) * _t(y)).sum(-1).mean()
    grads = dict(zip(ps, torch.autograd.grad(ref_loss, list(ps.values()))))
    ref_new = {k: params[k] - 1e-2 * grads[k] for k in params}
    return {"new": _full_params(new, mesh), "loss": float(loss),
            "ref_new": ref_new, "ref_loss": float(ref_loss)}


def _shardings(inputs):
    mesh = parallel.make_mesh(C.MeshConfig(data=2, model=2, seq=2))
    eeg = tm.EEGNetAttentionRegularized(samples=128, kern_length=8)
    state = tt.create_train_state(eeg, tt.make_optimizer(1e-3))
    sh = parallel.train.state_shardings(mesh, state)
    wn = parallel.param_shardings(mesh, _wavenet(inputs))
    return {"dense1": repr(sh["dense1.weight"]),
            "conv1": repr(sh["conv1.weight"]),
            "running_mean": repr(sh["batchnorm1.running_mean"]),
            "wavenet_output_0": repr(wn["output.0.weight"]),
            "wavenet_output_2": repr(wn["output.2.weight"]),
            "path": mesh_lib.flax_path(
                "wave_module.0.gated_tcns.1.gate.filters.2.weight", 3),
            "batch": repr(parallel.batch_sharding(mesh, 3)),
            "batch_seq": repr(parallel.batch_sharding(mesh, 3, seq_axis=2))}


def _dryrun(_):
    return entry.dryrun_multichip(8, device="cpu")


PARALLEL_CASES = [("mesh_shapes", _mesh_shapes), ("dp_step", _dp_step),
                  ("replay", _replay), ("nan_sentinel", _nan_sentinel),
                  ("trainer", _trainer), ("diffeeg", _diffeeg),
                  ("tp_mlp", _tp_mlp), ("dp_tp_sp", _dp_tp_sp),
                  ("shardings", _shardings), ("dryrun", _dryrun)]


def parallel_world(dev, inputs):
    return _run(PARALLEL_CASES, inputs, {"rank": dist.get_rank()})


# --- test_torch_seqparallel -------------------------------------------------

def _seq_mesh():
    return parallel.make_mesh(C.MeshConfig(data=1, model=1, seq=8))


def _halo(inputs):
    mesh = _seq_mesh()
    g = mesh.get_group("seq")
    s = mesh_lib.axis_index(mesh, "seq")
    x, k = _t(inputs["halo_x"]), _t(inputs["halo_k"])
    tl = x.shape[1] // 8
    xl = x[:, s * tl:(s + 1) * tl].clone().requires_grad_(True)
    kl = k.clone().requires_grad_(True)
    y = parallel.halo_conv1d(xl, kl, g)
    w = torch.linspace(-1, 1, y.numel()).view_as(y)
    gx, gk = torch.autograd.grad((y * w).sum(), (xl, kl))
    dist.all_reduce(gk, group=g)          # each part's share of dL/dk
    xr = x.clone().requires_grad_(True)
    kr = k.clone().requires_grad_(True)
    yr = parallel.halo_conv1d(xr, kr, None)
    wr = torch.cat([w] * 8, dim=1)
    grx, grk = torch.autograd.grad((yr * wr).sum(), (xr, kr))
    parts = [torch.empty_like(y) for _ in range(8)]
    dist.all_gather(parts, y.detach(), group=g)
    gxs = [torch.empty_like(gx) for _ in range(8)]
    dist.all_gather(gxs, gx, group=g)
    return {"y": torch.cat(parts, 1), "y_ref": yr, "gx": torch.cat(gxs, 1),
            "gx_ref": grx, "gk": gk, "gk_ref": grk}


def _attention(inputs):
    mesh = _seq_mesh()
    g = mesh.get_group("seq")
    s = mesh_lib.axis_index(mesh, "seq")
    q, k, v = (_t(inputs[n]) for n in ("att_q", "att_k", "att_v"))
    ll = q.shape[1] // 8
    loc = [t[:, s * ll:(s + 1) * ll].clone().requires_grad_(True)
           for t in (q, k, v)]
    out, w = parallel.sequence_parallel_attention(*loc, 4, g,
                                                  return_weights=True)
    grads = torch.autograd.grad(out.square().sum(), loc)
    full = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = seqparallel._local_attention(*full, 4)
    ref_grads = torch.autograd.grad(ref.square().sum(), full)
    gather = lambda t: torch.cat([*_all(t, g)], 1)
    return {"out": gather(out.detach()), "ref": ref,
            "weights_shape": tuple(w.shape),
            "grads": [gather(t) for t in grads], "ref_grads": list(ref_grads)}


def _all(t, g):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, t.contiguous(), group=g)
    return parts


def _encoder(inputs, key, **kw):
    enc = parallel.LongEEGEncoder(**kw)
    enc.load_state_dict(seqparallel.jax_params_to_state_dict(inputs[key]))
    return enc


def _long_eeg(inputs):
    mesh = _seq_mesh()
    enc = _encoder(inputs, "le_params", n_channels=4, patch=8, d_model=32,
                   depth=2, n_heads=4)
    x = _t(inputs["le_x"])
    with torch.no_grad():
        sp = parallel.long_eeg_forward(enc, None, x, mesh)
        local = enc.local_forward(x, None)
    return {"sp": sp, "local": local}


def _rollout(inputs):
    mesh = _seq_mesh()
    enc = _encoder(inputs, "ro_params", n_channels=2, patch=4, d_model=16,
                   depth=2, n_heads=2)
    x = _t(inputs["ro_x"])
    logits, roll = parallel.long_eeg_rollout(enc, None, x, mesh)
    with torch.no_grad():
        _, attn = enc.local_forward(x, None, return_attn=True)
    return {"logits": logits, "rollout": roll,
            "local": txai.attention_rollout(list(attn))}


SEQ_CASES = [("halo", _halo), ("attention", _attention),
             ("long_eeg", _long_eeg), ("rollout", _rollout)]


def seqparallel_world(dev, inputs):
    return _run(SEQ_CASES, inputs, {"rank": dist.get_rank()})


# --- test_torch_sharded_xai -------------------------------------------------

def _spec_model(inputs, fused):
    model = tm.SpectrogramCNN(fused_blocks=fused)
    model.load_state_dict({k: _t(v) for k, v in inputs["spec"].items()})
    return model.eval().requires_grad_(False)


def _sharded(inputs):
    mesh = parallel.make_mesh(C.MeshConfig(data=8, model=1, seq=1))
    out = {}
    x, bg = _t(inputs["x"]), _t(inputs["bg"])
    for fused in (0, 2):
        fwd = _spec_model(inputs, fused)
        tgt = _t(inputs["tgt"])
        r = {"ig": txai.sharded_integrated_gradients(mesh, fwd, x, None, tgt,
                                                     steps=16),
             "ig_ref": txai.integrated_gradients(fwd, x, None, tgt,
                                                 steps=16)}
        g = torch.Generator().manual_seed(1)
        r["eg"] = txai.sharded_expected_gradients(mesh, fwd, x, bg, g, tgt,
                                                  nsamples=4)
        r["eg_ref"] = txai.expected_gradients(
            fwd, x, bg, torch.Generator().manual_seed(1), tgt, nsamples=4)
        r["shap"] = txai.sharded_gradient_shap_values(
            mesh, fwd, x, bg, torch.Generator().manual_seed(1), nsamples=4)
        r["shap_ref"] = txai.gradient_shap_values(
            fwd, x, bg, torch.Generator().manual_seed(1), nsamples=4)
        out[f"fused{fused}"] = r
    try:
        txai.sharded_integrated_gradients(mesh, fwd, x[:6], steps=2)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def sharded_xai_world(dev, inputs):
    return _run([("sharded", _sharded)], inputs, {"rank": dist.get_rank()})
