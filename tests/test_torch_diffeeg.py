"""The PyTorch port's DiffEEG denoisers against the JAX package's: the
live ``DiffEEG`` and ``DiffEEGLegacy`` loaded from the reference-layout
state dicts of ``tests/torch_ref.py`` (JAX through
``load_torch_diffeeg_state_dict`` / ``..._legacy_state_dict``), the
conditioning upsampler's gather plan, gathered against dense
conditioning, the flax → state-dict export, the bf16 (amp) forward, the
same-class mixup and the small helpers.  Small shapes (C ≤ 6, T ≤ 500,
hidden ≤ 16); bounds at each test."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu.models import (
    diffeeg as jdiff)
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
    diffeeg as tdiff)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ref import make_torch_diffeeg, make_torch_diffeeg_legacy  # noqa: E402

#: the JAX package's import-parity bound (tests/test_diffusion.py:188,389)
PARITY = 2e-4
#: bf16 against float32 and against JAX's bf16 module, relative to the
#: output's max |value|: the JAX package's bf16 bound
#: (tests/test_models.py:176-186)
BF16_REL = 2e-2


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inputs(rng, c, t_len, f_s, ts, t_max=50):
    x = rng.standard_normal((2, c, t_len)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 2)]
    t = rng.integers(0, t_max, 2).astype(np.float32)
    spec = rng.standard_normal((2, c, f_s, ts)).astype(np.float32)
    return x, y, t, spec


def _jax_apply(jmod, sd, loader, args, dtype=None):
    v = jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))
    p = loader(sd, v)["params"]
    mod = jmod if dtype is None else jmod.clone(dtype=dtype)
    return np.asarray(mod.apply({"params": p}, *map(jnp.asarray, args))), p


@pytest.mark.parametrize("legacy", [False, True], ids=["diffeeg", "legacy"])
def test_denoiser_matches_torch_reference_and_jax(legacy):
    """The port, loaded with the reference state dict, against the
    reference torch forward and against JAX at rtol = atol = 2e-4."""
    rng = np.random.default_rng(0)
    if legacy:
        c, h, f_s, ts = 3, 16, 1, 25
        args = _inputs(rng, c, (4 * f_s - 3) * (4 * ts - 3), f_s, ts)
        sd, ref = make_torch_diffeeg_legacy(seed=3, n_channels=c, hidden=h)
        model = tm.DiffEEGLegacy(n_channels=c, hidden=h)
        want, _ = _jax_apply(jm.DiffEEGLegacy(n_channels=c, hidden=h), sd,
                             jm.load_torch_diffeeg_legacy_state_dict, args)
    else:
        c, h = 4, 16
        args = _inputs(rng, c, 128, 9, 20)
        sd, ref = make_torch_diffeeg(seed=1, n_channels=c, hidden=h)
        model = tm.DiffEEG(n_channels=c, hidden=h)
        want, _ = _jax_apply(jm.DiffEEG(n_channels=c, hidden=h), sd,
                             jm.load_torch_diffeeg_state_dict, args)
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model.eval()(*map(_t, args)).numpy()
        np.testing.assert_allclose(got, ref(*map(_t, args)).numpy(),
                                   rtol=PARITY, atol=PARITY)
    np.testing.assert_allclose(got, want, rtol=PARITY, atol=PARITY)


def test_legacy_shape_contract_raises():
    """(4·4−3)² = 169 ≠ 64: ``ValueError`` as in JAX."""
    model = tm.DiffEEGLegacy(n_channels=2, hidden=8)
    with pytest.raises(ValueError, match="shape contract"):
        model(torch.zeros(1, 2, 64), torch.eye(6)[:1], torch.zeros(1),
              torch.zeros(1, 2, 4, 4))


@pytest.mark.parametrize("c,t_len,f_s,ts", [(4, 256, 17, 9), (6, 500, 33, 63)])
def test_gather_plan_matches_jax(c, t_len, f_s, ts):
    """The plan probed from torch's ``conv_transpose2d`` (padding (1, 2),
    the kernel as torch stores it) equals JAX's, probed from
    ``lax.conv_transpose`` (padding ((1, 1), (0, 0)), the kernel flipped):
    the same gather indices and masks with the taps in reverse order, the
    same lerp weights."""
    got = tdiff._gather_plan(f_s, ts, t_len, (3, 3), (1, 8), (1, 2))
    want = jdiff._gather_plan(f_s, ts, t_len, (3, 3), (1, 8),
                              ((1, 1), (0, 0)))
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a[::-1] if i < 4 else a, b)


@pytest.mark.parametrize("c,t_len,f_s,ts", [(4, 256, 17, 9), (6, 500, 33, 63)])
def test_gathered_conditioning_matches_dense_and_jax(c, t_len, f_s, ts):
    """Gathered against dense conditioning (the whole ConvTranspose plane)
    within atol 3e-3, the JAX package's bound (``tests/test_diffusion.py:
    223-241``), and against JAX's gathered conditioning within 2e-4."""
    rng = np.random.default_rng(c)
    model = tm.DiffEEG(n_channels=c, hidden=8)
    model.load_state_dict(tm.seeded_state_dict(model, c))
    y = np.eye(6, dtype=np.float32)[[1, 4]]
    spec = rng.standard_normal((2, c, f_s, ts)).astype(np.float32)
    with torch.no_grad():
        got = model.conditioning(_t(y), _t(spec), t_len)
        dense = model.conditioning_dense(_t(y), _t(spec), t_len)
    assert got.shape == (2, 8, t_len)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=3e-3)
    jmod = jm.DiffEEG(n_channels=c, hidden=8)
    v = jmod.init(jax.random.PRNGKey(0), jnp.zeros((2, c, t_len)),
                  jnp.asarray(y), jnp.zeros((2,)), jnp.asarray(spec))
    v = {"params": jm.load_torch_diffeeg_state_dict(
        {k: t.numpy() for k, t in model.state_dict().items()}, v)["params"]}
    want = jmod.apply(v, jnp.asarray(y), jnp.asarray(spec), t_len,
                      method=jdiff.DiffEEG.conditioning)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1),
                               rtol=PARITY, atol=PARITY)


@pytest.mark.parametrize("legacy", [False, True], ids=["diffeeg", "legacy"])
def test_flax_export_round_trip(legacy):
    """flax-initialised variables → ``jax_variables_to_state_dict`` → the
    port gives JAX's output within 2e-4; the reference state dict → flax →
    the export is the state dict again, exactly."""
    rng = np.random.default_rng(2)
    if legacy:
        c, h = 3, 16
        args = _inputs(rng, c, 97, 1, 25)
        jmod, model = (jm.DiffEEGLegacy(n_channels=c, hidden=h),
                       tm.DiffEEGLegacy(n_channels=c, hidden=h))
        sd, _ = make_torch_diffeeg_legacy(seed=4, n_channels=c, hidden=h)
        loader = jm.load_torch_diffeeg_legacy_state_dict
    else:
        c, h = 4, 8
        args = _inputs(rng, c, 64, 9, 16)
        jmod, model = (jm.DiffEEG(n_channels=c, hidden=h),
                       tm.DiffEEG(n_channels=c, hidden=h))
        sd, _ = make_torch_diffeeg(seed=4, n_channels=c, hidden=h)
        loader = jm.load_torch_diffeeg_state_dict
    v = jmod.init(jax.random.PRNGKey(7), *map(jnp.asarray, args))
    model.load_state_dict(tm.jax_variables_to_state_dict(v))
    with torch.no_grad():
        got = model.eval()(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(
        v, *map(jnp.asarray, args))), rtol=PARITY, atol=PARITY)
    back = tm.jax_variables_to_state_dict(loader(sd, v))
    assert set(back) == set(sd)
    for k, t in sd.items():
        assert torch.equal(back[k], t), k


def test_amp_forward_matches_jax_bf16():
    """``dtype=torch.bfloat16`` (the JAX package's ``amp``): float32
    parameters and output; every dense and conv layer but the last returns
    bfloat16, the GroupNorms and ``final_projection.3`` float32; the output
    within 2e-2 of its max |value| of the float32 forward and of JAX's bf16
    module on the same weights, and further than 1e-4 of it from the
    float32 forward (a model that kept float32 would sit at 0)."""
    rng = np.random.default_rng(3)
    c, h = 4, 16
    args = _inputs(rng, c, 128, 9, 20)
    sd, _ = make_torch_diffeeg(seed=1, n_channels=c, hidden=h)
    want, _ = _jax_apply(jm.DiffEEG(n_channels=c, hidden=h), sd,
                         jm.load_torch_diffeeg_state_dict, args,
                         dtype=jnp.bfloat16)
    f32 = tm.DiffEEG(n_channels=c, hidden=h).eval()
    amp = tm.DiffEEG(n_channels=c, hidden=h, dtype=torch.bfloat16).eval()
    f32.load_state_dict(sd)
    amp.load_state_dict(sd)
    assert all(p.dtype == torch.float32 for p in amp.parameters())
    layers = (tdiff.Linear, tdiff.Conv1d, tdiff.GroupNorm1)
    seen, mods = {}, {n: m for n, m in amp.named_modules()
                      if isinstance(m, layers)}
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: seen.__setitem__(n, o.dtype))
        for n, m in mods.items()]
    with torch.no_grad():
        got, ref = amp(*map(_t, args)), f32(*map(_t, args))
    for hk in hooks:
        hk.remove()
    f32_layers = {n for n, m in mods.items()
                  if isinstance(m, tdiff.GroupNorm1)} | {"final_projection.3"}
    assert set(seen) == set(mods) and "final_projection.3" in seen
    for n, dt in seen.items():
        assert dt == (torch.float32 if n in f32_layers else torch.bfloat16), n
    assert got.dtype == torch.float32
    scale = float(ref.abs().max())
    assert 1e-4 * scale < float((got - ref).abs().max()) < BF16_REL * scale
    assert np.abs(got.numpy() - want).max() < BF16_REL * scale


def test_recombine_spectrograms_matches_jax():
    """Same-class mixup on JAX's uniform scores equals JAX's within 1e-7
    (single-member classes mix with themselves)."""
    rng = np.random.default_rng(4)
    spec = rng.standard_normal((9, 2, 3, 5)).astype(np.float32)
    labels = np.array([0, 2, 0, 1, 2, 0, 5, 2, 0])
    key = jax.random.PRNGKey(9)
    want = jdiff.recombine_spectrograms(key, jnp.asarray(spec),
                                        jnp.asarray(labels))
    scores = _t(jax.random.uniform(key, (9,)))
    got = tdiff.recombine_spectrograms(scores, _t(spec), _t(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    np.testing.assert_allclose(got[6].numpy(), spec[6])


@pytest.mark.parametrize("L,T", [(37, 160), (5000, 128), (128, 128)])
def test_linear_interpolate_time_matches_torch_and_jax(L, T):
    """``linear_interpolate_time`` (last axis) equals ``F.interpolate(
    mode='linear', align_corners=False)`` within rtol = atol = 1e-5 (the
    JAX package's bound and shapes, ``tests/test_diffusion.py:143-158``)
    and JAX's (middle axis) within the same bound: JAX places the taps in
    float32, the port in float64 as both gather plans do."""
    s = np.random.default_rng(L).standard_normal((2, 3, L)).astype(np.float32)
    got = tdiff.linear_interpolate_time(_t(s), T)
    np.testing.assert_allclose(got.numpy(), F.interpolate(
        _t(s), size=T, mode="linear", align_corners=False).numpy(),
        rtol=1e-5, atol=1e-5)
    want = jdiff.linear_interpolate_time(jnp.asarray(s.transpose(0, 2, 1)), T)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-5)


def test_embedding_and_cached_denoiser():
    """``sinusoidal_embedding`` equals JAX's within 1e-6; a cached
    denoiser equals the forward."""
    rng = np.random.default_rng(5)
    t = np.array([0.0, 7.0, 999.0], np.float32)
    np.testing.assert_allclose(
        tdiff.sinusoidal_embedding(_t(t), 16).numpy(),
        np.asarray(jdiff.sinusoidal_embedding(jnp.asarray(t), 16)), atol=1e-6)
    model = tm.DiffEEG(n_channels=2, hidden=8).eval()
    x, y, tt, spec = map(_t, _inputs(rng, 2, 64, 9, 64))
    den = tm.make_cached_denoiser(model, y, spec, 64)
    with torch.no_grad():
        torch.testing.assert_close(den(x, None, tt, None),
                                   model(x, y, tt, spec))


def test_sanity_check_autoencoder_matches_jax():
    """``DiffEEGSanityCheck`` with JAX's initial weights (Dense kernels
    transposed) gives JAX's output within 1e-5."""
    jmod = jdiff.DiffEEGSanityCheck(input_dim=20, hidden=8)
    x = np.random.default_rng(6).standard_normal((3, 4, 5)).astype(np.float32)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    model = tm.DiffEEGSanityCheck(input_dim=20, hidden=8)
    model.load_state_dict({
        f"{n}.{k}": _t(np.asarray(p[src]).T.copy() if k == "weight"
                       else np.asarray(p[src]))
        for n, p in v["params"].items()
        for k, src in (("weight", "kernel"), ("bias", "bias"))})
    with torch.no_grad():
        got = model(_t(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jmod.apply(
        v, jnp.asarray(x))), atol=1e-5)
