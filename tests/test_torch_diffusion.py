"""The PyTorch port's diffusion engine against the JAX package's: the
STFT conditioner, the schedules, q-sample, both reverse samplers fed the
JAX package's own draws, the NaN freeze guard, the EMA, the generation
metrics, cached class generation and dataset rebalancing.

Small shapes: C ≤ 4, T ≤ 256, ≤ 20 diffusion steps.  The denoisers are
``DiffEEG`` on both sides with the weights of ``tests/torch_ref.py``'s
``make_torch_diffeeg`` (JAX through ``load_torch_diffeeg_state_dict``).
Bounds are stated at each test."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import diffusion as jd
from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import ops as jops
from multimodal_brain_pattern_identification_xai_tpu_torch import (
    diffusion as td)
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch import ops as tops

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ref import make_torch_diffeeg  # noqa: E402

C, H, T, B = 2, 8, 64, 3
STEPS = 20


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- the STFT conditioner ---------------------------------------------------


@pytest.mark.parametrize("shape,nperseg,noverlap", [
    ((2, 3, 2000), 64, 32), ((3, 4, 256), 32, 16), ((2, 2, 100), 16, 8)])
def test_stft_matches_jax(shape, nperseg, noverlap):
    """``stft`` (f, t equal; Zxx) and ``stft_log1p_interp`` within atol
    2e-6, the bound of the JAX package's STFT against scipy
    (``tests/test_ops_dsp.py:95-125``)."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    f, t, Z = jops.stft(x, nperseg=nperseg, noverlap=noverlap)
    f2, t2, Z2 = tops.stft(_t(x), nperseg=nperseg, noverlap=noverlap)
    np.testing.assert_array_equal(f, f2)
    np.testing.assert_array_equal(t, t2)
    np.testing.assert_allclose(Z2.numpy(), np.asarray(Z), atol=2e-6)
    want = np.asarray(jops.stft_log1p_interp(
        x, out_t=shape[-1], nperseg=nperseg, noverlap=noverlap))
    got = tops.stft_log1p_interp(_t(x), out_t=shape[-1], nperseg=nperseg,
                                  noverlap=noverlap).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6)


# --- schedules and the forward process --------------------------------------


def test_schedules_match_jax():
    """Both schedules equal; ``make_schedule``'s device tensors equal the
    JAX arrays (√β within one float32 rounding)."""
    np.testing.assert_array_equal(td.linear_beta_schedule(STEPS),
                                  jd.linear_beta_schedule(STEPS))
    for a, b in zip(td.cosine_alpha_schedule(STEPS),
                    jd.cosine_alpha_schedule(STEPS)):
        np.testing.assert_array_equal(a, b)
    got, want = td.make_schedule(STEPS), jd.make_schedule(STEPS)
    assert got.timesteps == got.num_timesteps == want.timesteps
    np.testing.assert_array_equal(got.alpha_bar.numpy(), want.alpha_bar)
    np.testing.assert_array_equal(got.beta.numpy(), want.beta)
    np.testing.assert_allclose(got.noise_scale.numpy(), want.noise_scale,
                               rtol=1.2e-7)


def test_q_sample_with_given_noise_matches_jax():
    """x_t from the JAX draw of ε within 1e-6; a generator draws ε of x0's
    shape and returns it."""
    sched_j, sched_t = jd.make_schedule(STEPS), td.make_schedule(STEPS)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, C, T)).astype(np.float32)
    t = np.array([0, 5, 13, 19])
    xt, noise = jd.q_sample(sched_j, jax.random.PRNGKey(3), jnp.asarray(x0),
                            jnp.asarray(t))
    got, eps = td.q_sample(sched_t, _t(noise), _t(x0), _t(t))
    assert torch.equal(eps, _t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(xt), atol=1e-6)
    got2, eps2 = td.q_sample(sched_t, torch.Generator().manual_seed(0),
                             _t(x0), _t(t))
    assert eps2.shape == x0.shape
    torch.testing.assert_close(
        got2, _t(x0) * sched_t.alpha_bar[_t(t)].sqrt()[:, None, None]
        + eps2 * (1 - sched_t.alpha_bar[_t(t)]).sqrt()[:, None, None])


# --- the reverse samplers ---------------------------------------------------


def jax_draws(key, shape, steps):
    """The draws of the JAX samplers (``process.py:49-55``): ``key,
    init_key = split(key)``, x_T from ``init_key``, then ``k, nk =
    split(k)`` a step, the noise from ``nk``."""
    key, init_key = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(init_key, shape))
    noise, k = [], key
    for _ in range(steps):
        k, nk = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(nk, shape)))
    return x0, noise


def port_draws(x0, noise):
    return _t(x0), lambda i: _t(noise[i])


@pytest.fixture(scope="module")
def denoisers():
    """(JAX module, variables, port model) from one torch state dict."""
    sd, _ = make_torch_diffeeg(seed=5, n_channels=C, hidden=H)
    jmod = jm.DiffEEG(n_channels=C, hidden=H)
    z = jnp.zeros
    v = jmod.init(jax.random.PRNGKey(0), z((1, C, T)), z((1, 6)), z((1,)),
                  z((1, C, 9, T)))
    v = {"params": jm.load_torch_diffeeg_state_dict(sd, v)["params"]}
    model = tm.DiffEEG(n_channels=C, hidden=H).eval()
    model.load_state_dict(sd)
    return jmod, v, model


@pytest.mark.parametrize("sampler", ["reverse_diffusion", "ddpm_sample"])
def test_samplers_match_jax_draws(denoisers, sampler):
    """20 reverse steps of ``DiffEEG`` fed the JAX sampler's own draws end
    within 1e-4 of the JAX sampler (float32 on both sides, the denoisers
    within ~5e-7 a call)."""
    jmod, v, model = denoisers
    rng = np.random.default_rng(1)
    y = np.eye(6, dtype=np.float32)[[0, 2, 5]]
    spec = rng.random((B, C, 9, T)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(getattr(jd, sampler)(
        jd.make_schedule(STEPS), lambda x, yy, t, s: jmod.apply(v, x, yy, t, s),
        key, B, jnp.asarray(y), jnp.asarray(spec), (C, T)))
    x0, noise = jax_draws(key, (B, C, T), STEPS)
    got = getattr(td, sampler)(td.make_schedule(STEPS), model,
                               port_draws(x0, noise), B, _t(y), _t(spec),
                               (C, T))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_nan_guard_freezes_a_step_and_goes_on():
    """A denoiser that returns NaN at t = 5: the guard keeps x for that
    step and the loop goes on (the JAX test's denoiser,
    ``tests/test_diffusion.py:64-75``), equal to the JAX sampler on its
    draws within 1e-6; without the guard the NaN reaches the output."""
    key = jax.random.PRNGKey(0)
    shape = (1, 2, 8)
    want = np.asarray(jd.reverse_diffusion(
        jd.make_schedule(10),
        lambda x, y, t, s: jnp.where(t[0] == 5, jnp.nan, 0.0) * x + 0.01,
        key, 1, jnp.zeros((1, 6)), jnp.zeros((1, 2, 9, 8)), (2, 8)))
    x0, noise = jax_draws(key, shape, 10)
    calls = []

    def bad(x, y, t, s):
        calls.append(t)
        return torch.where(t[0] == 5, float("nan"), 0.0) * x + 0.01

    args = (1, torch.zeros((1, 6)), torch.zeros((1, 2, 9, 8)), (2, 8))
    got = td.reverse_diffusion(td.make_schedule(10), bad,
                               port_draws(x0, noise), *args)
    assert len(calls) == 10 and [int(t[0]) for t in calls] == list(
        range(9, -1, -1))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    off = td.reverse_diffusion(td.make_schedule(10), bad,
                               port_draws(x0, noise), *args, nan_guard=False)
    assert torch.isnan(off).all()


# --- EMA --------------------------------------------------------------------


def test_ema_matches_jax_over_30_steps():
    """Reset while step < 5, a blend every 3rd step after, kept otherwise:
    the port's EMA of the flat parameter vector equal to the JAX EMA of
    the same parameters as a pytree, flattened, within 1e-6 over 30 steps
    of random parameters."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal(4).astype(np.float32),
          "b": rng.standard_normal((2, 3)).astype(np.float32)}

    def flat(p):
        return np.concatenate([p[k].ravel() for k in sorted(p)])
    je = jd.EMA.create({k: jnp.asarray(v) for k, v in p0.items()}, 0.9, 5, 3)
    te = td.EMA.create(_t(flat(p0)), 0.9, 5, 3)
    for step in range(1, 31):
        p = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p0.items()}
        je = jd.ema_update(je, {k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(step))
        te = td.ema_update(te, _t(flat(p)), step)
        np.testing.assert_allclose(te.params.numpy(), flat(
            {k: np.asarray(v) for k, v in je.params.items()}), atol=1e-6)


# --- metrics ----------------------------------------------------------------


@pytest.mark.parametrize("n,m,d", [(40, 30, 16), (12, 10, 600)],
                         ids=["dense", "nuclear-norm"])
def test_metrics_match_jax(n, m, d):
    """MMD and Pearson (on m pairs) within 1e-5; the Fréchet distance within 1e-4
    relative on both branches (d = 16: the dense ``eigh`` square root;
    d = 600 > 512 and > 4(n+m): the nuclear-norm identity)."""
    rng = np.random.default_rng(d)
    a = rng.standard_normal((n, 2, d // 2)).astype(np.float32)
    b = (0.8 * rng.standard_normal((m, 2, d // 2)) + 0.3).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(float(td.compute_mmd(_t(a), _t(b), 4.0)),
                               float(jd.compute_mmd(ja, jb, 4.0)), atol=1e-5)
    np.testing.assert_allclose(
        float(td.pearson_correlation(_t(a[:m]), _t(b))),
        float(jd.pearson_correlation(ja[:m], jb)), atol=1e-5)
    np.testing.assert_allclose(
        float(td.compute_frechet_distance(_t(a), _t(b))),
        float(jd.compute_frechet_distance(ja, jb)), rtol=1e-4)


# --- generation and rebalancing ---------------------------------------------


def test_generate_for_class_cached_matches_jax(denoisers):
    """Class 3 from the zeros (50, 50) prior, 20 steps, the JAX draws
    injected: within 1e-4 of JAX's ``generate_for_class_cached``; the
    uncached ``generate_for_class`` gives the same windows within 1e-5."""
    jmod, v, model = denoisers
    key = jax.random.PRNGKey(4)
    kw = dict(n_channels=C, length=T, n_classes=6)
    want = jd.generate_for_class_cached(jd.make_schedule(STEPS), jmod, v,
                                        key, 3, 2, **kw)
    draws = port_draws(*jax_draws(key, (2, C, T), STEPS))
    sched = td.make_schedule(STEPS)
    got = td.generate_for_class_cached(sched, model, draws, 3, 2, **kw)
    assert isinstance(got, np.ndarray) and got.shape == (2, C, T)
    np.testing.assert_allclose(got, want, atol=1e-4)
    plain = td.generate_for_class(sched, model, draws, 3, 2, **kw)
    np.testing.assert_allclose(plain, got, atol=1e-5)


@pytest.mark.parametrize("soft,groups", [(True, True), (False, False)])
def test_augment_dataset_balanced_matches_jax(soft, groups):
    """Equal to the JAX function's output, synthetic group ids from
    100,000."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((13, 2, 5)).astype(np.float32)
    hard = np.array([0] * 6 + [1] * 3 + [2] * 2 + [4] * 2)
    y = (np.eye(5, dtype=np.float32)[hard] * 0.7 + 0.06) if soft else hard
    gen = {c: rng.standard_normal((4, 2, 5)).astype(np.float32)
           for c in (1, 2, 3)}
    g = np.arange(13, dtype=np.int64) * 7 if groups else None
    want = jd.augment_dataset_balanced(x, y, gen, seed=3, groups=g)
    got = td.augment_dataset_balanced(x, y, gen, seed=3, groups=g)
    assert len(got) == len(want) == (3 if groups else 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if groups:
        assert got[2].max() >= 100_000
