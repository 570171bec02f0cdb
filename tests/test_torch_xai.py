"""Input-gradient XAI of the PyTorch port against the JAX package's
``xai`` on the CPU, on weights carried across with
``jax_variables_to_state_dict``: the port's ``seeded_state_dict`` (weights
~ N(0, 1/fan_in), non-trivial BatchNorm statistics, so the log-softmax is
not saturated and the gradients are not zero) loaded into flax with the
JAX package's ``torch_import`` and carried back.

The port's spectrogram model serves blocks 1-2 through the fused block
(its plain version and VJP on the CPU); the JAX side runs the unfused
model, whose gradients JAX's own tests pin equal to the fused model's
(tests/test_pallas_specblock.py) — Pallas interpret mode under vmapped
IG/EG would be slow.  Bound: rtol 1e-3, the JAX package's attribution
bound (tests/test_xai.py:229, 258, 304), with an absolute floor of 1e-5 of
the tensor's maximum for elements near zero (float32 sums in other
orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import xai as jxai
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch import xai as txai
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    cuda_specblock)

SAMPLES = 480
SPEC = (64, 48)


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * scale)


@pytest.fixture(scope="module")
def pair():
    """The multimodal model in both packages on one set of weights, and
    seeded inputs: EEG (2, 1, 37, 480), spectrograms (2, 3, 64, 48)."""
    port = tm.MultimodalModel(tm.EEGNetAttentionRegularized(samples=SAMPLES),
                              tm.SpectrogramCNN(fused_blocks=2))
    sd = tm.seeded_state_dict(port, seed=7)
    rng = np.random.default_rng(8)
    eeg = rng.standard_normal((2, 1, 37, SAMPLES)).astype(np.float32)
    spec = rng.standard_normal((2, 3) + SPEC).astype(np.float32)
    flax_m = jm.MultimodalModel(
        eeg_model=jm.EEGNetAttentionRegularized(samples=SAMPLES),
        spectrogram_model=jm.SpectrogramCNN())
    v = flax_m.init(jax.random.PRNGKey(0), jnp.asarray(eeg),
                    jnp.asarray(spec))
    v = jm.load_torch_multimodal_state_dict(sd, v)
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    port.load_state_dict(tm.jax_variables_to_state_dict(v))
    port.eval().requires_grad_(False)
    jfwd = {
        "multimodal": jax.jit(lambda e, s: flax_m.apply(v, e, s)),
        "eeg": jax.jit(lambda e: flax_m.apply(
            v, e, method=jm.MultimodalModel.forward_eeg)),
        "spec": jax.jit(lambda s: flax_m.apply(
            v, s, method=jm.MultimodalModel.forward_spectrogram)),
    }
    tfwd = {"multimodal": port, "eeg": port.forward_eeg,
            "spec": port.forward_spectrogram}
    return dict(v=v, port=port, jfwd=jfwd, tfwd=tfwd,
                x={"eeg": eeg, "spec": spec})


def _sub(v, name):
    return {"params": v["params"][name], "batch_stats": v["batch_stats"][name]}


@pytest.mark.parametrize("branch", ["eeg", "spec"])
def test_saliency_matches_jax(pair, branch):
    x = pair["x"][branch]
    want = jxai.saliency_maps(pair["jfwd"][branch], jnp.asarray(x))
    _close(txai.saliency_maps(pair["tfwd"][branch], torch.from_numpy(x)),
           want)


def test_saliency_signed_with_target(pair):
    x = pair["x"]["eeg"]
    tgt = np.array([3, 0])
    want = jxai.saliency_maps(pair["jfwd"]["eeg"], jnp.asarray(x),
                              target=jnp.asarray(tgt), absolute=False)
    got = txai.saliency_maps(pair["tfwd"]["eeg"], torch.from_numpy(x),
                             target=torch.from_numpy(tgt), absolute=False)
    assert float(got.min()) < 0
    _close(got, want)


def test_multimodal_saliency_matches_jax(pair):
    """Both inputs' gradients from one backward, through the fused
    spectrogram blocks (two fused-block backwards)."""
    e, s = pair["x"]["eeg"], pair["x"]["spec"]
    we, ws = jxai.multimodal_saliency(pair["jfwd"]["multimodal"],
                                      jnp.asarray(e), jnp.asarray(s))
    n0 = cuda_specblock.fused_specblock_convpool.backward_calls
    ge, gs = txai.multimodal_saliency(pair["port"], torch.from_numpy(e),
                                      torch.from_numpy(s))
    assert cuda_specblock.fused_specblock_convpool.backward_calls == n0 + 2
    _close(ge, we)
    _close(gs, ws)


@pytest.mark.parametrize("branch,chunk", [("eeg", None), ("eeg", 4),
                                          ("spec", None), ("spec", 2)])
def test_integrated_gradients_matches_jax(pair, branch, chunk):
    x = pair["x"][branch]
    want = jxai.integrated_gradients(pair["jfwd"][branch], jnp.asarray(x),
                                     steps=8, chunk=chunk)
    got = txai.integrated_gradients(pair["tfwd"][branch],
                                    torch.from_numpy(x), steps=8, chunk=chunk)
    _close(got, want)


def test_integrated_gradients_baseline_and_completeness(pair):
    """A non-zero baseline, and the completeness axiom on the port alone:
    Σ attr ≈ f(x) − f(x₀) (the JAX test's bound, tests/test_xai.py:58)."""
    x = torch.from_numpy(pair["x"]["eeg"])
    base = torch.full_like(x, 0.1)
    fwd = pair["tfwd"]["eeg"]
    tgt = torch.tensor([1, 4])
    want = jxai.integrated_gradients(pair["jfwd"]["eeg"], jnp.asarray(x),
                                     jnp.asarray(base), jnp.asarray(tgt),
                                     steps=8)
    got = txai.integrated_gradients(fwd, x, base, tgt, steps=64, chunk=16)
    _close(txai.integrated_gradients(fwd, x, base, tgt, steps=8), want)
    with torch.no_grad():
        gap = (fwd(x) - fwd(base)).gather(1, tgt[:, None])[:, 0]
    np.testing.assert_allclose(got.flatten(1).sum(1).numpy(), gap.numpy(),
                               rtol=0.05, atol=5e-3)


@pytest.mark.parametrize("fn", ["ig", "eg"])
def test_chunk_must_divide(pair, fn):
    x = torch.from_numpy(pair["x"]["eeg"])
    fwd = pair["tfwd"]["eeg"]
    with pytest.raises(ValueError, match="must divide"):
        if fn == "ig":
            txai.integrated_gradients(fwd, x, steps=8, chunk=3)
        else:
            txai.expected_gradients(fwd, x, x, torch.Generator(),
                                    torch.tensor([0, 1]), nsamples=8,
                                    chunk=3)


def _jax_draws(key, nsamples, batch, n_bg):
    """The draws ``expected_gradients`` makes from ``key``
    (xai/expected_gradients.py:45-49)."""
    kb, ka = jax.random.split(key)
    bg_idx = np.array(jax.random.randint(kb, (nsamples, batch), 0, n_bg))
    alphas = np.array(jax.random.uniform(ka, (nsamples, batch)))
    return torch.from_numpy(bg_idx).long(), torch.from_numpy(alphas)


@pytest.mark.parametrize("branch", ["eeg", "spec"])
def test_expected_gradients_matches_jax(pair, branch):
    """The same Monte-Carlo draws (replayed from ``jax.random``) on both
    sides; the port in chunks of 4, JAX in one batch.  A draw whose point
    puts a ReLU input or a max-pool pair within rounding of a tie gives
    gradients a discrete step apart (seen at 4e-3 of the map's maximum for
    one of eight draws with another background seed); these seeds have
    none."""
    x = pair["x"][branch]
    bg = np.random.default_rng(19).standard_normal(
        (5,) + x.shape[1:]).astype(np.float32)
    tgt = np.array([2, 5])
    key = jax.random.PRNGKey(3)
    want = jxai.expected_gradients(pair["jfwd"][branch], jnp.asarray(x),
                                   jnp.asarray(bg), key, jnp.asarray(tgt),
                                   nsamples=8)
    bg_idx, alphas = _jax_draws(key, 8, 2, 5)
    got = txai.expected_gradients_from_draws(
        pair["tfwd"][branch], torch.from_numpy(x), torch.from_numpy(bg),
        torch.from_numpy(tgt), bg_idx, alphas, chunk=4)
    _close(got, want)


def test_gradient_shap_values_matches_jax(pair):
    """Per-class expected gradients with each class's draws replayed from
    ``gradient_shap_values``'s split keys."""
    x = pair["x"]["eeg"]
    bg = np.random.default_rng(10).standard_normal(
        (4,) + x.shape[1:]).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jxai.gradient_shap_values(pair["jfwd"]["eeg"], jnp.asarray(x),
                                     jnp.asarray(bg), key, nsamples=4)
    keys = jax.random.split(key, 6)
    got = torch.stack([txai.expected_gradients_from_draws(
        pair["tfwd"]["eeg"], torch.from_numpy(x), torch.from_numpy(bg),
        torch.full((2,), c), *_jax_draws(keys[c], 4, 2, 4))
        for c in range(6)])
    _close(got, want)


def test_gradient_shap_values_takes_generator_draws(pair):
    """The port's ``gradient_shap_values`` is the per-class stack of
    expected gradients over draws taken from its generator in class
    order."""
    x = torch.from_numpy(pair["x"]["eeg"])
    bg = x.flip(0) * 0.5
    fwd = pair["tfwd"]["eeg"]
    got = txai.gradient_shap_values(fwd, x, bg, torch.Generator().manual_seed(5),
                                    nsamples=4, chunk=2)
    assert got.shape == (6,) + tuple(x.shape)
    gen = torch.Generator().manual_seed(5)
    for c in range(6):
        draws = txai.sample_draws(4, 2, 2, gen)
        want = txai.expected_gradients_from_draws(
            fwd, x, bg, torch.full((2,), c), *draws, chunk=2)
        torch.testing.assert_close(got[c], want, rtol=0, atol=0)


@pytest.mark.parametrize("branch,size", [("eeg", (4, 60)),
                                         ("spec", SPEC),
                                         ("spec", None)])
def test_grad_cam_matches_jax(pair, branch, size):
    """Grad-CAM on each branch's feature map, with the bilinear
    ``upsample_to`` (equal to ``jax.image.resize``)."""
    x = pair["x"][branch]
    name = "eeg_model" if branch == "eeg" else "spectrogram_model"
    jmodel = (jm.EEGNetAttentionRegularized(samples=SAMPLES)
              if branch == "eeg" else jm.SpectrogramCNN())
    want = jxai.grad_cam(jmodel, _sub(pair["v"], name), jnp.asarray(x),
                         upsample_to=size)
    got = txai.grad_cam(getattr(pair["port"], name), torch.from_numpy(x),
                        upsample_to=size)
    assert float(got.min()) >= 0 and float(got.max()) <= 1 + 1e-6
    _close(got, want)


def test_grad_cam_downsample_matches_jax_resize():
    """Shrinking a cam antialiases as ``jax.image.resize`` does."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.xai.gradcam \
        import _resize_bilinear
    cam = np.random.default_rng(11).random((2, 15, 12)).astype(np.float32)
    for size in [(7, 5), (30, 5), (8, 24)]:
        want = jax.image.resize(jnp.asarray(cam), (2,) + size, "bilinear")
        np.testing.assert_allclose(
            _resize_bilinear(torch.from_numpy(cam), size).numpy(),
            np.asarray(want), rtol=1e-5, atol=1e-6)


def test_explain_entry_cpu():
    """The attribution entry at full width (B=1): preprocessed inputs
    that autograd can use, a frozen eval model, and input gradients
    through both fused spectrogram blocks."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        explain_entry)
    model, (eeg, spec) = explain_entry(device="cpu", batch=1)
    assert eeg.shape == (1, 1, 37, 3000) and spec.shape == (1, 3, 400, 300)
    assert not model.training
    assert not any(p.requires_grad for p in model.parameters())
    assert not (eeg.is_inference() or spec.is_inference())
    n0 = cuda_specblock.fused_specblock_convpool.backward_calls
    ge, gs = txai.multimodal_saliency(model, eeg, spec)
    assert cuda_specblock.fused_specblock_convpool.backward_calls == n0 + 2
    for g, x in ((ge, eeg), (gs, spec)):
        assert g.shape == x.shape and bool(torch.isfinite(g).all())
        assert float(g.max()) > 0
