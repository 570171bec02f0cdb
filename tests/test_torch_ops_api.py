"""The rest of the JAX package's public API in the port, against the JAX
package on the same numpy inputs: the montage, NaN-repair and z-score
options, ``dummy_eeg_dataset``, ``native_available``,
``make_train_step(nan_sentinel=False)``, the eight ``load_torch_*``
importers (a reference-layout state dict through JAX's importer and the
port's, logits compared) and the model constructors' options.

Bounds: bitwise where both sides do the same float32 operations in the
same order, else 1e-6; the importers at the JAX package's own bounds
(tests/test_aux_components.py: rtol = atol = 2e-4, EfficientNet 5e-4).
"""

import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import config as jc
from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import train as jt
from multimodal_brain_pattern_identification_xai_tpu.data.dummy import (
    dummy_eeg_dataset as jax_dummy_eeg_dataset)
from multimodal_brain_pattern_identification_xai_tpu.models import (
    layers as jlayers)
from multimodal_brain_pattern_identification_xai_tpu.ops import (
    montage as jmont, nanfix as jnan, normalize as jnorm)

from multimodal_brain_pattern_identification_xai_tpu_torch import _build
from multimodal_brain_pattern_identification_xai_tpu_torch import data as tdata
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch import runtime
from multimodal_brain_pattern_identification_xai_tpu_torch import train as tt
from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
    layers as tlayers, weights)
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    montage as tmont, nanfix as tnan, normalize as tnorm)
from multimodal_brain_pattern_identification_xai_tpu_torch.runtime import (
    loader as tloader)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402

IMPORT_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small programs gain nothing from more,
    and beside other test processes more threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eeg(seed, shape=(2, 3, 20, 64)):
    return (np.random.default_rng(seed).standard_normal(shape) * 30
            ).astype(np.float32)


# --- montage, NaN repair, z-score -------------------------------------------

def test_apply_montage_takes_the_matrix():
    """JAX's signature ``apply_montage(x, matrix)``: the double-banana
    matrix (±1 entries: bitwise), a montage of a few pairs keeping some
    channels, and a dense float matrix (1e-6), each on x's dtype."""
    x = _eeg(0)
    cases = [jmont.montage_matrix(jc.MAP_FEATURES),
             jmont.montage_matrix(jc.MAP_FEATURES[:5],
                                  keep_channels=jc.EEG_FEATURES[:4]),
             np.random.default_rng(1).standard_normal((7, 20)).astype(
                 np.float32)]
    for i, m in enumerate(cases):
        want = np.asarray(jmont.apply_montage(jnp.asarray(x), m))
        got = tmont.apply_montage(torch.from_numpy(x), m)
        assert got.dtype == torch.float32 and got.shape == want.shape
        if i < 2:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
        got64 = tmont.apply_montage(torch.from_numpy(x).double(),
                                    torch.as_tensor(m))
        assert got64.dtype == torch.float64


def test_bipolar_differential_options_match_jax():
    x = _eeg(2)
    np.testing.assert_array_equal(
        tmont.bipolar_differential(torch.from_numpy(x)).numpy(),
        np.asarray(jmont.bipolar_differential(jnp.asarray(x))))
    cols = jc.EEG_COLUMNS[::-1]
    pairs = (("Fp1", "O2"), ("C3", "Cz"), ("EKG", "Fz"))
    np.testing.assert_array_equal(
        tmont.bipolar_differential(torch.from_numpy(x), columns=cols,
                                   pairs=pairs).numpy(),
        np.asarray(jmont.bipolar_differential(jnp.asarray(x), columns=cols,
                                              pairs=pairs)))


def test_select_and_map_channels_options_match_jax():
    x = _eeg(3, (2, 38, 16))
    np.testing.assert_array_equal(
        tmont.select_and_map_channels(torch.from_numpy(x)).numpy(),
        np.asarray(jmont.select_and_map_channels(jnp.asarray(x))))
    kw = dict(columns=jc.EEG_COLUMNS, features=("Cz", "Fp1", "O2"),
              n_pairs=4)
    x = x[:, :24]
    np.testing.assert_array_equal(
        tmont.select_and_map_channels(torch.from_numpy(x), **kw).numpy(),
        np.asarray(jmont.select_and_map_channels(jnp.asarray(x), **kw)))


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_nan_to_channel_mean_axis_matches_jax(axis):
    """NaNs scattered and one all-NaN lane along ``axis``: 1e-6."""
    x = _eeg(4, (5, 6, 40))
    x[1, 2, 3] = x[0, 0, 7] = x[4, 5, 39] = np.nan
    idx = [slice(None)] * 3
    idx[axis] = slice(None)
    other = [d for d in range(3) if d != axis % 3]
    idx[other[0]], idx[other[1]] = 2, 1
    x[tuple(idx)] = np.nan
    want = np.asarray(jnan.nan_to_channel_mean(jnp.asarray(x), axis=axis))
    got = tnan.nan_to_channel_mean(torch.from_numpy(x), axis=axis).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 30)


@pytest.mark.parametrize("axis,eps", [(-1, 1e-6), (0, 1e-6), (1, 1e-2)])
def test_zscore_axis_and_eps_match_jax(axis, eps):
    x = _eeg(5, (4, 9, 50)) + 7.0
    want = np.asarray(jnorm.zscore(jnp.asarray(x), axis=axis, eps=eps))
    got = tnorm.zscore(torch.from_numpy(x), axis=axis, eps=eps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# --- small helpers -----------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(n_per_class=3, n_channels=4,
                                         length=50, n_classes=2)])
def test_dummy_eeg_dataset_bitwise(kw):
    want = jax_dummy_eeg_dataset(np.random.default_rng(9), **kw)
    got = tdata.dummy_eeg_dataset(np.random.default_rng(9), **kw)
    assert sorted(got) == sorted(want) == ["x", "y"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_native_available(tmp_path, monkeypatch):
    """True where the host library builds here; False, not an exception,
    when no g++ is found and nothing is built."""
    assert runtime.native_available() is True
    tloader._lib.cache_clear()
    try:
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        assert runtime.native_available() is False
    finally:
        monkeypatch.undo()
        tloader._lib.cache_clear()
    assert runtime.native_available() is True


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def test_train_step_without_sentinel_matches_jax():
    """``make_train_step(nan_sentinel=False)`` on a batch with a NaN target
    (finite activations, non-finite loss), as JAX's: the update is applied,
    so the same parameters turn NaN on both sides, the BatchNorm running
    statistics take the batch's (1e-5), ``nonfinite`` is set and the step
    advances; with the sentinel (the default) the port keeps them."""
    rng = np.random.default_rng(0)
    S, K = 128, 16
    x = rng.standard_normal((4, 1, 37, S)).astype(np.float32)
    y = rng.random((4, 6)).astype(np.float32)
    y /= y.sum(1, keepdims=True)
    y[1, 2] = np.nan
    jmodel = jm.EEGNetAttentionRegularized(samples=S, kern_length=K)
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x[:2]))
    js = jt.TrainState.create(apply_fn=jmodel.apply, params=v["params"],
                              tx=jt.state.make_optimizer(1e-3),
                              batch_stats=v["batch_stats"])
    with fnn.intercept_methods(_no_dropout):
        js, mj = jt.make_train_step(nan_sentinel=False)(
            js, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
            jax.random.PRNGKey(1))
    want = tm.jax_variables_to_state_dict(
        {"params": js.params, "batch_stats": js.batch_stats})

    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    for sentinel in (False, True):
        m = tm.EEGNetAttentionRegularized(samples=S, kern_length=K)
        m.load_state_dict(tm.jax_variables_to_state_dict(v))
        for d in m.modules():
            if isinstance(d, tm.Dropout):
                d.p = 0.0
        ts = tt.create_train_state(m, tt.make_optimizer(1e-3))
        before = {k: t.clone() for k, t in m.state_dict().items()}
        ts, mt = tt.make_train_step(nan_sentinel=sentinel)(ts, batch)
        assert bool(mt["nonfinite"]) and bool(mj["nonfinite"])
        assert ts.step == 1
        got = m.state_dict()
        for k, w in want.items():
            g = got[k]
            if not sentinel:
                if "running" in k:
                    np.testing.assert_allclose(g.numpy(), w.numpy(),
                                               rtol=1e-5, atol=1e-6)
                else:
                    np.testing.assert_array_equal(torch.isnan(g).numpy(),
                                                  torch.isnan(w).numpy())
            else:
                assert torch.equal(g, before[k]), k
        if not sentinel:
            assert any(torch.isnan(got[k]).any() for k in want)


# --- the reference-checkpoint importers --------------------------------------

def _init(jmodel, *args, seed=0):
    """flax variables of ``jmodel`` drawn with numpy in the shapes of its
    ``init`` (``jax.eval_shape``: nothing is compiled): N(0, 0.1²), running
    variances U(0.5, 1.5); ``params`` and ``batch_stats`` only (flax's
    zero ``perturbations`` stay out)."""
    shapes = _bn_vars(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                     *map(jnp.asarray, args)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _logits(jmodel, jv, port, args, jit=True):
    apply = jax.jit(jmodel.apply) if jit else jmodel.apply
    want = np.asarray(apply(jv, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = port.eval()(*map(torch.from_numpy, args)).numpy()
    return got, want


def _bn_vars(v):
    return {k: v[k] for k in ("params", "batch_stats") if k in v}


@pytest.mark.parametrize("name", ["eegnet", "eegnet_attention", "speccnn",
                                  "multimodal"])
def test_reference_importers_match_jax(name):
    """A reference-layout state dict (``tests/torch_ref.py``, with
    BatchNorm's ``num_batches_tracked`` as a reference checkpoint has it)
    through JAX's importer and the port's: the same log-probs, and both
    those of the reference forward."""
    rng = np.random.default_rng(1)
    eeg = rng.standard_normal((2, 1, 37, 480)).astype(np.float32)
    spec = rng.standard_normal((2, 3, 64, 48)).astype(np.float32)
    if name == "eegnet":
        sd, ref = torch_ref.make_torch_eegnet(seed=0, samples=480)
        jmodel, port, args = jm.EEGNet(samples=480), tm.EEGNet(
            samples=480), (eeg,)
        jl, tl = jm.load_torch_eegnet_state_dict, \
            tm.load_torch_eegnet_state_dict
    elif name == "eegnet_attention":
        sd, ref = torch_ref.make_torch_eegnet_attention(seed=3, samples=480)
        jmodel = jm.EEGNetAttentionRegularized(samples=480)
        port, args = tm.EEGNetAttentionRegularized(samples=480), (eeg,)
        jl, tl = jm.load_torch_eegnet_attention_state_dict, \
            tm.load_torch_eegnet_attention_state_dict
    elif name == "speccnn":
        sd, ref = torch_ref.make_torch_speccnn(seed=4)
        jmodel, port, args = jm.SpectrogramCNN(), tm.SpectrogramCNN(), (spec,)
        jl, tl = jm.load_torch_speccnn_state_dict, \
            tm.load_torch_speccnn_state_dict
    else:
        sd, ref = torch_ref.make_torch_multimodal(seed=5, samples=480)
        jmodel = jm.MultimodalModel(
            eeg_model=jm.EEGNetAttentionRegularized(samples=480),
            spectrogram_model=jm.SpectrogramCNN())
        port = tm.MultimodalModel(tm.EEGNetAttentionRegularized(samples=480),
                                  tm.SpectrogramCNN())
        args = (eeg, spec)
        jl, tl = jm.load_torch_multimodal_state_dict, \
            tm.load_torch_multimodal_state_dict
    sd = dict(sd)
    for k in [k for k in sd if k.endswith("running_mean")]:
        sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(7)
    jv = _bn_vars(jl(sd, _init(jmodel, *args)))
    assert tl(sd, port) is port
    got, want = _logits(jmodel, jv, port, args)
    np.testing.assert_allclose(got, want, rtol=IMPORT_TOL, atol=IMPORT_TOL)
    with torch.no_grad():
        np.testing.assert_allclose(
            got, ref(*map(torch.from_numpy, args)).numpy(), rtol=IMPORT_TOL,
            atol=IMPORT_TOL)


@pytest.mark.parametrize("legacy", [False, True], ids=["diffeeg", "legacy"])
def test_diffeeg_importers_match_jax(legacy):
    rng = np.random.default_rng(2)
    if legacy:
        c, h, f_s, ts = 3, 16, 1, 25
        t_len = (4 * f_s - 3) * (4 * ts - 3)
        sd, _ = torch_ref.make_torch_diffeeg_legacy(seed=3, n_channels=c,
                                                    hidden=h)
        jmodel, port = jm.DiffEEGLegacy(n_channels=c, hidden=h), \
            tm.DiffEEGLegacy(n_channels=c, hidden=h)
        jl, tl = jm.load_torch_diffeeg_legacy_state_dict, \
            tm.load_torch_diffeeg_legacy_state_dict
    else:
        c, h, f_s, ts, t_len = 4, 16, 9, 20, 128
        sd, _ = torch_ref.make_torch_diffeeg(seed=1, n_channels=c, hidden=h)
        jmodel, port = jm.DiffEEG(n_channels=c, hidden=h), \
            tm.DiffEEG(n_channels=c, hidden=h)
        jl, tl = jm.load_torch_diffeeg_state_dict, \
            tm.load_torch_diffeeg_state_dict
    args = (rng.standard_normal((2, c, t_len)).astype(np.float32),
            np.eye(6, dtype=np.float32)[[1, 4]],
            np.asarray([3.0, 17.0], np.float32),
            rng.standard_normal((2, c, f_s, ts)).astype(np.float32))
    # the denoiser probes its upsampler's gather plan with numpy: no jit
    jv = {"params": jl(sd, jmodel.init(jax.random.PRNGKey(0),
                                       *map(jnp.asarray, args)))["params"]}
    tl(sd, port)
    got, want = _logits(jmodel, jv, port, args, jit=False)
    np.testing.assert_allclose(got, want, rtol=IMPORT_TOL, atol=IMPORT_TOL)


VIT = dict(image_size=(64, 48), dim=64, depth=2, n_heads=4, mlp_dim=128)


@pytest.mark.parametrize("name", ["spectrogram_vit", "efficientnet_b0"])
def test_torchvision_importers_match_jax(name):
    """A torchvision-layout state dict (the ViT's head as ``heads.head``,
    B0's classifier 1000 wide or the module's 6) through both importers.
    The ViT keeps its own positional embedding and head on both sides (set
    equal after the import); a 1000-way B0 classifier is not imported."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 64, 48)).astype(np.float32)
    kw = VIT if name == "spectrogram_vit" else {}
    jmodel, port = jm.build(name, **kw), tm.build(name, **kw)
    v = _init(jmodel, x)
    own = {k: t.clone() for k, t in port.state_dict().items()}
    sd = tm.seeded_state_dict(tm.build(name, **kw), 8)
    if name == "spectrogram_vit":
        sd = {("heads." + k if k.startswith("head.") else k): t
              for k, t in sd.items()}
        jv = {"params": jm.load_torch_vit_state_dict(
            sd, v["params"], depth=VIT["depth"])}
        tm.load_torch_vit_state_dict(sd, port, depth=VIT["depth"])
        kept = ("encoder.pos_embedding", "head.weight", "head.bias")
        for k in kept:
            assert torch.equal(port.state_dict()[k], own[k]), k
        mine = tm.jax_variables_to_state_dict(jv, arch=name)
        port.load_state_dict({**port.state_dict(),
                              **{k: mine[k] for k in kept}})
        with pytest.raises(ValueError):
            tm.load_torch_vit_state_dict(sd, port, depth=3)
        tol = IMPORT_TOL
    else:
        sd["classifier.1.weight"] = torch.randn(1000, 1280) * 0.01
        sd["classifier.1.bias"] = torch.zeros(1000)
        jv = _bn_vars(jm.load_torch_efficientnet_state_dict(sd, v))
        tm.load_torch_efficientnet_state_dict(sd, port)
        for k in ("classifier.1.weight", "classifier.1.bias"):
            assert torch.equal(port.state_dict()[k], own[k]), k
        mine = tm.jax_variables_to_state_dict(jv, arch=name)
        port.load_state_dict({**port.state_dict(),
                              **{k: mine[k] for k in ("classifier.1.weight",
                                                      "classifier.1.bias")}})
        tol = 5e-4
    got, want = _logits(jmodel, jv, port, (x,))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_importer_rejects_a_wrong_shape():
    sd, _ = torch_ref.make_torch_eegnet(seed=0, samples=480)
    with pytest.raises(ValueError):
        tm.load_torch_eegnet_state_dict(sd, tm.EEGNet(samples=480), f1=4)
    bad = dict(sd)
    bad["dense.weight"] = torch.zeros(6, 3)
    with pytest.raises(ValueError):
        tm.load_torch_eegnet_state_dict(bad, tm.EEGNet(samples=480))


# --- the models' constructor options ----------------------------------------

def test_speccnn_widths_pools_and_classes_match_jax():
    """``SpectrogramCNN(num_classes, widths, pools)`` and
    ``MultimodalModel(num_classes)`` against flax on the same weights."""
    rng = np.random.default_rng(7)
    spec = rng.standard_normal((2, 3, 32, 24)).astype(np.float32)
    eeg = rng.standard_normal((2, 1, 37, 128)).astype(np.float32)
    kw = dict(num_classes=3, widths=(4, 8, 12), pools=("avg", "max", "avg"))
    jmodel = jm.SpectrogramCNN(**kw)
    v = _init(jmodel, spec, seed=3)
    port = tm.SpectrogramCNN(**kw)
    port.load_state_dict(tm.jax_variables_to_state_dict(v))
    got, want = _logits(jmodel, v, port, (spec,))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=IMPORT_TOL, atol=IMPORT_TOL)

    jmm = jm.MultimodalModel(
        eeg_model=jm.EEGNetAttentionRegularized(samples=128, kern_length=16),
        spectrogram_model=jm.SpectrogramCNN(widths=(4, 8)), num_classes=4)
    v = _init(jmm, eeg, spec, seed=4)
    port = tm.MultimodalModel(
        tm.EEGNetAttentionRegularized(samples=128, kern_length=16),
        tm.SpectrogramCNN(widths=(4, 8)), num_classes=4)
    port.load_state_dict(tm.jax_variables_to_state_dict(v))
    got, want = _logits(jmm, v, port, (eeg, spec))
    assert got.shape == (2, 4)
    np.testing.assert_allclose(got, want, rtol=IMPORT_TOL, atol=IMPORT_TOL)


@pytest.mark.parametrize("pool_size", [(2, 2), (3, 3)])
def test_spectrogram_block_pool_size_matches_jax(pool_size):
    """One block with ``pool_size`` against flax's (the skip resized to the
    pooled plane), eval mode; ``dropout_p`` is carried to the dropout."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 12, 9)).astype(np.float32)
    jblock = jlayers.SpectrogramBlock(5, pool_type="max",
                                        pool_size=pool_size, dropout_p=0.3)
    x_nhwc = jnp.asarray(x).transpose(0, 2, 3, 1)
    v = jblock.init(jax.random.PRNGKey(5), x_nhwc)
    p, s = v["params"], v["batch_stats"]
    sd = {}
    for i in (1, 2, 3):
        sd[f"conv{i}.weight"] = weights._conv(p[f"conv{i}"]["kernel"])
        sd[f"conv{i}.bias"] = weights._np(p[f"conv{i}"]["bias"])
    weights._bn(sd, "bn", p["BatchNorm_0"], s["BatchNorm_0"])
    sd["conv1x1.weight"] = weights._conv(p["conv1x1"]["kernel"])
    sd["conv1x1.bias"] = weights._np(p["conv1x1"]["bias"])
    port = tlayers.SpectrogramBlock(3, 5, pool_type="max",
                                    pool_size=pool_size, dropout_p=0.3)
    assert port.dropout.p == 0.3
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(a))
                          for k, a in sd.items()})
    want = np.asarray(jblock.apply(v, x_nhwc)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=IMPORT_TOL, atol=IMPORT_TOL)


def test_mbconv_options():
    """``MBConv(se_ratio)`` sizes the squeeze-excite as flax does
    (max(1, int(inp · se_ratio))); ``drop_rate`` drops whole samples of
    the residual branch in training and nothing in eval."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
        efficientnet as teff)
    blk = teff.MBConv(16, 4, 16, 1, 3, se_ratio=0.5, drop_rate=0.5)
    assert blk.block[2].fc1.out_channels == 8
    x = torch.randn(64, 16, 5, 5)
    with torch.no_grad():
        blk.eval()
        branch = blk.block(x)
        torch.testing.assert_close(blk(x), branch + x, rtol=0, atol=0)
        blk.drop.train()
        torch.manual_seed(0)
        got = blk(x) - x
    dropped = got.flatten(1).abs().amax(1) == 0
    assert 0 < int(dropped.sum()) < 64
    kept = ~dropped
    torch.testing.assert_close(got[kept], branch[kept] * 2.0)
