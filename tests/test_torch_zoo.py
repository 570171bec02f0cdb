"""The rest of the model zoo in the port against the JAX package's flax
models: ``build``/``REGISTRY``, every new model in eval mode on the same
weights (drawn with numpy in the flax models' shapes, BatchNorm statistics
off their defaults, carried with ``jax_variables_to_state_dict(arch=...)``), one
training-mode forward a family (BatchNorm on batch statistics), the ViT
and B0 loaded from a torchvision-layout state dict through the JAX
package's importers, and the ``BiLSTM`` forward/reverse mapping on a
sequence.  Bound: log-probs within rtol = atol = 2e-4, the bound of
``test_torch_models.py``."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu.models.layers import (
    BiLSTM as JBiLSTM)
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
    weights)

EEG = (2, 1, 37, 384)
SPEC = (2, 3, 64, 48)
VIT = dict(image_size=(64, 48), dim=64, depth=2, n_heads=4, mlp_dim=128)
#: name → (keyword arguments of both models, input shape)
CASES = {
    "eegnet": (dict(samples=384), EEG),
    "eegnet_attention_deep": (dict(samples=384), EEG),
    "eegnet_residual": (dict(samples=384), EEG),
    "eegnet_residual_lstm": (dict(samples=384), EEG),
    "eegnet_transformer": (dict(samples=384, num_layers=2), EEG),
    "eeg_seizure_detection": (dict(samples=384), EEG),
    "deepconvnet": (dict(samples=1100), (2, 1, 37, 1100)),
    "efficientnet_b0": ({}, SPEC),
    "efficientnetv2_b2": ({}, SPEC),
    "spectrogram_vit": (VIT, SPEC),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small programs gain nothing from more,
    and beside other test processes more threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(jmodel, x, seed):
    """flax variables of ``jmodel`` for input ``x``, drawn with numpy from
    ``seed`` in the shapes of its ``init`` (``jax.eval_shape``: nothing is
    compiled): kernels and embeddings ~ N(0, 1/fan_in), biases ~ N(0,
    0.1²), scales ~ 1 + N(0, 0.1²), running means ~ N(0, 0.1²), variances
    ~ U(0.5, 1.5)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    return _moved(shapes, seed)


def _moved(variables, seed):
    """Every leaf of a flax variable tree (arrays or shapes) drawn anew as
    :func:`_variables` says."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
    out = {}
    for path, a in flat.items():
        shape = tuple(a.shape)
        if path[0] == "batch_stats":
            a = (rng.uniform(0.5, 1.5, shape) if path[-1] == "var"
                 else rng.standard_normal(shape) * 0.1)
        elif path[-1] == "bias":
            a = rng.standard_normal(shape) * 0.1
        elif path[-1] == "scale":
            a = 1.0 + rng.standard_normal(shape) * 0.1
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            if len(shape) == 3 and path[-2] == "out":       # (H, D_h, D)
                fan_in = shape[0] * shape[1]
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        out[path] = np.asarray(a, np.float32)
    v = flax.traverse_util.unflatten_dict(out)
    return {k: v[k] for k in ("params", "batch_stats") if k in v}


def _pair(name, seed=0, **extra):
    """(flax model, its moved variables, the port's model with the same
    weights in eval mode, input)."""
    kw, shape = CASES[name]
    kw = {**kw, **extra}
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jmodel = jm.build(name, **kw)
    v = _variables(jmodel, x, seed)
    port = tm.build(name, **kw)
    port.load_state_dict(tm.jax_variables_to_state_dict(v, arch=name))
    return jmodel, v, port.eval(), x


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_build_knows_every_jax_name():
    assert sorted(tm.REGISTRY) == sorted(jm.REGISTRY)
    with pytest.raises(KeyError) as got:
        tm.build("nope")
    with pytest.raises(KeyError) as want:
        jm.build("nope")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(tm.REGISTRY))
def test_build_constructs(name):
    kw = {"deepconvnet": {"samples": 1100},
          "eeg_seizure_detection": {"samples": 384}}.get(name, {})
    model = tm.build(name, **kw)
    assert isinstance(model, torch.nn.Module)
    assert type(model).__name__ == type(jm.build(name, **kw)).__name__
    # flax's BatchNorm statistics and seeded dropout draws: the port's own
    # modules, never torch's
    for m in model.modules():
        assert not isinstance(m, torch.nn.modules.batchnorm._BatchNorm), m
        assert not isinstance(m, torch.nn.Dropout) or isinstance(
            m, tm.Dropout), m


@pytest.mark.parametrize("name", sorted(CASES))
def test_zoo_matches_flax(name):
    jmodel, v, port, x = _pair(name)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jmodel.apply)(v, jnp.asarray(x)))
    assert got.shape == want.shape == (x.shape[0], 6)
    _close(got, want)


@pytest.mark.parametrize("name", ["eegnet_residual", "eeg_seizure_detection",
                                  "deepconvnet", "efficientnetv2_b2"])
def test_zoo_training_forward_matches_flax(name):
    """One training-mode forward (dropout off): the log-probs and the
    updated BatchNorm statistics against flax ``train=True``.  The
    EfficientNet's head dropout is fixed in both models, so there only the
    statistics are held."""
    extra = {} if name.startswith("efficientnet") else {"dropout_rate": 0.0}
    jmodel, v, port, x = _pair(name, seed=1, **extra)
    for m in port.modules():
        if isinstance(m, tm.Dropout):
            m.p = 0.0
    out, upd = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(v, jnp.asarray(x))
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x)).numpy()
    if not name.startswith("efficientnet"):
        _close(got, np.asarray(out))
    want = tm.jax_variables_to_state_dict(
        {"params": v["params"], "batch_stats": upd["batch_stats"]}, arch=name)
    sd = port.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_bilstm_cells_on_a_sequence():
    """flax ``BiLSTM``'s ``OptimizedLSTMCell_0`` is the forward cell and
    ``_1`` the reverse one (each direction's states in input order): held
    on L = 5, where a swapped mapping or a reversed output differs."""
    x = np.random.default_rng(3).standard_normal((2, 5, 3)).astype(np.float32)
    jmodel = JBiLSTM(4)
    v = _variables(jmodel, x, 3)
    sd = {}
    weights._bilstm(sd, "m", v["params"])
    port = tm.BiLSTM(3, 4)
    port.load_state_dict({k[2:]: torch.from_numpy(a) for k, a in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    swapped = {}
    weights._lstm(swapped, "m", v["params"]["OptimizedLSTMCell_1"])
    weights._lstm(swapped, "m", v["params"]["OptimizedLSTMCell_0"],
                  "_reverse")
    port.load_state_dict({k[2:]: torch.from_numpy(a)
                          for k, a in swapped.items()})
    with torch.no_grad():
        assert np.abs(port(torch.from_numpy(x)).numpy() - want).max() > 1e-2


@pytest.mark.parametrize("name", ["spectrogram_vit", "efficientnet_b0"])
def test_torchvision_layout_through_jax_importer(name):
    """A torchvision-layout state dict (the port's keys, the ViT's head
    renamed ``heads.head`` as torchvision names it) through the JAX
    package's importer: the flax model and the port loaded with the same
    dict agree, and exporting the flax parameters back gives the imported
    tensors bitwise."""
    kw, shape = CASES[name]
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    port = tm.build(name, **kw)
    sd = tm.seeded_state_dict(port, 5)
    jmodel = jm.build(name, **kw)
    v = _variables(jmodel, x, 5)
    if name == "spectrogram_vit":
        tv = {("heads." + k if k.startswith("head.") else k): t
              for k, t in sd.items()}
        v = {"params": jm.load_torch_vit_state_dict(tv, v["params"],
                                                    depth=VIT["depth"])}
        skipped = ("encoder.pos_embedding", "head.weight", "head.bias")
    else:
        v = jm.load_torch_efficientnet_state_dict(sd, v)
        v = {k: v[k] for k in ("params", "batch_stats")}
        skipped = ()
    back = tm.jax_variables_to_state_dict(v, arch=name)
    for k, t in sd.items():
        if k not in skipped:
            assert torch.equal(back[k], t), k
    port.load_state_dict(back)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(jax.jit(jmodel.apply)(v, jnp.asarray(x))))


def test_deepconvnet_short_window_raises():
    with pytest.raises(ValueError, match="needs ≥1021 time samples"):
        tm.DeepConvNet(samples=1020)
    with pytest.raises(ValueError, match="needs ≥1021 time samples"):
        tm.DeepConvNet(samples=1100)(torch.zeros(1, 1, 37, 600))


@pytest.mark.parametrize("kind", ["vit", "transformer"])
def test_encoder_layer_gelu_and_layernorm_eps(kind):
    """One encoder layer against flax's at 1e-5, on tokens of small spread
    (where LayerNorm's eps counts) and of large values (where the GELU's
    form counts): the ViT layer's tanh GELU and eps 1e-6, the transformer
    layer's eps 1e-5.  Torch's erf GELU or the other eps would miss."""
    from multimodal_brain_pattern_identification_xai_tpu.models import (
        layers as jl, vit as jv)
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.standard_normal((1, 5, 32)) * 3e-3,
                        rng.standard_normal((1, 5, 32)) * 4.0]
                       ).astype(np.float32)
    if kind == "vit":
        jmodel = jv.ViTEncoderLayer(32, 4, 64)
        port = tm.vit.ViTEncoderLayer(32, 4, 64)
        norms, attn, dense = (("ln_1", "ln_2"), "self_attention",
                              (("mlp_0", "mlp.0"), ("mlp_3", "mlp.3")))
    else:
        jmodel = jl.TransformerEncoderLayer(32, 4, dim_feedforward=64)
        port = tm.TransformerEncoderLayer(32, 4, dim_feedforward=64)
        norms, attn, dense = (("norm1", "norm2"), "self_attn",
                              (("linear1", "linear1"), ("linear2", "linear2")))
    p = _variables(jmodel, x, 6)["params"]
    sd = {}
    weights._mha(sd, attn, p[attn])
    for name in norms:
        weights._layer_norm(sd, name, p[name])
    for src, dst in dense:
        weights._dense(sd, dst, p[src])
    port.load_state_dict({k: torch.from_numpy(a) for k, a in sd.items()})
    port.eval()
    want = np.asarray(jmodel.apply({"params": p}, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_allclose(port(xt).numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        lns = [m for m in port.modules() if isinstance(m, torch.nn.LayerNorm)]
        gelus = [m for m in port.modules() if isinstance(m, torch.nn.GELU)]
        assert len(gelus) == (kind == "vit")
        for m in lns:
            m.eps = 1e-5 if kind == "vit" else 1e-6
        assert np.abs(port(xt).numpy() - want).max() > 1e-4
        for m in lns:
            m.eps = 1e-6 if kind == "vit" else 1e-5
        for m in gelus:
            m.approximate = "none"
            assert np.abs(port(xt).numpy() - want).max() > 1e-4

