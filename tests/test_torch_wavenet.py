"""The port's ``DilatedInceptionWaveNet`` against the JAX package's flax
model, with the flax weights carried across by
``jax_variables_to_state_dict``: the forward (rel 1e-5, TF32 off), the
``SAME`` padding of even kernels at dilations above 1, one Adam training
step (float64 on both sides, rel 1e-5), and Grad-CAM's map at the sown
``feature_map``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import train as jt
from multimodal_brain_pattern_identification_xai_tpu import xai as jxai
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch import train as tt
from multimodal_brain_pattern_identification_xai_tpu_torch import xai as txai
from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
    wavenet)

SMALL = dict(block_layers=(2, 1), block_dims=(8, 8))
L = 256


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small programs gain nothing from more,
    and beside other test processes more threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module", autouse=True)
def no_tf32():
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


@pytest.fixture(scope="module")
def pair():
    """(flax model, its variables, the port's model with them, x, y)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, L, 8)).astype(np.float32)
    y = rng.random((3, 6)).astype(np.float32)
    y /= y.sum(1, keepdims=True)
    model = jm.DilatedInceptionWaveNet(**SMALL)
    v = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    port = tm.DilatedInceptionWaveNet(**SMALL)
    port.load_state_dict(tm.jax_variables_to_state_dict(v))
    return model, v, port, x, y


def test_state_dict_keys_and_shapes(pair):
    _, v, port, _, _ = pair
    sd = tm.jax_variables_to_state_dict(v)
    assert set(sd) == set(port.state_dict())
    assert sd["wave_module.0.gated_tcns.1.gate.filters.2.weight"].shape == \
        (2, 8, 6)
    assert sd["output.0.weight"].shape == (64, 32)


def test_forward_matches_flax(pair):
    """Logits on (B, L, 8) and on ``{"x": ...}``, and the feature map
    (8·B, C, 1, L) against the sown ``feature_map`` (8·B, 1, L, C)."""
    model, v, port, x, _ = pair
    want, inter = model.apply(v, jnp.asarray(x), mutable=["intermediates"])
    feat_j = np.asarray(inter["intermediates"]["feature_map"][0])
    with torch.no_grad():
        t = torch.from_numpy(x)
        got = port(t)
        feat = port.features(t)
        assert torch.equal(port({"x": t}), got)
    assert got.shape == (3, 6) and feat.shape == (24, 8, 1, L)
    assert rel(got, want) < 1e-5
    assert rel(feat.numpy().transpose(0, 2, 3, 1), feat_j) < 1e-5


@pytest.mark.parametrize("k,d", [(6, 2), (2, 4), (7, 8), (3, 1)])
def test_same_padding_of_even_kernels(k, d):
    """One dilated inception branch of kernel ``k`` at dilation ``d``
    against flax's ``padding="SAME"``: ⌊d(k−1)/2⌋ zeros before the signal,
    the rest after."""
    rng = np.random.default_rng(k * 10 + d)
    x = rng.standard_normal((2, 1, 40, 4)).astype(np.float32)
    flax_mod = jm.wavenet.DilatedInception(8, kernel_sizes=(k,), dilation=d)
    v = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(flax_mod.apply(v, jnp.asarray(x)))[:, 0]   # (2, 40, 8)
    port = wavenet.DilatedInception(4, 8, kernel_sizes=(k,), dilation=d)
    p = v["params"][f"conv_k{k}"]
    with torch.no_grad():
        port.filters[0].weight.copy_(torch.tensor(
            np.asarray(p["kernel"])[0].transpose(2, 1, 0)))
        port.filters[0].bias.copy_(torch.tensor(np.asarray(p["bias"])))
        got = port(torch.from_numpy(x[:, 0].transpose(0, 2, 1)))
    assert rel(got.numpy().transpose(0, 2, 1), want) < 1e-5


def test_training_step_matches_jax(pair):
    """One ``make_train_step`` step (KLDiv on logits, Adam at 1e-3) on the
    carried weights against ``jax.value_and_grad`` + optax ``adam`` in
    float64: the loss and every parameter after the step within 1e-5."""
    model, v, port, x, y = pair
    port = tm.DilatedInceptionWaveNet(**SMALL).double()
    port.load_state_dict(tm.jax_variables_to_state_dict(v))
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     v["params"])
        x64, y64 = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
        tx = optax.adam(1e-3)

        @jax.jit
        def step(p):
            loss, g = jax.value_and_grad(lambda q: jt.kldiv_with_logits(
                model.apply({"params": q}, x64, True), y64))(p)
            upd, _ = tx.update(g, tx.init(p), p)
            return loss, optax.apply_updates(p, upd)
        loss_j, new = step(p64)
        new = jax.tree_util.tree_map(np.asarray, new)
    state = tt.create_train_state(port, tt.make_optimizer(1e-3))
    state, m = tt.make_train_step()(state, {
        "x": torch.from_numpy(x).double(), "y": torch.from_numpy(y).double()})
    assert float(m["loss"]) == pytest.approx(float(loss_j), rel=1e-5)
    want = tm.jax_variables_to_state_dict({"params": new})
    for name, p in port.named_parameters():
        assert rel(p.detach(), want[name]) < 1e-5, name


def test_grad_cam_matches_jax(pair):
    """``xai.grad_cam`` on the features / head split against the JAX
    package's sow-and-perturb Grad-CAM: (8·B, 1, L) maps, max-normalised,
    within 1e-5; the argmax targets and given ones."""
    model, v, port, x, _ = pair
    for target in (None, np.array([0, 5, 2])):
        want = np.asarray(jxai.grad_cam(
            model, v, jnp.asarray(x),
            target=None if target is None else jnp.asarray(target)))
        got = txai.grad_cam(port, torch.from_numpy(x), target=None if
                            target is None else torch.from_numpy(target))
        assert got.shape == want.shape == (24, 1, L)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5)
