"""The port's sharded attribution (``_torch/xai/sharded.py``) against the
JAX package's ``xai.sharded_*`` and against the port's unsharded
functions, on data=8.

One gloo world of 8 ranks (module scope) runs the cases
(``torch_parallel_cases.sharded_xai_world``): ``SpectrogramCNN`` on x
(8, 3, 32, 32), weights from the flax model's init, unfused and with
blocks 1-2 fused (their plain version and VJP on the CPU).  Bounds: rtol
1e-4, atol 1e-6 (tests/test_aux_components.py:587-608); the sharded
expected gradients and SHAP values take the unsharded functions' draws,
so they equal them to that bound too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_brain_pattern_identification_xai_tpu.config as JC
from multimodal_brain_pattern_identification_xai_tpu import (
    models as jm, parallel as jp, xai as jxai)
from multimodal_brain_pattern_identification_xai_tpu_torch import (
    models as tm)
from multimodal_brain_pattern_identification_xai_tpu_torch.parallel import (
    launch)

import torch_parallel_cases as cases


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(42)
    model = jm.SpectrogramCNN()
    x = rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]))
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    fwd = lambda xx: model.apply(variables, xx)
    tgt = np.asarray(jnp.argmax(fwd(jnp.asarray(x)), -1))
    mesh = jp.make_mesh(JC.MeshConfig(data=8, model=1, seq=1))
    ig = jxai.sharded_integrated_gradients(mesh, fwd, jnp.asarray(x), None,
                                           jnp.asarray(tgt), steps=16)
    bg = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    inputs = {"spec": {k: t.numpy() for k, t in
                       tm.jax_variables_to_state_dict(variables).items()},
              "x": x, "bg": bg, "tgt": tgt.astype(np.int64)}
    res = launch.spawn(cases.sharded_xai_world, 8, "cpu", (inputs,))
    return {"rank0": res[0]["sharded"], "ranks": res,
            "jax": {"ig": np.asarray(ig)}}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.fixture
def rank0(world):
    r = world["rank0"]
    assert "error" not in r, r.get("error")
    return r


@pytest.mark.parametrize("fused", [0, 2])
def test_sharded_integrated_gradients(rank0, world, fused):
    """IG with the samples over data=8 against the unsharded IG, and (both
    forwards the flax model's function) against JAX's sharded IG."""
    r = rank0[f"fused{fused}"]
    assert r["ig"].shape == (8, 3, 32, 32)
    _close(r["ig"], r["ig_ref"])
    _close(r["ig"], world["jax"]["ig"])


@pytest.mark.parametrize("fused", [0, 2])
def test_sharded_expected_gradients(rank0, fused):
    r = rank0[f"fused{fused}"]
    assert r["eg"].shape == (8, 3, 32, 32)
    _close(r["eg"], r["eg_ref"])


@pytest.mark.parametrize("fused", [0, 2])
def test_sharded_gradient_shap_values(rank0, fused):
    """(n_classes, B, ...) gathered over the ranks, each class's draws
    the unsharded function's."""
    r = rank0[f"fused{fused}"]
    assert r["shap"].shape == (6, 8, 3, 32, 32)
    _close(r["shap"], r["shap_ref"])


def test_every_rank_holds_the_whole_result(world, rank0):
    for res in world["ranks"][1:]:
        np.testing.assert_array_equal(res["sharded"]["fused2"]["shap"],
                                      rank0["fused2"]["shap"])


def test_indivisible_batch_raises(rank0):
    assert rank0["indivisible"] == "batch 6 does not divide over a data " \
                                   "axis of 8"
