"""The port's sequence parallelism (``_torch/parallel/seqparallel.py``:
halo convolution, sequence-parallel attention, the long-EEG encoder and
its attention rollout) against the JAX package's ``shard_map`` programs
on seq=8.

One gloo world of 8 ranks (module scope) runs every case
(``torch_parallel_cases.seqparallel_world``); the JAX side runs on the 8
virtual CPU devices of ``conftest.py`` on the same inputs, the encoders'
weights carried over with ``seqparallel.jax_params_to_state_dict``.
Bounds are the JAX package's tests' (tests/test_parallel.py:252-302,
tests/test_aux_components.py:572-584)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import multimodal_brain_pattern_identification_xai_tpu.config as JC
from multimodal_brain_pattern_identification_xai_tpu import parallel as jp
from multimodal_brain_pattern_identification_xai_tpu_torch.parallel import (
    launch, seqparallel)

import torch_parallel_cases as cases


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(42)
    mesh = jp.make_mesh(JC.MeshConfig(data=1, model=1, seq=8))
    halo_x = rng.standard_normal((2, 64, 3)).astype(np.float32)
    halo_k = (rng.standard_normal((5, 3, 4)) * 0.1).astype(np.float32)
    halo = shard_map(functools.partial(jp.halo_conv1d, axis_name="seq"),
                     mesh=mesh, in_specs=(P(None, "seq", None), P()),
                     out_specs=P(None, "seq", None), check_vma=False)
    q, k, v = (rng.standard_normal((2, 32, 16)).astype(np.float32)
               for _ in range(3))
    att = shard_map(functools.partial(jp.sequence_parallel_attention,
                                      n_heads=4, axis_name="seq"),
                    mesh=mesh, in_specs=(P(None, "seq", None),) * 3,
                    out_specs=P(None, "seq", None), check_vma=False)
    le_enc = jp.LongEEGEncoder(n_channels=4, patch=8, d_model=32, depth=2,
                               n_heads=4)
    le_params = le_enc.init(jax.random.PRNGKey(0))
    le_x = rng.standard_normal((2, 4, 8 * 64)).astype(np.float32)
    ro_enc = jp.LongEEGEncoder(n_channels=2, patch=4, d_model=16, depth=2,
                               n_heads=2)
    ro_params = ro_enc.init(jax.random.PRNGKey(0))
    ro_x = rng.standard_normal((2, 2, 4 * 8 * 8)).astype(np.float32)
    ro_logits, ro_roll = jp.long_eeg_rollout(ro_enc, ro_params,
                                             jnp.asarray(ro_x), mesh)
    jax_res = {
        "halo": np.asarray(halo(jnp.asarray(halo_x), jnp.asarray(halo_k))),
        "halo_global": np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(halo_x), jnp.asarray(halo_k), (1,), "SAME",
            dimension_numbers=("NHC", "HIO", "NHC"))),
        "attention": np.asarray(att(*(jnp.asarray(t) for t in (q, k, v)))),
        "le_sp": np.asarray(jp.long_eeg_forward(le_enc, le_params,
                                                jnp.asarray(le_x), mesh)),
        "le_local": np.asarray(le_enc.local_forward(
            le_params, jnp.asarray(le_x), axis_name=None)),
        "ro_logits": np.asarray(ro_logits), "ro_rollout": np.asarray(ro_roll),
    }
    inputs = {"halo_x": halo_x, "halo_k": halo_k, "att_q": q, "att_k": k,
              "att_v": v, "le_params": _np_tree(le_params), "le_x": le_x,
              "ro_params": _np_tree(ro_params), "ro_x": ro_x}
    res = launch.spawn(cases.seqparallel_world, 8, "cpu", (inputs,))
    return {"rank0": res[0], "ranks": res, "jax": jax_res}


def _case(world, name):
    r = world["rank0"][name]
    assert not (isinstance(r, dict) and "error" in r), r.get("error")
    return r


def test_converter_keeps_every_parameter():
    """The JAX encoder's pytree fills the port encoder's state dict
    exactly, layouts (in, out) unchanged."""
    enc = jp.LongEEGEncoder(n_channels=2, patch=4, d_model=8, depth=2,
                            n_heads=2)
    params = enc.init(jax.random.PRNGKey(3))
    sd = seqparallel.jax_params_to_state_dict(_np_tree(params))
    port = seqparallel.LongEEGEncoder(n_channels=2, patch=4, d_model=8,
                                      depth=2, n_heads=2)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    np.testing.assert_array_equal(port.layers[1].fc1.detach().numpy(),
                                  np.asarray(params["layers"][1]["fc1"]))
    np.testing.assert_array_equal(port.layers[0].ln2_scale.detach().numpy(),
                                  np.asarray(params["layers"][0]["ln2"][0]))


def test_halo_conv_matches_jax_and_global(world):
    """The halo convolution on seq=8 against the JAX ``shard_map`` program
    and the global 'SAME' convolution (1e-5); its input and kernel
    gradients (halo gradients sent back to their owners) against the
    single-device convolution's."""
    r = _case(world, "halo")
    np.testing.assert_allclose(r["y"], world["jax"]["halo"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(r["y"], world["jax"]["halo_global"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["y_ref"], world["jax"]["halo_global"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["gx"], r["gx_ref"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["gk"], r["gk_ref"], rtol=1e-5, atol=1e-6)


def test_seq_parallel_attention_exact(world):
    """Local queries against the gathered keys and values equal the
    whole-sequence attention (JAX's shard_map program and the port's
    local attention, 1e-5); the weights are (B, H, L_local, L); the
    reduce-scattered key and value gradients equal the local ones."""
    r = _case(world, "attention")
    np.testing.assert_allclose(r["out"], world["jax"]["attention"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["out"], r["ref"], rtol=1e-5, atol=1e-5)
    assert tuple(r["weights_shape"]) == (2, 4, 4, 32)
    for got, want in zip(r["grads"], r["ref_grads"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_long_eeg_seq_parallel_matches_local_and_jax(world):
    """The encoder split over seq=8 against its single-device forward and
    against the JAX package's (1e-4/1e-5, tests/test_parallel.py:271)."""
    r = _case(world, "long_eeg")
    assert r["sp"].shape == (2, 6)
    np.testing.assert_allclose(r["sp"], r["local"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r["sp"], world["jax"]["le_sp"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(r["local"], world["jax"]["le_local"],
                               rtol=1e-4, atol=1e-5)


def test_long_eeg_rollout(world):
    """Rollout over the weights gathered on seq=8: (B, L, L), rows summing
    to 1 (1e-4), equal to the single-device rollout and to JAX's."""
    r = _case(world, "rollout")
    L = 64
    assert r["logits"].shape == (2, 6)
    assert r["rollout"].shape == (2, L, L)
    np.testing.assert_allclose(r["rollout"].sum(-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(r["rollout"], r["local"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(r["rollout"], world["jax"]["ro_rollout"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r["logits"], world["jax"]["ro_logits"],
                               rtol=1e-4, atol=1e-5)
