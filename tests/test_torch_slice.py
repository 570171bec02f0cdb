"""The whole serving slice — raw EEG + raw spectrogram → log-probs — in
the PyTorch port (CPU: plain PyTorch versions, spectrogram blocks 1-2
through the fused block's plain version) against the JAX package's
``preprocess_multimodal`` + ``MultimodalModel``, for both EEG routes, at
the small configuration of ``__graft_entry__._dryrun_payload``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import config as JC
from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import ops as jops
from multimodal_brain_pattern_identification_xai_tpu_torch import config as TC
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
    build_model, capture_forward, make_forward)

SAMPLES, KERN = 512, 16

# Tolerance on log-probs: the two EEG chains are float32 cascades computed
# by different algorithms (block-parallel scan in XLA, sequential scan
# here), ~1e-4 apart in z-units, and the model parity alone is 2e-4
# (tests/test_torch_models.py); 1e-3 bounds both through the network.
ATOL = 1e-3


def _perturbed_variables(variables, seed):
    """flax init leaves BatchNorm at identity; move its statistics and
    affine so the weight mapping is exercised."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        name = jax.tree_util.keystr(path)
        if "var" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), leaf.dtype)
        if "mean" in name or "BatchNorm" in name or "bn" in name:
            return leaf + jnp.asarray(rng.standard_normal(leaf.shape) * 0.1,
                                      leaf.dtype)
        return leaf
    return {"params": jax.tree_util.tree_map_with_path(move,
                                                       variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                move, variables["batch_stats"])}


@pytest.mark.parametrize("assume_finite", [False, True])
def test_slice_matches_jax(assume_finite):
    rng = np.random.default_rng(0)
    raw_eeg = (rng.standard_normal((2, 20, 2000)) * 40).astype(np.float32)
    raw_spec = (rng.standard_normal((2, 64, 48)) * 5).astype(np.float32)
    if not assume_finite:
        raw_eeg[1, 7, 500:650] = np.nan
        raw_spec[0, 3, 10:14] = np.nan

    jsig = JC.SignalConfig(fixed_length=SAMPLES, image_size=(64, 48))
    mm = jm.MultimodalModel(
        eeg_model=jm.EEGNetAttentionRegularized(samples=SAMPLES,
                                                kern_length=KERN),
        spectrogram_model=jm.SpectrogramCNN())
    eeg_in, spec_in = jops.preprocess_multimodal(
        raw_eeg, raw_spec, signal=jsig, assume_finite=assume_finite)
    v = mm.init(jax.random.PRNGKey(0), eeg_in, spec_in)
    v = _perturbed_variables(v, 1)
    want = np.asarray(mm.apply(v, eeg_in, spec_in))

    model = build_model(samples=SAMPLES, kern_length=KERN)
    model.load_state_dict(tm.jax_variables_to_state_dict(v))
    forward = make_forward(
        model, signal=TC.SignalConfig(fixed_length=SAMPLES,
                                      image_size=(64, 48)),
        assume_finite=assume_finite)
    got = forward(torch.from_numpy(raw_eeg), torch.from_numpy(raw_spec))
    assert got.shape == (2, 6) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_capture_forward_returns_forward_on_cpu():
    """``capture_forward`` captures CUDA graphs only: on the CPU it hands
    back the eager forward itself."""
    forward = make_forward(build_model(samples=SAMPLES, kern_length=KERN),
                           signal=TC.SignalConfig(fixed_length=SAMPLES,
                                                  image_size=(64, 48)))
    args = (torch.zeros(1, 20, 2000), torch.zeros(1, 64, 48))
    assert capture_forward(forward, args) is forward
