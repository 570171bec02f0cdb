"""The plain reference agrees with the port at tiny sizes on the CPU
(float32): both preprocessing chains, both fused models, saliency and
integrated gradients."""

import numpy as np
import pytest
import torch

from benchmark.lib import seeded
from benchmark.reference import cells, models, preprocess, xai as rxai
from conftest import BY_MODEL
from multimodal_brain_pattern_identification_xai_tpu_torch import config, entry, xai
from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
    EEGNetAttentionRegularized, EfficientNetV2B2, MultimodalModel)
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    hms_eeg_preprocess, preprocess_multimodal)

CPU = torch.device("cpu")
PLANE = (64, 48)
SIGNAL = config.SignalConfig(image_size=PLANE)


def _setup(spec_model, seed=5, batch=3, n_points=800):
    gen = seeded.generator(seed, CPU)
    w = seeded.weights(models.fusion_shapes(BY_MODEL[spec_model]), gen, CPU)
    eeg, spec = seeded.windows(gen, CPU, 1, batch, n_points, PLANE)
    if spec_model == "speccnn":
        model = entry.build_model(fused_blocks=2)
    else:
        model = MultimodalModel(EEGNetAttentionRegularized(),
                                EfficientNetV2B2()).eval()
    model.load_state_dict(w, strict=True)
    return w, eeg[0], spec[0], model.requires_grad_(False)


def test_eeg_chain_matches_the_nan_route():
    _, eeg, _, _ = _setup("speccnn")
    ref = preprocess.eeg(eeg)
    port = hms_eeg_preprocess(eeg)                 # the literal NaN route
    assert (ref - port).abs().max() <= 1e-3 * ref.abs().max()


@pytest.mark.parametrize("spec_model", ["speccnn", "effnetv2_b2"])
def test_fused_forward(spec_model):
    w, eeg, spec, model = _setup(spec_model)
    with torch.no_grad():
        xe, xs = preprocess_multimodal(eeg, spec, signal=SIGNAL,
                                       assume_finite=True)
        cfg = BY_MODEL[spec_model]
        c = preprocess.chain(cfg)
        ref = models.fusion(w, preprocess.eeg(eeg, c=c),
                            preprocess.spectrogram(spec, PLANE, c=c), cfg)
        assert (model(xe, xs) - ref).abs().max() < 1e-4
        # the spectrogram branch alone, from the same plane
        assert (model.forward_spectrogram(xs)
                - models.spectrogram_branch(w, xs, cfg)).abs().max() < 1e-5


def test_score_cell_reference_runs_in_rows():
    w, eeg, spec, _ = _setup("speccnn")
    cfg = BY_MODEL["speccnn"]
    prog = dict.fromkeys(("eeg_input_dtype", "eeg_chain_dtype",
                          "eeg_model_dtype", "spec_chain_dtype",
                          "spec_model_dtype"), "float32")
    whole = cells.score(cfg, prog, w, eeg, spec, PLANE, rows=3)
    rows = cells.score(cfg, prog, w, eeg, spec, PLANE, rows=1)
    assert torch.allclose(whole, rows, atol=1e-6)


def test_attributions():
    w, eeg, spec, model = _setup("speccnn", batch=2)
    with torch.no_grad():
        xe, xs = preprocess_multimodal(eeg, spec, signal=SIGNAL,
                                       assume_finite=True)
        t = model(xe, xs).argmax(-1)
        te = model.forward_eeg(xe).argmax(-1)
    ge, gs = xai.multimodal_saliency(model, xe, xs, target=t)
    ig = xai.integrated_gradients(model.forward_eeg, xe, target=te, steps=8)

    def fused(e, s):
        return models.fusion(w, e, s, BY_MODEL["speccnn"])
    rge, rgs = rxai.saliency(fused, xe, xs, t)
    rig = rxai.integrated_gradients(lambda x: models.eegnet_attention(w, x),
                                    xe, te, steps=8, chunk=3)
    for a, r in ((ge, rge), (gs, rgs), (ig, rig)):
        assert (a - r).norm() <= 1e-4 * r.norm()


def test_stated_eeg_chain_errs_like_a_float32_recursion():
    """The stated precision's EEG chain runs its bandpasses as float32
    recursions: its error against the float64 chain is of the order of the
    port's float32 chain, where rounding float64 results is 100× below."""
    from benchmark.reference.precision import at
    _, eeg, _, _ = _setup("speccnn", n_points=4000)
    ref = preprocess.eeg(eeg)
    f32 = at("float32", False)

    def err(x):
        return float((x - ref).norm() / ref.norm())
    port = err(hms_eeg_preprocess(eeg, assume_finite=True))
    recursion = err(preprocess.eeg(eeg, f32, f32, recursion=np.float32))
    rounded = err(preprocess.eeg(eeg, f32, f32))
    assert port / 10 < recursion < port * 10
    assert rounded < port / 100
