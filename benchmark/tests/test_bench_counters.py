"""The operation and byte counters against hand counts and against
``torch.utils.flop_counter`` run over the plain reference (and the
program's serving EEG stem) at small shapes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.lib import counters, seeded
from benchmark.reference import branches, models
from conftest import BY_MODEL


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as m:
        fn()
    return float(m.get_total_flops())


def test_hand_counts():
    # SpectrogramCNN block 1 at 400x300: three 3x3 convs and the 1x1 skip
    cfg = BY_MODEL["speccnn"]
    b1 = branches.get("speccnn").blocks(cfg["spectrogram"], 400, 300)[0]
    assert b1[:4] == (400, 300, 3, 16)
    assert b1[4] == 2 * 400 * 300 * 9 * (3 * 16 + 2 * 16 * 16) + 2 * 200 * 150 * 3 * 16
    assert counters.spectrogram_branch(cfg, 400, 300) == pytest.approx(6.698e9, rel=1e-3)
    # #2: 11 sections, 9 operations a section a sample + 1 for the mean
    ops, nbytes = counters.iir(5120, 10000, 11)
    assert ops == 5120 * 10000 * 100 and nbytes == 4 * 5120 * (10000 + 2500)
    # #3, block 1 at B=256 in bf16
    ops, nbytes = counters.specblock(256, 400, 300, 3, 16)
    assert ops == 256 * 2 * 400 * 300 * 9 * (3 * 16 + 2 * 256)
    assert nbytes == 2 * (256 * (400 * 300 * 3 + 200 * 150 * 16)
                          + 9 * (3 * 16 + 2 * 256) + 48)
    assert counters.spectrogram_chain(400, 300) == 2 * 400 * 400 * 300 + 2 * 400 * 300 * 300


def test_least_seconds():
    f = {"bf16": 989e12, "f32": 67e12}
    assert counters.least_seconds(f, {"bf16": 989e12, "f32": 67e12}) == pytest.approx(2.0)


@pytest.fixture(scope="module")
def weights():
    gen = seeded.generator(3, torch.device("cpu"))
    return {m: seeded.weights(models.fusion_shapes(BY_MODEL[m]), gen,
                              torch.device("cpu"))
            for m in ("speccnn", "effnetv2_b2")}


@pytest.mark.parametrize("model,h,w", [("speccnn", 64, 48),
                                       ("effnetv2_b2", 96, 64)])
def test_spectrogram_branch_against_flop_counter(weights, model, h, w):
    x = torch.rand(1, 3, h, w)
    cfg = BY_MODEL[model]
    got = _counted(lambda: models.spectrogram_branch(weights[model], x, cfg))
    assert counters.spectrogram_branch(cfg, h, w) == pytest.approx(got, rel=1e-9)


def test_eegnet_canonical_against_flop_counter(weights):
    x = torch.randn(1, 1, 37, 3000)
    got = _counted(lambda: models.eegnet_attention(weights["speccnn"], x))
    assert counters.eegnet(reassociated=False) == pytest.approx(got, rel=1e-9)


def test_eegnet_serving_stem_against_flop_counter(weights):
    from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
        EEGNetAttentionRegularized)
    m = EEGNetAttentionRegularized().eval()
    m.load_state_dict({k[len("eeg_model."):]: v for k, v in
                       weights["speccnn"].items() if k.startswith("eeg_model.")})
    x = torch.randn(1, 1, 37, 3000)
    with torch.no_grad():
        got = _counted(lambda: m(x))
    assert counters.eegnet(reassociated=True) == pytest.approx(got, rel=1e-9)


def test_fusion_head_against_flop_counter(weights):
    a, b = torch.randn(1, 6), torch.randn(1, 6)
    got = _counted(lambda: models.fusion_head(weights["speccnn"], a, b))
    assert counters.fusion_head() == got
