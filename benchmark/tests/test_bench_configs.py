"""Every size and setting a configuration states is what the program and
the reference build: the port's model under the reference's names and
shapes, a changed width refused, the chains' settings read by both
sides, and a model that has no files of its own refused by name."""

import copy

import pytest
import torch

from benchmark import builders
from benchmark.lib import program, seeded
from benchmark.reference import branches, cells, models
from conftest import BY_MODEL, CONFIGS

CPU = torch.device("cpu")
PLANE = (64, 48)


def _built(cfg, prog):
    return builders.get(cfg["spectrogram"]["model"]).build(
        cfg, prog, program._dtype(prog["spec_model_dtype"]))


@pytest.mark.parametrize("name,prog", [(n, p) for n, c in CONFIGS.items()
                                       for p in c["programs"]])
def test_program_builds_the_stated_shapes(name, prog):
    cfg = CONFIGS[name]
    built = {k: tuple(v.shape) for k, v in
             _built(cfg, cfg["programs"][prog]).state_dict().items()}
    assert built == models.fusion_shapes(cfg)


@pytest.mark.parametrize("model,key,value", [
    ("speccnn", "widths", [16, 32, 48, 128, 256]),
    ("speccnn", "pools", ["avg", "avg", "max", "avg", "max"]),
    ("effnetv2_b2", "stage_widths", [16, 32, 56, 104, 120, 200])])
def test_a_changed_width_is_refused(model, key, value):
    cfg = copy.deepcopy(BY_MODEL[model])
    cfg["spectrogram"][key] = value
    prog = next(iter(cfg["programs"].values()))
    with pytest.raises(ValueError):
        shapes = models.fusion_shapes(cfg)
        program._model(cfg, prog, seeded.weights(
            shapes, seeded.generator(1, CPU), CPU), CPU)


def test_other_coefficients_build_other_widths_the_port_lacks():
    """EfficientNetV2-B0's widths (width and depth 1.0) are a valid
    configuration to the reference, and the port's B2 refuses them."""
    cfg = copy.deepcopy(BY_MODEL["effnetv2_b2"])
    cfg["spectrogram"].update(width_coefficient=1.0, depth_coefficient=1.0,
                              stem=32, head=1280,
                              stage_widths=[16, 32, 48, 96, 112, 192],
                              stage_depths=[1, 2, 2, 3, 5, 8])
    shapes = models.fusion_shapes(cfg)
    assert shapes["spectrogram_model.head_conv.weight"] == (1280, 192, 1, 1)
    with pytest.raises(RuntimeError):
        program._model(cfg, cfg["programs"]["score"], seeded.weights(
            shapes, seeded.generator(1, CPU), CPU), CPU)


def _band(cfg, band):
    cfg = copy.deepcopy(cfg)
    cfg["eeg"]["band_hz"] = band
    cfg["spectrogram"]["gaussian_sigma"] = 2.0
    return cfg


def test_make_forward_refuses_other_chains():
    cfg = _band(BY_MODEL["speccnn"], [1.0, 15.0])
    w = seeded.weights(models.fusion_shapes(cfg), seeded.generator(1, CPU), CPU)
    eeg, spec = seeded.windows(seeded.generator(2, CPU), CPU, 1, 2, 400, PLANE)
    with pytest.raises(ValueError):
        program.Scoring(cfg, cfg["programs"]["score"], w, CPU, PLANE,
                        (eeg[0], spec[0]))


def test_both_sides_read_the_chains_settings():
    """With another band and σ the composed program and the reference
    still agree, and both differ from the stated settings' answer."""
    base = BY_MODEL["effnetv2_b2"]
    prog = base["programs"]["score"]
    w = seeded.weights(models.fusion_shapes(base), seeded.generator(1, CPU), CPU)
    eeg, spec = seeded.windows(seeded.generator(2, CPU), CPU, 1, 2, 800, PLANE)
    out = {}
    for tag, cfg in (("stated", base), ("other", _band(base, [1.0, 15.0]))):
        run = program.Scoring(cfg, prog, w, CPU, PLANE, (eeg[0], spec[0]))
        out[tag] = (run.replay(eeg[0], spec[0]),
                    cells.score(cfg, prog, w, eeg[0], spec[0], PLANE))
    for got, ref in out.values():
        assert (got.exp() - ref.exp()).abs().max() < 2e-3
    assert (out["stated"][1] - out["other"][1]).abs().max() > 1e-3


@pytest.mark.parametrize("get", [branches.get, builders.get],
                         ids=["reference", "builder"])
@pytest.mark.parametrize("model", ["resnet50", "../lib/harness", ""])
def test_unknown_model_is_refused_by_name(get, model):
    with pytest.raises(ValueError, match="no "):
        get(model)
