"""The port's ``utils/`` and ``xai/shap_plots.py`` on the CPU: every plot
writes its image with matplotlib and returns None (with one logged
"plot skipped" line) without it; ``WandbLogger``'s JSONL records carry
the JAX package's keys; ``seed_everything`` seeds numpy and ``random``
as JAX's does; ``benchmark_fn`` returns JAX's keys; ``trace`` writes a
Chrome trace; ``model_summary`` lists the module tree."""

import json
import logging
import os
import random
import sys

import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import utils as jutils
from multimodal_brain_pattern_identification_xai_tpu_torch import utils
from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
    DiffEEGSanityCheck, SpectrogramCNN)
from multimodal_brain_pattern_identification_xai_tpu_torch.xai import (
    lime, shap_plots)

CLASSES = ("Seizure", "LPD", "GPD", "LRDA", "GRDA", "Other")
CHANNELS = [f"ch{i}" for i in range(5)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small programs gain nothing from more,
    and beside other test processes more threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plots(tmp):
    """(name, call) for every plot of ``utils`` and ``shap_plots``."""
    rng = np.random.default_rng(0)
    d = str(tmp)
    shap = rng.standard_normal((6, 2, 1, 5, 16))
    seg = lime.slic_segments(rng.random((20, 16)), 6)
    expl = {"segments": seg, "mask": seg < 2, "heatmap": rng.random((20, 16)),
            "label": 1}
    return [
        ("training_curves", lambda: utils.plot_training_curves(
            {"train_loss": [1.0, 0.5], "val_loss": [1.2, 0.7]}, d)),
        ("confusion_matrix", lambda: utils.plot_confusion_matrix(
            rng.integers(0, 5, (6, 6)), CLASSES, d)),
        ("class_distribution", lambda: utils.plot_class_distribution(
            rng.integers(0, 6, 30), rng.integers(0, 6, 40), CLASSES, d)),
        ("real_vs_generated", lambda: utils.plot_real_vs_generated(
            rng.standard_normal((1, 4, 64)), rng.standard_normal((1, 4, 64)),
            d)),
        ("lr_and_regularization", lambda: utils.plot_lr_and_regularization(
            [1e-3, 5e-4], [0.1, 0.05], d)),
        ("spectrogram_pair", lambda: utils.plot_spectrogram_pair(
            rng.random((20, 16)), rng.random((20, 16, 3)), d)),
        ("stft_comparison", lambda: utils.plot_stft_comparison(
            rng.standard_normal(256), rng.standard_normal(256), d,
            nperseg=32, noverlap=16)),
        ("saliency", lambda: utils.plot_saliency_heatmap(
            rng.random((5, 64)), d, channel_names=CHANNELS)),
        ("samples", lambda: utils.plot_sample_grid(rng.random((10, 8, 8)),
                                                   d)),
        ("model_summary", lambda: utils.model_summary(
            DiffEEGSanityCheck(64, 16), torch.zeros(2, 8, 8), save_dir=d)
            and None),
        ("lime_overlay", lambda: lime.plot_lime_overlay(
            rng.random((20, 16, 3)), expl, d)),
        ("shap_mean_bar", lambda: shap_plots.plot_mean_shap_values(
            shap, CHANNELS, d, class_names=CLASSES)),
        ("shap_mean_scatter", lambda: shap_plots.plot_mean_shap_values_scatter(
            shap, CHANNELS, d)),
        ("shap_summary", lambda: shap_plots.plot_shap_summary(
            shap[0], rng.standard_normal((2, 1, 5, 16)), CHANNELS, d)),
    ]


@pytest.mark.parametrize("i", range(14))
def test_plot_writes_with_matplotlib_and_skips_without(tmp_path, monkeypatch,
                                                       caplog, i):
    name, call = _plots(tmp_path / "with")[i]
    path = call()
    png = tmp_path / "with" / f"{name}.png"
    assert png.exists() and png.stat().st_size > 0
    assert path in (None, str(png))            # model_summary returns text
    name, call = _plots(tmp_path / "without")[i]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with caplog.at_level(logging.WARNING):
        assert call() is None
    assert not (tmp_path / "without" / f"{name}.png").exists()
    skipped = [r.getMessage() for r in caplog.records
               if "plot skipped" in r.getMessage()]
    assert skipped == [f"plot skipped: {name}.png (matplotlib is not "
                       "installed)"]


def test_model_summary_lists_modules_and_shapes():
    text = utils.model_summary(SpectrogramCNN(), torch.zeros(2, 3, 32, 32))
    n = sum(p.numel() for p in SpectrogramCNN().parameters())
    assert "block1" in text and "(2, 16, 16, 16)" in text
    assert "block5.conv1" in text and f"total params: {n:,}" in text


def test_wandb_logger_jsonl_has_jax_keys(tmp_path):
    def run(mod, d):
        lg = mod.WandbLogger("p", "run1", log_dir=str(d))
        lg.log_loss(0.5, 3)
        lg.log_evaluation({"kldiv": 1.25, "accuracy": 0.5}, 2)
        lg.plot_metrics({"loss": [1.0, 0.5], "acc": [0.1, 0.2]})
        lg.save_model("ckpt/best")
        lg.finish()
        with open(os.path.join(d, "metrics_run1.jsonl")) as f:
            return [json.loads(line) for line in f]
    got, want = run(utils, tmp_path / "t"), run(jutils, tmp_path / "j")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        g.pop("ts"), w.pop("ts")
        assert g == w


def test_seed_everything_matches_jax():
    gen = utils.seed_everything(123)
    got = (np.random.rand(4), random.random(), os.environ["PYTHONHASHSEED"])
    jutils.seed_everything(123)
    want = (np.random.rand(4), random.random(), os.environ["PYTHONHASHSEED"])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 123


def test_benchmark_fn_has_jax_keys():
    got = utils.benchmark_fn(lambda: torch.ones(8).sum(), warmup=1, iters=3)
    want = jutils.benchmark_fn(lambda: np.ones(8).sum(), warmup=1, iters=3)
    assert got.keys() == want.keys()
    assert got["iters"] == 3 and got["min_s"] <= got["median_s"] \
        <= got["max_s"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with utils.trace(str(tmp_path)) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
