"""The port's benchmark harness (``bench.py`` of the port) on the CPU.

The headline's chained step (B=2, two chained steps, the JAX weights
carried across by the port's importer) and the ``--multimodal`` step (B=2,
the 200×150 preset) against the same chains built from the JAX package,
1e-3 on log-probs as ``tests/test_torch_slice.py``; every mode of the
repo-root ``bench.py`` (``docs/BENCH.md``'s table) through ``main`` at
small sizes: one JSON line with ``bench.py``'s metric, a finite value,
``device == "cpu"`` and the port's ``vs_baseline`` rule; the headline and
``--hostgather`` through ``cli.main``; the supervisor's partial on a
deadline and its error line and exit code; no run opens
``BENCH_SWEEP.jsonl``; without a card and without ``--device cpu`` the run
stops with an error line naming the device."""

import ast
import builtins
import json
import math
import re
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import config as JC
from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import ops as jops
from multimodal_brain_pattern_identification_xai_tpu_torch import bench, cli
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from test_torch_slice import _perturbed_variables

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-3           # log-probs, as tests/test_torch_slice.py

#: each mode's flags and the small sizes it runs at here
MODES = {
    "headline": ([], dict(batch=2, scan=2, iters=1, reps=1, n_points=400)),
    "gradcam": (["--gradcam"], dict(batch=2, scan=2, iters=1)),
    "latency": (["--latency"], dict(scan=2, iters=1)),
    "multimodal": (["--multimodal"], dict(
        batch=2, scan=2, iters=1, reps=1, n_points=400, image_size=(64, 48),
        fused_spec=2)),
    "multimodal-effnet": (["--multimodal-effnet"], dict(
        batch=2, scan=1, iters=1, reps=1, n_points=400, image_size=(64, 48))),
    "multimodal-effnetv2": (["--multimodal-effnetv2"], dict(
        batch=2, scan=1, iters=1, reps=1, n_points=400, image_size=(64, 48))),
    "breakdown": (["--multimodal", "--breakdown"], dict(
        batch=2, iters=1, reps=1, n_points=400, image_size=(64, 48))),
    "train": (["--train"], dict(batch=2, iters=1, reps=1, n_points=400,
                                image_size=(64, 48))),
    "diffusion": (["--diffusion"], dict(batch=2, steps=4, length=256,
                                        iters=1)),
    "diffeeg-train": (["--diffeeg-train"], dict(
        batch=2, accumulate=2, length=256, iters=1, reps=1)),
    "longeeg": (["--longeeg"], dict(hours=0.005, iters=1, reps=1)),
    "xai-batch": (["--xai-batch"], dict(batch=2, ig_steps=2,
                                        shap_nsamples=2, iters=1, reps=1)),
    "hostgather": (["--hostgather"], dict(batch=4, n_rows=16, n_eeg=4,
                                          n_spec=3)),
    "convprobe": (["--convprobe"], dict(n_tile=512, r=2, iters=1, reps=1,
                                        plane=(16, 12), gemm_cols=2048,
                                        conv_batch=1)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small programs gain nothing from more,
    and beside other test processes more threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(monkeypatch):
    """Runs in this process (no supervisor) at each mode's small sizes."""
    monkeypatch.setenv("BENCH_NO_SUPERVISOR", "1")
    env_kwargs = bench._env_kwargs

    def kwargs(mode):
        key = "multimodal" if mode == "multimodal-speccnn" else mode
        return {**env_kwargs(mode), **MODES[key][1]}
    monkeypatch.setattr(bench, "_env_kwargs", kwargs)


def _jax_mode_metric():
    """``_MODE_METRIC`` of the repo-root ``bench.py``, read with ``ast``
    (importing it would set its JAX cache variables)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and [getattr(t, "id", "") for t in node.targets]
                == ["_MODE_METRIC"]):
            return ast.literal_eval(node.value)
    raise AssertionError("bench.py has no _MODE_METRIC")


def _jax_metric(flags):
    """The metric ``bench.py`` prints for ``flags`` (its
    ``_metric_for_argv``, no ``BENCH_SPEC_RES``)."""
    if "--multimodal" in flags and "--breakdown" in flags:
        return "multimodal_breakdown"
    return next((m for flag, m in _jax_mode_metric().items()
                 if flag in flags), "eeg_windows_per_sec_per_chip")


def _one_line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


# ---------------------------------------------------------------------------
# parity with the JAX package

def test_headline_chain_matches_jax():
    """Two chained headline steps at B=2 on (20, 4000) windows: the port's
    program against raw → JAX ``hms_eeg_preprocess(assume_finite=True)``
    → ``EEGNetAttentionRegularized`` on the same weights, each step's
    log-probs and the perturbed input."""
    jmodel = jm.EEGNetAttentionRegularized()
    v = _perturbed_variables(jmodel.init(jax.random.PRNGKey(0),
                                         jnp.zeros((2, 1, 37, 3000))), 1)
    step, raw, _ = bench.headline_program(
        "cpu", batch=2, n_points=4000,
        state_dict=tm.jax_variables_to_state_dict(v))
    r = jnp.asarray(raw.numpy())
    for _ in range(2):
        want = jmodel.apply(v, jops.hms_eeg_preprocess(r, assume_finite=True))
        r = r * (1.0 + jnp.mean(want) * 1e-4)
        got = step()
        assert got.shape == (2, 6) and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(raw.numpy(), np.asarray(r), rtol=1e-6)


def test_multimodal_step_matches_jax():
    """``--multimodal`` at the 200×150 preset (``BENCH_SPEC_RES``), B=2:
    the port's step (bf16 spectrogram chain and CNN) against JAX's
    ``MultimodalModel(EEGNetAttentionRegularized, SpectrogramCNN(bf16))``
    on the same weights and raw inputs."""
    sig = JC.SignalConfig(image_size=(200, 150), resize_mode="resample")
    mm = jm.MultimodalModel(
        eeg_model=jm.EEGNetAttentionRegularized(),
        spectrogram_model=jm.SpectrogramCNN(dtype=jnp.bfloat16))
    step, (raw_eeg, raw_spec), _ = bench.multimodal_program(
        "cpu", batch=2, spec_res="200x150", n_points=400)
    re_, rs = jnp.asarray(raw_eeg.numpy()), jnp.asarray(raw_spec.numpy())
    prep_e = lambda r: jops.hms_eeg_preprocess(r, assume_finite=True)
    prep_s = lambda r: jops.hms_spectrogram_preprocess(
        r, signal=sig, serving_dtype=jnp.bfloat16)
    v = _perturbed_variables(mm.init(jax.random.PRNGKey(0), prep_e(re_),
                                     prep_s(rs)), 1)
    step, _, _ = bench.multimodal_program(
        "cpu", batch=2, spec_res="200x150", n_points=400,
        state_dict=tm.jax_variables_to_state_dict(v))
    want = np.asarray(mm.apply(v, prep_e(re_), prep_s(rs)))
    got = step()
    assert got.shape == (2, 6) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# every mode

def test_every_documented_flag_is_run():
    """Each flag of ``docs/BENCH.md``'s mode table is among the modes the
    next test runs."""
    table = (ROOT / "docs" / "BENCH.md").read_text().split("## Modes")[1]
    documented = set(re.findall(r"`(--[a-z-]+)`", table.split("##")[0]))
    documented |= {"--multimodal-effnetv2"}       # written `-effnetv2` there
    run = {f for flags, _ in MODES.values() for f in flags}
    assert documented <= run, documented - run


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_prints_one_line(mode, small, capsys):
    flags = MODES[mode][0]
    assert bench.main(flags + ["--device", "cpu"]) == 0
    line = _one_line(capsys)
    assert line["metric"] == _jax_metric(flags)
    assert isinstance(line["value"], (int, float))
    assert math.isfinite(line["value"]) and line["unit"] != "error"
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    if mode == "gradcam":
        # both rounded to 3 digits from the unrounded ratio
        assert line["vs_baseline"] == pytest.approx(2.0 / line["value"],
                                                    abs=2e-3)
    elif mode == "hostgather":
        assert line["vs_baseline"] > 0
    elif mode == "convprobe":
        assert line["vs_baseline"] == pytest.approx(line["value"] / 989.0,
                                                    abs=1e-4)
        probes = {k: v for k, v in line.items()
                  if k.endswith(("_tflops", "_ms", "_mfu"))}
        assert len(probes) == 18
        assert all(isinstance(v, (int, float)) for v in probes.values())
    else:
        assert line["vs_baseline"] is None
    if mode == "breakdown":
        # per-stage ms from the spans each stage opens (on the CPU their
        # host time), the mode's keys as before
        stages = line["per_stage_ms"]
        assert list(stages) == [
            "dispatch_overhead", "eeg_preprocess", "spec_preprocess",
            "eeg_branch", *[f"spec_block{k}" for k in range(1, 6)],
            "full_pipeline"]
        assert all(math.isfinite(v) for v in stages.values())
        assert all(v > 0 for k, v in stages.items()
                   if k != "dispatch_overhead")
        assert set(line["spec_block_mfu"]) == {f"block{k}"
                                               for k in range(1, 6)}
        assert "span" in line["note"]
    assert "last_good" not in line and "baseline_basis" not in line


@pytest.mark.parametrize("flags", [[], ["--hostgather"]],
                         ids=["headline", "hostgather"])
def test_cli_bench(flags, small, capsys, tmp_path):
    rc = cli.main(["bench"] + flags + ["--device", "cpu",
                                       "--ckpt-dir", str(tmp_path)])
    assert rc == 0
    line = _one_line(capsys)
    assert line["metric"] == _jax_metric(flags) and line["device"] == "cpu"


# ---------------------------------------------------------------------------
# supervision

def _child(code: str):
    return [sys.executable, "-c", code]


def test_deadline_prints_the_partial(monkeypatch, capsys):
    """A child that publishes a partial and then stalls: on the deadline
    the supervisor stops it and prints the partial, marked; exit 0."""
    monkeypatch.setenv("BENCH_TOTAL_BUDGET", "4")
    part = {"metric": "eeg_windows_per_sec_per_chip", "value": 7.5,
            "unit": "windows/s", "vs_baseline": None, "device": "cpu"}
    code = ("import json, sys, time\n"
            f"print('PARTIAL ' + json.dumps({part!r}), flush=True)\n"
            "time.sleep(120)\n")
    t0 = time.monotonic()
    rc = bench._supervise([], "eeg_windows_per_sec_per_chip", _child(code))
    assert rc == 0 and time.monotonic() - t0 < 60
    line = _one_line(capsys)
    assert line["partial"] is True and line["value"] == 7.5
    assert "deadline" in line["stopped_by"]


def test_child_error_prints_the_error_line(capsys):
    """A child that fails with nothing measured: its error line, exit 1;
    with a partial before the error: the partial, exit 0."""
    err = bench._error_line("eeg_windows_per_sec_per_chip",
                            "RuntimeError: boom")
    code = f"import json\nprint(json.dumps({err!r}))\nraise SystemExit(1)\n"
    assert bench._supervise([], err["metric"], _child(code)) == 1
    assert _one_line(capsys) == err
    part = {"metric": err["metric"], "value": 3.0, "unit": "windows/s"}
    code = (f"import json\nprint('PARTIAL ' + json.dumps({part!r}))\n"
            f"print(json.dumps({err!r}))\nraise SystemExit(1)\n")
    assert bench._supervise([], err["metric"], _child(code)) == 0
    line = _one_line(capsys)
    assert line["partial"] is True and line["stopped_by"] == err["error"]


def test_supervised_run_without_a_measurement_fails(monkeypatch, capsys):
    """The real child (this module under ``-m``) on a 2 s deadline, far
    too short for the full-size headline on the CPU: an error line naming
    the deadline, exit 1."""
    monkeypatch.delenv("BENCH_NO_SUPERVISOR", raising=False)
    monkeypatch.delenv("BENCH_SUPERVISED", raising=False)
    monkeypatch.setenv("BENCH_TOTAL_BUDGET", "2")
    assert bench.main(["--device", "cpu"]) == 1
    line = _one_line(capsys)
    assert line["metric"] == "eeg_windows_per_sec_per_chip"
    assert line["value"] is None and line["unit"] == "error"
    assert "deadline" in line["error"]


def test_raised_error_exits_1(small, monkeypatch, capsys):
    def boom(**_):
        raise ValueError("boom\nsecond line")
    monkeypatch.setattr(bench, "bench_longeeg", boom)
    assert bench.main(["--longeeg", "--device", "cpu"]) == 1
    line = _one_line(capsys)
    assert line == {"metric": "longeeg_rollout_hours_per_sec_per_chip",
                    "value": None, "unit": "error", "vs_baseline": None,
                    "error": "ValueError: boom"}


def test_no_run_opens_the_sweep_file(small, monkeypatch, capsys):
    opened = []
    real_open, real_path_open = builtins.open, Path.open

    def spy_open(file, *a, **k):
        opened.append(str(file))
        return real_open(file, *a, **k)

    def spy_path_open(self, *a, **k):
        opened.append(str(self))
        return real_path_open(self, *a, **k)
    monkeypatch.setattr(builtins, "open", spy_open)
    monkeypatch.setattr(Path, "open", spy_path_open)
    for flags in ([], ["--gradcam"], ["--hostgather"]):
        assert bench.main(flags + ["--device", "cpu"]) == 0
    monkeypatch.setattr(bench, "bench_gradcam", lambda **_: 1 / 0)
    assert bench.main(["--gradcam", "--device", "cpu"]) == 1
    capsys.readouterr()
    assert not [f for f in opened if "BENCH_SWEEP" in f], opened


# ---------------------------------------------------------------------------
# the device

def test_no_card_stops_with_an_error_line(monkeypatch, capsys):
    """No card and no ``--device cpu``: an error line naming CUDA, exit 1,
    from the module and (as every computing command) from the CLI."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--train"]) == 1
    line = _one_line(capsys)
    assert line["metric"] == "multimodal_train_windows_per_sec_per_chip"
    assert line["value"] is None and "CUDA" in line["error"]
    assert cli.main(["bench", "--ckpt-dir", "unused"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "no CUDA device" in err[0]


def test_duty_r512_needs_the_accumulation_bound():
    """Why chip_smoke holds the convprobe's R=512 duty output to
    R·(k/16)·2^-23 of the max and not 1e-5: the probe's function sums
    R·k/16 partial products (k/16 16-deep wgmma steps a pass) into one
    float32 accumulator.  Simulated here in float64 at (16, 144) with the
    probe's operand scales on 256 columns: rounding each step to nearest
    float32 already misses 1e-5 against R·(W @ P); rounding toward zero,
    as the tensor cores accumulate, stays inside the bound."""
    rng = np.random.default_rng(0)
    co, k, n, R = 16, 144, 256, 512
    bf = lambda a: torch.as_tensor(a, dtype=torch.bfloat16).double().numpy()
    w, p = bf(rng.standard_normal((co, k))), bf(rng.standard_normal((k, n))
                                                * 0.1)
    parts = [w[:, i:i + 16] @ p[i:i + 16] for i in range(0, k, 16)]
    plain = R * (w @ p)

    def toward_zero(x):
        f = x.astype(np.float32)
        over = np.abs(f.astype(np.float64)) > np.abs(x)
        f[over] = np.nextafter(f[over], np.float32(0))
        return f

    errs = {}
    for name, rnd in (("nearest", lambda x: x.astype(np.float32)),
                      ("toward zero", toward_zero)):
        acc = np.zeros((co, n), np.float32)
        for _ in range(R):
            for part in parts:
                acc = rnd(acc.astype(np.float64) + part)
        errs[name] = np.abs(acc - plain).max() / np.abs(plain).max()
    assert errs["nearest"] > 1e-5, errs
    assert errs["toward zero"] < R * (k // 16) * 2.0 ** -23, errs
