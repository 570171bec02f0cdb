"""Whole runs of every cell at tiny sizes on the CPU (the harness's look
for a card skipped): the result line's schema; the control in the
program's place fails the check; and with the timed path broken
underneath (half of the batch left out and the mean of the rest put in
its place; one answer altered where it is produced) ``correct`` comes out
false.  The cells have no training step and no exchange between chips, so
the other faults do not apply."""

import json
import math
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run as bench_run
from benchmark.lib import harness, registry
from conftest import ROOT, TINY

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
CELLS = [w["name"] for w in registry.benchmark_json()["workloads"]]
SCORE = [c for c in CELLS if registry.cell(c).traffic["kind"] == "score"]
EXPLAIN = [c for c in CELLS if registry.cell(c).traffic["kind"] == "explain"]


def _run(cell, trace=False, tamper=None):
    return harness.run(registry.cell(cell), SEED, 0.5, trace, CPU,
                       time.time(), TINY, tamper)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    c = registry.cell(cell)
    line = _run(cell)
    json.dumps(line, allow_nan=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
        assert m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes", "power_limit_w"}
    assert set(line["checks"]) == set(c.limits)
    for chk in line["checks"].values():
        assert chk["value"] <= chk["limit"]


def test_traced_result_line():
    cell = SCORE[0]
    line = _run(cell, trace=True)
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    names = {m["name"] for m in registry.cell(cell).per_layer}
    assert set(line["metrics"]) <= names        # device metrics: none on a CPU


def _half_score(st):
    replay = st.program.replay

    def broken(re, rs):
        out = replay(re, rs)
        h = out.shape[0] // 2
        out[h:] = out[:h].mean(0)
        return out
    st.program.replay = broken


def _altered_score(st):
    replay = st.program.replay

    def broken(re, rs):
        out = replay(re, rs)
        out[0] = out[0].roll(1)
        return out
    st.program.replay = broken


def _half_explain(st):
    request = st.program.request

    def broken(re, rs, span):
        out = list(request(re, rs, span))
        h = out[0].shape[0] // 2
        for m in out[:3]:
            m[h:] = m[:h].mean(0)
        return tuple(out)
    st.program.request = broken


def _altered_explain(st):
    request = st.program.request

    def broken(re, rs, span):
        ge, gs, ig, t, te = request(re, rs, span)
        ig[0] = ig[0].flip(-1)
        return ge, gs, ig, t, te
    st.program.request = broken


@pytest.mark.parametrize("cell,fault", [
    *[(c, f) for c in SCORE for f in (_half_score, _altered_score)],
    *[(c, f) for c in EXPLAIN for f in (_half_explain, _altered_explain)]],
    ids=lambda v: getattr(v, "__name__", v))
def test_broken_timed_path_is_not_correct(cell, fault):
    assert _run(cell, tamper=fault)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell):
    """The reference one step below the configuration's precision, in the
    program's place, at a size a test run holds."""
    c = registry.cell(cell)
    kind = registry.kind(c.traffic["kind"])
    st = kind.setup(c, SEED, CPU, TINY)
    kind.window(st, 0.2)
    kind.release(st)
    got = kind.judge(st, control=True)
    assert any(got[k] > c.limits[k] for k in c.limits), got


def test_no_jax_in_the_process():
    """What the port loads in a run's process (not only what the harness
    imports) holds no JAX."""
    code = (f"import sys, time; sys.path.insert(0, {str(ROOT)!r}); "
            "sys.path.insert(0, {!r}); ".format(str(ROOT / 'benchmark' / 'tests'))
            + "import torch; from conftest import TINY; "
            "from benchmark import run; from benchmark.lib import harness, registry; "
            f"harness.run(registry.cell({SCORE[0]!r}), 1, 0.2, False, "
            "torch.device('cpu'), time.time(), TINY); "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_words(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "multimodal_brain_pattern_identification_xai_tpu_torch.x", object())
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert bench_run.forbidden_modules() == ["jax"]


def test_no_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          SCORE[0], "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
