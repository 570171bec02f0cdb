"""The metrics that read the program's own spans and counters
(``lib/program_spans.py``), given a stand-in for the port's
``profiling.collect()``: each divides by the program's counter of
requests, reads the right sums (graph or eager, device or host ms), and
returns None where the spans or the counter are absent, as on a commit
whose port has no spans; and each new ``per_layer`` entry has its reader,
with ``LAYER`` and ``MOVES`` as the entry says."""

from dataclasses import dataclass, field
from types import SimpleNamespace

import pytest

from benchmark.lib import program_spans, registry

NEW = {"graph_preprocess_ms.score", "graph_eeg_branch_ms.score",
       "graph_spec_branch_ms.score", "launch_ms.score",
       "saliency_backward_ms.explain", "kernel_load_s.score",
       "capture_s.score"}


@dataclass
class Sum:
    calls: int = 1
    timed: int = -1                  # -1: as many as calls
    host_ms: float = 0.0
    device_ms: float = 0.0
    self_host_ms: float = 0.0
    self_device_ms: float = 0.0

    def __post_init__(self):
        if self.timed < 0:
            self.timed = self.calls


@dataclass
class Collected:
    sums: dict = field(default_factory=dict)
    graph_sums: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)


def _score_run():
    """16 traced replays of a scoring request, the eager pass's spans of
    the same names beside them, and the set-up spans."""
    return Collected(
        sums={"mbx.entry.launch": Sum(16, host_ms=8.0, device_ms=320.0),
              "mbx.preprocess.eeg": Sum(2, device_ms=999.0),
              "mbx.model.spec_branch": Sum(2, device_ms=999.0),
              # the load's self time; the build (cold) its child
              "mbx.setup.kernels": Sum(3, host_ms=41500.0,
                                       self_host_ms=1500.0),
              "mbx.setup.capture": Sum(1, host_ms=5000.0,
                                       self_host_ms=3500.0)},
        graph_sums={"mbx.preprocess.eeg": Sum(16, device_ms=16.0),
                    "mbx.preprocess.spec": Sum(16, device_ms=16.0),
                    "mbx.model.eeg_branch": Sum(16, device_ms=32.0),
                    "mbx.model.spec_branch": Sum(16, device_ms=256.0)},
        counters={"entry.requests": 16})


def _explain_run():
    return Collected(
        sums={"mbx.xai.saliency.backward": Sum(4, host_ms=9.0,
                                               device_ms=160.0)},
        counters={"xai.saliency.requests": 4})


def _read(monkeypatch, name, got):
    monkeypatch.setattr(program_spans, "collected", lambda: got)
    return registry.metric_reader(name).read(SimpleNamespace())


@pytest.mark.parametrize("name,want", [
    ("graph_preprocess_ms.score", 2.0),       # (16 + 16) / 16
    ("graph_eeg_branch_ms.score", 2.0),
    ("graph_spec_branch_ms.score", 16.0),     # the graph's, not the eager's
    ("launch_ms.score", 0.5),                 # host ms / request
    ("kernel_load_s.score", 1.5),             # self time: nvcc left out
    ("capture_s.score", 3.5),                 # self time
])
def test_score_readers(monkeypatch, name, want):
    assert _read(monkeypatch, name, _score_run()) == pytest.approx(want)


def test_explain_reader(monkeypatch):
    assert _read(monkeypatch, "saliency_backward_ms.explain",
                 _explain_run()) == pytest.approx(40.0)


@pytest.mark.parametrize("name", sorted(NEW))
def test_none_without_spans(monkeypatch, name):
    assert _read(monkeypatch, name, None) is None          # no collect()
    assert _read(monkeypatch, name, Collected()) is None   # nothing traced
    # spans present but no request counted: nothing to divide by
    got = _score_run() if name.endswith(".score") else _explain_run()
    got.counters = {}
    want_none = not name.startswith(("kernel_load", "capture"))
    assert (_read(monkeypatch, name, got) is None) == want_none


def test_device_metrics_need_device_times(monkeypatch):
    """A CPU run's spans have host times only: no device metric."""
    got = _explain_run()
    got.sums["mbx.xai.saliency.backward"].timed = 0
    assert _read(monkeypatch, "saliency_backward_ms.explain", got) is None
    got = _score_run()
    for s in got.graph_sums.values():
        s.timed = 0
    assert _read(monkeypatch, "graph_spec_branch_ms.score", got) is None
    assert _read(monkeypatch, "launch_ms.score", got) == pytest.approx(0.5)


def test_other_cells_spans_are_not_read(monkeypatch):
    """The explain run's spans give no score metric, and the reverse."""
    for name in NEW:
        other = _explain_run() if name.endswith(".score") else _score_run()
        assert _read(monkeypatch, name, other) is None


def test_collected_reads_the_port():
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        profiling)
    got = program_spans.collected()
    assert isinstance(got, profiling.Collected)


@pytest.mark.parametrize("name", sorted(NEW))
def test_entry_has_its_reader(name):
    entry = next(m for m in registry.benchmark_json()["per_layer"]
                 if m["name"] == name)
    reader = registry.metric_reader(name)
    assert reader.LAYER == entry["layer"] and reader.MOVES == entry["moves"]
    assert entry["workloads"]
