"""The port's spans and counters (``profiling``) on the CPU: a span's
record (name, parent, request, host times, self time); tracing off records
nothing but ``mbx.setup.*`` spans; ``traced`` and a ``torch.profiler``
session turn it on, the spans then being CPU ops
of the trace that are not user annotations; counters and ``collect``'s
sums by name; the spans a graph's capture registers, read with a stand-in
for the card's timing events; and the spans and counters of the program's
own layers (preprocessing, models, xai).  The card test
``tests/test_torch_cuda_kernels.py::test_captured_forward_times_its_layers``
reads the same layers from a captured graph on an H100."""

import threading
import time
import types

import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu_torch import (
    config as C, profiling, xai)
from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
    EEGNetAttentionRegularized, MultimodalModel, SpectrogramCNN)
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    hms_eeg_preprocess, hms_spectrogram_preprocess)


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts with tracing off and nothing recorded."""
    assert not profiling.tracing()
    profiling.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    profiling.reset()


def _sleep_ms(ms):
    t = time.perf_counter() + ms / 1e3
    while time.perf_counter() < t:
        pass


def test_span_record():
    with profiling.traced():
        t0 = time.perf_counter_ns()
        with profiling.span("mbx.a") as a:
            _sleep_ms(2)
            with profiling.span("mbx.b") as b:
                _sleep_ms(5)
            with profiling.span("mbx.b"):
                _sleep_ms(1)
        with profiling.span("mbx.c") as c:
            pass
        t1 = time.perf_counter_ns()
    recs = {r.name: r for r in profiling.collect().spans}
    ra, rb, rc = recs["mbx.a"], recs["mbx.b"], recs["mbx.c"]
    assert ra.parent is None and rb.parent == "mbx.a" and rc.parent is None
    assert a.request == b.request == ra.request == rb.request
    assert c.request != a.request
    assert not ra.graph
    assert t0 <= ra.start_ns < rb.start_ns < rb.end_ns <= ra.end_ns <= t1
    assert ra.host_ms >= 8 and rb.host_ms >= 1
    # a's self time: its time less both children's
    kids = [r for r in profiling.collect().spans if r.name == "mbx.b"]
    assert ra.self_host_ms == pytest.approx(
        ra.host_ms - sum(r.host_ms for r in kids), abs=1e-6)
    assert 2 <= ra.self_host_ms < ra.host_ms
    assert rb.self_host_ms == rb.host_ms
    assert ra.device_ms is None            # no card: no device times


def test_off_records_only_setup_spans():
    assert not profiling.tracing()
    with profiling.span("mbx.a") as a:
        profiling.count("n")
        with profiling.span("mbx.setup.kernels") as s:
            with profiling.span("mbx.setup.kernels.build"):
                with profiling.span("mbx.b"):
                    pass
    assert a is None and s is not None
    got = profiling.collect()
    assert [r.name for r in got.spans] == ["mbx.setup.kernels.build",
                                           "mbx.setup.kernels"]
    assert got.spans[0].parent == "mbx.setup.kernels"
    assert got.spans[1].parent is None and got.counters == {}
    with profiling.traced():
        assert profiling.tracing()
        with profiling.span("mbx.a"):
            profiling.count("n")
    assert not profiling.tracing()
    with profiling.span("mbx.a"):
        profiling.count("n")
    got = profiling.collect()
    assert got.sums["mbx.a"].calls == 1 and got.counters == {"n": 1}


def test_traced_restores_the_state():
    with profiling.traced():
        assert profiling.tracing()
    assert not profiling.tracing()
    with profiling.traced():
        with profiling.traced():
            pass
        assert profiling.tracing()            # the outer block's state
        with pytest.raises(RuntimeError):
            with profiling.traced():
                raise RuntimeError
        assert profiling.tracing()
    assert not profiling.tracing()


def test_profiler_session_turns_spans_on():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.tracing()
        with profiling.span("mbx.outer"):
            with profiling.span("mbx.inner"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert not profiling.tracing()
    ops = {e.name: e for e in prof.events() if e.name.startswith("mbx.")}
    assert set(ops) == {"mbx.outer", "mbx.inner"}
    for e in ops.values():
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert e.is_user_annotation is False
    inner = ops["mbx.inner"]
    assert any(c.name == "aten::matmul" for c in inner.cpu_children)
    assert profiling.collect().sums["mbx.inner"].calls == 1


def test_counters_and_sums_of_a_nested_example():
    with profiling.traced():
        for i in range(3):
            with profiling.span("mbx.req"):
                profiling.count("req")
                profiling.count("rows", 4)
                with profiling.span("mbx.part"):
                    _sleep_ms(1)
                with profiling.span("mbx.part"):
                    _sleep_ms(1)
    got = profiling.collect()
    assert got.counters == {"req": 3, "rows": 12}
    req, part = got.sums["mbx.req"], got.sums["mbx.part"]
    assert (req.calls, part.calls) == (3, 6)
    assert part.host_ms >= 6 and part.self_host_ms == pytest.approx(
        part.host_ms)
    assert req.self_host_ms == pytest.approx(req.host_ms - part.host_ms,
                                             abs=1e-6)
    assert len({r.request for r in got.spans}) == 3
    assert got.graph_sums == {}


def test_raw_records_are_bounded(monkeypatch):
    with profiling.traced():
        for _ in range(profiling.MAX_SPANS + 10):
            with profiling.span("mbx.x"):
                pass
    got = profiling.collect()
    assert len(got.spans) == profiling.MAX_SPANS
    assert got.sums["mbx.x"].calls == profiling.MAX_SPANS + 10


class _Event:
    """A stand-in for ``torch.cuda.Event``: ``record`` reads a clock that
    the test advances."""
    clock = [0.0]
    made = []

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing
        self.external = external
        self.t = None
        _Event.made.append(self)

    def record(self, stream=None):
        self.t = _Event.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_device_times_of_eager_spans(monkeypatch):
    """With CUDA up, a ``device=True`` span's two events give its device
    time and its self time; a span without it times the host alone; a
    read pair of events serves the next span."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(device_index=0))
    _Event.made.clear()
    _Event.clock[0] = 0.0
    with profiling.traced():
        with profiling.span("mbx.outer", device=True):
            _Event.clock[0] += 1.0
            with profiling.span("mbx.inner", device=True):
                _Event.clock[0] += 3.0
            with profiling.span("mbx.host"):
                _Event.clock[0] += 2.0
    assert len(_Event.made) == 4 and not any(e.external for e in _Event.made)
    got = profiling.collect()
    outer, inner = got.sums["mbx.outer"], got.sums["mbx.inner"]
    assert (outer.device_ms, outer.self_device_ms) == (6.0, 3.0)
    assert (inner.device_ms, inner.timed) == (3.0, 1)
    assert got.sums["mbx.host"].timed == 0
    with profiling.traced():
        with profiling.span("mbx.again", device=True):
            _Event.clock[0] += 1.5
    assert len(_Event.made) == 4            # the read events, reused
    assert profiling.collect().sums["mbx.again"].device_ms == 1.5


def test_capture_registers_graph_spans(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    _Event.made.clear()
    clock = _Event.clock
    clock[0] = 0.0
    assert not profiling.tracing()           # recorded whether on or off
    with profiling.capturing() as cap:
        with profiling.span("mbx.pre"):
            clock[0] += 1.0
        with profiling.span("mbx.model"):
            with profiling.span("mbx.branch"):
                clock[0] += 2.0
            clock[0] += 0.5
            with profiling.span("mbx.setup.kernels"):    # never in a graph
                pass
        other = []
        t = threading.Thread(target=lambda: other.append(
            profiling.span("mbx.elsewhere")))
        t.start()
        t.join()
    assert other == [profiling._NULL]        # another thread: not captured
    assert cap.names == ["mbx.pre", "mbx.model", "mbx.branch"]
    assert cap.parents == [None, None, 1]
    assert len(cap) == 3 and len(_Event.made) == 6
    assert profiling.span("mbx.pre") is profiling._NULL   # capture over
    assert cap.times() == [1.0, 2.5, 2.0]
    # a replay marked unread is read by collect, once, as its request's
    cap.pending(41)
    got = profiling.collect()
    recs = [r for r in got.spans if r.graph]
    assert [(r.name, r.parent, r.request) for r in recs] == [
        ("mbx.pre", None, 41), ("mbx.model", None, 41),
        ("mbx.branch", "mbx.model", 41)]
    model = got.graph_sums["mbx.model"]
    assert (model.calls, model.device_ms, model.self_device_ms) == (
        1, 2.5, 0.5)
    assert "mbx.model" not in got.sums
    assert profiling.collect().graph_sums["mbx.model"].calls == 1
    # flush reads the marked replay before the next one would overwrite it
    cap.pending(42)
    cap.flush()
    cap.flush()
    got = profiling.collect()
    assert got.graph_sums["mbx.pre"].calls == 2
    assert {r.request for r in got.spans if r.graph} == {41, 42}


def test_graph_reads_become_records_in_bounded_batches(monkeypatch):
    """Replays read before the next one keep only their times; every
    ``KEEP_READS`` of them become records without a ``collect``."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    with profiling.capturing() as cap:
        with profiling.span("mbx.layer"):
            _Event.clock[0] += 1.0
    for r in range(profiling.KEEP_READS):
        cap.pending(r)
        cap.flush()
    got = profiling._graph_sums["mbx.layer"]
    assert got.calls == profiling.KEEP_READS and not cap._reads
    cap.pending(99)
    cap.flush()
    assert profiling.collect().graph_sums["mbx.layer"].calls == (
        profiling.KEEP_READS + 1)


def _tiny_model():
    torch.manual_seed(0)
    return MultimodalModel(
        EEGNetAttentionRegularized(samples=64, kern_length=8),
        SpectrogramCNN(widths=(4, 8), pools=("max", "avg"))).eval()


def test_program_layers_open_their_spans():
    sig = C.SignalConfig(fixed_length=64, image_size=(32, 24))
    raw_eeg = torch.randn(2, 20, 256) * 40
    raw_spec = torch.randn(2, 32, 24).abs()
    model = _tiny_model().requires_grad_(False)
    with profiling.traced():
        xe = hms_eeg_preprocess(raw_eeg, signal=sig, assume_finite=True)
        xs = hms_spectrogram_preprocess(raw_spec, signal=sig)
        with torch.no_grad():
            model(xe, xs)
        xai.multimodal_saliency(model, xe, xs)
        xai.integrated_gradients(model.forward_eeg, xe, steps=3)
    got = profiling.collect()
    assert got.counters == {"xai.saliency.requests": 1}
    calls = {k: v.calls for k, v in got.sums.items()}
    assert calls == {"mbx.preprocess.eeg": 1, "mbx.preprocess.spec": 1,
                     # the forward, the saliency's argmax and its forward;
                     # the IG's argmax and its one chunk
                     "mbx.model.eeg_branch": 5, "mbx.model.spec_branch": 3,
                     "mbx.model.head": 3, "mbx.xai.saliency": 1,
                     "mbx.xai.saliency.backward": 1, "mbx.xai.ig": 1}
    parents = {(r.name, r.parent) for r in got.spans}
    assert ("mbx.xai.saliency.backward", "mbx.xai.saliency") in parents
    assert ("mbx.model.head", "mbx.xai.saliency") in parents
    assert ("mbx.model.eeg_branch", "mbx.xai.ig") in parents
    sal = got.sums["mbx.xai.saliency"]
    assert 0 < sal.self_host_ms < sal.host_ms
