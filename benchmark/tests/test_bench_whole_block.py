"""``whole_block_pct.score`` from the port's counters, given a stand-in
for ``profiling.collect()``: the share of fused block calls served whole,
None where the counters are absent (a port without them) or no block was
fused, and its ``per_layer`` entry as the reader says."""

from types import SimpleNamespace

import pytest

from benchmark.lib import program_spans, registry

NAME = "whole_block_pct.score"


def _read(monkeypatch, counters):
    got = None if counters is None else SimpleNamespace(counters=counters)
    monkeypatch.setattr(program_spans, "collected", lambda: got)
    return registry.metric_reader(NAME).read(SimpleNamespace())


@pytest.mark.parametrize("counters,want", [
    ({"models.spec_block.fused": 4, "models.spec_block.whole": 4}, 100.0),
    ({"models.spec_block.fused": 4, "models.spec_block.whole": 1}, 25.0),
    ({"models.spec_block.fused": 4}, 0.0),
    ({"entry.requests": 16}, None),
    (None, None)])
def test_share_of_fused_calls_served_whole(monkeypatch, counters, want):
    assert _read(monkeypatch, counters) == want


def test_entry_matches_reader():
    entry = next(m for m in registry.benchmark_json()["per_layer"]
                 if m["name"] == NAME)
    reader = registry.metric_reader(NAME)
    assert reader.LAYER == entry["layer"] and reader.MOVES == entry["moves"]
    assert entry["workloads"] == ["speccnn.score.b256"]
    assert entry["unit"] == "%" and entry["source"] == "program_counter"
