"""Every cell, configuration, traffic mix and per-layer metric is a file of
its own that the harness finds by name; ``BENCHMARK.json`` keeps to the
contract's shape; a cell added as files is picked up with no edit."""

import json
import re
import shutil

import pytest

from benchmark.lib import registry

BENCH = registry.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [m["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for m in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = registry.cell(cell)
    assert c.chips in (1, 4)
    assert c.config["programs"][c.traffic["program"]]
    assert registry.kind(c.traffic["kind"]).judge
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert c.limits, "a cell's correctness check has limits"
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    reader = registry.metric_reader(metric)
    assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
    assert callable(reader.read) and UNIT.match(m["unit"])
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert set(m["workloads"]) <= set(CELLS)
    for cell in m["workloads"]:
        assert m["moves"] in {e["name"] for e in registry.cell(cell).end_to_end}
    if "roofline" in metric or "mfu" in metric:
        assert m["unit"] == "%"


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    body = json.loads((registry.BENCH.parent / cfg["file"]).read_text())
    assert body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"] == []
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def test_new_cell_is_files_only(tmp_path):
    """A cell, a traffic mix and a metric added as files in a copy are
    found without editing any file that is there."""
    shutil.copytree(registry.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "speccnn.score.b128",
                               "config": "fusion_speccnn",
                               "traffic": "score_b128", "chips": 1,
                               "why": "a smaller batch"})
    bench["per_layer"].append({"name": "copies_ms.score", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "device",
                               "moves": "infer_windows_per_s",
                               "workloads": ["speccnn.score.b128"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((registry.BENCH / "traffic" / "score_b256.json")
                         .read_text())
    (tmp_path / "benchmark" / "traffic" / "score_b128.json").write_text(
        json.dumps({**traffic, "batch": 128}))
    (tmp_path / "benchmark" / "workloads" / "speccnn.score.b128.json"
     ).write_text(json.dumps({"config": "fusion_speccnn",
                              "traffic": "score_b128", "chips": 1,
                              "why": "a smaller batch",
                              "limits": {"prob_gap_ratio": 1.0}}))
    (tmp_path / "benchmark" / "metrics" / "copies_ms.score.py").write_text(
        'LAYER = "device"\nMOVES = "infer_windows_per_s"\n\n\n'
        'def read(ctx):\n    return 1.0\n')
    c = registry.cell("speccnn.score.b128", root=tmp_path)
    assert c.traffic["batch"] == 128
    assert [m["name"] for m in c.per_layer] == ["copies_ms.score"]
    assert registry.metric_reader("copies_ms.score", root=tmp_path).read(None) == 1.0
    with pytest.raises(KeyError):
        registry.cell("speccnn.score.b128")          # not in this checkout


def test_cell_file_must_agree(tmp_path):
    shutil.copytree(registry.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    wl = tmp_path / "benchmark" / "workloads" / f"{CELLS[0]}.json"
    body = json.loads(wl.read_text())
    wl.write_text(json.dumps({**body, "chips": 4}))
    with pytest.raises(ValueError):
        registry.cell(CELLS[0], root=tmp_path)


def test_traffic_sizes_must_be_the_configs(tmp_path):
    shutil.copytree(registry.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    c = registry.cell(CELLS[0], root=tmp_path)
    tr = tmp_path / "benchmark" / "traffic" / f"{c.traffic_name}.json"
    tr.write_text(json.dumps({**c.traffic, "plane": [200, 150]}))
    with pytest.raises(ValueError):
        registry.cell(CELLS[0], root=tmp_path)
