"""One short run of every one-card cell through ``benchmark/run.py`` on a
card (``-m cuda``); skips without one."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.lib import registry
from conftest import ROOT

CELLS = [w["name"] for w in registry.benchmark_json()["workloads"]
         if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_a_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          cell, "--seed", "2147483999", "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
