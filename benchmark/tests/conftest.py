"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the checkout's root (CPU, tiny sizes; the ``cuda`` test skips without a
card and runs on one with ``-m cuda``)."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: traffic parameters that shrink every cell to what a CPU run holds
TINY = {"batch": 2, "pool": 2, "n_points": 400, "plane": [64, 48],
        "trace_requests": 1}

#: every configuration file, by name
CONFIGS = {p.stem: json.loads(p.read_text())
           for p in sorted((ROOT / "benchmark" / "configs").glob("*.json"))}
#: the configuration of each spectrogram model
BY_MODEL = {c["spectrogram"]["model"]: c for c in CONFIGS.values()}
