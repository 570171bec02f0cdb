"""Checkpoint-directory analysis (counterpart of the JAX package's
``train/analyze.py``): scan the metadata the ``CheckpointManager`` writes
and report the best snapshot."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple


def analyze_checkpoints(ckpt_dir: str, metric: str = "kldiv",
                        mode: str = "min") -> Tuple[Optional[Dict], List[Dict]]:
    """Rank the ``*.json`` snapshot records under ``ckpt_dir`` by
    ``metric``.  Returns (best, all) records, each with its ``name``."""
    records: List[Dict] = []
    if not os.path.isdir(ckpt_dir):
        return None, records
    for fname in sorted(os.listdir(ckpt_dir)):
        if not fname.endswith(".json"):
            continue
        try:
            with open(os.path.join(ckpt_dir, fname)) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        meta["name"] = fname[:-5]
        records.append(meta)
    scored = [r for r in records if metric in r]
    if not scored:
        return None, records
    best = (min if mode == "min" else max)(scored, key=lambda r: r[metric])
    return best, records
