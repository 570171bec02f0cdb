"""Checkpointing (counterpart of the JAX package's ``train/checkpoint.py``;
orbax there, ``torch.save`` here).

Layout under ``ckpt_dir``::

    step_<n>/state.pt     per-epoch resume points (the last ``keep``)
    best-<metric>/state.pt   best-so-far snapshot, metric-gated
    last/state.pt         final snapshot
    <name>.json           each snapshot's metadata
    hyperparams.json      the stream's hyperparameter fingerprint

A snapshot is :meth:`TrainState.state_dict`: the model's ``state_dict``
(BatchNorm buffers included), the optimizer state, the step, the EMA and
the generator's state, so a resume is bitwise.

A manager with ``write = False`` keeps the best-score bookkeeping and
reads snapshots but writes nothing: every rank of a data-parallel run but
the first (``parallel.is_primary``) holds one.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, ckpt_dir: str, ckpt_metric: str = "kldiv",
                 ckpt_mode: str = "min", keep: int = 3) -> None:
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.ckpt_metric = ckpt_metric
        self.direction = -1.0 if ckpt_mode == "max" else 1.0
        self.best_score = float("inf")
        self.best_epoch = -1
        self.keep = keep
        #: False: keep the bookkeeping, write no file
        self.write = True

    # -- low-level ---------------------------------------------------------

    def _save(self, name: str, state: Any, meta: Optional[Dict] = None):
        """Write the snapshot to a temporary directory, then move it over
        ``name``: a run cut while saving leaves the old snapshot whole."""
        if not self.write:
            return
        path = os.path.join(self.ckpt_dir, name)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state.state_dict(), os.path.join(tmp, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        if meta is not None:
            with open(os.path.join(self.ckpt_dir, f"{name}.json"), "w") as f:
                json.dump(meta, f)

    def load(self, name: str) -> Dict[str, Any]:
        """Snapshot ``name`` as written (tensors on the CPU)."""
        return torch.load(os.path.join(self.ckpt_dir, name, STATE_FILE),
                          map_location="cpu", weights_only=True)

    def restore(self, name: str, state: Any) -> Any:
        """Load snapshot ``name`` into ``state`` in place and return it."""
        return state.load_state_dict(self.load(name))

    # -- policy ------------------------------------------------------------

    def step(self, epoch: int, state: Any, val_result: Dict[str, float],
             last_epoch: bool = False) -> bool:
        """Metric-gated best-checkpoint update; also writes ``last`` on the
        last epoch.  Returns True if the best checkpoint was refreshed."""
        score = val_result[self.ckpt_metric] * self.direction
        improved = score < self.best_score
        if improved:
            self.best_score = score
            self.best_epoch = epoch
            self._save(f"best-{self.ckpt_metric}", state,
                       {"epoch": epoch, **val_result})
        if last_epoch:
            self._save("last", state, {"epoch": epoch, **val_result})
        return improved

    def _steps(self):
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
                      if d.startswith("step_")
                      and not d.endswith((".json", ".tmp")))

    def save_step(self, step: int, state: Any,
                  meta: Optional[Dict] = None) -> None:
        """Periodic step snapshot, pruning all but the last ``keep``."""
        self._save(f"step_{step}", state, meta or {"step": step})
        if not self.write:
            return
        for old in self._steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{old}"),
                          ignore_errors=True)
            meta_f = os.path.join(self.ckpt_dir, f"step_{old}.json")
            if os.path.exists(meta_f):
                os.remove(meta_f)

    def divert_on_change(self, hyperparams: Dict[str, Any]
                         ) -> "CheckpointManager":
        """Hyperparameter-change guard: the run's fingerprint is stored in
        ``hyperparams.json``; when an existing stream's differs, the
        manager diverts to a fresh ``<dir>_<changed-keys>-<hash>``
        directory (recording the new fingerprint there) instead of
        resuming incompatible state.  The suffix hashes the full
        fingerprint, so two runs that change one key to different values
        get different streams, and rerunning one fingerprint is stable."""
        blob = json.dumps(hyperparams, sort_keys=True, default=repr)
        path = os.path.join(self.ckpt_dir, "hyperparams.json")
        if not os.path.exists(path):
            if self.write:
                with open(path, "w") as f:
                    f.write(blob)
            return self
        with open(path) as f:
            prev = json.load(f)
        cur = json.loads(blob)
        changed = sorted(k for k in set(prev) | set(cur)
                         if prev.get(k) != cur.get(k))
        if not changed:
            return self
        tag = hashlib.sha1(blob.encode()).hexdigest()[:6]
        fresh = CheckpointManager(
            f"{self.ckpt_dir}_{'_'.join(changed)}-{tag}", self.ckpt_metric,
            "max" if self.direction < 0 else "min", self.keep)
        fresh.write = self.write
        if self.write:
            with open(os.path.join(fresh.ckpt_dir, "hyperparams.json"),
                      "w") as f:
                f.write(blob)
        return fresh

    def load_meta(self, name: str) -> Optional[Dict]:
        """A snapshot's metadata (epoch, history, best-score bookkeeping),
        or None."""
        path = os.path.join(self.ckpt_dir, f"{name}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def load_best(self, state: Any) -> Any:
        """Load the best checkpoint into ``state`` (the final eval)."""
        return self.restore(f"best-{self.ckpt_metric}", state)
