"""Logging (counterpart of the JAX package's ``utils/logging.py``): a
stdout logger, a timestamped file logger, and a wandb-compatible metrics
logger that writes a local JSONL file, in the JAX version's record format,
when wandb is not installed."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from datetime import datetime
from typing import Any, Dict, Optional

_FORMAT = "%(asctime)s | %(levelname)s | %(name)s | %(message)s"


def get_logger(name: str = "mbx", level: str = "info") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    return logger


def setup_file_logger(log_dir: str, name: str = "mbx",
                      resume_file: Optional[str] = None) -> logging.Logger:
    """A ``log_YYYYmmdd_HHMMSS.txt`` file handler under ``log_dir`` (or
    ``resume_file`` there, appended to when resuming) on
    :func:`get_logger`'s logger."""
    os.makedirs(log_dir, exist_ok=True)
    fname = resume_file or f"log_{datetime.now():%Y%m%d_%H%M%S}.txt"
    logger = get_logger(name)
    path = os.path.join(log_dir, fname)
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(fh)
    logger.info("logging to %s", path)
    return logger


class WandbLogger:
    """Experiment logger with wandb's calls, or, without wandb, one JSON
    record a line in ``<log_dir>/metrics_<exp_id>.jsonl``, each with a
    ``ts`` key: ``log_loss`` per step (``train/loss``, ``step``),
    ``log_evaluation`` per evaluation (``val/<metric>``, ``epoch``),
    ``plot_loss`` / ``plot_metrics`` (``plots/<label>``: the series),
    ``save_model`` (``checkpoint``).  The trainers take it in
    ``loggers=[...]``."""

    def __init__(self, project: str, exp_id: str,
                 log_dir: str = "logs", config: Optional[Dict] = None):
        self.exp_id = exp_id
        self._wandb = None
        self._wandb_mod = None
        try:
            import wandb
            self._wandb = wandb.init(project=project, name=exp_id,
                                     config=config or {})
            self._wandb_mod = wandb
        except Exception as e:                # no wandb, or no wandb run
            os.makedirs(log_dir, exist_ok=True)
            self._path = os.path.join(log_dir, f"metrics_{exp_id}.jsonl")
            self._fh = open(self._path, "a")
            logging.getLogger(__name__).info(
                "wandb unavailable (%s: %s); metrics go to %s",
                type(e).__name__, e, self._path)

    def _emit(self, record: Dict[str, Any]) -> None:
        if self._wandb is not None:
            self._wandb.log(record)
        else:
            record["ts"] = time.time()
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def log_loss(self, loss: float, step: int) -> None:
        self._emit({"train/loss": float(loss), "step": int(step)})

    def log_evaluation(self, metrics: Dict[str, float], epoch: int) -> None:
        self._emit({f"val/{k}": float(v) for k, v in metrics.items()}
                   | {"epoch": int(epoch)})

    def plot_loss(self, losses, label: str = "loss") -> None:
        """A line series over all steps so far; the JSONL record holds the
        whole series in one row."""
        series = [float(v) for v in losses]
        if self._wandb is not None:
            table = self._wandb_mod.Table(
                data=[[i, v] for i, v in enumerate(series)],
                columns=["step", label])
            self._emit({f"plots/{label}": self._wandb_mod.plot.line(
                table, "step", label, title=label)})
        else:
            self._emit({f"plots/{label}": series})

    def plot_metrics(self, metrics: Dict[str, Any]) -> None:
        """One named series per metric."""
        for name, series in metrics.items():
            self.plot_loss(series, label=name)

    def save_model(self, path: str) -> None:
        self._emit({"checkpoint": path})

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        else:
            self._fh.close()
