"""Epoch-loop trainer (counterpart of the JAX package's
``train/trainer.py``): epoch loop → train steps → eval → learning-rate
schedule (per batch or per epoch, plateau included) → metric-gated
checkpoints → final eval from the best checkpoint.

The data interface is an iterator of batch dicts ({"x" | "eeg" + "spec",
"y"}) of numpy arrays or tensors; they are moved to the model's device.
A run is bitwise reproducible from its seed when the device's kernels are
deterministic (on CUDA: ``torch.backends.cudnn.deterministic = True``).

With ``mesh`` (a ``DeviceMesh`` of ``parallel.make_mesh``; every rank of
the world builds its own Trainer on the same data) the training steps are
data parallel (``parallel.make_parallel_train_step``): each host batch is
split by rank (``parallel.shard_batch``; its leading size must divide
over the ``data`` axis), the loss, the gradients and the BatchNorm
statistics are averaged over ``data``.  Every rank evaluates the whole
validation set and takes rank 0's results, so the ranks decide alike
(best checkpoint, plateau, early stop).  Rank 0 alone writes checkpoints,
logs and runs the epoch callbacks; the others read its snapshots (resume,
the final best checkpoint).
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .checkpoint import CheckpointManager
from .metrics import Evaluator
from .schedules import ReduceLROnPlateau
from .state import TrainState, set_learning_rate
from .steps import make_eval_step, make_train_step

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 50
    ckpt_metric: str = "kldiv"
    ckpt_mode: str = "min"
    es_patience: int = 0              # 0 → no early stop
    step_per_batch: bool = True
    l2_lambda: float = 0.0
    lr_schedule: Optional[Callable[[int], float]] = None   # step/epoch → lr
    plateau: Optional[ReduceLROnPlateau] = None
    eval_metrics: tuple = ("kldiv", "ce", "accuracy", "f1")
    log_every: int = 50
    seed: int = 42
    #: resume from the latest epoch snapshot under ckpt_dir
    resume: bool = False
    #: extra run-identity keys (e.g. optimizer name) merged with l2_lambda
    #: into the checkpoint stream's fingerprint (``divert_on_change``)
    hyperparams: Optional[Dict[str, Any]] = None


class Trainer:
    def __init__(self, state: TrainState, cfg: TrainerConfig,
                 ckpt_dir: Optional[str] = None,
                 loggers: Optional[List[Any]] = None,
                 epoch_callbacks: Optional[List[Any]] = None,
                 mesh: Optional[Any] = None) -> None:
        from ..parallel import is_primary
        #: per-epoch hooks ``cb(trainer, epoch, val_result)``
        self.epoch_callbacks = epoch_callbacks or []
        self.state = state
        self.cfg = cfg
        self.mesh = mesh
        self.primary = mesh is None or is_primary()
        if mesh is not None:
            from ..parallel import make_parallel_train_step, shard_batch
            self.train_step = make_parallel_train_step(
                mesh, state, l2_lambda=cfg.l2_lambda)
            self._shard = lambda b: shard_batch(mesh, b)
        else:
            self.train_step = make_train_step(l2_lambda=cfg.l2_lambda)
            self._shard = None
        self.eval_step = make_eval_step()
        self.evaluator = Evaluator(list(cfg.eval_metrics))
        self.ckpt = None
        if ckpt_dir:
            # rank 0 settles the stream's directory (and its fingerprint
            # file) before the other ranks read it
            if not self.primary:
                self._barrier()
            self.ckpt = CheckpointManager(ckpt_dir, cfg.ckpt_metric,
                                          cfg.ckpt_mode)
            self.ckpt.write = self.primary
            self.ckpt = self.ckpt.divert_on_change(
                {"l2_lambda": cfg.l2_lambda, **(cfg.hyperparams or {})})
            if self.primary:
                self._barrier()
        self.loggers = (loggers or []) if self.primary else []
        self.history: Dict[str, List[float]] = {"train_loss": [],
                                                "val_loss": []}
        # the trainer's generator lives in the state, so checkpoints hold it
        state.rng.manual_seed(cfg.seed)
        self.rng = state.rng

    # ------------------------------------------------------------------

    def _barrier(self) -> None:
        """Wait for every rank of a mesh run (nothing without a mesh)."""
        if self.mesh is not None:
            dist.barrier()

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        dev = self.state.device
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    def _maybe_set_lr(self, counter: int) -> None:
        if self.cfg.lr_schedule is not None:
            set_learning_rate(self.state, float(self.cfg.lr_schedule(counter)))

    def train_epoch(self, train_iter: Iterable[Dict[str, Any]],
                    epoch: int) -> float:
        """One pass; returns the mean loss over the applied steps.  The
        sentinel's skip flags stay on the device and are summed once at
        the epoch's end (no per-step host sync)."""
        losses, skips = [], []
        for i, batch in enumerate(train_iter):
            if self.cfg.step_per_batch:
                self._maybe_set_lr(self.state.step)
            batch = self._batch(batch)
            if self._shard is not None:
                batch = self._shard(batch)
            self.state, metrics = self.train_step(self.state, batch, self.rng)
            losses.append(metrics["loss"])
            skips.append(metrics["nonfinite"])
            if i % self.cfg.log_every == 0:
                for lg in self.loggers:
                    lg.log_loss(float(metrics["loss"]), self.state.step)
        if not losses:
            raise ValueError(
                "training iterator yielded no batches — the batch size "
                "likely exceeds the training-split size, and drop_last "
                "discards the short tail batch")
        stack = torch.stack(losses)
        skipped = torch.stack(skips)
        n_skip = int(skipped.sum())
        if n_skip:
            # the mean over the APPLIED steps only, masked by the sentinel's
            # own flags (a skipped step can have a finite loss when only a
            # gradient overflowed)
            if self.primary:
                logger.warning("epoch %d: %d/%d batches skipped by the "
                               "non-finite sentinel", epoch, n_skip,
                               len(losses))
            good = ~skipped
            return float(torch.where(good, stack, 0.0).sum()
                         / good.sum().clamp_min(1))
        return float(stack.mean())

    def eval_epoch(self, val_iter: Iterable[Dict[str, Any]]):
        all_logits, all_targets, losses = [], [], []
        for batch in val_iter:
            batch = self._batch(batch)
            logits, loss = self.eval_step(self.state, batch)
            all_logits.append(logits.float().cpu())
            all_targets.append(batch["y"].float().cpu())
            losses.append(float(loss))
        y_pred = torch.cat(all_logits)
        y_true = torch.cat(all_targets)
        result = self.evaluator.evaluate(y_true, y_pred)
        loss = float(np.mean(losses))
        if self.mesh is not None:
            # the ranks decide on rank 0's numbers
            box = [(loss, result)]
            dist.broadcast_object_list(box, src=0)
            loss, result = box[0]
        return loss, result, y_pred.numpy()

    # ------------------------------------------------------------------

    @staticmethod
    def _epoch_iter(loader: Callable, epoch: int) -> Iterable:
        """Call a loader factory, passing the epoch when it takes one, so
        epoch-keyed shuffle and augmentation seeds replay on resume the
        stream an uninterrupted run sees at that epoch."""
        try:
            takes_epoch = bool(inspect.signature(loader).parameters)
        except (TypeError, ValueError):
            takes_epoch = False
        return loader(epoch) if takes_epoch else loader()

    def _resume(self):
        """Restore the latest epoch snapshot: state, epoch counter, loss
        history, best-metric and plateau bookkeeping.  Returns (start
        epoch, best metric, bad epochs), or None without a snapshot."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return None
        self.state = self.ckpt.restore(f"step_{latest}", self.state)
        meta = self.ckpt.load_meta(f"step_{latest}") or {}
        hist = meta.get("history")
        if hist:
            self.history = {k: list(v) for k, v in hist.items()}
        self.ckpt.best_score = float(meta.get("best_score",
                                              self.ckpt.best_score))
        self.ckpt.best_epoch = int(meta.get("best_epoch",
                                            self.ckpt.best_epoch))
        pl = meta.get("plateau")
        if pl is not None and self.cfg.plateau is not None:
            # host-side mutable state: without it the first epoch after a
            # resume would reset the learning rate
            self.cfg.plateau.lr = float(pl[0])
            self.cfg.plateau.best = float(pl[1])
            self.cfg.plateau.num_bad = int(pl[2])
        start = int(meta.get("epoch", latest - 1)) + 1
        if self.primary:
            logger.info("resumed from epoch snapshot step_%d (next epoch "
                        "%d)", latest, start)
        return (start, float(meta.get("best_metric", float("inf"))),
                int(meta.get("bad_epochs", 0)))

    def train_eval(self, train_loader: Callable[[], Iterable],
                   val_loader: Callable[[], Iterable],
                   fold: Optional[int] = None):
        """The full loop.  Loaders are factories returning fresh epoch
        iterators: zero-argument, or taking the epoch (``_epoch_iter``).
        With ``cfg.resume`` the loop restarts from the latest epoch
        snapshot under ``ckpt_dir``.  Returns (state, best metric, the
        predictions of the best epoch)."""
        best_metric = float("inf")
        bad_epochs = 0
        oof = None
        start_epoch = 0
        if self.cfg.resume and self.ckpt is not None:
            resumed = self._resume()
            if resumed is not None:
                start_epoch, best_metric, bad_epochs = resumed
        for epoch in range(start_epoch, self.cfg.epochs):
            t0 = time.time()
            if not self.cfg.step_per_batch:
                self._maybe_set_lr(epoch)
            train_loss = self.train_epoch(
                self._epoch_iter(train_loader, epoch), epoch)
            val_loss, val_result, preds = self.eval_epoch(val_loader())
            if self.cfg.plateau is not None:
                set_learning_rate(self.state, self.cfg.plateau.step(val_loss))
            self.history["train_loss"].append(train_loss)
            self.history["val_loss"].append(val_loss)
            last = epoch == self.cfg.epochs - 1
            if self.ckpt is not None:
                self.ckpt.step(epoch, self.state, val_result, last)
            score = val_result[self.cfg.ckpt_metric]
            if score < best_metric:
                best_metric = score
                bad_epochs = 0
                oof = preds
            else:
                bad_epochs += 1
            if self.ckpt is not None:
                pl = self.cfg.plateau
                self.ckpt.save_step(
                    epoch + 1, self.state,
                    meta={"epoch": epoch, "history": self.history,
                          "best_metric": best_metric,
                          "best_score": self.ckpt.best_score,
                          "best_epoch": self.ckpt.best_epoch,
                          "bad_epochs": bad_epochs,
                          "plateau": ([pl.lr, pl.best, pl.num_bad]
                                      if pl is not None else None)})
            msg = (f"[fold {fold}] " if fold is not None else "") + (
                f"epoch {epoch}: train_loss={train_loss:.4f} "
                f"val_loss={val_loss:.4f} "
                + " ".join(f"{k}={v:.4f}" for k, v in val_result.items())
                + f" ({time.time() - t0:.1f}s)")
            if self.primary:
                logger.info(msg)
                for cb in self.epoch_callbacks:
                    cb(self, epoch, val_result)
            for lg in self.loggers:
                lg.log_evaluation(val_result, epoch)
            if self.cfg.es_patience and bad_epochs >= self.cfg.es_patience:
                if self.primary:
                    logger.info("early stop at epoch %d", epoch)
                break
        if self.ckpt is not None and self.ckpt.best_epoch >= 0:
            self._barrier()           # rank 0's last snapshot is written
            self.state = self.ckpt.load_best(self.state)
            _, final_result, oof = self.eval_epoch(val_loader())
            if self.primary:
                logger.info("final (best ckpt): " + " ".join(
                    f"{k}={v:.4f}" for k, v in final_result.items()))
        return self.state, best_metric, oof
