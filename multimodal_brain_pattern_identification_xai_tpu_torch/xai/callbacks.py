"""Trainer epoch callbacks composing XAI into the training loop
(counterpart of the JAX package's ``xai/callbacks.py``).

:class:`LimeEpochSnapshot` explains a fixed validation spectrogram with
LIME at the end of every N-th epoch of multimodal training and saves the
overlay: a hook of ``train.Trainer(epoch_callbacks=[...])``.  The forward
is the trained model's spectrogram branch
(``trainer.state.model.forward_spectrogram``) in eval mode under
``no_grad``; the model's mode is restored afterwards and none of the
trainer's generators is drawn from, so a run with snapshots trains
bitwise as one without.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from .lime import lime_explain

logger = logging.getLogger(__name__)


def spectrogram_predict_fn(model, device: torch.device):
    """LIME's ``predict_fn`` over ``model.forward_spectrogram``: (n, H, W,
    3) host images → NCHW on ``device`` → probabilities (n, 6) on the
    host, under ``no_grad``.  The model is used in whatever mode it is
    in."""
    def predict(batch_hwc: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            spec = torch.from_numpy(batch_hwc).to(device).permute(0, 3, 1, 2)
            return model.forward_spectrogram(spec).float().exp().cpu().numpy()
    return predict


class LimeEpochSnapshot:
    """Per-epoch LIME snapshot on a fixed spectrogram sample.

    Args:
        sample_chw: (3, H, W) preprocessed spectrogram.
        out_dir: directory of the ``lime_epoch{N}.png`` overlays.
        every: a snapshot every N epochs (epochs 0, N, 2N, ...).
        n_segments, num_samples, seed: :func:`..lime.lime_explain`'s.

    ``results`` holds a ``{"epoch", "label", "weights", "path"}`` record a
    snapshot (``path`` None when the overlay was skipped: no
    matplotlib)."""

    def __init__(self, sample_chw: np.ndarray, out_dir: str,
                 every: int = 1, n_segments: int = 100,
                 num_samples: int = 200, seed: int = 0):
        self.sample_hwc = np.asarray(sample_chw, np.float32).transpose(1, 2, 0)
        self.out_dir = out_dir
        self.every = max(1, every)
        self.n_segments = n_segments
        self.num_samples = num_samples
        self.seed = seed
        self.results: list = []
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, trainer, epoch: int, val_result) -> None:
        if epoch % self.every:
            return
        model = trainer.state.model
        was_training = model.training
        model.eval()
        try:
            res = lime_explain(
                spectrogram_predict_fn(model, trainer.state.device),
                self.sample_hwc, n_segments=self.n_segments,
                num_samples=self.num_samples, seed=self.seed)
        finally:
            model.train(was_training)
        path = self._save_overlay(res, epoch)
        self.results.append({"epoch": epoch, "label": res["label"],
                             "weights": res["weights"], "path": path})
        logger.info("LIME snapshot epoch %d: top label %d → %s",
                    epoch, res["label"], path)

    def _save_overlay(self, res, epoch: int) -> Optional[str]:
        from ..utils.plotting import _plt, _save
        name = f"lime_epoch{epoch}"
        plt = _plt(name)
        if plt is None:
            return None
        img = self.sample_hwc.mean(-1)
        fig, ax = plt.subplots(figsize=(6, 5))
        ax.imshow(img, cmap="gray", aspect="auto")
        ax.imshow(np.ma.masked_where(~res["mask"], res["heatmap"]),
                  cmap="jet", alpha=0.5, aspect="auto")
        seg = res["segments"]
        edge = np.zeros_like(seg, bool)
        edge[:-1] |= seg[:-1] != seg[1:]
        edge[:, :-1] |= seg[:, :-1] != seg[:, 1:]
        ax.contour(edge, levels=[0.5], colors="yellow", linewidths=0.3)
        ax.set_title(f"LIME epoch {epoch} (label {res['label']})")
        return _save(plt, fig, self.out_dir, name, dpi=90)
