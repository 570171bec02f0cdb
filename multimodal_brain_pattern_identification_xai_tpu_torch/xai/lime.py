"""LIME on spectrograms (counterpart of the JAX package's ``xai/lime.py``):
SLIC superpixels → perturbed images with superpixels switched off → the
model's probabilities → a ridge fit of the top label's probability on the
on/off masks, weighted by lime's exponential kernel → the top positive
segments.

Everything but the model is numpy on the host: a native SLIC (k-means over
(intensity, y, x) from grid seeds) and a closed-form ridge regression
(sklearn's ``Ridge(alpha=1)`` through the origin).  The perturbed images
are built and sent to ``predict_fn`` ``chunk`` at a time (the serving
batch, 256, by default), so that 200 perturbations of a 400×300×3 image
never sit in one 288 MB array; the result is the same as one call.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

#: perturbed images a ``predict_fn`` call: the serving batch
LIME_CHUNK = 256


def slic_segments(image: np.ndarray, n_segments: int = 100,
                  compactness: float = 10.0, n_iter: int = 10) -> np.ndarray:
    """SLIC superpixels of an (H, W) intensity image, or of the channel
    mean of an (H, W, C) one → (H, W) int32 labels 0..K−1.

    Grid-seeded centres in (value, y, x) space, step S = √(H·W /
    n_segments); each iteration assigns every pixel within S of a centre
    to the nearest by value² + (compactness/S)²·(dy² + dx²), then moves
    each centre to its pixels' mean; labels are renumbered densely."""
    img = np.asarray(image, np.float64)
    if img.ndim == 3:
        img = img.mean(-1)
    H, W = img.shape
    S = max(1, int(np.sqrt(H * W / n_segments)))
    ys = np.arange(S // 2, H, S)
    xs = np.arange(S // 2, W, S)
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    centers = np.stack([img[cy.ravel(), cx.ravel()],
                        cy.ravel().astype(np.float64),
                        cx.ravel().astype(np.float64)], axis=1)
    K = len(centers)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    m = compactness
    labels = np.zeros((H, W), np.int32)
    dist = np.full((H, W), np.inf)
    for _ in range(n_iter):
        dist[:] = np.inf
        for k in range(K):
            v, cyk, cxk = centers[k]
            y0, y1 = max(0, int(cyk) - S), min(H, int(cyk) + S + 1)
            x0, x1 = max(0, int(cxk) - S), min(W, int(cxk) + S + 1)
            patch = img[y0:y1, x0:x1]
            dy = yy[y0:y1, x0:x1] - cyk
            dx = xx[y0:y1, x0:x1] - cxk
            d = ((patch - v) ** 2
                 + (m / S) ** 2 * (dy ** 2 + dx ** 2))
            win = d < dist[y0:y1, x0:x1]
            dist[y0:y1, x0:x1] = np.where(win, d, dist[y0:y1, x0:x1])
            labels[y0:y1, x0:x1] = np.where(win, k, labels[y0:y1, x0:x1])
        for k in range(K):
            mask = labels == k
            if mask.any():
                centers[k] = (img[mask].mean(), yy[mask].mean(),
                              xx[mask].mean())
    _, labels = np.unique(labels, return_inverse=True)
    return labels.reshape(H, W).astype(np.int32)


def lime_explain(predict_fn: Callable[[np.ndarray], np.ndarray],
                 image: np.ndarray,
                 segments: Optional[np.ndarray] = None,
                 n_segments: int = 100,
                 num_samples: int = 1000,
                 kernel_width: float = 0.25,
                 top_label: Optional[int] = None,
                 hide_color: Optional[float] = None,
                 seed: int = 0,
                 chunk: Optional[int] = LIME_CHUNK) -> Dict:
    """LIME image explanation with lime's sampling and weighting.

    Args:
        predict_fn: ``(n, H, W, C) float32 → (n, n_classes)``
            probabilities, for any ``n`` up to ``chunk``.
        image: (H, W, C) float image.
        segments: precomputed (H, W) labels (default: :func:`slic_segments`
            with ``n_segments``).
        num_samples: perturbations, the first the image itself; masks
            drawn by ``default_rng(seed)``.
        top_label: the class explained (default: the image's argmax).
        hide_color: value of a switched-off superpixel (default: its mean,
            as lime).
        chunk: perturbed images a ``predict_fn`` call (None: all at once).

    Returns ``segments``, ``label``, ``weights`` (the per-segment ridge
    coefficients), ``heatmap`` (H, W) and ``mask`` (the top ≤ 5 positive
    segments), and ``probs`` (num_samples, n_classes)."""
    rng = np.random.default_rng(seed)
    img = np.asarray(image, np.float64)
    if segments is None:
        segments = slic_segments(img, n_segments)
    K = int(segments.max()) + 1

    fudged = img.copy()
    for k in range(K):
        mask = segments == k
        fudged[mask] = (hide_color if hide_color is not None
                        else img[mask].mean(0))

    masks = rng.integers(0, 2, size=(num_samples, K))
    masks[0] = 1
    seg_onehot = (segments[None, :, :] == np.arange(K)[:, None, None])

    def perturbed(m: np.ndarray) -> np.ndarray:
        keep = np.einsum("nk,khw->nhw", m, seg_onehot)[..., None] > 0
        return np.where(keep, img[None], fudged[None]).astype(np.float32)

    step = chunk or num_samples
    probs = np.concatenate([
        np.asarray(predict_fn(perturbed(masks[s:s + step])))
        for s in range(0, num_samples, step)])
    if top_label is None:
        top_label = int(np.argmax(probs[0]))

    # lime's kernel: exp(-d²/width²) of the cosine distance to the image
    d = 1.0 - (masks @ masks[0]) / (
        np.linalg.norm(masks, axis=1) * np.linalg.norm(masks[0]) + 1e-12)
    w = np.sqrt(np.exp(-(d ** 2) / kernel_width ** 2))

    X = masks * w[:, None]
    y = probs[:, top_label] * w
    coef, *_ = np.linalg.lstsq(X.T @ X + 1.0 * np.eye(K), X.T @ y,
                               rcond=None)

    heat = coef[segments]
    order = np.argsort(-coef)
    pos = [k for k in order if coef[k] > 0][:5]
    sel = np.isin(segments, pos)
    return {"segments": segments, "label": top_label, "weights": coef,
            "heatmap": heat, "mask": sel, "probs": probs}


def mark_boundaries(image: np.ndarray, segments: np.ndarray,
                    color: Tuple[float, float, float] = (1.0, 1.0, 0.0)
                    ) -> np.ndarray:
    """skimage's ``mark_boundaries``: an RGB copy of ``image`` with every
    pixel whose label differs from its lower or right neighbour painted
    ``color``."""
    img = np.asarray(image, np.float64)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    out = img.copy()
    seg = np.asarray(segments)
    edge = np.zeros(seg.shape, bool)
    edge[:-1, :] |= seg[:-1, :] != seg[1:, :]
    edge[:, :-1] |= seg[:, :-1] != seg[:, 1:]
    out[edge] = color
    return out


def plot_lime_overlay(image: np.ndarray, explanation: Dict, save_dir: str,
                      name: str = "lime_overlay") -> Optional[str]:
    """The superpixels, the LIME weights and the top positive segments side
    by side, written to ``<save_dir>/<name>.png``.  Returns the path, or
    None (the skip logged) without matplotlib."""
    from ..utils.plotting import _plt, _save
    plt = _plt(name)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    img = np.asarray(image, np.float64)
    base = img.mean(-1) if img.ndim == 3 else img
    lo, hi = float(base.min()), float(base.max())
    norm = (base - lo) / (hi - lo + 1e-12)
    seg = explanation["segments"]
    masked = np.where(explanation["mask"], norm, 0.3 * norm)
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    axes[0].imshow(mark_boundaries(norm, seg))
    axes[0].set_title(f"superpixels ({seg.max() + 1})")
    axes[1].imshow(explanation["heatmap"], cmap="bwr")
    axes[1].set_title(f"LIME weights (label {explanation['label']})")
    axes[2].imshow(mark_boundaries(masked, seg))
    axes[2].set_title("top positive segments")
    for ax in axes:
        ax.axis("off")
    return _save(plt, fig, save_dir, name)
