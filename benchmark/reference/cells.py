"""The reference's answer to each kind of request, computed in blocks of
rows from the raw windows and the weights the benchmark made.

``mode``: ``"reference"`` is float32 with TF32 off (float64 chains);
``"stated"`` rounds each part to the precision the configuration's program
states for it (``precision.at``) and runs a float32 EEG chain's bandpasses
as float32 recursions: a plain implementation at that precision; ``"control"`` one step below it (``precision.below`` and
TF32), the control that the comparison has to fail.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import models, preprocess, xai
from .precision import at, below, ident, tf32

MODES = ("reference", "stated", "control")


def _rounds(prog: dict, mode: str) -> Dict[str, object]:
    """The rounding of each part: the raw EEG, the EEG chain's stages, the
    EEG branch, the spectrogram chain and the spectrogram branch."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    parts = {"eeg_in": ("eeg_input_dtype", False),
             "eeg_chain": ("eeg_chain_dtype", False),
             "eeg_model": ("eeg_model_dtype", True),
             "spec_chain": ("spec_chain_dtype", True),
             "spec_model": ("spec_model_dtype", True)}
    rnd = {"reference": None, "stated": at, "control": below}[mode]
    return {k: rnd(prog[key], dense) if rnd else ident
            for k, (key, dense) in parts.items()}


def score(cfg: dict, prog: dict, p: Dict[str, torch.Tensor],
          raw_eeg: torch.Tensor, raw_spec: torch.Tensor,
          plane: Sequence[int], mode: str = "reference", rows: int = 32
          ) -> torch.Tensor:
    """Log-probs (B, 6) of one batch of raw windows, on the host."""
    q = _rounds(prog, mode)
    c = preprocess.chain(cfg)
    rec = (np.float32 if (mode, prog["eeg_chain_dtype"]) == ("stated", "float32")
           else None)
    out = []
    with tf32(mode == "control"), torch.no_grad():
        for r in range(0, raw_eeg.shape[0], rows):
            xe = preprocess.eeg(raw_eeg[r:r + rows], q["eeg_in"], q["eeg_chain"],
                                c, rec)
            xs = preprocess.spectrogram(raw_spec[r:r + rows], plane,
                                        q["spec_chain"], c)
            out.append(models.fusion(p, xe, xs, cfg, q["spec_model"],
                                     q["eeg_model"]).cpu())
    return torch.cat(out)


def _resolve(logits: torch.Tensor, target, tie: float
             ) -> Tuple[torch.Tensor, int]:
    """The program's target where the reference puts its logit within
    ``tie`` of its best (a near tie either side may take), else the
    reference's argmax; and how many were not within it.  No target: the
    argmax."""
    best, arg = logits.max(-1)
    if target is None:
        return arg, 0
    ok = logits.gather(-1, target[:, None])[:, 0] >= best - tie
    return torch.where(ok, target, arg), int((~ok).sum())


def explain(cfg: dict, prog: dict, p: Dict[str, torch.Tensor],
            raw_eeg: torch.Tensor, raw_spec: torch.Tensor,
            plane: Sequence[int], ig_steps: int, target, eeg_target,
            tie: float, mode: str = "reference", rows: int = 16):
    """(|∂/∂eeg|, |∂/∂spec|, EEG integrated gradients, the fused and the
    EEG targets taken, the targets outside the tie) of one batch, on the
    host.  ``target`` and ``eeg_target`` are the program's choices, taken
    where the reference ties them; None takes the argmax."""
    q = _rounds(prog, mode)
    c = preprocess.chain(cfg)

    def fused(e, s):
        return models.fusion(p, e, s, cfg, q["spec_model"], q["eeg_model"])

    def eeg_branch(x):
        return models.eegnet_attention(p, x, q=q["eeg_model"])

    maps = ([], [], [], [], [])
    off = 0
    dev = raw_eeg.device
    with tf32(mode == "control"):
        for r in range(0, raw_eeg.shape[0], rows):
            with torch.no_grad():
                xe = preprocess.eeg(raw_eeg[r:r + rows], q["eeg_in"],
                                    q["eeg_chain"], c)
                xs = preprocess.spectrogram(raw_spec[r:r + rows], plane,
                                            q["spec_chain"], c)
                t, n1 = _resolve(fused(xe, xs), _rows(target, r, rows, dev),
                                 tie)
                te, n2 = _resolve(eeg_branch(xe),
                                  _rows(eeg_target, r, rows, dev), tie)
            off += n1 + n2
            ge, gs = xai.saliency(fused, xe, xs, t)
            ig = xai.integrated_gradients(eeg_branch, xe, te, ig_steps)
            for acc, m in zip(maps, (ge, gs, ig, t, te)):
                acc.append(m.detach().cpu())
    return (*(torch.cat(m) for m in maps), off)


def _rows(t, r: int, rows: int, dev: torch.device):
    return None if t is None else t[r:r + rows].to(dev)
