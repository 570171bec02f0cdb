"""The system under test, built from the port's own entries for a
configuration: the only module of the harness (with the traffic kinds
and ``builders/``) that imports the port,
``multimodal_brain_pattern_identification_xai_tpu_torch``.

The model is ``builders/<model>.py``'s for the configuration's
spectrogram model, its weights loaded strictly under the reference's
names and shapes (:func:`..reference.models.fusion_shapes`); both chains
run with the configuration's settings (:func:`chain`).

* :class:`Scoring`: raw windows → both preprocessing chains → the
  late-fusion model, as one captured CUDA graph (``entry.capture_forward``).
  ``"entry": "make_forward"`` serves the model through ``entry.make_forward``;
  ``"compose"`` composes the chains with the model itself, for a
  spectrogram model that ``make_forward`` does not take (it reads
  ``spectrogram_model.dtype``).
* :class:`Explaining`: the served model in float32 with its parameters
  frozen, preprocessing under ``no_grad``, ``xai.multimodal_saliency``
  over both branches and ``xai.integrated_gradients`` over the EEG branch,
  each for the argmax of its forward.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .. import builders

Span = Callable[[str], contextlib.AbstractContextManager]


def _dtype(name: str) -> Optional[torch.dtype]:
    return {"bfloat16": torch.bfloat16, "float32": None}[name]


def no_span(name: str) -> contextlib.AbstractContextManager:
    return contextlib.nullcontext()


def chain(cfg: dict, plane: Sequence[int]):
    """The port's ``(HMSPreprocessConfig, SignalConfig)`` for the
    configuration's chains and the traffic's plane."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        config as C)
    e, s = cfg["eeg"], cfg["spectrogram"]
    low, high = e["band_hz"]
    pre = C.HMSPreprocessConfig(
        bandpass=C.BandpassConfig(low=low, high=high),
        first_bandpass_order=e["first_bandpass_order"],
        denoise_bandpass_order=e["denoise_bandpass_order"],
        notch_freq_hz=s["notch_hz"], notch_quality=s["notch_q"],
        gaussian_sigma=s["gaussian_sigma"])
    signal = C.SignalConfig(sampling_rate=e["fs"], fixed_length=e["samples"],
                            image_size=tuple(plane))
    return pre, signal


def _model(cfg: dict, prog: dict, weights: Dict[str, torch.Tensor],
           dev: torch.device) -> torch.nn.Module:
    model = builders.get(cfg["spectrogram"]["model"]).build(
        cfg, prog, _dtype(prog["spec_model_dtype"]))
    model.to(dev).load_state_dict(weights, strict=True)
    return model.eval()


class Scoring:
    """``replay(raw_eeg, raw_spec) → log-probs`` (B, n) float32 on the
    device; ``staged(raw_eeg, raw_spec, span)`` runs the same program
    eagerly, one span a layer."""

    def __init__(self, cfg: dict, prog: dict, weights: Dict[str, torch.Tensor],
                 dev: torch.device, plane: Sequence[int],
                 example: Tuple[torch.Tensor, torch.Tensor]):
        from multimodal_brain_pattern_identification_xai_tpu_torch import (
            config as C, entry)
        from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
            hms_eeg_preprocess, hms_spectrogram_preprocess,
            preprocess_multimodal)

        pre, signal = chain(cfg, plane)
        model = _model(cfg, prog, weights, dev)
        spec_dt = _dtype(prog["spec_model_dtype"])
        chain_dt = _dtype(prog["spec_chain_dtype"])
        if prog["entry"] == "make_forward":
            if pre != C.HMSPreprocessConfig():
                raise ValueError("entry.make_forward runs the port's default "
                                 f"chains, not {pre}")
            forward = entry.make_forward(model, signal, assume_finite=True,
                                         serving_dtype=chain_dt)

            def preprocess(re, rs):
                return preprocess_multimodal(re, rs, pre, signal,
                                             assume_finite=True,
                                             serving_dtype=chain_dt)
        elif prog["entry"] == "compose":
            eeg_dt = _dtype(prog["eeg_input_dtype"])

            def preprocess(re, rs):
                xe = hms_eeg_preprocess(re, pre, signal, assume_finite=True,
                                        serving_dtype=eeg_dt)
                xs = hms_spectrogram_preprocess(rs, pre, signal,
                                                serving_dtype=chain_dt)
                return xe, xs.to(spec_dt or torch.float32)

            def forward(re, rs):
                with torch.inference_mode():
                    return model(*preprocess(re, rs))
        else:
            raise ValueError(f"no scoring program for entry {prog['entry']!r}")
        self.model, self.preprocess = model, preprocess
        self.replay = entry.capture_forward(forward, example)

    def staged(self, re: torch.Tensor, rs: torch.Tensor, span: Span) -> None:
        with torch.inference_mode():
            with span("bench.preprocess"):
                xe, xs = self.preprocess(re, rs)
            with span("bench.eeg_branch"):
                self.model.forward_eeg(xe)
            with span("bench.spec_branch"):
                self.model.forward_spectrogram(xs)


class Explaining:
    """``request(raw_eeg, raw_spec, span) → (eeg saliency, spectrogram
    saliency, EEG integrated gradients, fused target, EEG target)`` on the
    device."""

    def __init__(self, cfg: dict, prog: dict, weights: Dict[str, torch.Tensor],
                 dev: torch.device, plane: Sequence[int], ig_steps: int):
        self.pre, self.signal = chain(cfg, plane)
        self.model = _model(cfg, prog, weights, dev)
        self.model.requires_grad_(False)
        self.ig_steps = ig_steps

    def request(self, re: torch.Tensor, rs: torch.Tensor, span: Span = no_span):
        from multimodal_brain_pattern_identification_xai_tpu_torch import xai
        from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
            preprocess_multimodal)

        m = self.model
        with span("bench.preprocess"), torch.no_grad():
            xe, xs = preprocess_multimodal(re, rs, self.pre, self.signal,
                                           assume_finite=True)
        with span("bench.saliency"):
            with torch.no_grad():
                t = m(xe, xs).argmax(-1)
            ge, gs = xai.multimodal_saliency(m, xe, xs, target=t)
        with span("bench.ig"):
            with torch.no_grad():
                te = m.forward_eeg(xe).argmax(-1)
            ig = xai.integrated_gradients(m.forward_eeg, xe, target=te,
                                          steps=self.ig_steps)
        return ge, gs, ig, t, te
