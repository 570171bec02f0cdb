"""Weights across the two packages, and seeded random weights.

:func:`jax_variables_to_state_dict` maps the JAX package's flax variables
(``{"params", "batch_stats"}`` as nested dicts of arrays) of
``EEGNetAttentionRegularized``, ``SpectrogramCNN`` or ``MultimodalModel``
onto this package's ``state_dict`` — the inverse of the JAX package's
``models/torch_import.py``.  The key layout is the reference torch
models' (``conv1.weight``, ``batchnorm1.*``, ``depthwiseConv.weight``,
``blockN.convM.*``, ``blockN.bn.*``, ``fc1.*``, …); for ``DiffEEG`` and
``DiffEEGLegacy`` (``{"params"}`` only) ``step_embedding_mlp.{0,2,4}``,
``spectrogram_upsample1`` / ``spectrogram_upconv{1,2}``,
``res_block{i}.*``, …; for ``DilatedInceptionWaveNet`` (``{"params"}``)
``wave_module.{i}.in_conv``, ``wave_module.{i}.gated_tcns.{l}.{filt,
gate}.filters.{j}``, ``wave_module.{i}.skip_convs.{l}`` and
``output.{0,2}``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _conv(kernel) -> np.ndarray:
    """flax HWIO → torch OIHW."""
    return _np(kernel).transpose(3, 2, 0, 1)


def _bn(sd: Dict[str, np.ndarray], dst: str, p: Mapping, s: Mapping) -> None:
    sd[f"{dst}.weight"] = _np(p["scale"])
    sd[f"{dst}.bias"] = _np(p["bias"])
    sd[f"{dst}.running_mean"] = _np(s["mean"])
    sd[f"{dst}.running_var"] = _np(s["var"])


def _dense(sd: Dict[str, np.ndarray], dst: str, p: Mapping) -> None:
    sd[f"{dst}.weight"] = _np(p["kernel"]).T
    sd[f"{dst}.bias"] = _np(p["bias"])


def _eegnet_attention(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    stem, stem_s = p["stem"], s["stem"]
    sd["conv1.weight"] = _conv(stem["conv1"]["kernel"])
    _bn(sd, "batchnorm1", stem["bn1"], stem_s["bn1"])
    # flax contraction kernel K[h, g, d] (Chans, F1, D) → torch depthwise
    # (F1·D, 1, Chans, 1) with output channel g·D + d
    k = _np(stem["depthwiseConv_kernel"])
    chans, f1, d = k.shape
    sd["depthwiseConv.weight"] = k.transpose(1, 2, 0).reshape(
        f1 * d, 1, chans, 1)
    _bn(sd, "batchnorm2", stem["bn2"], stem_s["bn2"])
    sd["separableConv.weight"] = _conv(stem["separableConv"]["kernel"])
    _bn(sd, "batchnorm3", stem["BatchNorm_0"], stem_s["BatchNorm_0"])
    for name in ("query", "key", "value"):
        _dense(sd, f"attention_layer.{name}", p["attention_layer"][name])
    _dense(sd, "dense1", p["dense1"])
    _dense(sd, "dense2", p["dense2"])
    return sd


def _speccnn(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    n_blocks = sum(1 for k in p if k.startswith("block"))
    for i in range(1, n_blocks + 1):
        blk, stats = p[f"block{i}"], s[f"block{i}"]
        for j in range(1, 4):
            sd[f"block{i}.conv{j}.weight"] = _conv(blk[f"conv{j}"]["kernel"])
            sd[f"block{i}.conv{j}.bias"] = _np(blk[f"conv{j}"]["bias"])
        _bn(sd, f"block{i}.bn", blk["BatchNorm_0"], stats["BatchNorm_0"])
        sd[f"block{i}.conv1x1.weight"] = _conv(blk["conv1x1"]["kernel"])
        sd[f"block{i}.conv1x1.bias"] = _np(blk["conv1x1"]["bias"])
    _dense(sd, "fc", p["fc"])
    return sd


def _conv1d(sd: Dict[str, np.ndarray], dst: str, p: Mapping) -> None:
    """flax Conv kernel (k, I, O) → torch Conv1d weight (O, I, k)."""
    sd[f"{dst}.weight"] = _np(p["kernel"]).transpose(2, 1, 0)
    sd[f"{dst}.bias"] = _np(p["bias"])


def _conv_transpose(sd: Dict[str, np.ndarray], dst: str, p: Mapping) -> None:
    """flax ConvTranspose kernel (kh, kw, I, O), spatially flipped against
    torch's, → torch ConvTranspose2d weight (I, O, kh, kw)."""
    sd[f"{dst}.weight"] = _np(p["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    sd[f"{dst}.bias"] = _np(p["bias"])


def _group_norm(sd: Dict[str, np.ndarray], dst: str, p: Mapping) -> None:
    sd[f"{dst}.weight"] = _np(p["scale"])
    sd[f"{dst}.bias"] = _np(p["bias"])


def _diffeeg_common(p: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    for i in (0, 2, 4):
        _dense(sd, f"step_embedding_mlp.{i}", p[f"step_mlp_{i}"])
    sd["class_embedding.weight"] = _np(p["class_embedding"]["embedding"])
    return sd


def _diffeeg(p: Mapping) -> Dict[str, np.ndarray]:
    sd = _diffeeg_common(p)
    _conv_transpose(sd, "spectrogram_upsample1", p["spectrogram_upsample1"])
    for name in ("channel_expand", "spectrogram_project", "input_conv",
                 "skip_sum"):
        _conv1d(sd, name, p[name])
    _conv1d(sd, "gtu.conv1", p["gtu"]["conv1"])
    _conv1d(sd, "gtu.conv2", p["gtu"]["conv2"])
    for i in range(1, 5):
        blk = p[f"res_block{i}"]
        for j, name in ((0, "conv_in"), (2, "conv_dil"), (3, "conv_out")):
            _conv1d(sd, f"res_block{i}.{j}", blk[name])
        _group_norm(sd, f"res_block{i}.4", blk["norm"])
    _group_norm(sd, "layer_norm", p["layer_norm"])
    _conv1d(sd, "final_projection.0", p["final_0"])
    _group_norm(sd, "final_projection.2", p["final_norm"])
    _conv1d(sd, "final_projection.3", p["final_out"])
    return sd


def _diffeeg_legacy(p: Mapping) -> Dict[str, np.ndarray]:
    sd = _diffeeg_common(p)
    for name in ("spectrogram_upconv1", "spectrogram_upconv2"):
        _conv_transpose(sd, name, p[name])
    sd["spectrogram_embed.weight"] = _np(
        p["spectrogram_embed"]["kernel"]).transpose(3, 2, 0, 1)
    sd["spectrogram_embed.bias"] = _np(p["spectrogram_embed"]["bias"])
    for name in ("input_conv", "skip_sum", "output_conv"):
        _conv1d(sd, name, p[name])
    for i in range(1, 5):
        blk = p[f"res_block{i}"]
        for j, name in ((0, "conv_in"), (2, "conv_dil"), (4, "conv_out")):
            _conv1d(sd, f"res_block{i}.{j}", blk[name])
    return sd


def _conv_w(sd: Dict[str, np.ndarray], dst: str, p: Mapping) -> None:
    """flax Conv kernel (1, k, I, O) over the width → torch Conv1d weight
    (O, I, k)."""
    sd[f"{dst}.weight"] = _np(p["kernel"])[0].transpose(2, 1, 0)
    sd[f"{dst}.bias"] = _np(p["bias"])


def _numbered(p: Mapping, prefix: str) -> int:
    return sum(1 for k in p if k.startswith(prefix))


def _wavenet(p: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    for i in range(_numbered(p, "wave_block_")):
        blk, dst = p[f"wave_block_{i}"], f"wave_module.{i}"
        _conv_w(sd, f"{dst}.in_conv", blk["in_conv"])
        for layer in range(_numbered(blk, "gated_tcn_")):
            tcn = blk[f"gated_tcn_{layer}"]
            for part in ("filt", "gate"):
                convs = sorted(tcn[part], key=lambda k: int(k[len("conv_k"):]))
                for j, name in enumerate(convs):
                    _conv_w(sd, f"{dst}.gated_tcns.{layer}.{part}.filters.{j}",
                            tcn[part][name])
            _conv_w(sd, f"{dst}.skip_convs.{layer}", blk[f"skip_conv_{layer}"])
    _dense(sd, "output.0", p["output_0"])
    _dense(sd, "output.2", p["output_2"])
    return sd


def jax_variables_to_state_dict(variables: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a flax variable tree of
    ``EEGNetAttentionRegularized``, ``SpectrogramCNN`` or
    ``MultimodalModel`` (``{"params", "batch_stats"}``), or of ``DiffEEG``,
    ``DiffEEGLegacy`` or ``DilatedInceptionWaveNet`` (``{"params"}``),
    detected from the tree's top-level names."""
    p = variables["params"]
    s = variables.get("batch_stats", {})
    if "spectrogram_upsample1" in p:
        sd = _diffeeg(p)
    elif "spectrogram_upconv1" in p:
        sd = _diffeeg_legacy(p)
    elif "wave_block_0" in p:
        sd = _wavenet(p)
    elif "eeg_model" in p:
        sd = {f"eeg_model.{k}": v for k, v in
              _eegnet_attention(p["eeg_model"], s["eeg_model"]).items()}
        sd.update({f"spectrogram_model.{k}": v for k, v in _speccnn(
            p["spectrogram_model"], s["spectrogram_model"]).items()})
        _dense(sd, "fc1", p["fc1"])
        _dense(sd, "fc2", p["fc2"])
    elif "stem" in p:
        sd = _eegnet_attention(p, s)
    elif "block1" in p:
        sd = _speccnn(p, s)
    else:
        raise ValueError(f"unrecognised variable tree: {sorted(p)}")
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in sd.items()}


def seeded_state_dict(module: torch.nn.Module,
                      seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights for every key of ``module.state_dict()``, made with
    numpy from ``seed``: weights ~ N(0, 1/fan_in), biases ~ N(0, 0.1²),
    BatchNorm scale ~ 1 + N(0, 0.1²), running mean ~ N(0, 0.1²), running
    variance ~ U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in module.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("running_mean") or name.endswith("bias"):
            v = rng.standard_normal(shape) * 0.1
        elif len(shape) == 1:                       # BatchNorm scale
            v = 1.0 + rng.standard_normal(shape) * 0.1
        else:
            fan_in = int(np.prod(shape[1:]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        out[name] = torch.as_tensor(v, dtype=t.dtype)
    return out
