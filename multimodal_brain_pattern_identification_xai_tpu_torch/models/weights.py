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
``output.{0,2}``; for the rest of the zoo, named by ``arch``, the
layouts of the port's modules (torchvision's for ``SpectrogramViT`` and
``EfficientNetB0``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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


def _eegnet_stem(sd: Dict[str, np.ndarray], stem: Mapping,
                 stem_s: Mapping) -> None:
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


def _attention(sd: Dict[str, np.ndarray], dst: str, p: Mapping) -> None:
    for name in ("query", "key", "value"):
        _dense(sd, f"{dst}.{name}", p[name])


def _eegnet_attention(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _eegnet_stem(sd, p["stem"], s["stem"])
    _attention(sd, "attention_layer", p["attention_layer"])
    _dense(sd, "dense1", p["dense1"])
    _dense(sd, "dense2", p["dense2"])
    return sd


def _eegnet(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _eegnet_stem(sd, p["stem"], s["stem"])
    _dense(sd, "dense", p["dense"])
    return sd


def _eegnet_attention_deep(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _eegnet_stem(sd, p["stem"], s["stem"])
    sd["conv2.weight"] = _conv(p["conv2"]["kernel"])
    _bn(sd, "batchnorm4", p["BatchNorm_0"], s["BatchNorm_0"])
    _attention(sd, "attention_layer", p["attention_layer"])
    _dense(sd, "dense1", p["dense1"])
    _dense(sd, "dense2", p["dense2"])
    return sd


def _lstm(sd: Dict[str, np.ndarray], dst: str, cell: Mapping,
          suffix: str = "") -> None:
    """A flax ``OptimizedLSTMCell`` → torch ``nn.LSTM`` layer 0 (direction
    ``suffix``): gates (i, f, g, o) stacked; flax's input kernels carry no
    bias and its hidden kernels the one bias a gate, which goes to
    ``bias_hh`` (``bias_ih`` zero)."""
    gates = "ifgo"
    sd[f"{dst}.weight_ih_l0{suffix}"] = np.concatenate(
        [_np(cell[f"i{g}"]["kernel"]).T for g in gates])
    sd[f"{dst}.weight_hh_l0{suffix}"] = np.concatenate(
        [_np(cell[f"h{g}"]["kernel"]).T for g in gates])
    sd[f"{dst}.bias_hh_l0{suffix}"] = np.concatenate(
        [_np(cell[f"h{g}"]["bias"]) for g in gates])
    sd[f"{dst}.bias_ih_l0{suffix}"] = np.zeros_like(
        sd[f"{dst}.bias_hh_l0{suffix}"])


def _bilstm(sd: Dict[str, np.ndarray], dst: str, p: Mapping) -> None:
    """flax ``BiLSTM``: cell 0 runs forward, cell 1 in reverse."""
    _lstm(sd, dst, p["OptimizedLSTMCell_0"])
    _lstm(sd, dst, p["OptimizedLSTMCell_1"], "_reverse")


def _eegnet_residual(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _eegnet_stem(sd, p["stem"], s["stem"])
    sd["residual.residual_conv.weight"] = _conv(
        p["residual"]["residual_conv"]["kernel"])
    _bn(sd, "residual.bn", p["residual"]["BatchNorm_0"],
        s["residual"]["BatchNorm_0"])
    if "lstm" in p:
        _lstm(sd, "lstm", p["lstm"]["OptimizedLSTMCell_0"])
    _dense(sd, "dense", p["dense"])
    return sd


def _layer_norm(sd: Dict[str, np.ndarray], dst: str, p: Mapping) -> None:
    sd[f"{dst}.weight"] = _np(p["scale"])
    sd[f"{dst}.bias"] = _np(p["bias"])


def _mha(sd: Dict[str, np.ndarray], dst: str, p: Mapping) -> None:
    """flax ``MultiHeadDotProductAttention`` (q/k/v kernels (D, H, D_h),
    biases (H, D_h), ``out`` (H, D_h, D)) → the packed ``in_proj_weight``
    (3D, D) and ``in_proj_bias`` and ``out_proj``."""
    qkv = [_np(p[n]["kernel"]) for n in ("query", "key", "value")]
    d = qkv[0].shape[0]
    sd[f"{dst}.in_proj_weight"] = np.concatenate(
        [k.reshape(d, -1).T for k in qkv])
    sd[f"{dst}.in_proj_bias"] = np.concatenate(
        [_np(p[n]["bias"]).reshape(-1) for n in ("query", "key", "value")])
    sd[f"{dst}.out_proj.weight"] = _np(p["out"]["kernel"]).reshape(-1, d).T
    sd[f"{dst}.out_proj.bias"] = _np(p["out"]["bias"])


def _eegnet_transformer(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _eegnet_stem(sd, p["stem"], s["stem"])
    sd["separableConv2.weight"] = _conv(p["separableConv2"]["kernel"])
    _bn(sd, "batchnorm4", p["BatchNorm_0"], s["BatchNorm_0"])
    for i in range(_numbered(p, "encoder_")):
        enc, dst = p[f"encoder_{i}"], f"encoder.{i}"
        _mha(sd, f"{dst}.self_attn", enc["self_attn"])
        for name in ("linear1", "linear2"):
            _dense(sd, f"{dst}.{name}", enc[name])
        for name in ("norm1", "norm2"):
            _layer_norm(sd, f"{dst}.{name}", enc[name])
    for name in ("dense1", "dense2", "fc_output"):
        _dense(sd, name, p[name])
    return sd


def _seizure(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    for i in (1, 2):
        sd[f"conv{i}.weight"] = _conv(p[f"conv{i}"]["kernel"])
        sd[f"conv{i}.bias"] = _np(p[f"conv{i}"]["bias"])
        _bn(sd, f"batchnorm{i}", p[f"BatchNorm_{i - 1}"],
            s[f"BatchNorm_{i - 1}"])
    _bilstm(sd, "lstm1", p["lstm1"])
    _bilstm(sd, "lstm2", p["lstm2"])
    _dense(sd, "fc1", p["fc1"])
    _dense(sd, "fc2", p["fc2"])
    return sd


def _deepconvnet(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    for i in range(1, 6):
        sd[f"conv{i}.weight"] = _conv(p[f"conv{i}"]["kernel"])
    for k in range(4):
        _bn(sd, f"batchnorm{k + 1}", p[f"BatchNorm_{k}"], s[f"BatchNorm_{k}"])
    _dense(sd, "fc1", p["fc1"])
    return sd


def _vit(p: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    sd["conv_proj.weight"] = _conv(p["conv_proj"]["kernel"])
    sd["conv_proj.bias"] = _np(p["conv_proj"]["bias"])
    sd["class_token"] = _np(p["class_token"])
    sd["encoder.pos_embedding"] = _np(p["pos_embedding"])
    for i in range(_numbered(p, "encoder_layer_")):
        src, dst = p[f"encoder_layer_{i}"], f"encoder.layers.encoder_layer_{i}"
        _layer_norm(sd, f"{dst}.ln_1", src["ln_1"])
        _layer_norm(sd, f"{dst}.ln_2", src["ln_2"])
        _mha(sd, f"{dst}.self_attention", src["self_attention"])
        _dense(sd, f"{dst}.mlp.0", src["mlp_0"])
        _dense(sd, f"{dst}.mlp.3", src["mlp_3"])
    _layer_norm(sd, "encoder.ln", p["ln"])
    _dense(sd, "head", p["head"])
    return sd


def _conv_bias(sd: Dict[str, np.ndarray], dst: str, p: Mapping) -> None:
    sd[f"{dst}.weight"] = _conv(p["kernel"])
    sd[f"{dst}.bias"] = _np(p["bias"])


def _mbconv(sd: Dict[str, np.ndarray], dst: str, p: Mapping,
            s: Mapping) -> None:
    """A flax ``MBConv`` → torchvision's ``block`` layout: [expand conv +
    BN,] depthwise conv + BN, squeeze-excite ``fc1``/``fc2``, project conv
    + BN (flax numbers the BatchNorms in that order)."""
    convs = (["expand_conv"] if "expand_conv" in p else []) + [
        "depthwise_conv", "se", "project_conv"]
    bn = 0
    for i, name in enumerate(convs):
        if name == "se":
            _conv_bias(sd, f"{dst}.block.{i}.fc1", p["se"]["reduce"])
            _conv_bias(sd, f"{dst}.block.{i}.fc2", p["se"]["expand"])
            continue
        sd[f"{dst}.block.{i}.0.weight"] = _conv(p[name]["kernel"])
        _bn(sd, f"{dst}.block.{i}.1", p[f"BatchNorm_{bn}"],
            s[f"BatchNorm_{bn}"])
        bn += 1


def _efficientnet_b0(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    sd["features.0.0.weight"] = _conv(p["stem_conv"]["kernel"])
    _bn(sd, "features.0.1", p["BatchNorm_0"], s["BatchNorm_0"])
    n_stages = 1 + max(int(k[5:].split("_")[0]) for k in p
                       if k.startswith("stage"))
    for si in range(n_stages):
        for ri in range(_numbered(p, f"stage{si}_block")):
            name = f"stage{si}_block{ri}"
            _mbconv(sd, f"features.{si + 1}.{ri}", p[name], s[name])
    head = f"features.{n_stages + 1}"
    sd[f"{head}.0.weight"] = _conv(p["head_conv"]["kernel"])
    _bn(sd, f"{head}.1", p["BatchNorm_1"], s["BatchNorm_1"])
    _dense(sd, "classifier.1", p["classifier"])
    return sd


def _efficientnet_v2(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    for name in ("stem_conv", "head_conv"):
        sd[f"{name}.weight"] = _conv(p[name]["kernel"])
    for name in ("BatchNorm_0", "BatchNorm_1"):
        _bn(sd, name, p[name], s[name])
    for name in (k for k in p if k.startswith("stage")):
        blk, stats = p[name], s[name]
        if "fused_conv" in blk:
            for conv in ("fused_conv", "project_conv"):
                if conv in blk:
                    sd[f"{name}.{conv}.weight"] = _conv(blk[conv]["kernel"])
            for bn in (k for k in blk if k.startswith("BatchNorm_")):
                _bn(sd, f"{name}.{bn}", blk[bn], stats[bn])
        else:
            _mbconv(sd, name, blk, stats)
    _dense(sd, "classifier", p["classifier"])
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


#: REGISTRY name → exporter taking (params, batch_stats)
def _sanity_check(p: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    for name in ("enc1", "enc2", "dec1", "dec2"):
        _dense(sd, name, p[name])
    return sd


_BY_ARCH = {
    "eegnet": _eegnet,
    "eegnet_attention_deep": _eegnet_attention_deep,
    "eegnet_attention_regularized": _eegnet_attention,
    "eegnet_residual": _eegnet_residual,
    "eegnet_residual_lstm": _eegnet_residual,
    "eegnet_transformer": _eegnet_transformer,
    "eeg_seizure_detection": _seizure,
    "deepconvnet": _deepconvnet,
    "wavenet": lambda p, s: _wavenet(p),
    "spectrogram_cnn": _speccnn,
    "spectrogram_vit": lambda p, s: _vit(p),
    "efficientnet_b0": _efficientnet_b0,
    "efficientnetv2_b2": _efficientnet_v2,
    "diffeeg": lambda p, s: _diffeeg(p),
    "diffeeg_legacy": lambda p, s: _diffeeg_legacy(p),
    # not a REGISTRY model: the sanity check's autoencoder
    "diffeeg_sanity_check": lambda p, s: _sanity_check(p),
}


def _detect(p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    if "spectrogram_upsample1" in p:
        return _diffeeg(p)
    if "spectrogram_upconv1" in p:
        return _diffeeg_legacy(p)
    if "wave_block_0" in p:
        return _wavenet(p)
    if "eeg_model" in p:
        sd = {f"eeg_model.{k}": v for k, v in
              _eegnet_attention(p["eeg_model"], s["eeg_model"]).items()}
        sd.update({f"spectrogram_model.{k}": v for k, v in _speccnn(
            p["spectrogram_model"], s["spectrogram_model"]).items()})
        _dense(sd, "fc1", p["fc1"])
        _dense(sd, "fc2", p["fc2"])
        return sd
    if "stem" in p:
        return _eegnet_attention(p, s)
    if "block1" in p:
        return _speccnn(p, s)
    raise ValueError(f"unrecognised variable tree: {sorted(p)}")


def jax_variables_to_state_dict(variables: Mapping[str, Any],
                                arch: Optional[str] = None
                                ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a flax variable tree
    (``{"params", "batch_stats"}``, or ``{"params"}`` for a model without
    BatchNorm).

    ``arch`` names the model by its ``REGISTRY`` name: every model of the
    zoo, and ``"diffeeg_sanity_check"`` for ``DiffEEGSanityCheck``.  Without it the model is detected from the tree's top-level
    names, which tells apart only ``EEGNetAttentionRegularized`` (any tree
    with a ``stem``), ``SpectrogramCNN``, ``MultimodalModel``, ``DiffEEG``,
    ``DiffEEGLegacy`` and ``DilatedInceptionWaveNet``."""
    p = variables["params"]
    s = variables.get("batch_stats", {})
    if arch is None:
        sd = _detect(p, s)
    elif arch in _BY_ARCH:
        sd = _BY_ARCH[arch](p, s)
    else:
        raise KeyError(f"unknown model {arch!r}; available: "
                       f"{sorted(_BY_ARCH)}")
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
