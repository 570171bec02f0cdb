"""DiffEEG denoiser, a class- and spectrogram-conditioned noise predictor
(counterpart of the JAX package's ``models/diffeeg.py``).

Sinusoidal step embedding + 3-layer MLP, class embedding, a
ConvTranspose2d spectrogram upsampler + GTU gate, 1×1 input projection,
four dilated residual conv blocks, skip sum + GroupNorm, final projection,
on (B, C, T) tensors.  Parameter names and layouts are the reference
torch model's (``step_embedding_mlp.{0,2,4}``, ``spectrogram_upsample1``,
``res_block{i}.{0,2,3,4}``, ``final_projection.{0,2,3}``, …), so its
state dicts load with ``load_state_dict``.

``dtype`` (bf16: the JAX package's ``amp``) is the compute dtype of every
dense, conv and embedding layer but ``final_projection.3``, each casting
its float32 parameters at the call; GroupNorm computes in float32 (the
promoted type), so the blocks' outputs and the result are float32.  Not
``torch.autocast``, which picks its own ops.

GroupNorm(1) is flax's: the variance is E[x²] − E[x]² (clipped at 0),
not torch's two-pass estimate.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dropout


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` when set."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computing in ``compute_dtype`` when set."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt))


class GroupNorm1(nn.Module):
    """flax ``GroupNorm(num_groups=1)``: each sample normalised over every
    axis but the batch, with the variance as E[x²] − E[x]² (clipped at 0),
    in float32 at least, then the per-channel affine (``weight``, ``bias``
    on axis 1).  Where mean² ≫ var the difference cancels: the price of
    agreeing with flax rather than with torch's ``GroupNorm``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = tuple(range(1, xf.dim()))
        mean = xf.mean(dims, keepdim=True)
        var = ((xf * xf).mean(dims, keepdim=True) - mean * mean).clamp_min(0.0)
        shape = (1, -1) + (1,) * (xf.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(shape)
        return (xf - mean) * mul + self.bias.view(shape)


def _probe_axis_maps(n_in: int, kernel: int, stride: int, pad: int) -> list:
    """For one axis of torch's ``conv_transpose2d``: per kernel tap, the
    input position each output position reads (−1: none), found by running
    the op itself with a delta kernel on a ramp 1..n_in (float64, exact)."""
    x = torch.arange(1.0, n_in + 1.0, dtype=torch.float64).view(1, 1, 1, n_in)
    maps = []
    for kk in range(kernel):
        k = torch.zeros((1, 1, 1, kernel), dtype=torch.float64)
        k[..., kk] = 1.0
        out = F.conv_transpose2d(x, k, stride=(1, stride), padding=(0, pad))
        maps.append(np.rint(out[0, 0, 0].numpy()).astype(np.int64) - 1)
    return maps


@functools.lru_cache(maxsize=16)
def _gather_plan(f_in: int, ts_in: int, T: int, kernel: Tuple[int, int],
                 strides: Tuple[int, int], padding: Tuple[int, int]):
    """Static plan for evaluating the upsampler only at the 2·T flat
    positions the lerp onto T points reads (lo taps, then hi taps)
    instead of the whole (F', Ts') plane.

    Per kernel tap, gather indices into the (F, Ts) input plane and
    validity masks, and the lerp weights: ``(idx_f (kh, 2T), idx_t (kw,
    2T), ok_f, ok_t, w (T,))``, numpy.  The geometry is the module's; the
    maps come from probing ``F.conv_transpose2d`` (:func:`_probe_axis_maps`),
    with the reference's padding and the kernel as torch stores it."""
    fmap = _probe_axis_maps(f_in, kernel[0], strides[0], padding[0])
    tmap = _probe_axis_maps(ts_in, kernel[1], strides[1], padding[1])
    f_out, ts_out = len(fmap[0]), len(tmap[0])
    L = f_out * ts_out
    pos = np.clip((np.arange(T) + 0.5) * (L / T) - 0.5, 0.0, L - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, L - 1)
    w = (pos - lo).astype(np.float32)
    flat = np.concatenate([lo, hi])
    f_s, t_s = flat // ts_out, flat % ts_out
    idx_f = np.stack([np.maximum(m[f_s], 0) for m in fmap])
    ok_f = np.stack([(m[f_s] >= 0).astype(np.float32) for m in fmap])
    idx_t = np.stack([np.maximum(m[t_s], 0) for m in tmap])
    ok_t = np.stack([(m[t_s] >= 0).astype(np.float32) for m in tmap])
    return idx_f, idx_t, ok_f, ok_t, w


@functools.lru_cache(maxsize=16)
def _gather_plan_on(f_in: int, ts_in: int, T: int, kernel, strides, padding,
                    device: torch.device):
    """:func:`_gather_plan` as tensors on ``device``: the taps that read
    anything, each as (kh, kw, idx_f, idx_t, mask), and the lerp weights."""
    idx_f, idx_t, ok_f, ok_t, w = _gather_plan(f_in, ts_in, T, kernel,
                                               strides, padding)
    taps = []
    for kh in range(idx_f.shape[0]):
        for kw in range(idx_t.shape[0]):
            mask = ok_f[kh] * ok_t[kw]
            if mask.any():
                taps.append((kh, kw) + tuple(
                    torch.as_tensor(a, device=device)
                    for a in (idx_f[kh], idx_t[kw], mask)))
    return taps, torch.as_tensor(w, device=device)


def linear_interpolate_time(s: torch.Tensor, T: int) -> torch.Tensor:
    """``F.interpolate(mode='linear', align_corners=False)`` along the last
    axis of (B, C, L) onto T points, as a 2-tap lerp at the half-pixel
    grid (the JAX package's gather form, on the last axis here)."""
    L = s.shape[-1]
    pos = np.clip((np.arange(T) + 0.5) * (L / T) - 0.5, 0.0, L - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, L - 1)
    dev = s.device
    w = torch.as_tensor((pos - lo).astype(np.float32), device=dev).to(s.dtype)
    return (s[..., torch.as_tensor(lo, device=dev)] * (1.0 - w)
            + s[..., torch.as_tensor(hi, device=dev)] * w)


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) or (B, 1) diffusion steps → (B, dim) sin/cos embedding."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=t.dtype, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    ang = t.reshape(-1, 1) * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class GTU(nn.Module):
    """Gated Tanh Unit: tanh(conv1(x)) ⊙ sigmoid(conv2(x)), 1×1 convs
    computing in ``dtype`` when set."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv1d(channels, channels, 1, compute_dtype=dtype)
        self.conv2 = Conv1d(channels, channels, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.conv1(x)) * torch.sigmoid(self.conv2(x))


class ResidualBlock(nn.Sequential):
    """conv1×1 → ReLU → dilated conv3 → conv1×1 → GroupNorm(1) → Dropout
    (no residual add: the reference chains the blocks); the convs compute
    in ``dtype`` when set."""

    def __init__(self, channels: int, dilation: int, dropout: float,
                 dtype: Optional[torch.dtype] = None):
        dt = dtype
        super().__init__(
            Conv1d(channels, channels, 1, compute_dtype=dt), nn.ReLU(),
            Conv1d(channels, channels, 3, padding=dilation,
                   dilation=dilation, compute_dtype=dt),
            Conv1d(channels, channels, 1, compute_dtype=dt),
            GroupNorm1(channels), Dropout(dropout))


class DiffEEG(nn.Module):
    """Noise predictor ε̂(x_t, class, t, spectrogram).

    ``forward(x, y, t, spec)``: x (B, n_channels, T) noisy EEG, y (B,
    n_classes) one-hot labels, t (B,) float steps, spec (B, n_channels, F,
    T_s) conditioning spectrograms → (B, n_channels, T) predicted noise.
    Training mode turns dropout on (masks from :func:`.layers.
    dropout_generator`'s generator)."""

    def __init__(self, n_classes: int = 6, n_channels: int = 19,
                 hidden: int = 32, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        H, dt = hidden, dtype
        self.hidden, self.n_channels, self.dtype = hidden, n_channels, dtype
        self.step_embedding_mlp = nn.Sequential(
            Linear(H, H, compute_dtype=dt), nn.Sigmoid(),
            Linear(H, H, compute_dtype=dt), nn.ReLU(),
            Linear(H, H, compute_dtype=dt))
        self.class_embedding = nn.Embedding(n_classes, H)
        self.spectrogram_upsample1 = nn.ConvTranspose2d(
            n_channels, H // 2, 3, stride=(1, 8), padding=(1, 2))
        self.channel_expand = Conv1d(H // 2, H, 1, compute_dtype=dt)
        self.spectrogram_project = Conv1d(H, H, 1, compute_dtype=dt)
        self.gtu = GTU(H, dt)
        self.input_conv = Conv1d(n_channels, H, 1, compute_dtype=dt)
        for i, dil in enumerate((1, 2, 4, 8), start=1):
            self.add_module(f"res_block{i}",
                            ResidualBlock(H, dil, dropout, dt))
        self.skip_sum = Conv1d(H, H, 1, compute_dtype=dt)
        self.layer_norm = GroupNorm1(H)
        self.final_projection = nn.Sequential(
            Conv1d(H, H, 1, compute_dtype=dt), nn.ReLU(), GroupNorm1(H),
            Conv1d(H, n_channels, 1))

    def _class_emb(self, y: torch.Tensor) -> torch.Tensor:
        w = self.class_embedding.weight
        w = w if self.dtype is None else w.to(self.dtype)
        return F.embedding(y.argmax(-1), w)[:, :, None]       # (B, H, 1)

    def _spec_head(self, s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """1×1 convs and GTU on the upsampled, lerped (B, H/2, T) plane,
        plus the class embedding."""
        s = self.spectrogram_project(self.channel_expand(s))
        return self.gtu(s) + self._class_emb(y)

    def conditioning(self, y: torch.Tensor, spec: torch.Tensor,
                     T: int) -> torch.Tensor:
        """Class + spectrogram conditioning, (B, H, T).

        Depends on (y, spec) only, so a sampler computes it once for all
        its steps.  The upsampler runs only at the 2·T flat positions the
        lerp reads (one gather and one small product a kernel tap) instead
        of the whole (F, 8·Ts − 9) plane: the two linear 1×1 convs commute
        with the lerp and ReLU is pointwise, so this equals
        :meth:`conditioning_dense` up to rounding."""
        dt = self.dtype or spec.dtype
        up = self.spectrogram_upsample1
        B, _, F_in, Ts = spec.shape
        taps, w = _gather_plan_on(F_in, Ts, T, up.kernel_size, up.stride,
                                  up.padding, spec.device)
        weight = up.weight.to(dt)                              # (I, O, kh, kw)
        out = None
        for kh, kw, i_f, i_t, mask in taps:
            xg = spec[:, :, i_f, i_t].to(dt) * mask.to(dt)      # (B, I, 2T)
            term = xg.transpose(1, 2) @ weight[:, :, kh, kw]    # (B, 2T, O)
            out = term if out is None else out + term
        out = torch.relu(out + up.bias.to(dt))
        wj = w.to(dt)[None, :, None]
        s = out[:, :T] * (1.0 - wj) + out[:, T:] * wj           # (B, T, H/2)
        return self._spec_head(s.transpose(1, 2), y)

    def conditioning_dense(self, y: torch.Tensor, spec: torch.Tensor,
                           T: int) -> torch.Tensor:
        """The reference's dense chain: the whole ConvTranspose plane →
        ReLU → flatten → lerp onto T → 1×1 convs → GTU.  The golden for
        :meth:`conditioning`."""
        dt = self.dtype or spec.dtype
        up = self.spectrogram_upsample1
        s = F.conv_transpose2d(spec.to(dt), up.weight.to(dt), up.bias.to(dt),
                               stride=up.stride, padding=up.padding)
        s = linear_interpolate_time(torch.relu(s).flatten(2), T)
        return self._spec_head(s, y)

    def denoise(self, x: torch.Tensor, cond: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        """ε̂ from a precomputed conditioning tensor: the per-step work."""
        se = self.step_embedding_mlp(
            sinusoidal_embedding(t.to(torch.promote_types(
                t.dtype, torch.float32)), self.hidden))
        h = self.input_conv(x) + se[:, :, None] + cond
        h1 = self.res_block1(h)
        h2 = self.res_block2(h1)
        h3 = self.res_block3(h2)
        h4 = self.res_block4(h3)
        h = self.layer_norm(self.skip_sum(h1 + h2 + h3 + h4))
        return self.final_projection(h)

    def forward(self, x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                spec: torch.Tensor) -> torch.Tensor:
        return self.denoise(x, self.conditioning(y, spec, x.shape[-1]), t)


def make_cached_denoiser(model: DiffEEG, y: torch.Tensor, spec: torch.Tensor,
                         length: int) -> Callable[..., torch.Tensor]:
    """A denoiser for the reverse samplers with the (y, spec) conditioning
    computed once: ``denoise_fn(x, y, t, spec)`` ignores its y and spec.
    The model runs in the mode it is in (samplers want ``eval()``)."""
    with torch.no_grad():
        cond = model.conditioning(y, spec, length)

    def denoise_fn(x, _y, t, _spec):
        return model.denoise(x, cond, t)
    return denoise_fn


def recombine_spectrograms(scores: torch.Tensor, spectrograms: torch.Tensor,
                           labels: torch.Tensor, n_classes: int = 6,
                           alpha: float = 0.5) -> torch.Tensor:
    """Same-class spectrogram mixup: ``α·spec[i] + (1−α)·spec[partner(i)]``
    with ``partner`` a random permutation within each class.

    ``scores`` (B,) are uniform draws from the caller's generator.  The
    samples are ordered by (label, score) (two stable sorts: by score, then
    by label), and each takes the one before it in its class's run as its
    partner; the first of a run keeps itself (unless every sample shares
    one class: then the order wraps round)."""
    o1 = torch.argsort(scores, stable=True)
    order = o1[torch.argsort(labels[o1], stable=True)]
    lab_sorted = labels[order]
    left_ok = torch.roll(lab_sorted, 1) == lab_sorted
    partner_sorted = torch.where(left_ok, torch.roll(order, 1), order)
    partner = torch.empty_like(order).scatter_(0, order, partner_sorted)
    return alpha * spectrograms + (1 - alpha) * spectrograms[partner]


class DiffEEGSanityCheck(nn.Module):
    """MLP autoencoder the reference trains on MNIST as a sanity check."""

    def __init__(self, input_dim: int = 784, hidden: int = 128):
        super().__init__()
        self.enc1 = nn.Linear(input_dim, hidden)
        self.enc2 = nn.Linear(hidden, hidden // 2)
        self.dec1 = nn.Linear(hidden // 2, hidden)
        self.dec2 = nn.Linear(hidden, input_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.enc1(x.reshape(x.shape[0], -1)))
        h = torch.relu(self.dec1(torch.relu(self.enc2(h))))
        return self.dec2(h).reshape(x.shape)
