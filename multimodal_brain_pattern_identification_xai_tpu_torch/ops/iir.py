"""IIR filtering: host-side design (float64) and plain PyTorch application.

Counterpart of the JAX package's ``ops/iir.py``.  Coefficients are designed
on the host with scipy in float64 and applied to float32 tensors as a
cascade of second-order sections (biquads) in transposed direct-form II,
the numerically sound form in float32.

Three plain PyTorch routes apply a cascade:

* :func:`_sos_scan`: the sequential scan over time (optionally from an
  initial state).  A NaN reaches only the outputs at and after it, as in
  scipy.
* :func:`_biquad_block_parallel`: one biquad, block-parallel: every
  block's zero-state response by a scan of the block's depth, the block
  entry states chained serially over the blocks, and their contribution
  added as one matmul.  Exact; optionally from an initial state (``z0``).
* :func:`_cascade_block_matmul`: the block-Toeplitz formulation (every
  128-sample block's zero-state response and exit state as one matmul, the
  block entry states chained by a log-depth scan), with an optional output
  operator (``out_map``) and initial state (``z0``).  Exact on finite
  input; a NaN smears back to the start of its block (0·NaN), so it is
  used on finite signals only.

:func:`lfilter` and :func:`filtfilt` take the JAX package's ``engine``
names, which pick the algorithm; the device picks the implementation.  The
sequential scan runs the kernels of :mod:`.cuda_iir` on a CUDA tensor and
:func:`_sos_scan` on a CPU tensor; the two block routes are stock torch
operations on either.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class FilterCoeffs(NamedTuple):
    """IIR filter: transfer function (b, a) plus an equivalent cascade of
    second-order sections, as hashable float tuples (cache keys)."""
    b: Tuple[float, ...]
    a: Tuple[float, ...]
    sos: Tuple[Tuple[float, ...], ...]  # K × (b0,b1,b2,a0,a1,a2)

    @property
    def order(self) -> int:
        return len(self.a) - 1

    @staticmethod
    def make(b, a, sos=None) -> "FilterCoeffs":
        """``sos`` defaults to the single section of a biquad (b, a)."""
        b = np.asarray(b, np.float64)
        a = np.asarray(a, np.float64)
        if sos is None:
            if max(len(b), len(a)) > 3:
                raise ValueError("pass sos for a filter of order above 2")
            sos = np.zeros((1, 6))
            sos[0, :len(b)] = b
            sos[0, 3:3 + len(a)] = a
        sos = np.asarray(sos, np.float64)
        return FilterCoeffs(
            tuple(b.tolist()), tuple(a.tolist()),
            tuple(tuple(row) for row in sos.tolist()))


# ---------------------------------------------------------------------------
# Host-side design (float64)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def butter_bandpass(low: float, high: float, fs: float,
                    order: int) -> FilterCoeffs:
    """Butterworth bandpass design."""
    from scipy.signal import butter
    nyq = 0.5 * fs
    wn = [low / nyq, high / nyq]
    b, a = butter(order, wn, btype="band")
    sos = butter(order, wn, btype="band", output="sos")
    return FilterCoeffs.make(b, a, sos)


@functools.lru_cache(maxsize=64)
def butter_lowpass(cutoff: float, fs: float, order: int) -> FilterCoeffs:
    """Butterworth lowpass design."""
    from scipy.signal import butter
    wn = cutoff / (0.5 * fs)
    b, a = butter(order, wn, btype="low")
    sos = butter(order, wn, btype="low", output="sos")
    return FilterCoeffs.make(b, a, sos)


def cascade(*filters: FilterCoeffs) -> FilterCoeffs:
    """Compose filters into one SOS cascade (LTI composition is exact)."""
    b = np.asarray([1.0])
    a = np.asarray([1.0])
    sos = []
    for f in filters:
        b = np.polymul(b, np.asarray(f.b))
        a = np.polymul(a, np.asarray(f.a))
        sos.extend(f.sos)
    return FilterCoeffs.make(b, a, np.asarray(sos))


@functools.lru_cache(maxsize=64)
def iirnotch(freq: float, quality: float, fs: float) -> FilterCoeffs:
    """Second-order IIR notch design."""
    from scipy.signal import iirnotch as _iirnotch
    b, a = _iirnotch(freq, quality, fs)
    return FilterCoeffs.make(b, a)


def _norm_section(sec: Tuple[float, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """One SOS row → (b[3], a[3]) normalized to a0 = 1."""
    s = np.asarray(sec, np.float64)
    b, a = s[:3], s[3:]
    return b / a[0], a / a[0]


def section_coefs(sos: Tuple[Tuple[float, ...], ...]) -> np.ndarray:
    """(K, 5) float32 ``(b0, b1, b2, a1, a2)`` per normalised section — the
    constants the sequential scan and the CUDA kernels multiply by."""
    rows = []
    for sec in sos:
        b, a = _norm_section(sec)
        rows.append((b[0], b[1], b[2], a[1], a[2]))
    return np.asarray(rows, np.float32)


def _sos_zi(coeffs: FilterCoeffs) -> np.ndarray:
    """Per-section steady-state unit-step DF2T state, (K, 2) — the SOS
    analogue of ``scipy.signal.lfilter_zi`` (``sosfilt_zi``)."""
    return _steady_state(coeffs.sos)


@functools.lru_cache(maxsize=64)
def _steady_state(sos: Tuple[Tuple[float, ...], ...]) -> np.ndarray:
    from scipy.signal import lfilter_zi
    zis = []
    gain = 1.0
    for sec in sos:
        b, a = _norm_section(sec)
        zis.append(lfilter_zi(b, a) * gain)
        gain *= b.sum() / a.sum()   # section DC gain scales the next input
    return np.asarray(zis, np.float64)


def _section_state_space(sec: Tuple[float, ...]):
    """Biquad DF2T as ``z' = A z + B x``, ``y = C z + D x``."""
    b, a = _norm_section(sec)
    A = np.array([[-a[1], 1.0], [-a[2], 0.0]])
    B = np.array([b[1] - a[1] * b[0], b[2] - a[2] * b[0]])
    C = np.array([1.0, 0.0])
    return A, B, C, float(b[0])


@functools.lru_cache(maxsize=256)
def _block_operators(sec: Tuple[float, ...], block: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``A^block`` (2, 2) and the (block, 2) observation matrix ``O[t] =
    C A^t`` of one biquad, float64."""
    A, _, C, _ = _section_state_space(sec)
    obs = np.zeros((block, 2))
    Ak = np.eye(2)
    for t in range(block):
        obs[t] = C @ Ak
        Ak = Ak @ A
    return np.linalg.matrix_power(A, block), obs


def _compose_state_space(sos: Tuple[Tuple[float, ...], ...]):
    """The K-section cascade as one (A, B, C, D) system whose state is the
    concatenation of the per-section DF2T states, with
    ``z[t] = A z[t-1] + B x[t]``, ``y[t] = C z[t-1] + D x[t]``."""
    A = np.zeros((0, 0))
    B = np.zeros((0,))
    Cc = np.zeros((0,))
    D = 1.0
    for sec in sos:
        Ak, Bk, Ck, Dk = _section_state_space(sec)
        n = A.shape[0]
        A2 = np.zeros((n + 2, n + 2))
        A2[:n, :n] = A
        A2[n:, :n] = np.outer(Bk, Cc)       # next section driven by y_k
        A2[n:, n:] = Ak
        B = np.concatenate([B, Bk * D])
        Cc = np.concatenate([Dk * Cc, Ck])
        A = A2
        D = Dk * D
    return A, B, Cc, D


@functools.lru_cache(maxsize=256)
def _cascade_block_matmul_ops(sos: Tuple[Tuple[float, ...], ...],
                              block: int):
    """Float64 operators of the block-Toeplitz formulation of a cascade:
    ``L`` (block, block) zero-state impulse-response Toeplitz, ``S``
    (block, 2K) block inputs → exit state, ``A_blk`` (2K, 2K) = ``A^block``,
    ``obs`` (block, 2K) entry state → outputs (``C A^t``)."""
    A, B, C, D = _compose_state_space(sos)
    n = A.shape[0]
    h = np.zeros(block)
    S = np.zeros((block, n))
    z = np.zeros(n)
    for t in range(block):
        x_t = 1.0 if t == 0 else 0.0
        h[t] = C @ z + D * x_t
        z = A @ z + B * x_t
    S[block - 1] = B
    for s in range(block - 2, -1, -1):
        S[s] = A @ S[s + 1]                 # A^{block-1-s} B
    idx = np.arange(block)
    L = np.where(idx[:, None] >= idx[None, :],
                 h[idx[:, None] - idx[None, :]], 0.0)
    obs = np.zeros((block, n))
    Ak = np.eye(n)
    for t in range(block):
        obs[t] = C @ Ak
        Ak = Ak @ A
    return L, S, Ak, obs


def _float32_sections(sos: Tuple[Tuple[float, ...], ...]
                      ) -> Tuple[Tuple[float, ...], ...]:
    """The cascade the float32 scans run: each section's normalised
    coefficients rounded to float32, as SOS rows."""
    return tuple((b0, b1, b2, 1.0, a1, a2) for b0, b1, b2, a1, a2
                 in section_coefs(sos).astype(np.float64).tolist())


@functools.lru_cache(maxsize=64)
def _chunk_ops(sos: Tuple[Tuple[float, ...], ...], chunk: int):
    """Constants of the chunked scan (``_chunked_sos_scan`` and the CUDA
    kernels): ``coef`` (K, 5) float32 as :func:`section_coefs`, the unit
    steady state ``zi`` (K, 2) float32, and ``A^chunk`` (2K, 2K) float64 in
    the same state order (``zi.reshape(-1)``).  ``A`` is that of the
    float32-rounded sections the scans run, not of the float64 design: with
    poles this close to z = 1 the two differ enough to cost the chain its
    accuracy.  The power is built by the products of
    :func:`_cascade_block_matmul_ops`."""
    A = _compose_state_space(_float32_sections(sos))[0]
    A_pow = np.eye(A.shape[0])
    for _ in range(chunk):
        A_pow = A_pow @ A
    return section_coefs(sos), _steady_state(sos).astype(np.float32), A_pow


# ---------------------------------------------------------------------------
# Plain PyTorch application
# ---------------------------------------------------------------------------

def _sos_scan(x: torch.Tensor, sos: Tuple[Tuple[float, ...], ...],
              zi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential SOS cascade over the last axis.

    ``x``: (..., T); ``zi``: DF2T state per section broadcastable to
    (..., K, 2), or None for zeros."""
    return _df2t_scan(x, sos, zi)[0]


def _df2t_scan(x: torch.Tensor, sos: Tuple[Tuple[float, ...], ...],
               zi: Optional[torch.Tensor] = None):
    """:func:`_sos_scan` that also returns the final state (..., K, 2)."""
    coef = section_coefs(sos).tolist()
    K = len(coef)
    batch = x.shape[:-1]
    if zi is None:
        z0 = [x.new_zeros(batch) for _ in range(K)]
        z1 = [x.new_zeros(batch) for _ in range(K)]
    else:
        zi = zi.to(x.dtype).expand(batch + (K, 2))
        z0 = [zi[..., k, 0].clone() for k in range(K)]
        z1 = [zi[..., k, 1].clone() for k in range(K)]
    xt = x.movedim(-1, 0)
    ys = torch.empty_like(xt)
    for t in range(xt.shape[0]):
        v = xt[t]
        for k, (b0, b1, b2, a1, a2) in enumerate(coef):
            y = torch.add(z0[k], v, alpha=b0)                 # b0 v + z0
            z0[k] = torch.add(z1[k], v, alpha=b1).sub_(y, alpha=a1)
            z1[k] = torch.mul(v, b2).sub_(y, alpha=a2)
            v = y
        ys[t] = v
    return ys.movedim(0, -1), torch.stack([torch.stack(z0, -1),
                                           torch.stack(z1, -1)], -1)


def _biquad_block_parallel(x: torch.Tensor, sec: Tuple[float, ...],
                           block: int,
                           z0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One biquad along the last axis of ``x`` (..., T), block-parallel and
    exact, from the per-lane DF2T state ``z0`` (broadcastable to (..., 2);
    zeros if None).  Every block's zero-state response and exit state come
    from one scan of depth ``block`` over all blocks at once; the entry
    states chain serially over the blocks, ``z[k+1] = A^block z[k] +
    exit[k]``, in the input's dtype; ``y += O @ z[k]`` adds them."""
    T = x.shape[-1]
    pad = (-T) % block
    if pad:
        x = F.pad(x, (0, pad))
    n_blocks = x.shape[-1] // block
    batch = x.shape[:-1]
    dt, dev = x.dtype, x.device
    A_blk_np, obs_np = _block_operators(tuple(sec), block)
    A_blk = torch.as_tensor(A_blk_np, dtype=dt, device=dev)
    obs = torch.as_tensor(obs_np, dtype=dt, device=dev)

    y_zs, z_zs = _df2t_scan(x.reshape(batch + (n_blocks, block)), (sec,))
    z = (x.new_zeros(batch + (2,)) if z0 is None
         else z0.to(dt).expand(batch + (2,)))
    entry = []
    for k in range(n_blocks):
        entry.append(z)
        z = z @ A_blk.T + z_zs[..., k, 0, :]
    y = y_zs + torch.stack(entry, -2) @ obs.T
    return y.reshape(batch + (n_blocks * block,))[..., :T]


def _chunked_sos_scan(x: torch.Tensor, sos: Tuple[Tuple[float, ...], ...],
                      chunk: int, zi: Optional[torch.Tensor] = None,
                      rolldec: bool = False) -> torch.Tensor:
    """The CUDA kernels' chunked scan, vectorised over (lanes × chunks);
    equal to :func:`_sos_scan` up to float32 rounding.  Only the tests use
    it: a wrapper's CPU path is the sequential scan.

    Time is cut into chunks of ``chunk`` samples (the last one ragged).
    Pass A scans every chunk j from a seed — chunk 0 from the initial state
    ``zi`` (as in :func:`_sos_scan`), chunk j ≥ 1 from the steady state of
    its own first sample ``w_j = zi_unit · x[j·chunk]``, so that a DC
    offset leaves no large transient to cancel — and keeps its exit state.
    The chain, serial over chunks and in float64, gives every entry state:
    ``e_1 = exit_0``, ``e_{j+1} = A^chunk (e_j − w_j) + exit_j``; nothing
    is truncated, so a NaN reaches every later chunk.  Pass C rescans each
    chunk from ``e_j``.  ``rolldec``: then the mean of y[4u..4u+3] (T % 4
    == 0, chunk % 4 == 0)."""
    T = x.shape[-1]
    batch = x.shape[:-1]
    n_chunks = -(-T // chunk)
    _, zi_unit, a_pow = _chunk_ops(tuple(sos), chunk)
    K = zi_unit.shape[0]
    xc = F.pad(x, (0, n_chunks * chunk - T)).reshape(
        batch + (n_chunks, chunk))
    seed = torch.as_tensor(zi_unit, dtype=x.dtype) * xc[..., :1, None]
    seed[..., 0, :, :] = 0.0 if zi is None else zi.to(x.dtype)
    _, exits = _df2t_scan(xc, sos, seed)
    a_pow = torch.as_tensor(a_pow)
    seed, exits = seed.flatten(-2).double(), exits.flatten(-2).double()
    entry = [seed[..., 0, :]]                              # (..., 2K) each
    for j in range(1, n_chunks):
        entry.append(exits[..., 0, :] if j == 1 else
                     (entry[-1] - seed[..., j - 1, :]) @ a_pow.T
                     + exits[..., j - 1, :])
    entry = torch.stack(entry, -2).to(x.dtype).unflatten(-1, (K, 2))
    y = _df2t_scan(xc, sos, entry)[0].reshape(batch + (-1,))[..., :T]
    if not rolldec:
        return y
    y = y.reshape(batch + (T // 4, 4))
    return (y[..., 0] + y[..., 1] + y[..., 2] + y[..., 3]) * 0.25


def _chain_entry_states(z_zs: torch.Tensor, A_blk: np.ndarray) -> torch.Tensor:
    """Entry state of every block, ``z_entry[n] = Σ_{m<n} A_blk^{n-1-m}
    z_zs[m]``, by a Hillis-Steele scan whose level j applies the constant
    ``A_blk^(2^j)``.  Levels whose matrix has decayed below 1e-10 (below
    float32 resolution of the states) are exact no-ops and are skipped.
    ``z_zs``: (..., n, 2K)."""
    n = z_zs.shape[-2]
    s = z_zs
    A_pow = np.asarray(A_blk, np.float64)
    shift = 1
    while shift < n:
        if np.abs(A_pow).max() < 1e-10:
            break
        Aj = torch.as_tensor(A_pow, dtype=s.dtype, device=s.device)
        shifted = F.pad(s, (0, 0, shift, 0))[..., :n, :]
        s = s + shifted @ Aj.T
        A_pow = A_pow @ A_pow
        shift *= 2
    return F.pad(s, (0, 0, 1, 0))[..., :n, :]


def _cascade_block_matmul(x: torch.Tensor,
                          sos: Tuple[Tuple[float, ...], ...],
                          block: int = 128,
                          out_map: Optional[np.ndarray] = None,
                          z0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whole cascade along the last axis as block-Toeplitz matmuls.

    ``out_map``: optional (block_out, block) operator applied to each
    block's output (e.g. rolling-mean-4 + ::4); the output then has
    ``block_out`` samples per block.  ``z0``: optional initial state
    broadcastable to (..., 2K), in the concatenated per-section layout
    (``_sos_zi(...).reshape(-1)`` order)."""
    T = x.shape[-1]
    pad = (-T) % block
    if pad:
        x = F.pad(x, (0, pad))
    n_blocks = x.shape[-1] // block
    batch = x.shape[:-1]
    dt, dev = x.dtype, x.device

    L_np, S_np, A_blk_np, obs_np = _cascade_block_matmul_ops(tuple(sos), block)
    if out_map is not None:
        L_np = out_map @ L_np
        obs_np = out_map @ obs_np
    LS = torch.as_tensor(np.concatenate([L_np.T, S_np], axis=-1), dtype=dt,
                         device=dev)                  # (block, bo + 2K)
    obs = torch.as_tensor(obs_np, dtype=dt, device=dev)
    bo = L_np.shape[0]

    zz = x.reshape(batch + (n_blocks, block)) @ LS
    y_zs, z_zs = zz[..., :bo], zz[..., bo:]
    if z0 is not None:
        z0 = z0.to(dt).expand(batch + (z_zs.shape[-1],))
        A_blk = torch.as_tensor(A_blk_np, dtype=dt, device=dev)
        # z_entry[n≥1] gains A_blk^n z0: fold it into block 0's exit state
        z_zs = z_zs.clone()
        z_zs[..., 0, :] += z0 @ A_blk.T
    z_entry = _chain_entry_states(z_zs, A_blk_np)
    if z0 is not None:
        z_entry[..., 0, :] = z0
    y = (y_zs + z_entry @ obs.T).reshape(batch + (n_blocks * bo,))
    T_out = T if out_map is None else (T * bo + block - 1) // block
    return y[..., :T_out]


def lfilter(coeffs: FilterCoeffs, x: torch.Tensor, axis: int = -1,
            zi: Optional[torch.Tensor] = None,
            block_size: Optional[int] = 128,
            engine: str = "auto") -> torch.Tensor:
    """``scipy.signal.sosfilt`` along ``axis``; all other axes are
    independent lanes.

    ``zi``: the initial DF2T state of every section, broadcastable to
    (lanes..., K, 2), or None for zeros.  ``engine`` and ``block_size``
    pick the algorithm by the JAX package's rules:

    * ``"blockmm"`` without ``zi`` on more than ``block_size`` (128 if
      None) samples: :func:`_cascade_block_matmul`;
    * ``"auto"``, ``"pallas"``, ``"scan"``, any ``zi``, ``block_size=None``
      or at most ``block_size`` samples: the sequential scan (the CUDA
      kernel on a CUDA tensor, from ``zi`` where given; :func:`_sos_scan`
      on a CPU tensor);
    * any other name (``"block"``, ``"xla"``, ...):
      :func:`_biquad_block_parallel` once a section."""
    x = x.movedim(axis, -1)
    T = x.shape[-1]
    if engine == "blockmm" and zi is None and T > (block_size or 128):
        y = _cascade_block_matmul(x, coeffs.sos, block_size or 128)
    elif (engine in ("auto", "pallas", "scan") or zi is not None
          or block_size is None or T <= block_size):
        from .cuda_iir import sosfilt
        y = sosfilt(coeffs, x, zi=zi)
    else:
        y = x
        for sec in coeffs.sos:
            y = _biquad_block_parallel(y, sec, block_size)
    return y.movedim(-1, axis)


def _odd_extension(coeffs: FilterCoeffs, x: torch.Tensor,
                   padlen: Optional[int]) -> Tuple[torch.Tensor, int]:
    """``x`` (..., T) extended at both ends by ``padlen`` samples (default
    ``3·max(len a, len b)``, scipy's) reflected about the end samples, and
    that ``padlen``."""
    if padlen is None:
        padlen = 3 * max(len(coeffs.a), len(coeffs.b))
    T = x.shape[-1]
    if T <= padlen:
        raise ValueError(f"signal length {T} must exceed padlen {padlen}")
    left = 2 * x[..., :1] - x[..., 1:padlen + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -padlen - 1:-1].flip(-1)
    return torch.cat([left, x, right], dim=-1), padlen


def filtfilt(coeffs: FilterCoeffs, x: torch.Tensor, axis: int = -1,
             padlen: Optional[int] = None,
             engine: str = "auto") -> torch.Tensor:
    """Zero-phase filtering with ``scipy.signal.filtfilt`` semantics (odd
    extension by ``3·max(len a, len b)``, ``lfilter_zi`` initial state).
    ``engine="blockmm"``: both passes by :func:`_cascade_block_matmul` from
    the steady state; any other name: :func:`.cuda_iir.filtfilt` (the CUDA
    kernel on a CUDA tensor, the sequential scan on a CPU tensor)."""
    x = x.movedim(axis, -1)
    if engine != "blockmm":
        from .cuda_iir import filtfilt as _filtfilt
        return _filtfilt(coeffs, x, padlen).movedim(-1, axis)
    T = x.shape[-1]
    ext, padlen = _odd_extension(coeffs, x, padlen)
    zf = torch.as_tensor(_sos_zi(coeffs).reshape(-1), dtype=x.dtype,
                         device=x.device)
    y = _cascade_block_matmul(ext, coeffs.sos, z0=zf * ext[..., :1]).flip(-1)
    y = _cascade_block_matmul(y, coeffs.sos, z0=zf * y[..., :1]).flip(-1)
    return y[..., padlen:padlen + T].movedim(-1, axis)
