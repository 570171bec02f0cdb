"""Configuration subset of the serving slice.

A copy of the channel vocabulary and the preprocessing dataclasses of the
JAX package's ``config.py`` (the port imports nothing from that package).
Values reproduce the reference's defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

#: Raw parquet column order, incl. EKG.
EEG_COLUMNS: Tuple[str, ...] = (
    "Fp1", "F3", "C3", "P3", "F7", "T3", "T5", "O1", "Fz", "Cz", "Pz",
    "Fp2", "F4", "C4", "P4", "F8", "T4", "T6", "O2", "EKG",
)

#: The 19 scalp channels used as model features.
EEG_FEATURES: Tuple[str, ...] = EEG_COLUMNS[:-1]

#: 18 bipolar montage pairs (the double-banana montage).
MAP_FEATURES: Tuple[Tuple[str, str], ...] = (
    ("Fp1", "F7"), ("F7", "T3"), ("T3", "T5"), ("T5", "O1"),
    ("Fp1", "F3"), ("F3", "C3"), ("C3", "P3"), ("P3", "O1"),
    ("Fp2", "F8"), ("F8", "T4"), ("T4", "T6"), ("T6", "O2"),
    ("Fp2", "F4"), ("F4", "C4"), ("C4", "P4"), ("P4", "O2"),
    ("Fz", "Cz"), ("Cz", "Pz"),
)


@dataclass(frozen=True)
class BandpassConfig:
    """Butterworth bandpass parameters."""
    low: float = 0.5
    high: float = 20.0
    order: int = 2


@dataclass(frozen=True)
class SignalConfig:
    """Raw-EEG timing and shape parameters."""
    sampling_rate: int = 200          # Hz
    seq_length_s: int = 50            # seconds
    n_samples: int = 10_000           # sampling_rate * seq_length_s
    out_samples: int = 2_000          # n_samples // downsample
    fixed_length: int = 3_000         # HMS_EEG_Dataset target length
    in_channels: int = 19             # scalp channels (no EKG)
    n_raw_channels: int = 20          # parquet columns incl. EKG
    image_size: Tuple[int, int] = (400, 300)  # spectrogram (F, T)
    #: only "pad" is ported: zero-pad/crop to ``image_size``
    resize_mode: str = "pad"


@dataclass(frozen=True)
class HMSPreprocessConfig:
    """The HMS_EEG_Dataset preprocessing chain."""
    bandpass: BandpassConfig = field(default_factory=BandpassConfig)
    first_bandpass_order: int = 5
    denoise_bandpass_order: int = 6
    decimate_stride: int = 4
    zscore_eps: float = 1e-6
    notch_freq_hz: float = 60.0
    notch_quality: float = 30.0
    gaussian_sigma: float = 1.0
