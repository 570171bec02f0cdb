"""Configuration subset of the ported slices.

A copy of the channel and class vocabulary, the preprocessing, augmentation,
trainer and DiffEEG dataclasses of the JAX package's ``config.py`` (the port
imports nothing from that package).  Values reproduce the reference's
defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

#: Raw parquet column order, incl. EKG.
EEG_COLUMNS: Tuple[str, ...] = (
    "Fp1", "F3", "C3", "P3", "F7", "T3", "T5", "O1", "Fz", "Cz", "Pz",
    "Fp2", "F4", "C4", "P4", "F8", "T4", "T6", "O2", "EKG",
)

#: Classification targets.
CLASSES: Tuple[str, ...] = ("Seizure", "LPD", "GPD", "LRDA", "GRDA", "Other")
NAME2LABEL: Dict[str, int] = {name: i for i, name in enumerate(CLASSES)}
N_CLASSES: int = len(CLASSES)

#: Per-class vote columns of ``train.csv``.
TGT_VOTE_COLS: Tuple[str, ...] = (
    "seizure_vote", "lpd_vote", "gpd_vote", "lrda_vote", "grda_vote",
    "other_vote",
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

#: Chris' magic-8 bipolar pairs.
CHRIS_MAGIC_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("Fp1", "T3"), ("T3", "O1"),
    ("Fp1", "C3"), ("C3", "O1"),
    ("Fp2", "C4"), ("C4", "O2"),
    ("Fp2", "T4"), ("T4", "O2"),
)

#: Brain-region channel groups (mirror augmentation).
LL: Tuple[str, ...] = ("Fp1", "F7", "T3", "T5", "O1")
LP: Tuple[str, ...] = ("Fp1", "F3", "C3", "P3", "O1")
RL: Tuple[str, ...] = ("Fp2", "F8", "T4", "T6", "O2")
RP: Tuple[str, ...] = ("Fp2", "F4", "C4", "P4", "O2")


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
    #: how the spectrogram chain reaches ``image_size``: "pad" zero-pads or
    #: crops (the reference's chain); "resample" anti-alias-resizes the raw
    #: plane (``ops.resample.resize_antialiased``, skimage ``resize(...,
    #: anti_aliasing=True)`` semantics), the reduced-resolution preset
    resize_mode: str = "pad"


#: The reduced-resolution serving preset: raw planes anti-alias-resized to
#: 200x150 (the JAX bench's ``BENCH_SPEC_RES=200x150``; CLI ``--set
#: signal.image_size=[200,150] --set signal.resize_mode=resample``).
SPEC_RES_PRESET = SignalConfig(image_size=(200, 150), resize_mode="resample")


@dataclass(frozen=True)
class EEGTransformConfig:
    """Flags of the raw-EEG transformer chain (``ops.eeg_transform``)."""
    n_feats: int = 19
    apply_chris_magic_ch8: bool = False
    normalize: bool = True
    apply_butter_lowpass_filter: bool = True
    apply_mu_law_encoding: bool = False
    downsample: Optional[int] = 5
    lowpass_cutoff_hz: float = 20.0
    lowpass_order: int = 4
    clip_value: float = 1024.0
    scale: float = 32.0


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


@dataclass(frozen=True)
class SpecAugmentConfig:
    """Spectrogram train-time augmentation (``ops.augment``): MixUp against
    a reference pool (p=0.5, λ ~ Beta(α, α)), then one full-height time
    stripe and one full-width frequency stripe of CoarseDropout (extent
    6-10 % of the axis, p=0.5 each)."""
    mixup_prob: float = 0.5
    mixup_alpha: float = 0.4
    dropout_prob: float = 0.5         # per stripe family
    stripe_frac: Tuple[float, float] = (0.06, 0.1)


@dataclass(frozen=True)
class TrainerConfig:
    """Classifier trainer parameters (the reference's trainer defaults);
    the epoch loop's own settings are ``train.TrainerConfig``."""
    epochs: int = 50
    lr: float = 1e-3
    batch_size: int = 256
    use_amp: bool = True              # → the bf16 spectrogram branch
    grad_accum_steps: int = 1
    ckpt_metric: str = "kldiv"
    ckpt_mode: str = "min"
    es_patience: int = 0
    step_per_batch: bool = True
    weight_decay: float = 0.0
    l2_lambda: float = 0.0            # manual L2 term added to the loss
    warmup_epochs: int = 5
    seed: int = 42


@dataclass(frozen=True)
class DiffEEGConfig:
    """DiffEEG diffusion trainer and model parameters."""
    epochs: int = 10
    n_channels: int = 19
    input_length: int = 2_000
    n_classes: int = 6
    hidden_channels: int = 32
    #: the reference's setting; the model has four residual blocks
    #: whatever its value
    n_residual_layers: int = 16
    dropout: float = 0.1
    n_diffusion_steps: int = 1_000
    ema_decay: float = 0.995
    step_start_ema: int = 20
    update_ema_every: int = 10
    save_and_sample_every: int = 200
    gradient_accumulate_every: int = 50
    evaluate_every: int = 50
    lr: float = 1e-5
    batch_size: int = 64
    min_steps: int = 10_000
    # STFT conditioning parameters
    stft_n_fft: int = 64
    stft_noverlap: int = 32
    stft_window: str = "hann"
    #: recompute the denoiser's activations in backward
    #: (``torch.utils.checkpoint``): less memory, more work
    remat: bool = False
    #: fold this many accumulation micro-batches into one forward and
    #: backward (must divide ``gradient_accumulate_every``); the averaged
    #: gradient is the same, the batch of a pass is ``fuse_accum`` times
    #: larger
    fuse_accum: int = 1
    #: bf16 compute in the denoiser's dense and conv layers (parameters,
    #: norms, the loss and the optimizer state stay float32)
    amp: bool = False


#: Cross-validation folds of the real-data training commands.
N_FOLDS: int = 5


@dataclass(frozen=True)
class PathsConfig:
    """The HMS dataset's locations: ``train.csv``, the EEG parquet
    directory and the spectrogram parquet directory (the JAX package's
    ``PathsConfig`` with ``${data_root}`` resolved)."""
    data_root: str
    train_csv: str
    train_eegs: str
    train_spectr: str

    @classmethod
    def at(cls, data_root: str) -> "PathsConfig":
        """The dataset's standard layout under ``data_root``."""
        return cls(data_root, f"{data_root}/train.csv",
                   f"{data_root}/train_eegs/",
                   f"{data_root}/train_spectrograms/")


def feature_to_index(columns: Sequence[str] = EEG_COLUMNS) -> Dict[str, int]:
    """Channel-name → row-index map."""
    return {name: i for i, name in enumerate(columns)}
