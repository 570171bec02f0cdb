"""The typed configuration tree.

A copy of the JAX package's ``config.py`` (the port imports nothing from
that package): the channel and class vocabulary, the preprocessing,
augmentation, trainer, DiffEEG, path and mesh dataclasses, the root
:class:`Config`, and its YAML loading with ``key.path=value`` overrides
(:func:`load_config`, :func:`dump_yaml`).  Values reproduce the
reference's defaults.  PyYAML is imported only to read or write a YAML
file; overrides need no YAML.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

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
    """The HMS dataset's and the run's locations: ``train.csv``, the EEG
    parquet directory and the spectrogram parquet directory under
    ``data_root`` (``${data_root}`` is resolved by :func:`load_config`),
    and the artifact directories."""
    data_root: str = "/data/hms"
    train_csv: str = "${data_root}/train.csv"
    train_eegs: str = "${data_root}/train_eegs/"
    train_spectr: str = "${data_root}/train_spectrograms/"
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    plot_dir: str = "plots"

    @classmethod
    def at(cls, data_root: str) -> "PathsConfig":
        """The dataset's standard layout under ``data_root``, resolved."""
        return cls(data_root=data_root, train_csv=f"{data_root}/train.csv",
                   train_eegs=f"{data_root}/train_eegs/",
                   train_spectr=f"{data_root}/train_spectrograms/")


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes of the parallel programs (``parallel.make_mesh``:
    one rank a device; ``data`` splits batches, ``model`` the
    tensor-parallel head, ``seq`` the time axis of long EEG)."""
    data: int = -1                    # -1 → all remaining devices
    model: int = 1                    # tensor-parallel axis
    seq: int = 1                      # sequence-parallel axis


@dataclass(frozen=True)
class Config:
    """Root config object."""
    seed: int = 42
    debug: bool = False
    augment: bool = False
    validation_frac: float = 0.4
    n_folds: int = N_FOLDS
    paths: PathsConfig = field(default_factory=PathsConfig)
    signal: SignalConfig = field(default_factory=SignalConfig)
    bandpass: BandpassConfig = field(default_factory=BandpassConfig)
    eeg_transform: EEGTransformConfig = field(
        default_factory=EEGTransformConfig)
    hms: HMSPreprocessConfig = field(default_factory=HMSPreprocessConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    diffeeg: DiffEEGConfig = field(default_factory=DiffEEGConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # the vocabulary, kept on the object so callers need no globals
    classes: Tuple[str, ...] = CLASSES
    eeg_columns: Tuple[str, ...] = EEG_COLUMNS
    eeg_features: Tuple[str, ...] = EEG_FEATURES
    map_features: Tuple[Tuple[str, str], ...] = MAP_FEATURES

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    @property
    def n_model_channels(self) -> int:
        """Channels the HMS EEG models see: 19 scalp + 18 bipolar = 37."""
        return len(self.eeg_features) + len(self.map_features)


# ---------------------------------------------------------------------------
# YAML / command-line loading

def _interp(value: Any, root: Dict[str, Any]) -> Any:
    """``${key}`` string interpolation from the document's top-level
    string values."""
    if isinstance(value, str):
        for k, v in root.items():
            if isinstance(v, str):
                value = value.replace("${%s}" % k, v)
    return value


def _deep_tuple(v: Any) -> Any:
    if isinstance(v, (list, tuple)):
        return tuple(_deep_tuple(x) for x in v)
    return v


def _update_dataclass(obj: Any, updates: Dict[str, Any]) -> Any:
    """Recursively apply a dict of overrides onto a (frozen) dataclass."""
    if not dataclasses.is_dataclass(obj):
        return updates
    kwargs = {}
    for f in dataclasses.fields(obj):
        if f.name in updates:
            cur = getattr(obj, f.name)
            upd = updates[f.name]
            if dataclasses.is_dataclass(cur) and isinstance(upd, dict):
                kwargs[f.name] = _update_dataclass(cur, upd)
            elif isinstance(cur, tuple) and isinstance(upd, list):
                # YAML has no tuples: keep tuple-typed fields (vocabulary,
                # montage pairs, image_size) hashable on reload
                kwargs[f.name] = _deep_tuple(upd)
            else:
                kwargs[f.name] = upd
    return dataclasses.replace(obj, **kwargs)


def dump_yaml(cfg: Config) -> str:
    """A :class:`Config` as YAML that :func:`load_config` reads back, the
    paths under ``data_root`` written as ``${data_root}/...`` so that a
    reloaded file follows a ``paths.data_root`` override.  Needs PyYAML."""
    import yaml

    def clean(o: Any) -> Any:
        if dataclasses.is_dataclass(o):
            return {f.name: clean(getattr(o, f.name))
                    for f in dataclasses.fields(o)}
        if isinstance(o, (list, tuple)):
            return [clean(x) for x in o]
        return o

    doc = clean(cfg)
    root = doc["paths"].get("data_root", "")
    if root:
        for k, v in doc["paths"].items():
            if k != "data_root" and isinstance(v, str) \
                    and v.startswith(root):
                doc["paths"][k] = "${data_root}" + v[len(root):]
    return yaml.safe_dump(doc, sort_keys=False, width=78)


def load_config(path: Optional[str] = None,
                overrides: Optional[Sequence[str]] = None) -> Config:
    """A :class:`Config`: the defaults, then the YAML file at ``path``
    (needs PyYAML), then ``key.subkey=value`` overrides (Python literals,
    YAML's ``true``/``false``, else the string), then ``${data_root}``
    resolved in the path fields."""
    cfg = Config()
    if path is not None:
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        flat = {k: v for k, v in raw.items() if isinstance(v, str)}
        raw = {k: _interp(v, flat) for k, v in raw.items()}
        cfg = _update_dataclass(cfg, raw)
    for ov in overrides or ():
        key, _, val = ov.partition("=")
        try:
            pyval: Any = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            # ``--set diffeeg.amp=false`` must not become the truthy
            # string "false"
            pyval = {"true": True, "false": False}.get(val.lower(), val)
        parts = key.split(".")
        d: Dict[str, Any] = {parts[-1]: pyval}
        for p in reversed(parts[:-1]):
            d = {p: d}
        cfg = _update_dataclass(cfg, d)
    # after the overrides, so that ``paths.data_root=...`` moves every
    # derived path
    paths = cfg.paths
    resolved = {
        f.name: getattr(paths, f.name).replace("${data_root}",
                                               paths.data_root)
        for f in dataclasses.fields(paths)
        if isinstance(getattr(paths, f.name), str)
    }
    return dataclasses.replace(cfg, paths=dataclasses.replace(
        paths, **resolved))


def feature_to_index(columns: Sequence[str] = EEG_COLUMNS) -> Dict[str, int]:
    """Channel-name → row-index map."""
    return {name: i for i, name in enumerate(columns)}
