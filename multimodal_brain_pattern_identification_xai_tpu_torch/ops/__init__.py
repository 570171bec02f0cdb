"""Signal-processing ops (PyTorch; CUDA kernels in :mod:`.cuda_iir` and
:mod:`.cuda_specblock`, and the conv probe's in :mod:`.cuda_duty`)."""

from .iir import (  # noqa: F401
    FilterCoeffs,
    butter_bandpass,
    butter_lowpass,
    iirnotch,
    lfilter,
    filtfilt,
)
from .montage import (  # noqa: F401
    montage_matrix,
    apply_montage,
    bipolar_differential,
    chris_magic_ch8,
)
from .normalize import (  # noqa: F401
    zscore,
    minmax,
    clip_scale,
    mu_law_encode,
    baseline_correction,
)
from .nanfix import nan_to_channel_mean  # noqa: F401
from .resample import (decimate, rolling_mean4_flat,  # noqa: F401
                       rolling_mean4_decimate_flat, pad_or_truncate)
from .smooth import gaussian_smooth2d  # noqa: F401
from . import preprocess  # noqa: F401
from .preprocess import (  # noqa: F401
    eeg_transform,
    hms_eeg_preprocess,
    hms_spectrogram_preprocess,
    preprocess_multimodal,
    mirror_eeg,
)
from .cuda_specblock import fused_specblock_convpool  # noqa: F401
from .augment import spectrogram_augment  # noqa: F401
from .stft import stft, stft_log1p_interp  # noqa: F401
