"""Signal-processing ops of the serving slice (PyTorch; CUDA kernels in
:mod:`.cuda_iir` and :mod:`.cuda_specblock`, and the conv probe's in
:mod:`.cuda_duty`)."""

from .preprocess import (hms_eeg_preprocess, hms_spectrogram_preprocess,
                         preprocess_multimodal)

__all__ = ["hms_eeg_preprocess", "hms_spectrogram_preprocess",
           "preprocess_multimodal"]
