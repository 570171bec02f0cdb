"""Data layer (counterpart of the JAX package's ``data/``): synthetic
fixtures, batching and host → device prefetch."""

from .batching import (batch_iterator, multimodal_batch_iterator,  # noqa: F401
                       prefetch_to_device)
from .dummy import (dummy_metadata, synthetic_raw_eeg,  # noqa: F401
                    synthetic_raw_spectrogram)
