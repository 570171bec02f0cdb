"""Data layer (counterpart of the JAX package's ``data/``): ``train.csv``
and parquet readers, window cropping, the EEG window cache, the real-data
sources, synthetic fixtures, batching and host → device prefetch."""

from .batching import (batch_iterator, multimodal_batch_iterator,  # noqa: F401
                       prefetch_to_device)
from .dummy import (dummy_eeg_dataset, dummy_metadata,  # noqa: F401
                    synthetic_raw_eeg, synthetic_raw_spectrogram,
                    write_synthetic_hms_tree)
from .loader import (ColumnTable, EEGRecordCache,  # noqa: F401
                     crop_eeg_window, crop_spectrogram, load_eeg_parquet,
                     load_spectrogram_parquet, load_train_metadata)
from .hms import (MultimodalSource, SpectrogramStore,  # noqa: F401
                  aggregate_votes_by_eeg, build_or_load_eeg_cache,
                  multimodal_source, onehot_consensus, wavenet_arrays)
