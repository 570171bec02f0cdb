"""Utilities (counterpart of the JAX package's ``utils/``): loggers,
seeding, plots (matplotlib optional) and tracing / timing."""

from .logging import get_logger, setup_file_logger, WandbLogger  # noqa: F401
from .seed import seed_everything  # noqa: F401
from .plotting import (plot_training_curves, plot_confusion_matrix,  # noqa: F401
                       plot_class_distribution, plot_real_vs_generated,
                       plot_saliency_heatmap, plot_sample_grid,
                       plot_lr_and_regularization, plot_spectrogram_pair,
                       plot_stft_comparison, model_summary)
from .profiling import trace, benchmark_fn  # noqa: F401
