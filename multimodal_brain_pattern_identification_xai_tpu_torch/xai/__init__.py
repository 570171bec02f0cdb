"""XAI (counterpart of the JAX package's ``xai/``): input-gradient
attribution — saliency, integrated gradients, expected gradients /
gradient SHAP and Grad-CAM — on the serving model (``entry.
explain_entry``), whose fused spectrogram blocks pass gradients by the
fused block's VJP; attention rollout (:mod:`.rollout`) and SHAP-driven
channel selection with retraining (:mod:`.channel_select`); LIME on
spectrograms (:mod:`.lime`, host SLIC and ridge fit around the model's
forwards), its per-epoch snapshot in training (:mod:`.callbacks`) and the
SHAP plots (:mod:`.shap_plots`)."""

from .expected_gradients import (expected_gradients,
                                 expected_gradients_from_draws,
                                 gradient_shap_values, sample_draws)
from .gradcam import grad_cam
from .integrated_gradients import integrated_gradients
from .saliency import multimodal_saliency, saliency_maps
from .rollout import attention_rollout
from .channel_select import (get_top_n_channels, restructure_to_top_channels,
                             retrain_on_top_channels)
from .lime import (slic_segments, lime_explain, mark_boundaries,
                   plot_lime_overlay)
from . import callbacks, channel_select, rollout, shap_plots
from .callbacks import LimeEpochSnapshot
from .shap_plots import (plot_mean_shap_values,
                         plot_mean_shap_values_scatter, plot_shap_summary)

__all__ = ["LimeEpochSnapshot", "attention_rollout", "callbacks",
           "channel_select", "expected_gradients",
           "expected_gradients_from_draws", "get_top_n_channels",
           "grad_cam", "gradient_shap_values", "integrated_gradients",
           "lime_explain", "mark_boundaries", "multimodal_saliency",
           "plot_lime_overlay", "plot_mean_shap_values",
           "plot_mean_shap_values_scatter", "plot_shap_summary",
           "restructure_to_top_channels", "retrain_on_top_channels",
           "rollout", "saliency_maps", "sample_draws", "shap_plots",
           "slic_segments"]
