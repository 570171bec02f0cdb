"""XAI (counterpart of the JAX package's ``xai/``): input-gradient
attribution — saliency, integrated gradients, expected gradients /
gradient SHAP and Grad-CAM — on the serving model (``entry.
explain_entry``), whose fused spectrogram blocks pass gradients by the
fused block's VJP; attention rollout (:mod:`.rollout`) and SHAP-driven
channel selection with retraining (:mod:`.channel_select`)."""

from .expected_gradients import (expected_gradients,
                                 expected_gradients_from_draws,
                                 gradient_shap_values, sample_draws)
from .gradcam import grad_cam
from .integrated_gradients import integrated_gradients
from .saliency import multimodal_saliency, saliency_maps
from .rollout import attention_rollout
from .channel_select import (get_top_n_channels, restructure_to_top_channels,
                             retrain_on_top_channels)
from . import channel_select, rollout

__all__ = ["attention_rollout", "channel_select", "expected_gradients",
           "expected_gradients_from_draws", "get_top_n_channels",
           "grad_cam", "gradient_shap_values", "integrated_gradients",
           "multimodal_saliency", "restructure_to_top_channels",
           "retrain_on_top_channels", "rollout", "saliency_maps",
           "sample_draws"]
