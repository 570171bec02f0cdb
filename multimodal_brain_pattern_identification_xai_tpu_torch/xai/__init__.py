"""Input-gradient XAI (counterpart of the JAX package's ``xai/``):
saliency, integrated gradients, expected gradients / gradient SHAP and
Grad-CAM.  They run on the serving model (``entry.explain_entry``), whose
fused spectrogram blocks pass gradients by the fused block's VJP."""

from .expected_gradients import (expected_gradients,
                                 expected_gradients_from_draws,
                                 gradient_shap_values, sample_draws)
from .gradcam import grad_cam
from .integrated_gradients import integrated_gradients
from .saliency import multimodal_saliency, saliency_maps

__all__ = ["expected_gradients", "expected_gradients_from_draws",
           "grad_cam", "gradient_shap_values", "integrated_gradients",
           "multimodal_saliency", "saliency_maps", "sample_draws"]
