"""Device ms an explanation request spends in saliency
(``xai.multimodal_saliency`` and the fused model's argmax forward): the
kernels inside the ``bench.saliency`` span of the traced requests."""

LAYER = "xai"
MOVES = "explain_windows_per_s"


def read(ctx):
    s = ctx.segment.span_s.get("bench.saliency")
    return None if not s else s * 1e3
