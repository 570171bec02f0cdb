"""Device ms an explanation request spends in integrated gradients
(``xai.integrated_gradients`` over the EEG branch and its argmax
forward): the kernels inside the ``bench.ig`` span of the traced
requests."""

LAYER = "xai"
MOVES = "explain_windows_per_s"


def read(ctx):
    s = ctx.segment.span_s.get("bench.ig")
    return None if not s else s * 1e3
