"""Device ms a scoring request spends in the spectrogram branch
(``MultimodalModel.forward_spectrogram``): the kernels inside the
``bench.spec_branch`` span of the traced run's eager pass."""

LAYER = "models"
MOVES = "infer_windows_per_s"


def read(ctx):
    s = ctx.segment.span_s.get("bench.spec_branch")
    return None if not s else s * 1e3
