"""Device ms a scoring request spends in both preprocessing chains
(``ops.preprocess_multimodal``): the kernels inside the ``bench.preprocess``
span of the eager pass that the traced run makes of the same program."""

LAYER = "preprocessing"
MOVES = "infer_windows_per_s"


def read(ctx):
    s = ctx.segment.span_s.get("bench.preprocess")
    return None if not s else s * 1e3
