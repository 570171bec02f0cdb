"""Device ms an explanation request spends in the saliency's backward (the
VJP of #3 and cuDNN's data gradients): the span
``mbx.xai.saliency.backward`` around ``torch.autograd.grad``, timed by
events on the stream the backward's kernels run on, over the program's
``xai.saliency.requests``."""

from benchmark.lib import program_spans

LAYER = "xai"
MOVES = "explain_windows_per_s"


def read(ctx):
    return program_spans.per_request(
        program_spans.collected(), ("mbx.xai.saliency.backward",),
        "xai.saliency.requests")
