"""Device ms a scoring request spends in the spectrogram branch inside the
served CUDA graph: the ``graph=True`` span ``mbx.model.spec_branch`` of
the traced replays, over the program's ``entry.requests``."""

from benchmark.lib import program_spans

LAYER = "models"
MOVES = "infer_windows_per_s"


def read(ctx):
    return program_spans.per_request(
        program_spans.collected(), ("mbx.model.spec_branch",),
        "entry.requests", graph=True)
