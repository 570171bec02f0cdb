"""Device ms a scoring request spends in both preprocessing chains inside
the served CUDA graph: the ``graph=True`` spans ``mbx.preprocess.eeg`` and
``mbx.preprocess.spec`` (timing events captured into the graph) of the
traced replays, over the program's ``entry.requests``."""

from benchmark.lib import program_spans

LAYER = "preprocessing"
MOVES = "infer_windows_per_s"


def read(ctx):
    return program_spans.per_request(
        program_spans.collected(), ("mbx.preprocess.eeg", "mbx.preprocess.spec"),
        "entry.requests", graph=True)
