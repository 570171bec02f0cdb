"""Host ms a scoring request spends launching the served CUDA graph: the
span ``mbx.entry.launch`` (``graph.replay()``) on the host clock, over the
program's ``entry.requests``."""

from benchmark.lib import program_spans

LAYER = "entry"
MOVES = "infer_windows_per_s"


def read(ctx):
    return program_spans.per_request(
        program_spans.collected(), ("mbx.entry.launch",), "entry.requests",
        field="host_ms")
