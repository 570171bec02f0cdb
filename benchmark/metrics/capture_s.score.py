"""Seconds of the run's set-up spent in ``entry.capture_forward``'s
warm-up calls and the capture of the served CUDA graph, less the kernel
loads inside them: the self time of the program's ``mbx.setup.capture``
span, on the host clock."""

from benchmark.lib import program_spans

LAYER = "entry"
MOVES = "setup_s"


def read(ctx):
    return program_spans.total_s(program_spans.collected(),
                                 "mbx.setup.capture", "self_host_ms")
