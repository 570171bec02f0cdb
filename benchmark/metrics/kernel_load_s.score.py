"""Seconds of the run's set-up spent loading the port's CUDA kernel
libraries: the self time of the program's ``mbx.setup.kernels`` spans, on
the host clock.  The nvcc build of a cold checkout is their child
``mbx.setup.kernels.build`` and is left out, so a cold run and a warm one
read the same work."""

from benchmark.lib import program_spans

LAYER = "entry"
MOVES = "setup_s"


def read(ctx):
    return program_spans.total_s(program_spans.collected(),
                                 "mbx.setup.kernels", "self_host_ms")
