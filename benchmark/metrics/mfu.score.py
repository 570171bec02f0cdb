"""The whole scoring request's share of the card's peak: the least time
its operations need (each at the published peak of the precision it runs
in) over the measured time a request of the run's window."""

from benchmark.lib import counters

LAYER = "entry"
MOVES = "infer_windows_per_s"


def read(ctx):
    w = ctx.window
    done = w["attempted"] - w["failed"]
    if done <= 0:
        return None
    least = counters.least_seconds(ctx.flops, ctx.peaks)
    return 100.0 * least * done / w["seconds"]
