"""The share of the traced segment of graph replays in which nothing ran
on the card (no kernel, copy or set)."""

LAYER = "device"
MOVES = "infer_windows_per_s"


def read(ctx):
    s = ctx.segment
    return None if s.window_s <= 0 else 100.0 * (1.0 - s.busy_s / s.window_s)
