"""Kernel #3's share of its roofline in a scoring request: the least time
of the fused spectrogram blocks (operations at bf16's peak or bytes at
HBM's, a block at a time, at the configuration's widths) over the device
time of ``specblock_bf16_tc_kernel`` in the traced graph replays."""

from benchmark.lib import counters
from benchmark.reference import branches

LAYER = "kernels"
MOVES = "infer_windows_per_s"
KERNEL = r"specblock_bf16_tc_kernel"


def read(ctx):
    t = ctx.segment.kernel_s(KERNEL)
    n = ctx.program.get("fused_blocks", 0)
    spec = ctx.cell.config["spectrogram"]
    if (not t or not n or spec["model"] != "speccnn"
            or ctx.program["spec_model_dtype"] != "bfloat16"):
        return None
    h, w = ctx.traffic["plane"]
    least = 0.0
    for bh, bw, cin, cout, _ in branches.get("speccnn").blocks(spec, h, w)[:n]:
        ops, nbytes = counters.specblock(ctx.traffic["batch"], bh, bw, cin, cout)
        least += max(ops / ctx.peaks["bf16"], nbytes / ctx.hbm_bytes_per_s)
    return 100.0 * least / t
