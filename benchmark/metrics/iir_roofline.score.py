"""Kernel #2's share of its roofline in a scoring request: the least time
of the cascade with the fused mean and ::4 on the batch's 20 raw lanes
(operations at float32's peak or bytes at HBM's, whichever is longer)
over the device time of ``chunked_scan_kernel<…, MeanOut>`` in the
traced graph replays."""

from benchmark.lib import counters

LAYER = "kernels"
MOVES = "infer_windows_per_s"
KERNEL = r"chunked_scan_kernel<.*MeanOut"


def read(ctx):
    t = ctx.segment.kernel_s(KERNEL)
    if not t:
        return None
    e = ctx.cell.config["eeg"]
    sections = e["first_bandpass_order"] + e["denoise_bandpass_order"]
    ops, nbytes = counters.iir(ctx.traffic["batch"] * e["raw_channels"],
                               ctx.traffic["n_points"], sections)
    least = max(ops / ctx.peaks["f32"], nbytes / ctx.hbm_bytes_per_s)
    return 100.0 * least / t
