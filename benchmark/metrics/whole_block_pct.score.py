"""Share of the fused spectrogram blocks' calls that the port served whole
(conv×3 + pool, eval BatchNorm, the 2×2 skip and the residual add in one
launch of #3) in the traced segment's eager pass: the program's counter
``models.spec_block.whole`` over ``models.spec_block.fused``, in %.  None
where the port counts no fused call (a commit without these counters)."""

from benchmark.lib import program_spans

LAYER = "models"
MOVES = "infer_windows_per_s"


def read(ctx):
    c = program_spans.collected()
    fused = c.counters.get("models.spec_block.fused", 0) if c else 0
    if not fused:
        return None
    return 100.0 * c.counters.get("models.spec_block.whole", 0) / fused
