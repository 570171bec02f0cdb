"""Read the numbers a cell's correctness check compares, over many seeds in
one process: the program's (each seed's set-up, a short window at the
cell's own load, the comparison) and the control's (the reference one
step below the configuration's precision, in the program's place), on
the card at the cell's own sizes.  The limits in ``workloads/<cell>.json``
are set from these readings; the benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control 11 12 13] [--seconds 3]

Prints one JSON line a seed.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, nargs="*", default=())
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark.lib import registry

    cell = registry.cell(args.workload)
    kind = registry.kind(cell.traffic["kind"])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        t0 = time.perf_counter()
        st = kind.setup(cell, seed, dev, {})
        win = kind.window(st, args.seconds)
        kind.release(st)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out = {"seed": seed, "attempted": win["attempted"],
               "failed": win["failed"], "program": kind.judge(st, raw=True)}
        t2 = time.perf_counter()
        if seed in args.control:
            out["control"] = kind.judge(st, control=True, raw=True)
        out["seconds"] = {"setup_and_window": t1 - t0, "reference": t2 - t1,
                          "control": time.perf_counter() - t2}
        print(json.dumps(out), flush=True)
        del st
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
