"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, CUDA, the kernels' load or build, weights and inputs
from the seed, capture, one untimed pass of every input) is timed from
the start of this process.  Then the cell's traffic runs for ``--seconds``;
with ``--trace 1`` a short profiled segment follows and the per-layer
metrics are read from it instead of the end-to-end ones.  Last, the
answers of the window are compared with the plain reference.  The last
line of standard output is one JSON object; the numbers compared, each
with its limit, end standard error.  Exits 1 without a result where no
card (or too few) is visible, and 3 where the process holds JAX or the
JAX package once the window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"
#: top-level modules that must not be loaded (compared as whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "multimodal_brain_pattern_identification_xai_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # caches of the program's builds at fixed places inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(ROOT))
    from benchmark.lib import harness, registry

    cell = registry.cell(args.workload)
    t_torch = time.time()
    import torch
    t_cuda = time.time()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 1
    phases = {"start": t_torch - T_START, "torch_import": t_cuda - t_torch,
              "cuda_count": time.time() - t_cuda}
    line = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T_START, phases=phases)
    found = forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)}: the benchmark may "
              "load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                            # noqa: BLE001
        traceback.print_exc()
        sys.exit(2)
