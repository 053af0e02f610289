"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It builds the port's kernels on first use
(into the port's own ``csrc/_build/``), makes the weights and traffic from
the seed, warms up the cell's shapes, measures for ``--seconds`` seconds,
checks what the timed path produced against the plain reference, and
prints one JSON object as the last line of standard output.  It needs a
CUDA card and exits with another code than 0, printing no result, without
one.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
BENCH = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every cache of the program stays inside the checkout, at fixed paths
    cache = BENCH / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(BENCH))

    import torch

    from benchlib import harness
    from benchlib.cell import Cell

    cell = Cell.load(ROOT, args.workload)
    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here without the program)

    ctx = harness.Ctx(seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace))
    rc, out = harness.run(cell, ctx, T_START)
    if out is not None:
        harness.emit(out)
    return rc


if __name__ == "__main__":
    sys.exit(main())
