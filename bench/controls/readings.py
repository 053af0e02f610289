"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size, many seeds in one process:

    python3 bench/controls/readings.py --workload <name> --seeds 1 2 3 ...
        [--control-seeds 3] [--seconds 15] [--out chiprun_out/x.jsonl]

For each seed it runs the cell's set-up and a short window through the
harness's driver, then reads the numbers the check compares: the sound
program's (its lower reading), and for the first ``--control-seeds``
seeds the control's: the plain reference in float8 e4m3 put in the
program's place (its upper reading), and for a training cell the fault of
half the batch left out, planted in the reference.  What a cell reads is
its driver's ``readings(drv, ctx, control)``: serving reads the widest gap
of a served token below the reference's best, and the control, of the
token the float8 reference puts first at each position of the same
prompts and tokens.  One JSON line per seed.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path.cwd()
BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(BENCH)]

import torch  # noqa: E402

from benchlib.cell import Cell  # noqa: E402
from benchlib.harness import Ctx  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cell = Cell.load(ROOT, args.workload)
    for i, seed in enumerate(args.seeds):
        t0 = time.monotonic()
        ctx = Ctx(seed=seed, seconds=args.seconds, trace=False)
        mod = cell.driver()
        drv = mod.make(cell, ctx)
        drv.setup()
        drv.window(args.seconds, None)
        drv.release()
        gc.collect()
        torch.cuda.empty_cache()
        row = {"workload": args.workload, "seed": seed,
               **mod.readings(drv, ctx, i < args.control_seeds),
               "seconds": time.monotonic() - t0,
               "device": torch.cuda.get_device_name(0)}
        del drv
        gc.collect()
        torch.cuda.empty_cache()
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
