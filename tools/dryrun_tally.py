#!/usr/bin/env python3
"""The dry run's ``Tally`` against torch's own counters on one cell.

    PYTHONPATH=src python tools/dryrun_tally.py --arch granite-3-2b \\
        --shape prefill_32k [--runs 2]

Runs the cell's step as ``launch/dryrun.py::run_cell`` does (meta tensors,
rank 0 of a fake group of 256 on the production pod mesh), in turns under
``dryrun.Tally`` and under ``FlopCounterMode`` with ``MemTracker`` (the
step's arguments tracked as external tensors), and prints one JSON line a
run: its seconds, the peak bytes (MemTracker's per device) and the FLOPs.
"""
import argparse
import json
import time

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import sharding as shd


def measure(arch: str, shape: str, counter: str) -> dict:
    """One run of the cell's step under ``counter`` ("tally" or
    "torch"), inside a fake group of the pod mesh's ranks."""
    with dryrun.fake_world(dryrun.MESHES["pod"][0]):
        mesh = make_production_mesh(multi_pod=False, device_type="cpu")
        cell = steps.make_cell(arch, shape, security="trusted",
                               device="meta")
        with shd.use(shd.make_ctx(mesh)):
            fn, args, _ = dryrun.cell_inputs(cell, mesh)
            held = dryrun._locals(args)
            t0 = time.perf_counter()
            if counter == "tally":
                with dryrun.Tally() as tally:
                    tally.hold(held)
                    fn(*args)
                peak, flops = {"meta": tally.peak}, tally.flops
            else:
                mt = MemTracker()
                mt.track_external(*held)
                with FlopCounterMode(display=False) as fc, mt:
                    fn(*args)
                peak = {str(d): v["Total"] for d, v in
                        mt.get_tracker_snapshot("peak").items()}
                flops = fc.get_total_flops()
            s = time.perf_counter() - t0
    return {"arch": arch, "shape": shape, "counter": counter, "s": s,
            "peak_bytes": peak, "flops": flops}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--shape", default="prefill_32k")
    ap.add_argument("--runs", type=int, default=2,
                    help="runs of each counter, in turns")
    args = ap.parse_args()
    torch.set_num_threads(1)
    for _ in range(args.runs):
        for counter in ("tally", "torch"):
            print(json.dumps(measure(args.arch, args.shape, counter)),
                  flush=True)


if __name__ == "__main__":
    main()
