#!/usr/bin/env python3
"""Times the SSD scan kernels at each number of heads a block walks.

    python3 tools/ssd_heads_sweep.py [--heads 1 2 4 8]

For zamba2-1.2b's head (64 heads of p 64, N 64) at decode (S 1 at batch
1 and 8), a chunk, and prompts of 512 to 32768 tokens at batch 1: each
wrapper's device ms a call (``ssd_forward`` without checkpoints, then
``ssd_backward``) in a CUDA graph, with the heads a block forced to each
of ``--heads`` in turn, and the grid the launcher reports.  Prints a JSON
line a (B, S, heads), then one a (B, S) naming the fastest heads of each
wrapper beside ``ops.heads_per_block``'s choice, then the card's name and
power limit.  Needs a CUDA device.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402

CASES = [(1, 1), (8, 1), (1, 64), (1, 512), (1, 2048), (1, 4096),
         (1, 32768)]
H, P, N = 64, 64, 64


def operands(B, S, gen):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    la = -torch.nn.functional.softplus(randn(B, S, H))
    ins = (la, randn(B, S, H, P), randn(B, S, N), randn(B, S, N),
           randn(B, H, P, N))
    return ins, randn(B, S, H, P), randn(B, H, P, N)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    build.build_all()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    chosen = ops.heads_per_block
    try:
        for B, S in CASES:
            ins, dy, dh = operands(B, S, gen)
            _, _, ck = ops.ssd_forward(*ins, save=True)
            times = {}
            for g in args.heads:
                ops.heads_per_block = lambda *_, g=g: g
                fwd = chip_smoke.graph_ms(lambda: ops.ssd_forward(*ins))
                bwd = chip_smoke.graph_ms(
                    lambda: ops.ssd_backward(*ins[:4], ck, dy, dh))
                times[g] = (fwd, bwd)
                print(json.dumps({
                    "B": B, "S": S, "heads": g, "forward_ms": fwd,
                    "backward_ms": bwd,
                    "grids": ops.ssd_backward.last_plan["grids"]}),
                    flush=True)
            print(json.dumps({
                "B": B, "S": S,
                "fastest_forward": min(times, key=lambda g: times[g][0]),
                "fastest_backward": min(times, key=lambda g: times[g][1]),
                "heads_per_block": chosen(B, S, H, sms)}), flush=True)
            del ins, dy, dh, ck
            torch.cuda.empty_cache()
    finally:
        ops.heads_per_block = chosen
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
