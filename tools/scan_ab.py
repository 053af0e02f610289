#!/usr/bin/env python3
"""Time the recurrence scans of two checkouts in turns on one card.

    python3 tools/scan_ab.py PARENT_TREE CHANGE_TREE

Each tree (a checkout, or ``git archive`` of a commit unpacked into a
git-ignored directory) runs in a process of its own, in the order parent,
change, change, parent: it builds its kernels and, on the same inputs from
one seed, runs the WKV-6 and SSD scans at one layer of rwkv6-3b (B 1, S
4096, H 40, hd 64) and of zamba2-1.2b (H 64, p 64, N 64): each wrapper
timed in CUDA graphs (``chip_smoke.graph_ms``, three times; the forward
without and with checkpoints), each kernel's device ms a call from
torch.profiler, the checkpoint bytes, and a SHA-256 of every output's
bytes, so two trees' SSD outputs can be seen equal bit for bit.  A tree
whose WKV-6 ops take the decay w rather than its log gets exp(lw).  Prints
one JSON line a run, the largest difference of each tree's WKV-6 outputs
from the first run's, and the card's name and power limit.  Needs a CUDA
device.
"""
import json
import subprocess
import sys

CHILD = r'''
import hashlib, json, re, sys, torch
sys.path.insert(0, sys.argv[1] + "/src")
sys.path.insert(0, sys.argv[1])
import chip_smoke
from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.wkv6_scan import ops as wops
from torch.profiler import ProfilerActivity, profile
build.build_all()
g = torch.Generator(device="cuda").manual_seed(25)
def n(*shape):
    return torch.randn(shape, generator=g, device="cuda")
B, S, H, hd = 1, 4096, 40, 64
lw = -torch.exp(n(B, S, H, hd) - 3)
takes_log = hasattr(wops, "FORWARD_KERNELS")
wins = (n(B, S, H, hd), n(B, S, H, hd), n(B, S, H, hd),
        lw if takes_log else torch.exp(lw), 0.1 * n(H, hd), n(B, H, hd, hd))
wgrad = (n(B, S, H, hd), n(B, H, hd, hd))
sins = (-torch.nn.functional.softplus(n(1, S, 64)), n(1, S, 64, 64),
        n(1, S, 64), n(1, S, 64), n(1, 64, 64, 64))
sgrad = (n(1, S, 64, 64), n(1, 64, 64, 64))
def kernel_ms(call, prefix):
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    out = {}
    for name, (_, ms) in chip_smoke.kernel_rows(prof).items():
        m = re.search(rf"({prefix}_\w+(?:<\w+>)?)\(", name)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + ms / 10
    return out
def sha(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]
res = {"takes_log": takes_log}
for kind, ins, grads, fwd, bwd, n_in in (
        ("wkv6", wins, wgrad, wops.wkv6_forward, wops.wkv6_backward, 5),
        ("ssd", sins, sgrad, sops.ssd_forward, sops.ssd_backward, 4)):
    y, s, ck = fwd(*ins, save=True)
    gr = bwd(*ins[:n_in], ck, *grads)
    torch.cuda.synchronize()
    res[kind] = {
        "forward_ms": [chip_smoke.graph_ms(lambda: fwd(*ins))
                       for _ in range(3)],
        "forward_with_checkpoints_ms": [
            chip_smoke.graph_ms(lambda: fwd(*ins, save=True))
            for _ in range(3)],
        "backward_ms": [chip_smoke.graph_ms(
            lambda: bwd(*ins[:n_in], ck, *grads)) for _ in range(3)],
        "kernel_ms": {"forward": kernel_ms(lambda: fwd(*ins), kind),
                      "backward": kernel_ms(
                          lambda: bwd(*ins[:n_in], ck, *grads), kind)},
        "checkpoint_bytes": ck.numel() * ck.element_size(),
        "sha256": {"forward": sha((y, s, ck)), "backward": sha(gr)}}
    if kind == "wkv6":
        torch.save([t.cpu() for t in (y, s, *gr)], sys.argv[2])
    del y, s, ck, gr
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(res))
'''


def main(parent: str, change: str) -> int:
    import torch

    first = None
    for i, tree in enumerate((parent, change, change, parent)):
        out = f"{tree}/wkv6_outputs.{i}.pt"
        p = subprocess.run([sys.executable, "-c", CHILD, tree, out],
                           capture_output=True, text=True)
        got = [ln[7:] for ln in p.stdout.splitlines()
               if ln.startswith("RESULT ")]
        if p.returncode or not got:
            print(f"{tree}: failed\n{p.stderr[-3000:]}", file=sys.stderr)
            return 1
        res = json.loads(got[0])
        outs = torch.load(out)
        if first is None:
            first = outs
        # y, final state, dr, dk, dv, dw or dlw, du, ds0: the largest
        # difference of each from the first run's, relative to its largest
        # entry (dw and dlw are not the same gradient: skipped)
        res["wkv6_rel_diff_from_first"] = [
            None if j == 5 else
            ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for j, (a, b) in enumerate(zip(outs, first))]
        print(f"{tree}: {json.dumps(res)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
