#!/usr/bin/env python3
"""Time the CTR kernel of two checkouts in turns on one card.

    python3 tools/ctr_ab.py PARENT_TREE CHANGE_TREE

Each tree (a checkout, or ``git archive`` of a commit unpacked into a
git-ignored directory) runs in a process of its own, in the order parent,
change, change, parent: it builds its ``csrc/ctr_cipher.cu`` and times
``ctr_xor`` in CUDA graphs (``chip_smoke.graph_ms``, three times each) on
the same inputs: one paged decode step's page-batch gather (32 pages of
5120 rows of 64 bf16), granite-3-2b's stacked ``w_gate`` leaf (81920 rows
of 8192 bf16, whole Threefry blocks: the vector path) and its unembed
(2048 rows of 49155 bf16: the element-wise path).  Prints one line a run
and the card's name and power limit.  Needs a CUDA device.
"""
import json
import subprocess
import sys

CASES = (("page gather", (32, 5120, 64)), ("w_gate", (1, 81920, 8192)),
         ("unembed", (1, 2048, 49155)))

CHILD = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[1] + "/src")
sys.path.insert(0, sys.argv[1])
import chip_smoke
from repro_torch.kernels import build
from repro_torch.kernels.ctr_cipher import ops
build.build_all()
g = torch.Generator(device="cuda").manual_seed(5)
def bits(shape, dt):
    return torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                         device="cuda", dtype=torch.int64).to(dt)
out = {}
for name, shape in json.loads(sys.argv[2]):
    x, k = bits(shape, torch.int16), bits((shape[0], 2), torch.int32)
    out[name] = [chip_smoke.graph_ms(lambda: ops.ctr_xor(x, k))
                 for _ in range(3)]
print("RESULT " + json.dumps(out))
'''


def main(parent: str, change: str) -> int:
    for tree in (parent, change, change, parent):
        p = subprocess.run([sys.executable, "-c", CHILD, tree,
                            json.dumps(CASES)], capture_output=True, text=True)
        got = [ln[7:] for ln in p.stdout.splitlines()
               if ln.startswith("RESULT ")]
        if p.returncode or not got:
            print(f"{tree}: failed\n{p.stderr[-2000:]}", file=sys.stderr)
            return 1
        print(f"{tree}: ms {got[0]}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
