#!/usr/bin/env python3
"""Where the long prefill's logit check sets its limit: sound scans against
deliberately wrong ones.

    python3 tools/prefill_logit_spread.py [--seeds 0 1 2 3] [--tokens 2048] \
        [--dtype bfloat16|float32]

For rwkv6-3b and zamba2-1.2b at full width, and for each seed (weights
from the seed, the prompt from seed + 5, as ``chip_smoke.py`` draws them),
one sealed prefill of ``--tokens`` tokens through ``steps.make_prefill_fn``
in four ways: through the scan kernels, through the plain per-token loops
(``chip_smoke.plain_scans``, the yardstick), and through two wrong scans
built from the kernels' outputs.  ``--dtype float32`` runs the weights and
the activations in float32 (the configs' ``dtype`` and ``param_dtype``)
instead of the published bfloat16:

  rwkv6-3b     "no u bonus": the scan with u = 0, so y_t = r_t^T S_{t-1};
               "stale decay": w_t applied a token late, the decay of the
               token before;
  zamba2-1.2b  "y before the input": y_t = a_t h_{t-1} C_t, the state read
               before the token's dtx_t B_t^T is added;
               "stale decay": a_t applied a token late.

Prints one JSON line a (arch, seed): the largest absolute difference of
the last-token logits of each way from the plain loops' (and, under
``mean``, the mean absolute difference), and at the end
the card's name and power limit.  Needs a CUDA device.
"""
import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core import sealed as sealed_lib  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.wkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402


def _late(x):
    """x with each token's entry replaced by the token before's (the first
    token keeps its own): a decay applied one token late."""
    return torch.cat([x[:, :1], x[:, :-1]], dim=1)


@contextlib.contextmanager
def wrong_scans(kind: str):
    kernel_wkv, kernel_ssd = wkv_ops.wkv6_scan, ssd_ops.ssd_scan

    def no_u(r, k, v, lw, u, s):
        return kernel_wkv(r, k, v, lw, torch.zeros_like(u), s)

    def late_w(r, k, v, lw, u, s):
        return kernel_wkv(r, k, v, _late(lw), u, s)

    def no_input(la, dtx, b, c, h):
        y, h_out = kernel_ssd(la, dtx, b, c, h)
        return y - dtx * (b * c).sum(-1)[:, :, None, None], h_out

    def late_a(la, dtx, b, c, h):
        return kernel_ssd(_late(la), dtx, b, c, h)

    wkv_ops.wkv6_scan = {"no u bonus": no_u,
                         "stale decay": late_w}.get(kind, kernel_wkv)
    ssd_ops.ssd_scan = {"y before the input": no_input,
                        "stale decay": late_a}.get(kind, kernel_ssd)
    try:
        yield
    finally:
        wkv_ops.wkv6_scan, ssd_ops.ssd_scan = kernel_wkv, kernel_ssd


WRONG = {"rwkv6-3b": ("no u bonus", "stale decay"),
         "zamba2-1.2b": ("y before the input", "stale decay")}


def spread(arch: str, seed: int, n_tok: int, dtype: str = "bfloat16",
           device: str = "cuda", smoke: bool = False) -> dict:
    cell = steps.make_cell(arch, "prefill_32k", smoke=smoke, device=device,
                           overrides={"dtype": dtype, "param_dtype": dtype})
    cfg = cell.cfg
    params = cell.model.init(torch.Generator(device=device).manual_seed(seed),
                             cfg, device)
    sealed = sealed_lib.seal_tree(params, cell.key, cell.sec.weights, 1 << 8)
    del params
    g = torch.Generator(device=device).manual_seed(seed + 5)
    tokens = torch.randint(0, cfg.vocab, (1, chip_smoke.LONG_PREFILL_LEN),
                           generator=g, device=device,
                           dtype=torch.int32)[:, :n_tok]
    cell.shape = dataclasses.replace(cell.shape, seq_len=n_tok,
                                     global_batch=1)
    prefill = steps.make_prefill_fn(cell)

    def logits():
        out, _ = prefill(sealed, {"tokens": tokens})
        return out.float()

    with chip_smoke.plain_scans():
        plain = logits()
    row = {"arch": arch, "seed": seed, "tokens": n_tok, "dtype": dtype,
           "plain_max_abs": plain.abs().max().item(), "mean": {}}
    for kind in ("kernels",) + WRONG[arch]:
        with wrong_scans(kind):
            diff = (logits() - plain).abs()
        row[kind] = diff.max().item()
        row["mean"][kind] = diff.mean().item()
    del sealed
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--tokens", type=int,
                    default=chip_smoke.LONG_PREFILL_CHECK)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    for arch in chip_smoke.LONG_PREFILL_ARCHS:
        for seed in args.seeds:
            print(json.dumps(spread(arch, seed, args.tokens, args.dtype)),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
