"""One run of one cell: set up, measure for ``--seconds``, check, print.

The driver named by the cell's traffic file does the cell's own work
(``drivers/<kind>.py``: ``make(cell, ctx)`` returns an object with
``setup``, ``window``, ``layer_context``, ``release`` and ``check``); this
module times it, reads the device, runs the per-layer readers, keeps JAX
out and prints the result line.  The drivers keep the seconds of each part
of their set-up in ``setup_parts`` (``setup_part``), which the result line
carries beside ``setup_s``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time

import torch

from .cell import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Ctx:
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    smoke: bool = False          # the configurations' small sizes (tests)


@dataclasses.dataclass
class Check:
    """One number the comparison reads, its limit, and whether it held."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@contextlib.contextmanager
def setup_part(parts: dict, name: str, device: str):
    """Add the block's seconds to ``parts[name]``, the device synchronised
    at its end: what each part of set-up takes, printed with the result."""
    t0 = time.monotonic()
    yield
    if device != "cpu":
        torch.cuda.synchronize()
    parts[name] = parts.get(name, 0.0) + time.monotonic() - t0


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, which the rates and rooflines
    depend on (a card set below 700 W runs slower under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else out.stderr.strip()


def device_info(ctx: Ctx) -> dict:
    if ctx.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run(cell: Cell, ctx: Ctx, t_start: float) -> tuple[int, dict | None]:
    """-> (exit code, result line or None)."""
    t_run = time.monotonic()
    drv = cell.driver().make(cell, ctx)
    t_setup = time.monotonic()
    drv.setup()
    if ctx.device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start - drv.check_s
    parts = {"start": t_run - t_start, "make": t_setup - t_run,
             **drv.setup_parts}
    holder: dict = {}
    e2e = drv.window(ctx.seconds, holder if ctx.trace else None)
    device = device_info(ctx)
    layer_ctx = drv.layer_context()
    drv.release()
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    checks, attempted, failed = drv.check()

    if ctx.trace:
        tr = holder.get("trace")
        if tr is None:
            print("the traced stretch did not run", file=sys.stderr)
            return 4, None
        layer_ctx["trace"] = tr
        metrics = {}
        for m in cell.per_layer():
            v = cell.reader(m["name"]).read(layer_ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
    else:
        e2e["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in cell.end_to_end()}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in e2e.items() if k in units}
    out = {"correct": all(c.ok for c in checks) and failed == 0,
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if ctx.trace:
        out["breakdown"] = layer_ctx["trace"].breakdown()
    out["setup_parts"] = parts
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    if ctx.device != "cpu":
        print(f"card: {card_line()}", file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    # last before the result, once the check and the readers have loaded
    # what they load
    found = loaded_forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3, None
    return 0, out


def emit(out: dict) -> None:
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()


