"""The program's own spans laid over a traced stretch: the arithmetic the
readers of ``program_span`` metrics share.

The port's process tracer (``repro_torch.obs.trace.TRACER``) records while
a torch profiler does, on the clock the profiler stamps its host events
with (Unix-epoch ns), so its spans fall on the same time line as the
stretch's device operations and host launch calls.  A span is read here as
(name, start ns, end ns, device ms or None); ``device_ms`` is what the
span's two CUDA events measured on its stream.  A program without such a
tracer (an older commit) gives no spans, and every reader then gives None.
"""
from __future__ import annotations

import bisect

# the host calls that put work on the device, as the profiler names them
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
            "cudaMemsetAsync")
DERIVE = "seal.derive"
ENGINE = "engine."


def program_spans(trace) -> list:
    """The process tracer's finished spans that overlap the traced
    stretch: [(name, t0 ns, t1 ns, device ms or None)]; [] where the
    program has no process tracer."""
    try:
        from repro_torch.obs import trace as program_trace
    except ImportError:
        return []
    read = getattr(getattr(program_trace, "TRACER", None), "spans", None)
    if read is None:
        return []
    lo, hi = _stretch(trace)
    out = []
    for ev in read():
        t0 = round(ev["ts"] * 1e3)
        t1 = t0 + round(ev["dur"] * 1e3)
        if t1 >= lo and t0 <= hi:
            out.append((ev["name"], t0, t1,
                        ev.get("args", {}).get("device_ms")))
    return out


def _stretch(trace) -> tuple:
    """(first ns, last ns) of everything the profiler saw."""
    rows = trace.device + trace.host + trace.spans
    if not rows:
        return float("-inf"), float("inf")
    return min(r[1] for r in rows), max(r[2] for r in rows)


def union(ivs) -> list:
    """Sorted, disjoint [(t0, t1)] covering the intervals given."""
    out: list = []
    for t0, t1 in sorted(ivs):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def overlap_ns(a: list, b: list) -> int:
    """ns that two sorted, disjoint interval lists share."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_gaps(trace) -> list:
    """The spells between the device's operations (as ``Trace.idle_gaps``
    finds them, every one): sorted, disjoint [(t0, t1)]."""
    busy = union((t0, t1) for _, t0, t1 in trace.device)
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def _named(spans, match) -> list:
    return union((t0, t1) for name, t0, t1, _ in spans if match(name))


def device_ms_per_step(ctx: dict, name: str):
    """Σ ``device_ms`` of the spans called ``name``, per traced step; None
    where none was timed on a device."""
    tr = ctx["trace"]
    ms = [d for n, _, _, d in program_spans(tr) if n == name and
          d is not None]
    if not ms or not tr.steps:
        return None
    return sum(ms) / tr.steps


def derive_launches(ctx: dict):
    """Host launch calls that start inside a key derivation, per step."""
    tr = ctx["trace"]
    derive = _named(program_spans(tr), lambda n: n == DERIVE)
    if not derive or not tr.device or not tr.steps:
        return None
    starts = sorted(t0 for name, t0, _ in tr.host
                    if name.startswith(LAUNCHES))
    n = sum(bisect.bisect_right(starts, t1) - bisect.bisect_left(starts, t0)
            for t0, t1 in derive)
    return n / tr.steps


def idle_in_derive(ctx: dict):
    """Share of the stretch's wall time in which the device was idle while
    the host derived a key, %."""
    tr = ctx["trace"]
    derive = _named(program_spans(tr), lambda n: n == DERIVE)
    if not derive or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * overlap_ns(idle_gaps(tr), derive) / 1e9 / tr.window_s


def idle_off_engine(ctx: dict):
    """Share of the stretch's wall time in which the device was idle
    outside every engine call (scheduler, gateway bookkeeping, token
    emission), %."""
    tr = ctx["trace"]
    engine = _named(program_spans(tr), lambda n: n.startswith(ENGINE))
    if not engine or not tr.device or tr.window_s <= 0:
        return None
    gaps = idle_gaps(tr)
    idle = sum(t1 - t0 for t0, t1 in gaps)
    return 100.0 * (idle - overlap_ns(gaps, engine)) / 1e9 / tr.window_s
