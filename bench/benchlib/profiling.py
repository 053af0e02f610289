"""Spans and the device trace of a traced run.

Spans are ``torch.profiler.record_function`` ranges that the benchmark's
own code opens around its calls into the program (``bench.step``,
``bench.submit``, ``bench.prefill``, ...).  They cost nothing while no
profiler runs, and inside a traced stretch they land in the same trace as
the device's kernels, on the same clock.

The trace is read straight from the profiler's raw events (the port's
chip smoke run found ``key_averages`` too slow over ~100k launches).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

SPAN_PREFIX = "bench."


def span(name: str):
    """A span around a call into the program, named ``bench.<name>``."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def spanned(fn, name: str):
    """``fn`` with every call wrapped in the span ``name``."""
    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return call


@dataclasses.dataclass
class Trace:
    """What one traced stretch saw: each device operation's (name, start
    ns, end ns), the host's operator and span ranges, the stretch's wall
    seconds and the steps it held."""
    device: list
    host: list
    spans: list
    window_s: float
    steps: int

    def kernel_rows(self) -> dict:
        """{name: [launches, device seconds]}."""
        rows: dict = {}
        for name, t0, t1 in self.device:
            r = rows.setdefault(name, [0, 0.0])
            r[0] += 1
            r[1] += (t1 - t0) / 1e9
        return rows

    def kernel_seconds(self, *needles: str) -> float:
        """Device seconds of the operations whose name holds a needle."""
        return sum(s for name, (_, s) in self.kernel_rows().items()
                   if any(n in name for n in needles))

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        busy, end = 0, None
        for _, t0, t1 in sorted(self.device, key=lambda d: d[1]):
            if end is None or t0 >= end:
                busy += t1 - t0
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        return busy / 1e9

    def launches(self) -> int:
        return len(self.device)

    def idle_gaps(self, top: int = 10) -> list:
        """The longest spells with no device operation, each named by the
        innermost span and host operator open at its middle:
        [[name, seconds], ...]."""
        ivs = sorted((t0, t1) for _, t0, t1 in self.device)
        gaps, end = [], None
        for t0, t1 in ivs:
            if end is not None and t0 > end:
                gaps.append((end, t0))
            end = t1 if end is None else max(end, t1)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:top]:
            mid = (g0 + g1) // 2
            where = [_innermost(self.spans, mid), _innermost(self.host, mid)]
            out.append([" / ".join(w for w in where if w) or "host",
                        (g1 - g0) / 1e9])
        return out

    def breakdown(self) -> dict:
        top = sorted(self.kernel_rows().items(), key=lambda kv: -kv[1][1])
        return {"device_ops": [[name[:120], s] for name, (_, s) in top[:10]],
                "idle_gaps": self.idle_gaps()}


def _innermost(ranges: list, t: int) -> str | None:
    best = None
    for name, t0, t1 in ranges:
        if t0 <= t <= t1 and (best is None or t1 - t0 < best[2] - best[1]):
            best = (name, t0, t1)
    return best[0] if best else None


@contextlib.contextmanager
def traced(holder: dict):
    """Run the block under torch.profiler (CPU and CUDA activities) and
    put its ``Trace`` in ``holder["trace"]`` (the caller sets its
    ``steps``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        t_0 = e.start_ns()
        row = (e.name(), t_0, t_0 + e.duration_ns())
        if e.name().startswith(SPAN_PREFIX):
            # a span shows on the host and, as an annotation, on the device
            if e.device_type() == DeviceType.CPU:
                spans.append(row)
        elif e.device_type() != DeviceType.CPU:
            device.append(row)
        else:
            host.append(row)
    holder["trace"] = Trace(device=device, host=host, spans=spans,
                            window_s=wall, steps=0)
