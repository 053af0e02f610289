"""Profiler — step-scoped phase timing + jitted-dispatch accounting.

Wraps every engine phase (prefill chunk, decode, page close/reopen, COW,
nonce-lane refresh, swap out/in, prefix publish) in a *device-synchronized*
timing boundary and counts how many jitted dispatches each gateway step
issues — the dispatches-per-step progress metric (one kernel dispatch per
engine step at max occupancy).

Usage (the engine host wrappers):

    with profiler.phase("decode", tenant=None) as ph:
        out = self._decode(...)          # one jitted call
        ph.dispatch(out)                 # count it + register for sync

``ph.dispatch(x)`` increments the phase's (and the step's) dispatch count
and registers ``x`` for synchronization: on phase exit the profiler calls
``torch.cuda.synchronize()`` when anything was registered, so the closing
timestamp measures completed device work, not the asynchronous enqueue.
In the port one "dispatch" is one engine call (there is no jit).  Nested
phases are legal — a ``renonce`` wraps only its own dispatch while the
close/reopen it triggers time themselves — but the umbrella
``prefix_publish`` phase deliberately spans its nested phases (documented
in docs/OBSERVABILITY.md).

Step accounting (the gateway calls these around ``scheduler.step``):

    profiler.step_begin()
    ... the step's phases run ...
    profiler.step_end(active=n_active)

``step_end`` diffs the global dispatch counter, records an
``(occupancy, dispatches)`` sample for the window, emits Perfetto counter
tracks into the process tracer (obs/trace.py ``TRACER.counter``) and
returns the step's dispatch count.  ``dispatches_per_step()`` averages
the samples taken at the window's maximum observed occupancy — the
steady-state number.

All timing/count data is untrusted-side telemetry: wall clocks, ciphertext
byte counts and dispatch tallies, never plaintext-derived values.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from .costs import CostLedger, priced_by
from .metrics import MetricsRegistry
from .trace import TID_ENGINE, TRACER


def _block_until_ready(obj) -> None:
    """Wait for the card's queued work; host-only runs have none."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _PhaseHandle:
    """The object ``profiler.phase(...)`` yields inside the with-block."""

    __slots__ = ("name", "tenant", "dispatches", "_pending")

    def __init__(self, name: str, tenant: str | None):
        self.name = name
        self.tenant = tenant
        self.dispatches = 0
        self._pending: list = []

    def dispatch(self, result=None):
        """Count one jitted dispatch; register its result for device sync."""
        self.dispatches += 1
        if result is not None:
            self._pending.append(result)
        return result


class _NullHandle:
    """Dispatch-counting no-op for a disabled profiler."""

    __slots__ = ()
    name = tenant = None
    dispatches = 0

    def dispatch(self, result=None):
        return result


_NULL_HANDLE = _NullHandle()


class Profiler:
    def __init__(self, registry: MetricsRegistry | None = None,
                 enabled: bool = True, chunk_words: int = 128):
        self.enabled = enabled
        self.registry = registry if registry is not None else MetricsRegistry()
        self.ledger = CostLedger(registry=self.registry,
                                 chunk_words=chunk_words)
        self._dispatch_total = 0             # lifetime, monotone
        self._step_t0: float | None = None
        self._step_d0 = 0
        # window samples: one (occupancy, dispatches) pair per gateway step
        self._step_samples: list[tuple[int, int]] = []
        self._g_dps = self.registry.gauge(
            "profiler_dispatches_per_step",
            "mean jitted dispatches per step at max observed occupancy")

    # -- phase timing ----------------------------------------------------
    @contextmanager
    def phase(self, name: str, tenant: str | None = None):
        if not self.enabled:
            yield _NULL_HANDLE
            return
        handle = _PhaseHandle(name, tenant)
        t0 = time.monotonic()
        try:
            yield handle
        finally:
            if handle._pending:
                _block_until_ready(handle._pending)
            wall_us = (time.monotonic() - t0) * 1e6
            self._dispatch_total += handle.dispatches
            self.ledger.time(name, handle.tenant, wall_us,
                             dispatches=handle.dispatches)

    # -- per-step dispatch accounting ------------------------------------
    def step_begin(self) -> None:
        if not self.enabled:
            return
        self._step_t0 = time.monotonic()
        self._step_d0 = self._dispatch_total

    def step_end(self, active: int = 0) -> int:
        """Close the step: record its (occupancy, dispatches) sample, emit
        counter-track points, return the step's dispatch count."""
        if not self.enabled or self._step_t0 is None:
            return 0
        d = self._dispatch_total - self._step_d0
        self._step_t0 = None
        self._step_samples.append((int(active), d))
        self._g_dps.set(self.dispatches_per_step())
        if TRACER.recording:
            TRACER.counter("dispatches", {"per_step": d}, tid=TID_ENGINE)
            TRACER.counter(
                "sealed_bytes",
                {b: n for b, n in self.ledger.bucket_bytes.items()},
                tid=TID_ENGINE)
        return d

    @property
    def dispatch_total(self) -> int:
        return self._dispatch_total

    @property
    def steps(self) -> int:
        return len(self._step_samples)

    @property
    def max_occupancy(self) -> int:
        return max((occ for occ, _ in self._step_samples), default=0)

    def dispatches_per_step(self, at_max_occupancy: bool = True) -> float:
        """Mean dispatches per gateway step over the window's samples.

        at_max_occupancy=True (the default, and the headline metric)
        averages only the steps taken at the window's maximum observed
        occupancy — the steady-state decode regime, where the fused-path
        target is exactly one dispatch.
        """
        samples = self._step_samples
        if at_max_occupancy:
            occ = self.max_occupancy
            samples = [s for s in samples if s[0] == occ]
        if not samples:
            return 0.0
        return sum(d for _, d in samples) / len(samples)

    # -- reporting -------------------------------------------------------
    def report(self, model=None, clock_hz: float | None = None) -> dict:
        """Profile document: per-phase columns and the drift table.

        ``model`` prices sealed bytes for the predicted-vs-measured drift
        table (an object with ``crypto_cycles(n_bytes)``; default the
        card's analytic model, ``core.overhead.H100``), at ``clock_hz``
        (default the model's own clock).
        """
        model, clock_hz = priced_by(model, clock_hz)
        return {
            "benchmark": "profile",
            "model": getattr(model, "name", str(model)),
            "steps": self.steps,
            "max_occupancy": self.max_occupancy,
            "dispatch_total": self._dispatch_total,
            "dispatches_per_step": self.dispatches_per_step(),
            "dispatches_per_step_overall": self.dispatches_per_step(
                at_max_occupancy=False),
            "phases": self.ledger.reconcile(model, clock_hz=clock_hz),
            "tenants": [
                {"tenant": t, **cols}
                for t, cols in sorted(self.ledger.tenant_totals().items())],
            "buckets": dict(self.ledger.bucket_bytes),
        }

    def reset_window(self) -> None:
        """Fresh measurement window: drop step samples and ledger rows.

        The mirrored registry counters are windowed metrics — the gateway's
        ``reset_metrics()`` zeroes them via ``MetricsRegistry.reset()`` and
        calls this for the profiler's own state, in that order."""
        self._step_samples.clear()
        self._step_t0 = None
        self.ledger.reset_window()
