"""CostLedger — per-phase / per-tenant crypto-cost attribution.

The §3.4 story says sealing cost is O(bytes written); the pool's windowed
``kv_pool_sealed_bytes_{prefill,decode,swap}_total`` counters prove the
*totals*, but cannot say which engine phase (decode write-back vs page
close vs COW break vs swap traffic) or which tenant generated them.  The
ledger closes that gap: every ``PagedKVPool.note_*`` call site that charges
a sealed-bytes bucket also charges a ledger row keyed by

    (phase, tenant)         phase in PHASES below, tenant = page owner

with the SAME byte formula — so by construction the ledger's per-bucket
sums reconcile *exactly* against the pool counters, and the
derived ``sealed_bytes_per_token`` gateway metric is reproducible from
ledger rows alone.

Derived columns (deterministic protocol accounting, not measurements):

    cipher_blocks   Threefry-2x32 keystream blocks = ceil(bytes / 8)
                    (one block yields two uint32 keystream words)
    mac_ops         chunk-tag computations = ceil(words / chunk_words)
                    with words = bytes / 4 — the MAC granularity knob of
                    core/mac.block_tags

Wall time and dispatch counts per phase come from the Profiler
(obs/profiler.py), which owns a ledger and adds its timing columns.

``reconcile`` turns the measured rows into a drift report against an
analytic model: per phase, the crypto cycles the model predicts for the
charged bytes vs the wall time the profiler measured.  Its *movement*
between runs is the regression signal — a phase whose measured/predicted
ratio jumps grew real work the byte accounting did not capture.

Every value here is untrusted-side telemetry: byte counts, block counts
and timestamps derive from ciphertext sizes and host clocks, never from
plaintext or key material.
"""
from __future__ import annotations

from .metrics import MetricsRegistry

# engine phases the profiler/ledger attribute to (docs/OBSERVABILITY.md):
#   prefill        batched chunk-prefill dispatch (whole pages sealed)
#   decode         decode-step dispatch incl. the fused seal_slot write-back
#   close          OPEN -> CLOSED page transitions (page-close MAC)
#   reopen         CLOSED -> OPEN transitions (swap-in tail pages)
#   renonce        nonce-lane refresh re-seals (monitor action)
#   cow            copy-on-write breaks of shared prefix pages
#   swap_out       host-side export + store put of preempted sealed pages
#   swap_in        store fetch + page re-install (reopen timed separately)
#   prefix_publish umbrella span over a prefix publication (its prefill /
#                  close crypto is charged to those phases, not here)
PHASES = ("prefill", "decode", "close", "reopen", "renonce", "cow",
          "swap_out", "swap_in", "prefix_publish")

# bytes per Threefry-2x32 keystream block: one call yields 2 uint32 words
CIPHER_BLOCK_BYTES = 8

_COLUMNS = ("calls", "dispatches", "wall_us", "sealed_bytes",
            "cipher_blocks", "mac_ops")


def cipher_blocks_for(n_bytes: int) -> int:
    return -(-int(n_bytes) // CIPHER_BLOCK_BYTES)


def mac_ops_for(n_bytes: int, chunk_words: int) -> int:
    words = -(-int(n_bytes) // 4)
    return -(-words // max(1, int(chunk_words)))


class CostLedger:
    """(phase, tenant)-keyed cost rows, mirrored into a MetricsRegistry."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 chunk_words: int = 128):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.chunk_words = int(chunk_words)
        self._rows: dict[tuple, dict] = {}     # (phase, tenant) -> columns
        self.bucket_bytes: dict[str, int] = {"prefill": 0, "decode": 0,
                                             "swap": 0}

    def _row(self, phase: str, tenant: str | None) -> dict:
        key = (phase, tenant or "-")
        row = self._rows.get(key)
        if row is None:
            row = self._rows[key] = {c: 0 for c in _COLUMNS}
        return row

    def charge(self, phase: str, tenant: str | None, sealed_bytes: int,
               bucket: str, chunk_words: int | None = None) -> None:
        """Attribute ``sealed_bytes`` of sealing work to (phase, tenant).

        ``bucket`` names the pool's sealed-bytes accounting bucket
        ("prefill" / "decode" / "swap") the same bytes were charged to, so
        per-bucket ledger sums reconcile exactly against the pool counters.
        """
        n = int(sealed_bytes)
        cw = self.chunk_words if chunk_words is None else int(chunk_words)
        row = self._row(phase, tenant)
        blocks = cipher_blocks_for(n)
        tags = mac_ops_for(n, cw)
        row["sealed_bytes"] += n
        row["cipher_blocks"] += blocks
        row["mac_ops"] += tags
        self.bucket_bytes[bucket] = self.bucket_bytes.get(bucket, 0) + n
        t = tenant or "-"
        reg = self.registry
        reg.counter("cost_sealed_bytes_total",
                    "sealed bytes attributed per phase and tenant",
                    phase=phase, tenant=t).inc(n)
        reg.counter("cost_cipher_blocks_total",
                    "Threefry keystream blocks attributed per phase/tenant",
                    phase=phase, tenant=t).inc(blocks)
        reg.counter("cost_mac_ops_total",
                    "MAC chunk-tag operations attributed per phase/tenant",
                    phase=phase, tenant=t).inc(tags)

    def time(self, phase: str, tenant: str | None, wall_us: float,
             calls: int = 1, dispatches: int = 0) -> None:
        """Record a timed phase execution (the Profiler's exit hook)."""
        row = self._row(phase, tenant)
        row["calls"] += int(calls)
        row["dispatches"] += int(dispatches)
        row["wall_us"] += float(wall_us)
        reg = self.registry
        reg.counter("profiler_phase_calls_total",
                    "timed phase executions", phase=phase).inc(calls)
        reg.counter("profiler_phase_dispatches_total",
                    "jitted dispatches issued inside the phase",
                    phase=phase).inc(dispatches)
        reg.counter("profiler_phase_wall_us_total",
                    "device-synchronized wall time inside the phase, us",
                    phase=phase).inc(wall_us)

    # -- views -----------------------------------------------------------
    def rows(self) -> list[dict]:
        """Per-(phase, tenant) rows, phase order then tenant order."""
        order = {p: i for i, p in enumerate(PHASES)}
        out = []
        for (phase, tenant), cols in sorted(
                self._rows.items(),
                key=lambda kv: (order.get(kv[0][0], len(order)), kv[0])):
            out.append({"phase": phase, "tenant": tenant, **cols})
        return out

    def phase_totals(self) -> dict[str, dict]:
        """Rows aggregated over tenants: {phase: columns}."""
        out: dict[str, dict] = {}
        for (phase, _tenant), cols in self._rows.items():
            agg = out.setdefault(phase, {c: 0 for c in _COLUMNS})
            for c in _COLUMNS:
                agg[c] += cols[c]
        return out

    def tenant_totals(self) -> dict[str, dict]:
        """Rows aggregated over phases: {tenant: columns}."""
        out: dict[str, dict] = {}
        for (_phase, tenant), cols in self._rows.items():
            agg = out.setdefault(tenant, {c: 0 for c in _COLUMNS})
            for c in _COLUMNS:
                agg[c] += cols[c]
        return out

    def reconcile(self, model, clock_hz: float = 940e6) -> list[dict]:
        """Drift report: measured wall time vs the analytic model.

        ``model`` has a ``crypto_cycles(n_bytes)`` method; that
        term (CTR throughput + pipeline fill + MAC chunk tags) prices the
        bytes each phase charged, converted to us at ``clock_hz``.  Rows
        with no bytes (host-copy phases, umbrella spans) predict 0 and
        report ratio None.
        """
        out = []
        order = {p: i for i, p in enumerate(PHASES)}
        totals = self.phase_totals()
        for phase in sorted(totals, key=lambda p: order.get(p, len(order))):
            cols = totals[phase]
            cycles = model.crypto_cycles(cols["sealed_bytes"])
            predicted_us = 1e6 * cycles / clock_hz
            ratio = (cols["wall_us"] / predicted_us if predicted_us > 0
                     else None)
            out.append({"phase": phase, "calls": cols["calls"],
                        "dispatches": cols["dispatches"],
                        "sealed_bytes": cols["sealed_bytes"],
                        "cipher_blocks": cols["cipher_blocks"],
                        "mac_ops": cols["mac_ops"],
                        "wall_us": cols["wall_us"],
                        "predicted_us": predicted_us,
                        "ratio": ratio})
        return out

    def reset_window(self) -> None:
        """Drop the window's rows (the registry counters are windowed too:
        ``MetricsRegistry.reset()`` zeroes them independently)."""
        self._rows.clear()
        for k in self.bucket_bytes:
            self.bucket_bytes[k] = 0
