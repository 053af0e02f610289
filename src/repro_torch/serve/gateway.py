"""SecureGateway — the multi-tenant serving front-end (torch port of
``repro.serve.gateway``; ``device`` places every channel key, the KV pool
and the engine's work, on the card unless the caller passes "cpu").

The gateway is the host-program role of the paper, generalized to many
mutually-distrusting tenants on one trusted accelerator:

  * one *provider* session seals the model weights and MACs the global
    serve-step launch descriptors (Rule 3);
  * each tenant gets its own attested session (serve/sessions.py) whose key
    seals that tenant's KV pages in the shared pool (serve/kv_pager.py);
  * a preemptive priority-class scheduler (serve/scheduler.py) interleaves
    prefill and decode of mixed-length requests at variable occupancy, and
    swaps sealed KV of preempted requests into a host-tier SealedStore
    (store/sealed_store.py) — so the pool can be oversubscribed: total
    reserved pages may exceed physical pages and everything still completes.

API: ``submit`` / ``step`` / ``collect`` (+ ``drain``), with throughput,
latency, preemption and pool-occupancy metrics aggregated per gateway and
per tenant.

Observability (src/repro_torch/obs/; docs/OBSERVABILITY.md, and for the
process tracer docs/OBSERVABILITY_torch.md): every gateway owns

  * one ``MetricsRegistry`` — all counters/gauges/histograms of the pool,
    scheduler and gateway; ``metrics()`` is a snapshot of it and
    ``metrics_text()`` the Prometheus exposition;
  * the process's tracer (``obs.trace.TRACER``; ``trace=True`` switches it
    on until ``close()``) — request lifecycle, scheduler and engine phase
    spans, exported via ``export_trace`` (Perfetto-loadable);
  * one ``AuditLog`` — an HMAC-chained record of every trust event,
    keyed off the provider session; ``verify_audit()`` checks the chain.
"""
from __future__ import annotations

import time
import weakref

import numpy as np

from ..core.policy import SecurityConfig
from ..obs import (AuditLog, MetricsRegistry, Monitor, MonitorConfig,
                   Profiler, TID_ENGINE, TRACER)
from ..obs import rules as obs_rules
from ..store import SealedStore
from .engine import PagedEngine
from .kv_pager import PagedKVPool
from .prefix_cache import PREFIX_TENANT, PrefixRegistry
from .scheduler import Scheduler
from .sessions import SessionManager

PROVIDER = "_provider"
RESERVED_TENANTS = (PROVIDER, PREFIX_TENANT)


class SecureGateway:
    def __init__(self, cfg, params, *, security: str = "trusted",
                 max_slots: int = 4, page_size: int = 8, n_pages: int = 64,
                 max_pages_per_seq: int = 4, rotate_every: int = 0,
                 chunk_words: int = 128, device_id: str = "gpu-0",
                 store: SealedStore | None = None, open_pages: bool = True,
                 prefill_chunk: int = 0, trace: bool = False,
                 monitor: bool = True,
                 monitor_config: MonitorConfig | None = None,
                 device="cuda"):
        """open_pages: slice-seal the tail page of each sequence (per-token
        seal cost O(bytes written), paper §3.4) instead of re-sealing the
        whole page every decode step.  False keeps the legacy whole-page
        baseline — token streams are bitwise-identical either way.

        prefill_chunk: tokens per batched prefill chunk (multiple of
        page_size; 0 = whole-prompt chunks, i.e. max_pages_per_seq pages).
        Smaller chunks cut TTFT under bursty admission.

        trace: switch the process's tracer on, its buffer emptied, to
        record request-lifecycle, scheduler and engine-phase trace events
        (export with ``export_trace``) until ``close()`` or until the
        gateway is collected; off by default, when it records only while a
        torch profiler does.  A later ``trace=True`` gateway takes the
        tracer over.

        monitor: evaluate the streaming SLO/posture Monitor at the end of
        every step and let it drive scheduler actions (tamper-storm
        quarantine, occupancy spill, nonce-lane refresh) over its action
        bus.  monitor_config tunes the thresholds (obs/rules.py); latency
        SLO bounds default off, security/headroom rules default on."""
        self.cfg = cfg
        sec = (SecurityConfig() if security == "trusted"
               else SecurityConfig.off())
        self.store = store if store is not None else SealedStore()
        self.sessions = SessionManager(device_id, config=sec,
                                       rotate_every=rotate_every,
                                       store=self.store, device=device)
        self.device = self.sessions.device
        provider = self.sessions.register(PROVIDER).channel
        # the audit chain keys off the provider session (the same root of
        # trust that MACs launch descriptors); it must exist before any
        # tenant registers so every attest lands in the chain — the
        # provider's own attest is emitted retroactively by attach_audit
        self.audit = AuditLog(provider.key_bytes)
        self.sessions.attach_audit(self.audit)
        self.store.audit = self.audit
        # trace=True holds the process tracer until close() or collection
        self._trace_owner = object()
        self._trace_stop = None
        if trace:
            TRACER.start(self._trace_owner)
            self._trace_stop = weakref.finalize(self, TRACER.stop,
                                                self._trace_owner)
        TRACER.name_process("secure-gateway")
        TRACER.name_thread(TID_ENGINE, "engine")
        self.registry = MetricsRegistry()
        self.profiler = Profiler(registry=self.registry,
                                 chunk_words=chunk_words)
        sealed = sec.enabled
        params_dev = provider.upload_tree(params) if sealed else params
        self.pool = PagedKVPool(
            n_pages=n_pages, page_size=page_size, n_layers=cfg.n_layers,
            n_kv_heads=cfg.n_kv_heads, hd=cfg.hd, dtype=cfg.act_dtype,
            chunk_words=chunk_words, sealed=sealed, open_pages=open_pages,
            metrics=self.registry, audit=self.audit,
            profiler=self.profiler, device=self.device)
        self.engine = PagedEngine(
            cfg=cfg, params=params_dev, channel=provider, pool=self.pool,
            max_slots=max_slots, max_pages=max_pages_per_seq,
            prefill_chunk=prefill_chunk, profiler=self.profiler)
        # the prefix-cache publisher gets its own attested session: shared
        # prefix pages seal under per-entry keys derived from THIS channel,
        # never under the provider's weight/launch channel or a tenant key
        prefix_ch = self.sessions.register(PREFIX_TENANT).channel
        self.prefixes = PrefixRegistry(
            self.engine, self.pool, self.store, self.sessions, prefix_ch,
            audit=self.audit, metrics=self.registry)
        self.scheduler = Scheduler(self.engine, self.pool, self.sessions,
                                   max_slots, max_pages_per_seq,
                                   store=self.store, provider=provider,
                                   audit=self.audit,
                                   prefixes=self.prefixes)
        # the window starts at its first step (set-up is not in it)
        self._t_start: float | None = None
        self._c_steps = self.registry.counter(
            "gateway_steps_total", "scheduling steps this window")
        self._h_token_lat = self.registry.histogram(
            "token_latency_ms", "per-token step latency, ms")
        self._h_occ = self.registry.histogram(
            "pool_occupancy_ratio", "live/usable pages, sampled per step")
        # the monitor's clock: a plain monotone python counter, NOT the
        # windowed steps counter above — reset_metrics() zeroes that one,
        # which would run the monitor's cooldowns and storm windows
        # backwards mid-flight
        self._nsteps = 0
        self.monitor = None
        if monitor:
            self.monitor = Monitor(config=monitor_config,
                                   registry=self.registry, audit=self.audit)
            self.monitor.on(obs_rules.ACT_QUARANTINE,
                            self._on_alert_quarantine)
            self.monitor.on(obs_rules.ACT_SPILL, self._on_alert_spill)
            self.monitor.on(obs_rules.ACT_RENONCE, self._on_alert_renonce)

    def reset_metrics(self) -> None:
        """Start a fresh measurement window (e.g. after a warm-up pass).

        One call on the shared registry resets every *windowed* metric the
        pool, scheduler and gateway registered — there is no per-object
        reset list to drift out of sync.  Lifetime metrics (allocator
        totals, peak-live gauge) are exempt by construction.  The window's
        clock starts at the next ``step()``."""
        self._t_start = None
        self.registry.reset()
        self.profiler.reset_window()

    # -- tenant + request lifecycle -------------------------------------
    def register_tenant(self, tenant_id: str):
        """Run the §3.2 attestation handshake for a tenant (idempotent)."""
        if tenant_id in RESERVED_TENANTS:
            raise ValueError("reserved tenant id")
        return self.sessions.register(tenant_id)

    def register_prefix(self, tokens):
        """Publish a shared prompt prefix (system prompt, few-shot header):
        prefilled once under the prefix channel, sealed per-entry,
        content-hashed into the store, mapped read-only into any matching
        request.  Idempotent per token sequence. -> PrefixEntry"""
        return self.prefixes.register(np.asarray(tokens, np.int32))

    def evict_prefix(self, prefix_id: int) -> bool:
        """Retire a published prefix (pages freed once the last reader
        unmaps; new submits stop matching immediately)."""
        return self.prefixes.evict(prefix_id)

    def submit(self, tenant_id: str, prompt, max_new: int,
               priority: int = 0) -> int:
        """Queue a generation request under the tenant's session. -> rid

        priority: higher classes may preempt running lower-class requests
        (their sealed KV swaps out to the store and back — see scheduler).
        """
        self.register_tenant(tenant_id)
        return self.scheduler.submit(tenant_id, np.asarray(prompt, np.int32),
                                     max_new, priority=priority)

    def step(self) -> dict:
        """Advance the engine one scheduling step (admit + decode + evict)."""
        t0 = time.monotonic()
        if self._t_start is None:
            self._t_start = t0
        provider = self.sessions.channel(PROVIDER)
        active = [r.rid for r in self.scheduler.active]
        step_no = int(self._c_steps.value)
        self.profiler.step_begin()
        with TRACER.span("serve_step", cat="serve",
                              args={"step": step_no, "active": len(active),
                                    "queued": len(self.scheduler.queue)}):
            events = provider.launch(
                self.scheduler.step,
                {"op": "serve_step", "step": step_no,
                 "queued": len(self.scheduler.queue), "active": active})
        self.profiler.step_end(active=len(self.scheduler.active))
        dt_ms = (time.monotonic() - t0) * 1e3
        self._c_steps.inc()
        usable = max(1, self.pool.n_pages - 1)
        self._h_occ.observe(self.pool.live_pages / usable)
        for rid, _tok in events["emitted"]:
            self._h_token_lat.observe(dt_ms)
            req = self.scheduler.requests[rid]
            self.registry.counter("tokens_total", "tokens emitted",
                                  tenant=req.tenant_id).inc()
        self._nsteps += 1
        if self.monitor is not None:
            self._monitor_observe()
        return events

    # -- monitor sample + action handlers --------------------------------
    def _monitor_observe(self) -> None:
        """Feed the monitor this step's SLO values, observation counts and
        trusted-side headroom reports, then let fired alerts act."""
        lat = self._h_token_lat
        ttft = self.scheduler._h_ttft
        elapsed = self._elapsed()
        usable = max(1, self.pool.n_pages - 1)
        slo = {
            "ttft_p95_ms": ttft.percentile(0.95) if ttft.count else None,
            "token_p95_ms": lat.percentile(0.95) if lat.count else None,
            "tok_per_s": (lat.count / elapsed) if elapsed > 0 else None,
            "occupancy_pct": 100.0 * self.pool.live_pages / usable,
        }
        counts = {
            "ttft_p95_ms": ttft.count,
            "token_p95_ms": lat.count,
            "tok_per_s": lat.count,
            "occupancy_pct": self._nsteps,
        }
        headroom = self.pool.headroom()
        cap = self.store.capacity_bytes
        if cap:
            free_pct = 100.0 * max(0, cap - self.store.nbytes) / cap
            headroom.append({"source": "store_capacity", "id": "store",
                             "remaining": free_pct,
                             "capacity_bytes": cap})
        self.monitor.observe(self._nsteps, slo=slo, counts=counts,
                             headroom=headroom)

    def _on_alert_quarantine(self, alert) -> None:
        tenant = alert.tenant
        if not tenant or tenant in RESERVED_TENANTS:
            return
        if self.sessions.is_quarantined(tenant):
            return
        self.scheduler.quarantine_tenant(tenant, reason=alert.rule)

    def _on_alert_spill(self, alert) -> None:
        self.scheduler.proactive_spill()

    def _on_alert_renonce(self, alert) -> None:
        page = alert.detail.get("id")
        if page is not None:
            self.scheduler.refresh_page_lane(int(page))

    # -- quarantine (operator surface) ------------------------------------
    def quarantine(self, tenant_id: str, reason: str = "manual") -> list:
        """Drain + bar a tenant; returns the drained rids (audit-logged)."""
        if tenant_id in RESERVED_TENANTS:
            raise ValueError("cannot quarantine a reserved session")
        return self.scheduler.quarantine_tenant(tenant_id, reason=reason)

    def release_quarantine(self, tenant_id: str) -> bool:
        return self.scheduler.release_tenant(tenant_id)

    def quarantined(self) -> list:
        return self.sessions.quarantined

    def dashboard(self, tail: int = 8) -> str:
        """Terminal posture snapshot (obs/dash.py)."""
        from ..obs import dash
        return dash.render_gateway(self, tail=tail)

    def collect(self, rid: int, max_steps: int = 100_000) -> np.ndarray:
        """Step until ``rid`` finishes; return its tokens (int32 array).

        A poisoned request (failed page/weight verification) still returns —
        its last token is the TOKEN_POISON sentinel and ``status(rid)`` is
        "poisoned".
        """
        req = self.scheduler.requests[rid]
        for _ in range(max_steps):
            if req.finished:
                break
            self.step()
        if not req.finished:
            raise RuntimeError(f"request {rid} did not finish")
        return np.asarray(req.tokens_out, np.int32)

    def status(self, rid: int) -> str:
        return self.scheduler.requests[rid].status

    def drain(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.scheduler.idle:
                return
            self.step()
        raise RuntimeError("gateway did not drain")

    # -- metrics ---------------------------------------------------------
    def _elapsed(self) -> float:
        """Seconds since the window's first step (0 before it)."""
        if self._t_start is None:
            return 0.0
        return time.monotonic() - self._t_start

    def metrics(self) -> dict:
        """Snapshot of the measurement window — same keys as ever, now
        computed from the registry (percentiles are nearest-rank; the old
        ad-hoc ``int(p * len)`` indexing biased small windows low).
        ``elapsed_s`` and ``tok_per_s`` count from the window's first
        ``step()``."""
        lat = self._h_token_lat
        elapsed = self._elapsed()
        n_tok = lat.count
        rotations = sum(s.rotations for s in
                        (self.sessions.get(t) for t in self.sessions.tenants))
        sched = self.scheduler
        swaps = sched.swap_stats
        pf = sched.prefill_stats
        ps_stats = self.pool.stats
        dec_tok = ps_stats["decode_tokens"]
        per_tenant = {
            dict(labels)["tenant"]: m.value
            for labels, m in self.registry.family("tokens_total").items()}
        return {
            "steps": int(self._c_steps.value),
            "tokens": n_tok,
            "elapsed_s": elapsed,
            "tok_per_s": n_tok / elapsed if elapsed > 0 else 0.0,
            "p50_token_ms": lat.percentile(0.50),
            "p95_token_ms": lat.percentile(0.95),
            "mean_ttft_ms": sched._h_ttft.mean,
            "preempted_ttft_ms": sched._h_pre_ttft.mean,
            "preempted_requests": sched._h_pre_ttft.count,
            "swap_outs": swaps["swap_outs"],
            "swap_ins": swaps["swap_ins"],
            "swapped_bytes": swaps["swapped_bytes"],
            "pool_occupancy_pct": 100.0 * self._h_occ.mean,
            # chunked batched prefill
            "prefill_chunks": pf["chunks"],
            "prefill_chunk_tokens": pf["chunk_tokens"],
            "prefill_chunk_occupancy_pct": (
                100.0 * pf["chunk_lanes"]
                / (pf["chunks"] * self.engine.max_slots)
                if pf["chunks"] else 0.0),
            # §3.4 sealing cost accounting (ciphertext bytes through seal)
            "sealed_bytes_prefill": ps_stats["sealed_bytes_prefill"],
            "sealed_bytes_decode": ps_stats["sealed_bytes_decode"],
            "sealed_bytes_swap": ps_stats["sealed_bytes_swap"],
            "decode_tokens": dec_tok,
            "sealed_bytes_per_token": (
                ps_stats["sealed_bytes_decode"] / dec_tok if dec_tok
                else 0.0),
            "page_closes": ps_stats["page_closes"],
            "page_reopens": ps_stats["page_reopens"],
            # sealed prefix cache
            "prefix_published": int(self.prefixes._c_published.value),
            "prefix_hits": int(self.prefixes._c_hits.value),
            "prefix_misses": int(self.prefixes._c_misses.value),
            "prefix_hit_rate": (
                self.prefixes._c_hits.value
                / (self.prefixes._c_hits.value
                   + self.prefixes._c_misses.value)
                if (self.prefixes._c_hits.value
                    + self.prefixes._c_misses.value) else 0.0),
            "prefix_pages_saved": int(self.prefixes._c_pages_saved.value),
            "prefix_cow_breaks": int(self.pool._c_cow_breaks.value),
            "tokens_per_tenant": per_tenant,
            "kv_pages_peak": self.pool.stats["peak_live"],
            "kv_pages_free": self.pool.free_pages,
            # ROADMAP item 1: jitted dispatches per step at max occupancy
            "dispatches_per_step": self.profiler.dispatches_per_step(),
            "dispatch_total": self.profiler.dispatch_total,
            "rotations": rotations,
            "launches_verified": self.sessions.channel(
                PROVIDER).device_regs.last_nonce,
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition of the whole registry."""
        return self.registry.to_prometheus()

    def profile_report(self, model=None,
                       clock_hz: float | None = None) -> dict:
        """Per-phase cost attribution + predicted-vs-measured drift table
        for the current window, against an analytic cost ``model`` (the
        card's, ``core.overhead.H100``, by default)."""
        return self.profiler.report(model=model, clock_hz=clock_hz)

    # -- trace + audit export --------------------------------------------
    def export_trace(self, path: str, fmt: str = "chrome") -> int:
        """Write the process tracer's buffer: ``chrome`` (Perfetto-loadable
        JSON object) or ``jsonl`` (one event per line).  -> event count"""
        if fmt == "chrome":
            return TRACER.to_chrome_trace(path)
        if fmt == "jsonl":
            return TRACER.to_jsonl(path)
        raise ValueError(f"unknown trace format {fmt!r}")

    def close(self) -> None:
        """Switch the process tracer off again if this gateway switched it
        on (``trace=True``) and still holds it; its buffer stays for
        export."""
        if self._trace_stop is not None:
            self._trace_stop()

    def export_audit(self, path: str, key_path: str | None = None) -> int:
        """Write the audit log as JSONL (+ signed trailer); optionally also
        write the derived verification key for offline auditors."""
        n = self.audit.to_jsonl(path)
        if key_path is not None:
            self.audit.export_key(key_path)
        return n

    def verify_audit(self) -> dict:
        return self.audit.verify_chain()
