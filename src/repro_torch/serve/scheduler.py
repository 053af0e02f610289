"""Preemptive priority-class scheduler over the paged sealed KV pool
(torch port of ``repro.serve.scheduler``: the host loop of the port's
serving path).

Requests of any length join an admission queue ordered by (priority desc,
arrival), claim a free *slot* (a lane of the jitted decode step) plus enough
KV pages for prompt + generation, prefill their prompt in fixed-size
*chunks* batched across admitted requests, and then ride the shared decode
step until they finish — joining and leaving at step granularity while
other requests keep decoding (vLLM-style continuous batching, here with
per-tenant sealing).

Chunked batched prefill: a scheduler step is (admit -> prefill-chunk ->
decode).  All requests in the "prefilling" state advance by one
``prefill_chunk``-token chunk in a single jitted call, spliced between the
running batch's decode steps.  Under bursty admission this bounds how long
any waiter (and the running decode batch) stalls behind someone else's long
prompt: TTFT is paid in chunk-sized installments instead of one monolithic
prefill per request at admission.

Admission reserves a request's full page budget up front, so a running
request can never be starved of pages mid-decode by later arrivals.  What
replaced the old FIFO head-of-line block is **preemption**: when the best
waiter cannot be admitted (no free slot, or not enough free pages) and some
running request has strictly lower priority, the scheduler swaps that victim
out — its sealed pages move *verbatim* (ciphertext + tags, no decrypt) into
the SealedStore host tier, the pages return to the pool, and the victim
rejoins the queue.  When resources free up it swaps back in and resumes
decode mid-sequence, bitwise-identical to an uninterrupted run.

Freshness across the swap: the per-page nonces are retained in the request's
``swap_nonces`` (modeling enclave-resident bookkeeping — they never enter
the untrusted store).  The page MAC key is nonce-bound, so a tampered or
stale (replayed) store object fails verification on the next decode step and
NaN-poisons only the owning request.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from ..core import channel as channel_lib
from ..obs import StatsView, request_tid
from ..obs.trace import TRACER
from ..store import SealedStore, StoreError, choose_victim
from .engine import TOKEN_POISON, PagedEngine
from .kv_pager import SCRATCH_PAGE, PagedKVPool
from .sessions import SessionManager

SWAP_KIND = "kv_swap"


class TenantQuarantined(RuntimeError):
    """Admission refused: the tenant is quarantined (monitor action)."""


def swap_object_id(rid: int) -> str:
    return f"kvswap/{rid}"


def _np_dtype(t) -> np.dtype:
    """The numpy dtype ``export_pages`` gives for a pool tensor."""
    return np.dtype(str(t.dtype).removeprefix("torch."))


@dataclasses.dataclass
class Request:
    rid: int
    tenant_id: str
    prompt: np.ndarray              # [S] int32
    max_new: int
    priority: int = 0               # higher preempts lower
    status: str = "queued"          # queued | prefilling | running | swapped
                                    # | done | poisoned | quarantined
    tokens_out: list = dataclasses.field(default_factory=list)
    slot: int = -1
    pages: list = dataclasses.field(default_factory=list)
    prefill_pos: int = 0            # prompt tokens already in the cache
    t_submit: float = 0.0
    t_first: float = 0.0            # first-token (prefill) completion time
    t_last: float = 0.0             # last progress (token / admission) time
    t_done: float = 0.0
    swaps_out: int = 0
    swaps_in: int = 0
    swap_nonces: np.ndarray | None = None   # enclave-retained page nonces
    swap_spent: list | None = None  # per-page nonce-span bumps consumed
    resume_prefill: bool = False    # swapped out mid-prefill
    prefix_id: int = -1             # matched prefix-cache entry (-1 = miss)
    n_shared: int = 0               # shared pages at the head of ``pages``
    shared_mapped: bool = False     # refcounts currently held in the pool

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def seq_len(self) -> int:
        """KV positions currently stored.

        During prefill this is the chunk high-water mark; afterwards it is
        prompt + emitted - 1 (the latest token's KV lands on its decode)."""
        if not self.tokens_out:
            return self.prefill_pos
        return self.prompt_len + len(self.tokens_out) - 1

    @property
    def finished(self) -> bool:
        return self.status in ("done", "poisoned", "quarantined")


class Scheduler:
    def __init__(self, engine: PagedEngine, pool: PagedKVPool,
                 sessions: SessionManager, max_slots: int, max_pages: int,
                 store: SealedStore | None = None, provider=None,
                 audit=None, prefixes=None):
        self.engine = engine
        self.pool = pool
        self.sessions = sessions
        self.prefixes = prefixes    # PrefixRegistry (attached by gateway)
        self.provider = provider    # provider SecureChannel: MACs the
                                    # batched prefill-chunk dispatch
        self.max_slots = max_slots
        self.max_pages = max_pages
        self.store = store if store is not None else SealedStore()
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * max_slots
        self.requests: dict[int, Request] = {}
        self._next_rid = 1
        # its own request lanes and span keys in the process tracer, so
        # that two gateways recording at once keep their requests apart
        self._lane_base = TRACER.lane_base()
        self._span_key = object()
        self.audit = audit          # obs.AuditLog (attached by the gateway)
        # scheduler counters live in the pool's registry so the gateway
        # snapshots one registry; dict-style views keep the historical
        # ``swap_stats`` / ``prefill_stats`` read surface working
        reg = self.metrics = pool.metrics
        self._c_swaps = {
            "swap_outs": reg.counter("sched_swap_outs_total",
                                     "preemption swap-outs"),
            "swap_ins": reg.counter("sched_swap_ins_total",
                                    "preemption swap-ins"),
            "swapped_bytes": reg.counter("sched_swapped_bytes_total",
                                         "sealed bytes moved to the store"),
        }
        self._c_prefill = {
            "chunks": reg.counter("sched_prefill_chunks_total",
                                  "batched prefill-chunk steps"),
            "chunk_lanes": reg.counter("sched_prefill_chunk_lanes_total",
                                       "lanes advanced across chunk steps"),
            "chunk_tokens": reg.counter("sched_prefill_chunk_tokens_total",
                                        "prompt tokens prefilled"),
        }
        self.swap_stats = StatsView(reg, {
            k: c.name for k, c in self._c_swaps.items()})
        self.prefill_stats = StatsView(reg, {
            k: c.name for k, c in self._c_prefill.items()})
        self._h_ttft = reg.histogram("request_ttft_ms",
                                     "submit -> first token, ms")
        self._h_pre_ttft = reg.histogram(
            "request_preempted_ttft_ms",
            "submit -> first token for requests that were swapped out, ms")

    def reset(self) -> None:
        """Fresh measurement window for the scheduler's own metrics."""
        for c in self._c_swaps.values():
            c.reset()
        for c in self._c_prefill.values():
            c.reset()
        self._h_ttft.reset()
        self._h_pre_ttft.reset()

    def _audit(self, kind: str, tenant: str | None, **detail) -> None:
        if self.audit is not None:
            self.audit.append(kind, tenant=tenant, **detail)

    # -- submission ------------------------------------------------------
    def total_pages(self, req: Request) -> int:
        """Logical page-table length: shared prefix pages + private pages."""
        ps = self.pool.page_size
        return -(-(req.prompt_len + req.max_new) // ps)

    def required_pages(self, req: Request) -> int:
        """Pages the request must *allocate* — shared prefix pages are
        mapped read-only, not allocated, so a cache hit shrinks the
        admission footprint (and the preemption feasibility math)."""
        return self.total_pages(req) - req.n_shared

    def submit(self, tenant_id: str, prompt: np.ndarray, max_new: int,
               priority: int = 0) -> int:
        if self.sessions.is_quarantined(tenant_id):
            self._audit("quarantine_reject", tenant_id,
                        reason=self.sessions.quarantine_reason(tenant_id))
            raise TenantQuarantined(
                f"tenant {tenant_id!r} is quarantined "
                f"({self.sessions.quarantine_reason(tenant_id)})")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        now = time.monotonic()
        req = Request(rid=self._next_rid, tenant_id=tenant_id, prompt=prompt,
                      max_new=max_new, priority=priority, t_submit=now,
                      t_last=now)
        usable = self.pool.n_pages - 1          # page 0 is scratch
        if self.total_pages(req) > min(self.max_pages, usable):
            raise ValueError(
                f"request needs {self.total_pages(req)} pages > "
                f"min(max_pages_per_seq={self.max_pages}, pool={usable}) — "
                "it could never be admitted")
        if self.prefixes is not None:
            hit = self.prefixes.lookup(prompt)
            if hit is not None:
                req.prefix_id = hit.prefix_id
                req.n_shared = hit.n_full
        self._next_rid += 1
        self.requests[req.rid] = req
        self.queue.append(req)
        tid = request_tid(req.rid, self._lane_base)
        TRACER.name_thread(tid, f"req {req.rid} ({tenant_id})")
        TRACER.instant("submit", cat="request", tid=tid,
                       args={"rid": req.rid, "tenant": tenant_id,
                             "prompt_len": req.prompt_len,
                             "max_new": max_new,
                             "priority": priority})
        TRACER.begin((self._span_key, req.rid), "queued", cat="request",
                     tid=tid)
        return req.rid

    @property
    def active(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active

    def tenant_quiescent(self, tenant_id: str) -> bool:
        """No sealed state in flight: no live pages *and* no swapped-out KV
        (a rotation would orphan store objects sealed under the old key)."""
        if self.pool.pages_of(tenant_id):
            return False
        return not any(r.status == "swapped" and r.tenant_id == tenant_id
                       for r in self.requests.values())

    # -- monitor actions -------------------------------------------------
    def quarantine_tenant(self, tenant_id: str, reason: str = "") -> list:
        """Drain a tenant and refuse further admission (monitor action).

        Every in-flight request of the tenant — queued, prefilling,
        running, swapped — terminates with status ``quarantined``; its
        slot and pages return to the pool and its swap objects are
        destroyed.  Other tenants' lanes are untouched, so their token
        streams are bitwise-identical to a run without the quarantine.
        Returns the drained rids; the decision is audit-logged.
        """
        self.sessions.quarantine(tenant_id, reason)
        dropped = []
        victims = [r for r in self.requests.values()
                   if r.tenant_id == tenant_id and not r.finished]
        for req in victims:
            if req in self.queue:
                self.queue.remove(req)
            req.status = "quarantined"
            self._evict(req)
            dropped.append(req.rid)
        self._audit("quarantine", tenant_id, reason=reason,
                    dropped=sorted(dropped))
        return sorted(dropped)

    def release_tenant(self, tenant_id: str) -> bool:
        """Lift a quarantine (operator action); audit-logged."""
        released = self.sessions.release(tenant_id)
        if released:
            self._audit("quarantine_release", tenant_id)
        return released

    def proactive_spill(self) -> int | None:
        """Swap out the least-valuable running request ahead of pool
        exhaustion (occupancy-watermark monitor action).  Reuses the
        preemption path verbatim — sealed pages move ciphertext-only into
        the store and the request rejoins the queue — but bypasses the
        priority feasibility gate: the point is freeing pages now, not
        admitting a specific waiter.  Returns the spilled rid (None when
        fewer than two requests are active — spilling the sole tenant of
        the pool frees nothing anyone is waiting for).
        """
        candidates = [r for r in self.active
                      if r.status in ("prefilling", "running")]
        if len(candidates) < 2:
            return None
        victim = min(candidates,
                     key=lambda r: (r.priority, r.t_last, r.rid))
        n_pages = len(victim.pages)
        events = {k: [] for k in ("admitted", "emitted", "finished",
                                  "poisoned", "preempted", "resumed")}
        self._swap_out(victim, events)
        if victim.rid in events["poisoned"]:
            return None
        self._audit("proactive_spill", victim.tenant_id, rid=victim.rid,
                    n_pages=n_pages)
        return victim.rid

    def refresh_page_lane(self, page: int) -> bool:
        """Re-seal ``page`` under a freshly reserved channel nonce lane
        (nonce-headroom monitor action) — the page's budget restarts
        instead of the guard failing closed mid-decode.  ROADMAP item 5.
        """
        owner = self.pool.owner_of(page)
        if owner is None:
            return False
        ch = self.sessions.channel(owner)
        span = self.pool.page_size + 2
        fresh = ch.fresh_nonce(span=span)
        return self.engine.renonce_page(page, fresh, span)

    # -- one scheduling step --------------------------------------------
    def step(self) -> dict:
        events = {"admitted": [], "emitted": [], "finished": [],
                  "poisoned": [], "preempted": [], "resumed": []}
        with TRACER.span("sched.admit", cat="sched"):
            self._admit(events)
        with TRACER.span("sched.prefill", cat="sched"):
            self._prefill_step(events)
        with TRACER.span("sched.decode", cat="sched"):
            self._decode(events)
        return events

    # -- admission + preemption -----------------------------------------
    def _next_waiter(self) -> Request | None:
        if not self.queue:
            return None
        return min(self.queue,
                   key=lambda r: (-r.priority, r.t_submit, r.rid))

    def _free_slot(self) -> int | None:
        for slot in range(self.max_slots):
            if self.slots[slot] is None:
                return slot
        return None

    def _admit(self, events: dict) -> None:
        """Admit waiters in priority order; preempt lower-priority running
        requests when admission stalls on slots or pages."""
        while True:
            req = self._next_waiter()
            if req is None:
                return
            if (req.prefix_id >= 0 and not req.shared_mapped
                    and (self.prefixes is None
                         or self.prefixes.get(req.prefix_id) is None)):
                # the entry was evicted while this request queued — fall
                # back to an ordinary unshared admission
                req.prefix_id, req.n_shared = -1, 0
            n_pages = self.required_pages(req)
            slot = self._free_slot()
            if slot is None or n_pages > self.pool.free_pages:
                # feasibility first: preempting is two full sealed-page
                # copies for the victim, so never swap anyone out unless
                # evicting the eligible class actually admits the waiter
                eligible = [r for r in self.active
                            if r.priority < req.priority]
                # shared prefix pages are not reclaimable by preempting any
                # single request — only its private pages return to the pool
                reclaimable = sum(len(r.pages) - r.n_shared for r in eligible)
                if ((slot is None and not eligible)
                        or self.pool.free_pages + reclaimable < n_pages):
                    return      # wait: swapping now would be futile
                victim = choose_victim(self.active, req.priority)
                self._swap_out(victim, events)
                continue        # re-evaluate with the freed slot/pages
            self.queue.remove(req)
            if req.status == "swapped":
                self._swap_in(req, slot, events)
            else:
                self._admit_fresh(req, slot, events)

    def _admit_fresh(self, req: Request, slot: int, events: dict) -> None:
        entry = (self.prefixes.get(req.prefix_id)
                 if self.prefixes is not None and req.prefix_id >= 0
                 else None)
        n_pages = self.required_pages(req)
        sess = self.sessions.get(req.tenant_id)
        # rotation point: tenant has no sealed state in flight right now
        if (self.sessions.rotation_due(req.tenant_id)
                and self.tenant_quiescent(req.tenant_id)):
            self.sessions.rotate(req.tenant_id)
        ch = sess.channel
        ps = self.pool.page_size
        nonces = [ch.fresh_nonce(span=ps + 2) for _ in range(n_pages)]
        priv = self.pool.alloc(n_pages, req.tenant_id,
                               ch.key_words, nonces, span=ps + 2)
        req.slot = slot
        req.t_last = time.monotonic()
        self.slots[slot] = req
        if entry is None:
            req.pages = priv
            req.status = "prefilling"
            req.prefill_pos = 0
            TRACER.begin((self._span_key, req.rid), "prefill", cat="request",
                         tid=request_tid(req.rid, self._lane_base),
                         args={"pages": n_pages, "slot": slot})
            return
        # -- prefix-cache hit: map the shared full pages read-only -------
        shared = list(entry.pages[:entry.n_full])
        self.pool.map_shared(shared)
        req.pages = shared + priv
        req.n_shared = entry.n_full
        req.shared_mapped = True
        # grant: the entry's page key wrapped to THIS tenant's session key,
        # bound to (prefix, tenant) — the only road from a tenant session
        # to the prefix plaintext runs through this unwrap
        wrapped = self.prefixes.wrap_for(entry, req.tenant_id)
        self.prefixes.note_map(entry, entry.n_full)
        self._audit("prefix_map", req.tenant_id, rid=req.rid,
                    prefix_id=entry.prefix_id, object=entry.object_id,
                    n_shared=entry.n_full, wrapped=wrapped.hex())
        zero_suffix = req.prompt_len == entry.length
        ok = True
        if zero_suffix and entry.tail_fill:
            # divergence mid-page with nothing left to prefill: break the
            # shared partial tail copy-on-write into the tenant's first
            # private page, under the key the tenant just unwrapped
            src_key = channel_lib.unwrap_key_words(
                wrapped, ch.key_bytes,
                self.prefixes.wrap_context(entry.prefix_id, req.tenant_id))
            self.pool.map_shared([entry.tail_page])
            ok = self.engine.cow_page(entry.tail_page, priv[0], src_key,
                                      entry.tail_fill)
            self.pool.unmap_shared([entry.tail_page])
            self._audit("cow_break", req.tenant_id, rid=req.rid,
                        prefix_id=entry.prefix_id, src=int(entry.tail_page),
                        dst=int(priv[0]), fill=entry.tail_fill, ok=bool(ok))
        if zero_suffix:
            # the whole prompt is cached: skip prefill, join decode with
            # the greedy first token computed once at publish (decode is
            # deterministic, so it is bitwise what this lane would emit)
            req.prefill_pos = req.prompt_len
            req.status = "running"
            req.t_first = time.monotonic()
            TRACER.begin((self._span_key, req.rid), "decode", cat="request",
                         tid=request_tid(req.rid, self._lane_base),
                         args={"pages": n_pages, "slot": slot,
                               "prefix": entry.prefix_id})
            good = ok and entry.first_ok
            self._record_token(req, entry.first_token if good
                               else TOKEN_POISON, events, ok=good)
        else:
            # suffix diverges at/after the shared full pages: re-prefill
            # from the page-aligned floor (chunks write whole pages, and
            # recomputed KV is bitwise-identical for identical tokens)
            req.prefill_pos = entry.n_full * ps
            req.status = "prefilling"
            TRACER.begin((self._span_key, req.rid), "prefill", cat="request",
                         tid=request_tid(req.rid, self._lane_base),
                         args={"pages": n_pages, "slot": slot,
                               "prefix": entry.prefix_id,
                               "skip_tokens": req.prefill_pos})

    # -- chunked batched prefill ----------------------------------------
    def _prefill_step(self, events: dict) -> None:
        """Advance every prefilling slot by one chunk, in one batched call.

        A prompt shorter than the chunk completes immediately (its first
        token is recorded and it joins the decode batch this very step);
        longer prompts pay their prefill in installments so a burst of
        arrivals never serializes whole prompts in front of each other.
        """
        lanes = [r for r in self.slots
                 if r is not None and r.status == "prefilling"]
        if not lanes:
            return
        B, P = self.max_slots, self.max_pages
        C = self.engine.prefill_chunk
        tokens = np.zeros((B, C), np.int32)
        start = np.zeros((B,), np.int32)
        valid = np.ones((B,), np.int32)         # >=1 keeps idle slices legal
        active = np.zeros((B,), bool)
        page_tables = np.full((B, P), SCRATCH_PAGE, np.int32)
        lane_desc = []
        for r in lanes:
            b = r.slot
            chunk = r.prompt[r.prefill_pos:r.prefill_pos + C]
            tokens[b, :len(chunk)] = chunk
            start[b] = r.prefill_pos
            valid[b] = len(chunk)
            active[b] = True
            page_tables[b, :len(r.pages)] = r.pages
            desc = {"rid": r.rid, "tenant": r.tenant_id,
                    "start": int(r.prefill_pos), "len": int(len(chunk)),
                    "pages": list(r.pages)}
            # Rule 3, tenant side: each tenant's channel attests the chunk
            # range and pages being advanced on its behalf
            self.sessions.channel(r.tenant_id).launch(
                lambda: None, {"op": "prefill_chunk", **desc})
            self.sessions.note_launch(r.tenant_id)
            lane_desc.append(desc)
        # Rule 3, dispatch side: the batched step runs under the provider's
        # MACed launch whose descriptor binds every lane — the verified
        # descriptor gates the compute, as the per-request prefill did
        launch = (self.provider.launch if self.provider is not None
                  else lambda fn, _desc, *a: fn(*a))
        tok, ok = launch(
            self.engine.chunk_prefill,
            {"op": "prefill_chunk_batch", "lanes": lane_desc},
            tokens, start, valid, active, page_tables)
        self._c_prefill["chunks"].inc()
        self._c_prefill["chunk_lanes"].inc(len(lanes))
        self._c_prefill["chunk_tokens"].inc(int(
            sum(valid[r.slot] for r in lanes)))
        now = time.monotonic()
        for r in lanes:
            b = r.slot
            r.prefill_pos += int(valid[b])
            r.t_last = now
            if not bool(ok[b]):
                self._record_token(r, TOKEN_POISON, events, ok=False)
            elif r.prefill_pos >= r.prompt_len:
                r.status = "running"
                r.t_first = now
                TRACER.begin((self._span_key, r.rid), "decode", cat="request",
                             tid=request_tid(r.rid, self._lane_base))
                self._record_token(r, int(tok[b]), events)

    def _swap_out(self, victim: Request, events: dict) -> None:
        """Move a running request's sealed pages into the host-tier store.

        The ciphertext and chunk tags copy *verbatim* — nothing is decrypted.
        The per-page nonces stay on the trusted side (victim.swap_nonces):
        they are what binds the store bytes to this exact page version, so a
        tampered or replayed store object fails the nonce-bound page MAC at
        swap-in and poisons only this request.

        An OPEN tail page must close first (page-close MAC): the store only
        ever holds closed pages, so a swap object is self-contained under
        the whole-page tags + retained nonces and the slice-tag sidecar
        never leaves the pool.
        """
        if self.engine.open_pages:
            tail_fill = victim.seq_len % self.pool.page_size
            if tail_fill:
                tail = victim.pages[victim.seq_len // self.pool.page_size]
                if not self.engine.close_page(tail, account="swap"):
                    # tampered open page caught at the close: poison the
                    # owner instead of swapping garbage out (fail closed)
                    self._poison_unreadable(victim, events)
                    return
        victim.resume_prefill = victim.status == "prefilling"
        # shared prefix pages are exempt from preemption: they are mapped,
        # not owned, so only the private suffix spills — the read-only
        # mapping (and its refcount) rides out the swap untouched
        pages = list(victim.pages[victim.n_shared:])
        TRACER.instant("swap_out", cat="request",
                       tid=request_tid(victim.rid, self._lane_base),
                       args={"rid": victim.rid, "pages": len(pages)})
        # wall-only phase: the ciphertext export + store put are host copies
        # (0 dispatches, 0 fresh sealed bytes — the tail close above charged
        # its bytes to the "close" phase under the swap bucket already)
        with self.engine.profiler.phase("swap_out",
                                        tenant=victim.tenant_id):
            chunks, victim.swap_nonces = self.pool.export_pages(pages)
            # the nonce-span budget walks with the page across the swap: the
            # retained nonces keep their accumulated bumps, so the guard must
            # keep its accumulated spend too (else repeated preemption could
            # silently overflow the reserved lane — keystream reuse)
            victim.swap_spent = [self.pool.nonce_spent(p) for p in pages]
            victim.swaps_out += 1
            ch = self.sessions.channel(victim.tenant_id)
            self.store.put(
                swap_object_id(victim.rid), victim.tenant_id, chunks,
                key_bytes=ch.key_bytes, kind=SWAP_KIND, pinned=True,
                freshness=victim.swaps_out, nonce_epoch=ch.epoch,
                meta={"rid": victim.rid, "n_pages": len(pages),
                      "seq_len": victim.seq_len,
                      "tokens_emitted": len(victim.tokens_out)})
        swapped_bytes = sum(c.nbytes for c in chunks.values())
        self._c_swaps["swap_outs"].inc()
        self._c_swaps["swapped_bytes"].inc(swapped_bytes)
        self._audit("swap_out", victim.tenant_id, rid=victim.rid,
                    n_pages=len(pages), bytes=swapped_bytes,
                    freshness=victim.swaps_out, seq_len=victim.seq_len)
        self.slots[victim.slot] = None
        victim.slot = -1
        self.pool.free(pages)
        victim.pages = victim.pages[:victim.n_shared]
        victim.status = "swapped"
        self.queue.append(victim)
        events["preempted"].append(victim.rid)
        TRACER.begin((self._span_key, victim.rid), "swapped", cat="request",
                     tid=request_tid(victim.rid, self._lane_base))

    def _swap_in(self, req: Request, slot: int, events: dict) -> None:
        """Bring a swapped request back: fresh physical pages, store bytes
        installed verbatim, retained nonces re-branded — then decode resumes
        mid-sequence with no prefill.

        verify=False: the store is untrusted, so its host-side hashes prove
        nothing here.  The binding check is the in-graph page MAC against the
        retained nonces on the next decode step.  A store that destroys the
        object outright (deleted / renamed / reshaped chunks) is the same
        attacker with a blunter instrument — it poisons this request, never
        the gateway.
        """
        chunks = self._fetch_swap_chunks(req)
        if chunks is None:
            self._poison_unreadable(req, events)
            return
        n_pages = len(req.swap_nonces)
        # wall-only phase: alloc + verbatim ciphertext install are host
        # copies (0 dispatches, 0 fresh sealed bytes); the tail reopen below
        # times itself under the "reopen" phase
        with self.engine.profiler.phase("swap_in", tenant=req.tenant_id):
            priv = self.pool.alloc(
                n_pages, req.tenant_id,
                self.sessions.channel(req.tenant_id).key_words,
                req.swap_nonces,
                span=self.pool.page_size + 2, spent=req.swap_spent)
            self.pool.write_pages(priv, chunks["k_ct"], chunks["v_ct"],
                                  chunks["k_tags"], chunks["v_tags"])
        # req.pages kept its shared prefix head across the swap
        req.pages = req.pages + priv
        self.store.delete(swap_object_id(req.rid))
        req.swaps_in += 1
        self._c_swaps["swap_ins"].inc()
        self._audit("swap_in", req.tenant_id, rid=req.rid, n_pages=n_pages,
                    freshness=req.swaps_out, seq_len=req.seq_len)
        req.slot = slot
        req.status = "prefilling" if req.resume_prefill else "running"
        req.t_last = time.monotonic()
        self.slots[slot] = req
        TRACER.begin(
            (self._span_key, req.rid),
            "prefill" if req.resume_prefill else "decode",
            cat="request", tid=request_tid(req.rid, self._lane_base),
            args={"resumed": True, "swaps_in": req.swaps_in})
        if self.engine.open_pages:
            # restore the open-page discipline: the partial tail page
            # reopens (verify close MAC, re-seal, fresh slice tags) and
            # pages not yet written revert to OPEN/empty so decode and
            # prefill chunks can keep appending at O(bytes written)
            ps = self.pool.page_size
            tail_fill = req.seq_len % ps
            n_written = -(-req.seq_len // ps)
            if tail_fill:
                if not self.engine.reopen_page(
                        req.pages[req.seq_len // ps], tail_fill):
                    self._poison_unreadable(req, events)
                    return
            self.pool.mark_open(req.pages[n_written:])
        events["resumed"].append(req.rid)

    def _fetch_swap_chunks(self, req: Request) -> dict | None:
        """Fetch + shape-check a swap object; None if the store mangled it."""
        try:
            chunks, _ = self.store.get(swap_object_id(req.rid), verify=False)
        except StoreError:
            return None
        n = len(req.swap_nonces)
        p = self.pool
        page_shape = (n, p.n_layers, p.page_size, p.n_kv_heads, p.hd)
        want = {"k_ct": (page_shape, _np_dtype(p.k_ct)),
                "v_ct": (page_shape, _np_dtype(p.v_ct)),
                "k_tags": ((n, p.n_tags), _np_dtype(p.k_tags)),
                "v_tags": ((n, p.n_tags), _np_dtype(p.v_tags))}
        for name, (shape, dtype) in want.items():
            if (name not in chunks or chunks[name].shape != shape
                    or chunks[name].dtype != dtype):
                return None
        return chunks

    def _poison_unreadable(self, req: Request, events: dict) -> None:
        req.tokens_out.append(TOKEN_POISON)
        req.status = "poisoned"
        events["emitted"].append((req.rid, TOKEN_POISON))
        events["poisoned"].append(req.rid)
        self._evict(req)

    # -- decode ----------------------------------------------------------
    def _decode(self, events: dict) -> None:
        live = [r for r in self.slots
                if r is not None and r.status == "running"]
        if not live:
            return
        B, P = self.max_slots, self.max_pages
        ps = self.pool.page_size
        tokens = np.zeros((B,), np.int32)
        seq_lens = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        page_tables = np.full((B, P), SCRATCH_PAGE, np.int32)
        write_pp = np.full((B,), SCRATCH_PAGE, np.int32)
        writes = []                 # (req, page, slot written this step)
        for r in live:
            b = r.slot
            tokens[b] = r.tokens_out[-1]
            seq_lens[b] = r.seq_len
            active[b] = True
            page_tables[b, :len(r.pages)] = r.pages
            write_pp[b] = r.pages[r.seq_len // ps]
            writes.append((r, int(write_pp[b]), r.seq_len % ps))
        tok, ok = self.engine.decode_step(tokens, seq_lens, active,
                                          page_tables, write_pp)
        for r in live:
            self.sessions.note_launch(r.tenant_id)
            self._record_token(r, int(tok[r.slot]), events,
                               ok=bool(ok[r.slot]))
        if self.engine.open_pages:
            # a tail page whose last slot was just written CLOSES: slice
            # tags fold into the page-close MAC, the nonce bumps once
            for r, page, slot in writes:
                if slot == ps - 1 and r.status == "running":
                    if not self.engine.close_page(page):
                        self._poison_unreadable(r, events)

    def _record_token(self, req: Request, tok: int, events: dict,
                      ok: bool = True) -> None:
        req.tokens_out.append(tok)
        req.t_last = time.monotonic()
        events["emitted"].append((req.rid, tok))
        if not ok or tok == TOKEN_POISON:
            req.status = "poisoned"
            events["poisoned"].append(req.rid)
            self._evict(req)
        elif len(req.tokens_out) >= req.max_new:
            req.status = "done"
            events["finished"].append(req.rid)
            self._evict(req)
        elif req.status == "running" and len(req.tokens_out) == 1:
            events["admitted"].append(req.rid)

    def _evict(self, req: Request) -> None:
        req.t_done = time.monotonic()
        if req.slot >= 0:
            self.slots[req.slot] = None
            req.slot = -1
        if req.shared_mapped:
            # drop the read-only mappings; the shared pages themselves stay
            # in the pool for other readers (refcounted — a quarantined or
            # poisoned tenant's drain can never free them out from under
            # someone else's page table)
            self.pool.unmap_shared(req.pages[:req.n_shared])
            req.shared_mapped = False
        self.pool.free(req.pages[req.n_shared:])
        req.pages = []
        if self.store.exists(swap_object_id(req.rid)):
            self.store.delete(swap_object_id(req.rid))
        # TTFT is scored at *finish* time so the preempted/clean split is
        # final (a request can be preempted after its first token);
        # quarantine-drained requests never score (they were cut short)
        if req.t_first > 0 and req.status != "quarantined":
            ttft_ms = (req.t_first - req.t_submit) * 1e3
            self._h_ttft.observe(ttft_ms)
            if req.swaps_out > 0:
                self._h_pre_ttft.observe(ttft_ms)
        tid = request_tid(req.rid, self._lane_base)
        TRACER.end((self._span_key, req.rid),
                   args={"tokens": len(req.tokens_out)})
        if req.status == "poisoned":
            TRACER.instant("poison", cat="request", tid=tid,
                           args={"rid": req.rid})
            self._audit("tamper", req.tenant_id, rid=req.rid,
                        tokens_emitted=len(req.tokens_out),
                        swaps_out=req.swaps_out, swaps_in=req.swaps_in)
        elif req.status == "quarantined":
            TRACER.instant("quarantine_drop", cat="request", tid=tid,
                           args={"rid": req.rid})
        else:
            TRACER.instant("finish", cat="request", tid=tid,
                           args={"rid": req.rid,
                                 "tokens": len(req.tokens_out)})
