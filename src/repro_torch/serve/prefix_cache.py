"""Provider-keyed sealed prefix cache with copy-on-write shared pages
(torch port of ``repro.serve.prefix_cache``).

Millions of users share massive prompt prefixes (system prompts, few-shot
headers, RAG preambles), but per-tenant sealing means every request would
re-prefill and re-seal identical KV pages under its own channel.  This
module prefills a registered prefix ONCE under a dedicated provider-side
channel (`_prefix` session), seals its full pages under a per-entry key,
content-hashes the sealed bytes into the SealedStore for dedup, and lets
any tenant's request map those pages read-only into its page table.

Cross-tenant sharing under per-tenant keys is the trust problem the paper
(§3.4) never had to solve.  The resolution here:

  * every pool page carries its own branded (key, nonce) pair, and the
    jitted gather verifies each page against *its* pair — so a shared page
    sealed under the prefix-entry key verifies identically for every
    mapped tenant with zero changes to the in-graph path;
  * authorization is a **key-wrap**: the prefix entry's page key is
    wrapped to the requesting tenant's session key (core.channel
    wrap_key_words), bound to the (prefix, tenant) pair.  Only that tenant
    can unwrap; a wrong tenant's unwrap yields garbage words, and the one
    place the unwrapped key is *consumed* — the copy-on-write break —
    fails its MAC under garbage words and poisons only the perpetrator;
  * divergence is **copy-on-write**: the first tenant-written token into a
    shared partial tail page unseals it under the (unwrapped) prefix key
    and re-seals the contents into a tenant-owned page under the tenant's
    channel and nonce lane.  The shared original is never written, so
    later tampering of it cannot reach COW-broken requests.

Lifecycle: ``register`` (publish once) -> ``lookup`` at submit ->
scheduler maps shared full pages read-only (refcounted in the pool,
exempt from preemption/spill/eviction of any single tenant) -> COW or
aligned re-prefill at the divergence page -> ``unmap`` at request
eviction -> ``evict`` retires the entry (deferred until the last reader
unmaps).  Audit kinds: ``prefix_publish`` / ``prefix_map`` /
``cow_break``.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..core import channel as channel_lib
from ..core import cipher
from .engine import PagedEngine
from .kv_pager import SCRATCH_PAGE, PagedKVPool

# reserved session id for the prefix-cache publisher channel; like
# "_provider" it can never be registered or quarantined as a tenant
PREFIX_TENANT = "_prefix"
PREFIX_KIND = "prefix"


@dataclasses.dataclass
class PrefixEntry:
    """One published prefix: sealed pages + the grant material."""
    prefix_id: int
    tokens: np.ndarray              # [L] int32 — the registered prefix
    pages: list                     # pool pages (full pages, then tail)
    n_full: int                     # whole shared pages (CLOSED)
    tail_fill: int                  # tokens in the partial tail page (0 = none)
    key_words: np.ndarray           # uint32[2] per-entry sealing key
    object_id: str                  # content-hash id in the SealedStore
    first_token: int                # greedy continuation after the prefix
    first_ok: bool                  # publish-time verification verdict

    @property
    def length(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def tail_page(self):
        return self.pages[-1] if self.tail_fill else None


class PrefixRegistry:
    """Publish, look up, grant and retire shared sealed prefixes."""

    def __init__(self, engine: PagedEngine, pool: PagedKVPool, store,
                 sessions, channel, audit=None, metrics=None):
        self.engine = engine
        self.pool = pool
        self.store = store
        self.sessions = sessions
        self.channel = channel      # the _prefix session's SecureChannel
        self.audit = audit
        self._entries: dict[int, PrefixEntry] = {}
        self._by_hash: dict[bytes, int] = {}
        self._next_id = 1
        reg = metrics if metrics is not None else pool.metrics
        self._c_published = reg.counter(
            "prefix_published_total", "prefixes published", windowed=False)
        self._c_hits = reg.counter(
            "prefix_hits_total", "submits that matched a registered prefix")
        self._c_misses = reg.counter(
            "prefix_misses_total", "submits with no usable prefix match")
        self._c_pages_saved = reg.counter(
            "prefix_pages_saved_total",
            "page allocations avoided by read-only shared mappings")

    # -- publish ---------------------------------------------------------
    def register(self, tokens) -> PrefixEntry:
        """Prefill + seal a prefix once under the prefix channel.

        Idempotent: registering byte-identical tokens returns the existing
        entry — no re-prefill, no second seal, no new store object.  That
        idempotency is what makes the content-hash dedup honest: the same
        logical prefix always resolves to the same sealed object id.
        """
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise ValueError("cannot register an empty prefix")
        thash = hashlib.sha256(tokens.tobytes()).digest()
        if thash in self._by_hash:
            return self._entries[self._by_hash[thash]]
        ps = self.pool.page_size
        n_pages = -(-tokens.size // ps)
        if n_pages > min(self.engine.max_pages, self.pool.n_pages - 1):
            raise ValueError(
                f"prefix needs {n_pages} pages > page-table width "
                f"{self.engine.max_pages} / pool {self.pool.n_pages - 1}")
        prefix_id = self._next_id
        self._next_id += 1
        ch = self.channel
        # per-entry sealing key: one Threefry block keyed by the prefix
        # channel, countered by the entry id — compromise of one entry's
        # (wrapped) key never exposes a sibling prefix or the channel root
        y0, y1 = cipher.threefry2x32(
            torch.from_numpy(np.asarray(ch.key_words, np.uint32)
                             .view(np.int32).copy()),
            prefix_id, 0x505246)                        # "PRF"
        entry_key = np.array([int(y0), int(y1)], np.int32).view(np.uint32)
        nonces = [ch.fresh_nonce(span=ps + 2) for _ in range(n_pages)]
        # umbrella phase: spans the nested prefill/close phases (which also
        # time + charge themselves), so its own ledger row carries the
        # publish wall time with 0 dispatches / 0 bytes of its own
        with self.engine.profiler.phase("prefix_publish",
                                        tenant=PREFIX_TENANT):
            pages = self.pool.alloc(n_pages, PREFIX_TENANT, entry_key,
                                    nonces, span=ps + 2)
            first_token, ok = self._prefill(tokens, pages)
            tail_fill = tokens.size % ps
            if tail_fill:
                # the boundary partial page is OPEN (slice tags); close it
                # so every shared page is self-contained under whole-page
                # tags
                ok = self.engine.close_page(pages[-1],
                                            account="prefill") and ok
            if not ok:
                self.pool.free(pages)
                raise RuntimeError(
                    "prefix prefill failed verification — not publishing")
            self.pool.make_shared(pages)
            chunks, _ = self.pool.export_pages(pages)
            h = hashlib.sha256()
            for name in sorted(chunks):
                h.update(name.encode())
                h.update(np.ascontiguousarray(chunks[name]).tobytes())
            object_id = f"prefix/{h.hexdigest()[:16]}"
            root = None
            if not self.store.exists(object_id):     # content-hash dedup
                manifest = self.store.put(
                    object_id, PREFIX_TENANT, chunks,
                    key_bytes=ch.key_bytes, kind=PREFIX_KIND, pinned=True,
                    freshness=prefix_id, nonce_epoch=ch.epoch,
                    meta={"prefix_id": prefix_id,
                          "length": int(tokens.size),
                          "n_pages": n_pages, "tail_fill": tail_fill})
                root = manifest.get("merkle_root")
        entry = PrefixEntry(
            prefix_id=prefix_id, tokens=tokens, pages=pages,
            n_full=tokens.size // ps, tail_fill=tail_fill,
            key_words=entry_key, object_id=object_id,
            first_token=int(first_token), first_ok=bool(ok))
        self._entries[prefix_id] = entry
        self._by_hash[thash] = prefix_id
        self._c_published.inc()
        if self.audit is not None:
            self.audit.append(
                "prefix_publish", tenant=PREFIX_TENANT,
                prefix_id=prefix_id, length=int(tokens.size),
                n_pages=n_pages, n_full=entry.n_full, tail_fill=tail_fill,
                object=object_id, **({"root": root} if root else {}))
        return entry

    def _prefill(self, tokens: np.ndarray, pages: list) -> tuple[int, bool]:
        """Chunked prefill of the prefix on lane 0 under the prefix
        channel's MACed launch (Rule 3) — same jitted path every tenant
        prompt takes, so shared KV is bitwise what a tenant would compute.
        """
        eng = self.engine
        B, P = eng.max_slots, eng.max_pages
        C = eng.prefill_chunk
        pos, first_token, all_ok = 0, 0, True
        while pos < tokens.size:
            chunk = tokens[pos:pos + C]
            buf = np.zeros((B, C), np.int32)
            buf[0, :len(chunk)] = chunk
            start = np.zeros((B,), np.int32)
            start[0] = pos
            valid = np.ones((B,), np.int32)
            valid[0] = len(chunk)
            active = np.zeros((B,), bool)
            active[0] = True
            page_tables = np.full((B, P), SCRATCH_PAGE, np.int32)
            page_tables[0, :len(pages)] = pages
            tok, ok = self.channel.launch(
                eng.chunk_prefill,
                {"op": "prefix_prefill_chunk", "start": int(pos),
                 "len": int(len(chunk)), "pages": list(pages)},
                buf, start, valid, active, page_tables)
            all_ok = all_ok and bool(ok[0])
            pos += len(chunk)
            if pos >= tokens.size:
                first_token = int(tok[0])
        return first_token, all_ok

    # -- lookup + grant --------------------------------------------------
    def lookup(self, prompt: np.ndarray) -> PrefixEntry | None:
        """Longest registered prefix of ``prompt`` worth sharing.

        A match is usable when it contributes at least one whole shared
        page, or when the prompt IS the prefix (zero-length private
        suffix — the partial tail is then reached by copy-on-write and
        prefill is skipped entirely).  A mid-prompt divergence inside the
        tail page shares only the full pages: chunked prefill writes whole
        pages, so the suffix re-prefills from the page-aligned floor.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        best = None
        for e in self._entries.values():
            if e.length > prompt.size:
                continue
            if not np.array_equal(prompt[:e.length], e.tokens):
                continue
            if e.n_full == 0 and e.length != prompt.size:
                continue            # nothing page-aligned to share
            if best is None or e.length > best.length:
                best = e
        if best is None:
            self._c_misses.inc()
        else:
            self._c_hits.inc()
        return best

    def get(self, prefix_id: int) -> PrefixEntry | None:
        return self._entries.get(prefix_id)

    @staticmethod
    def wrap_context(prefix_id: int, tenant_id: str) -> bytes:
        return f"prefix/{prefix_id}|tenant/{tenant_id}".encode()

    def wrap_for(self, entry: PrefixEntry, tenant_id: str) -> bytes:
        """Wrap the entry's page key to one tenant's session key.

        The wrap context binds (prefix, tenant): a tenant cannot replay a
        wrap minted for someone else, or transplant its own wrap onto a
        different prefix — either mismatch unwraps to garbage words that
        fail the page MAC at the COW break.
        """
        ch = self.sessions.channel(tenant_id)
        return channel_lib.wrap_key_words(
            entry.key_words, ch.key_bytes,
            self.wrap_context(entry.prefix_id, tenant_id))

    def note_map(self, entry: PrefixEntry, n_pages: int) -> None:
        self._c_pages_saved.inc(n_pages)

    # -- retire ----------------------------------------------------------
    def evict(self, prefix_id: int) -> bool:
        """Retire a published prefix.  Its pages leave the pool immediately
        if unmapped, otherwise when the last mapped request evicts — a
        quarantined or drained tenant can therefore never free pages still
        referenced by others."""
        entry = self._entries.pop(prefix_id, None)
        if entry is None:
            return False
        self._by_hash = {h: pid for h, pid in self._by_hash.items()
                         if pid != prefix_id}
        self.pool.release_shared(entry.pages)
        if self.store.exists(entry.object_id):
            self.store.delete(entry.object_id)
        return True

    @property
    def entries(self) -> list[PrefixEntry]:
        return list(self._entries.values())
