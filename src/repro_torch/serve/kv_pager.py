"""Sealed *paged* KV cache — one physical pool shared by all tenants (torch port).

Same design and bits as ``repro.serve.kv_pager``: the unit of sealing is a
page of ``page_size`` token slots across all layers,

    k page plaintext: [n_layers, page_size, n_kv_heads, hd]   (v likewise)

CTR-encrypted under the owning tenant's key with a per-page nonce and
authenticated by encrypt-then-MAC chunk tags under a (tenant key, page
nonce)-bound MAC key.  CLOSED pages carry whole-page chunk tags; the OPEN
tail page of a sequence carries one slice tag per written slot
(``seal_slot``) and closes with a page-close MAC (``close_page``) when it
fills.

Port specifics:

  * Every page function takes one page (key int32 [2], nonce an int or a
    0-d tensor) or a batch of N pages stacked on a leading axis (keys
    [N, 2], nonces [N]) — the batch is what ``jax.vmap`` gave the
    reference, and it is sealed and verified in one launch of each kernel.
  * Ciphertext is stored as int16/int32 bits (the reference's uint16/
    uint32); tags, nonces and keys as int32 bits.
  * ``PagedKVPool`` keeps its arrays on its device and the engine updates
    them IN PLACE, where the reference returns new arrays
    (``arrays``/``update_arrays`` remain for callers that thread them).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..core import cipher, mac
from ..core import sealed as sealed_guard
from ..core.channel import resolve_device
from ..kernels import common
from ..obs import MetricsRegistry, StatsView

KV_K_DOMAIN = 0x4B5047   # "KPG"
KV_V_DOMAIN = 0x565047   # "VPG"
KV_MAC_DOMAIN = 0x4D5047  # "MPG"
KV_SLICE_DOMAIN = 0x534C43  # "SLC" — per-slot slice-tag key lane

SCRATCH_PAGE = 0  # physical page 0 is never allocated: pad entries in page
                  # tables and write-back lanes of idle slots target it.


class PoolExhausted(RuntimeError):
    pass


def page_words(n_layers: int, page_size: int, n_kv_heads: int, hd: int,
               dtype) -> int:
    return cipher.words_for((n_layers, page_size, n_kv_heads, hd), dtype)


def page_tag_count(n_words: int, chunk_words: int) -> int:
    """Divisor-aligned chunk count of a page — mac.block_tags chunking."""
    return mac.chunk_count(n_words, chunk_words)


def _batched(base_key: torch.Tensor) -> bool:
    return base_key.dim() == 2


def _flat(t: torch.Tensor, batched: bool) -> torch.Tensor:
    """A page (or each page of a batch) as one flat row of elements."""
    return t.reshape(t.shape[0], -1) if batched else t.reshape(-1)


def bump_nonce(nonce):
    """nonce + 1 (mod 2^32), for an int or an int32 tensor."""
    if isinstance(nonce, torch.Tensor):
        return common.i32(common.u32(nonce) + 1)
    return (int(nonce) + 1) & common.M32


def _poison_tags(tags: torch.Tensor, ok: torch.Tensor, value: int):
    """tags ^ value where ok is False (ok per page, tags [..., n])."""
    bad = torch.where(ok, 0, common.i32(torch.tensor(value)).item())
    return tags ^ bad.to(torch.int32)[..., None]


def _page_mac_key(base_key: torch.Tensor, nonce) -> torch.Tensor:
    """Nonce-bound MAC key: replaying a page's old (ct, tags) fails."""
    y0, y1 = cipher.threefry2x32(base_key, nonce, KV_MAC_DOMAIN)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def seal_page(k_page: torch.Tensor, v_page: torch.Tensor,
              base_key: torch.Tensor, nonce, chunk_words: int):
    """Seal one KV page (or a batch) under a tenant key.
    Returns (kct, vct, ktags, vtags)."""
    b = _batched(base_key)
    kct = cipher.seal_bits(k_page, cipher.derive_key(base_key, KV_K_DOMAIN),
                           nonce)
    vct = cipher.seal_bits(v_page, cipher.derive_key(base_key, KV_V_DOMAIN),
                           nonce)
    mk = _page_mac_key(base_key, nonce)
    ktags = mac.block_tags(_flat(kct, b), mk, chunk_words, KV_K_DOMAIN)
    vtags = mac.block_tags(_flat(vct, b), mk, chunk_words, KV_V_DOMAIN)
    return kct, vct, ktags, vtags


def unseal_page(kct: torch.Tensor, vct: torch.Tensor, ktags: torch.Tensor,
                vtags: torch.Tensor, base_key: torch.Tensor, nonce, dtype,
                chunk_words: int):
    """Verify + decrypt one page (or a batch). Returns (k, v, ok) with ``ok``
    a bool tensor per page: callers gate outputs per sequence on it."""
    b = _batched(base_key)
    mk = _page_mac_key(base_key, nonce)
    ok_k = mac.verify_block_tags(_flat(kct, b), mk, chunk_words, ktags,
                                 KV_K_DOMAIN).all(dim=-1)
    ok_v = mac.verify_block_tags(_flat(vct, b), mk, chunk_words, vtags,
                                 KV_V_DOMAIN).all(dim=-1)
    k = cipher.unseal_bits(kct, cipher.derive_key(base_key, KV_K_DOMAIN),
                           nonce, dtype)
    v = cipher.unseal_bits(vct, cipher.derive_key(base_key, KV_V_DOMAIN),
                           nonce, dtype)
    return k, v, ok_k & ok_v


def bitcast_page(k_page: torch.Tensor, v_page: torch.Tensor):
    """Protection-off path: shape-preserving bitcast, no keystream, no tags."""
    udt = cipher.uint_dtype_for(k_page.dtype)
    return k_page.contiguous().view(udt), v_page.contiguous().view(udt)


# ---------------------------------------------------------------------------
# open pages: slice sealing + page-close MAC
# ---------------------------------------------------------------------------

def slot_rows(n_layers: int, page_size: int, n_kv_heads: int,
              slot) -> torch.Tensor:
    """int32 [L, K] counter-row indices of one token slot within a page
    (or [N, L, K] for a [N] tensor of slots): rows (l * ps + t) * K + k.
    Sealing a slot against these rows gives ciphertext bit-identical to the
    matching slice of a whole-page seal under the same nonce."""
    dev = slot.device if isinstance(slot, torch.Tensor) else None
    li = torch.arange(n_layers, dtype=torch.int64, device=dev)[:, None]
    ki = torch.arange(n_kv_heads, dtype=torch.int64, device=dev)[None, :]
    t = torch.as_tensor(slot, dtype=torch.int64, device=dev)
    if t.dim():
        t = t[:, None, None]
    return common.i32((li * page_size + t) * n_kv_heads + ki)


def _slice_mac_key(base_key: torch.Tensor, nonce, slot) -> torch.Tensor:
    """Per-(page nonce, slot) slice-tag key: slots cannot be transplanted."""
    y0, y1 = cipher.threefry2x32(_page_mac_key(base_key, nonce), slot,
                                 KV_SLICE_DOMAIN)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _pack(ct: torch.Tensor, batched: bool) -> torch.Tensor:
    """Pack each slot's ciphertext into int32 words (cipher.pack_words)."""
    if not batched:
        return cipher.pack_words(ct)
    flat = ct.reshape(ct.shape[0], -1)
    per_word = 4 // ct.element_size()
    pad = (-flat.shape[1]) % per_word
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.contiguous().view(torch.int32)


def _slot_tag(ct_slot: torch.Tensor, base_key: torch.Tensor, nonce, slot,
              chunk_words: int, domain: int) -> torch.Tensor:
    """Root tag over one slot's ciphertext words (int32, per slot)."""
    sk = _slice_mac_key(base_key, nonce, slot)
    return mac.tag_root(_pack(ct_slot, _batched(sk)), sk, chunk_words, domain)


def seal_slot(k_slot: torch.Tensor, v_slot: torch.Tensor,
              base_key: torch.Tensor, nonce, slot, page_size: int,
              chunk_words: int):
    """Seal ONE token slot of an open page — cost O(slot bytes), §3.4.

    k_slot/v_slot: [n_layers, K, hd] (or [N, n_layers, K, hd] with [N]
    keys/nonces/slots).  Returns (kct_slot, vct_slot, ktag, vtag); the page
    nonce does NOT move.
    """
    Lc, K = k_slot.shape[-3], k_slot.shape[-2]
    rows = slot_rows(Lc, page_size, K, slot)
    kct = cipher.seal_bits_slice(
        k_slot, cipher.derive_key(base_key, KV_K_DOMAIN), nonce, rows)
    vct = cipher.seal_bits_slice(
        v_slot, cipher.derive_key(base_key, KV_V_DOMAIN), nonce, rows)
    ktag = _slot_tag(kct, base_key, nonce, slot, chunk_words, KV_K_DOMAIN)
    vtag = _slot_tag(vct, base_key, nonce, slot, chunk_words, KV_V_DOMAIN)
    return kct, vct, ktag, vtag


def page_slot_tags(kct: torch.Tensor, vct: torch.Tensor,
                   base_key: torch.Tensor, nonce, chunk_words: int):
    """Slice tags for every slot of already-sealed pages.

    kct/vct: [n_layers, page_size, K, hd] (or [N, ...]).  Returns
    (ktags [ps], vtags [ps]) (or [N, ps]); all N * ps slots are tagged in
    one batch.
    """
    b = _batched(base_key)
    Lc, ps, K, hd = kct.shape[-4:]
    n = kct.shape[0] if b else 1
    keys = base_key.reshape(n, 2).repeat_interleave(ps, dim=0)
    nonces = cipher.u32_of(nonce, base_key.device).reshape(-1).expand(n)
    nonces = common.i32(nonces.repeat_interleave(ps))
    slots = torch.arange(ps, dtype=torch.int32,
                         device=base_key.device).repeat(n)

    def tags(ct, domain):
        per_slot = ct.reshape(n, Lc, ps, K, hd).transpose(1, 2)
        t = _slot_tag(per_slot.reshape(n * ps, Lc, K, hd), keys, nonces,
                      slots, chunk_words, domain)
        return t.reshape(n, ps) if b else t.reshape(ps)

    return tags(kct, KV_K_DOMAIN), tags(vct, KV_V_DOMAIN)


def verify_open_page(kct: torch.Tensor, vct: torch.Tensor,
                     k_stags: torch.Tensor, v_stags: torch.Tensor,
                     base_key: torch.Tensor, nonce, fill,
                     chunk_words: int) -> torch.Tensor:
    """Verify the written slots (< fill) of open pages. Bool per page."""
    ps = kct.shape[-3]
    kt, vt = page_slot_tags(kct, vct, base_key, nonce, chunk_words)
    ok = (kt == k_stags) & (vt == v_stags)
    fill = torch.as_tensor(fill, device=kct.device)
    unused = torch.arange(ps, device=kct.device) >= fill[..., None]
    return (ok | unused).all(dim=-1)


def close_page(kct: torch.Tensor, vct: torch.Tensor, k_stags: torch.Tensor,
               v_stags: torch.Tensor, base_key: torch.Tensor, nonce, fill,
               dtype, chunk_words: int):
    """OPEN -> CLOSED: verify the slice tags, re-seal the page under
    nonce+1 with whole-page chunk tags (the page-close MAC).  Returns
    (kct2, vct2, ktags, vtags, ok); tags are corrupted on ok=False so a
    tampered page fails closed."""
    ok = verify_open_page(kct, vct, k_stags, v_stags, base_key, nonce, fill,
                          chunk_words)
    k = cipher.unseal_bits(kct, cipher.derive_key(base_key, KV_K_DOMAIN),
                           nonce, dtype)
    v = cipher.unseal_bits(vct, cipher.derive_key(base_key, KV_V_DOMAIN),
                           nonce, dtype)
    kct2, vct2, ktags, vtags = seal_page(k, v, base_key, bump_nonce(nonce),
                                         chunk_words)
    return (kct2, vct2, _poison_tags(ktags, ok, 1), _poison_tags(vtags, ok, 1),
            ok)


def cow_page(kct: torch.Tensor, vct: torch.Tensor, ktags: torch.Tensor,
             vtags: torch.Tensor, src_key: torch.Tensor, src_nonce,
             dst_key: torch.Tensor, dst_nonce, dtype, chunk_words: int):
    """Copy-on-write break of a shared page: verify + decrypt under the
    source key, re-seal OPEN under the destination key and nonce with
    per-slot slice tags.  Returns (kct2, vct2, k_stags, v_stags, ok); slice
    tags are corrupted on ok=False."""
    k, v, ok = unseal_page(kct, vct, ktags, vtags, src_key, src_nonce,
                           dtype, chunk_words)
    kct2 = cipher.seal_bits(k, cipher.derive_key(dst_key, KV_K_DOMAIN),
                            dst_nonce)
    vct2 = cipher.seal_bits(v, cipher.derive_key(dst_key, KV_V_DOMAIN),
                            dst_nonce)
    k_stags, v_stags = page_slot_tags(kct2, vct2, dst_key, dst_nonce,
                                      chunk_words)
    return (kct2, vct2, _poison_tags(k_stags, ok, 0xA5A5A5A5),
            _poison_tags(v_stags, ok, 0xA5A5A5A5), ok)


def reopen_page(kct: torch.Tensor, vct: torch.Tensor, ktags: torch.Tensor,
                vtags: torch.Tensor, base_key: torch.Tensor, nonce, dtype,
                chunk_words: int):
    """CLOSED -> OPEN: verify the close MAC, re-seal under nonce+1, emit
    per-slot slice tags.  Returns (kct2, vct2, k_stags, v_stags, ok); tags
    are corrupted on ok=False."""
    k, v, ok = unseal_page(kct, vct, ktags, vtags, base_key, nonce, dtype,
                           chunk_words)
    n2 = bump_nonce(nonce)
    kct2 = cipher.seal_bits(k, cipher.derive_key(base_key, KV_K_DOMAIN), n2)
    vct2 = cipher.seal_bits(v, cipher.derive_key(base_key, KV_V_DOMAIN), n2)
    k_stags, v_stags = page_slot_tags(kct2, vct2, base_key, n2, chunk_words)
    return (kct2, vct2, _poison_tags(k_stags, ok, 1),
            _poison_tags(v_stags, ok, 1), ok)


def _u32_words(values) -> torch.Tensor:
    """Host uint32 values (ints / numpy) as an int32 tensor of the same bits."""
    return torch.from_numpy(np.asarray(values, np.uint32).view(np.int32).copy())


@dataclasses.dataclass
class PagedKVPool:
    """Free-list allocator + device-resident page arrays.

    Page 0 is reserved as scratch; allocations hand out distinct pages, so
    two live requests never share a physical page and the write-back
    scatter has no index collisions among active lanes.
    """
    n_pages: int
    page_size: int
    n_layers: int
    n_kv_heads: int
    hd: int
    dtype: object               # plaintext torch dtype
    chunk_words: int = 128
    sealed: bool = True
    open_pages: bool = True     # slice-sealed tail pages (False = legacy
                                # whole-page reseal per decode write)
    metrics: MetricsRegistry | None = None
    audit: object = None        # AuditLog-like sink for close/reopen events
    profiler: object = None     # obs.Profiler — its CostLedger is charged
                                # from the same note_* call sites and byte
                                # formulas as the sealed-bytes counters
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        dev = self.device
        shape = (self.n_pages, self.n_layers, self.page_size,
                 self.n_kv_heads, self.hd)
        udt = cipher.uint_dtype_for(self.dtype)
        pw = page_words(self.n_layers, self.page_size, self.n_kv_heads,
                        self.hd, self.dtype)
        self.n_tags = (page_tag_count(pw, self.chunk_words)
                       if self.sealed else 1)
        i32 = torch.int32
        self.k_ct = torch.zeros(shape, dtype=udt, device=dev)
        self.v_ct = torch.zeros(shape, dtype=udt, device=dev)
        self.k_tags = torch.zeros((self.n_pages, self.n_tags), dtype=i32,
                                  device=dev)
        self.v_tags = torch.zeros((self.n_pages, self.n_tags), dtype=i32,
                                  device=dev)
        self.k_stags = torch.zeros((self.n_pages, self.page_size), dtype=i32,
                                   device=dev)
        self.v_stags = torch.zeros((self.n_pages, self.page_size), dtype=i32,
                                   device=dev)
        self.open_flags = torch.zeros((self.n_pages,), dtype=torch.bool,
                                      device=dev)
        self.fill = torch.zeros((self.n_pages,), dtype=i32, device=dev)
        self.nonces = torch.zeros((self.n_pages,), dtype=i32, device=dev)
        self.keys = torch.zeros((self.n_pages, 2), dtype=i32, device=dev)
        self._free = deque(range(1, self.n_pages))
        self._owner: dict[int, str] = {}
        self._nonce_guard: dict[int, sealed_guard.NonceSpanGuard] = {}
        self._refs: dict[int, int] = {}
        self._pending_release: set[int] = set()
        if self.metrics is None:
            self.metrics = MetricsRegistry()
        reg = self.metrics
        self._c_allocs = reg.counter(
            "kv_pool_allocs_total", "pages handed out", windowed=False)
        self._c_frees = reg.counter(
            "kv_pool_frees_total", "pages returned", windowed=False)
        self._c_alloc_failures = reg.counter(
            "kv_pool_alloc_failures_total", "PoolExhausted raises",
            windowed=False)
        self._g_peak_live = reg.gauge(
            "kv_pool_peak_live_pages", "high-water mark of live pages",
            windowed=False)
        self._c_sealed = {
            phase: reg.counter(f"kv_pool_sealed_bytes_{phase}_total",
                               f"sealed bytes charged to {phase}")
            for phase in ("prefill", "decode", "swap")}
        self._c_decode_tokens = reg.counter(
            "kv_pool_decode_tokens_total", "decode write-backs")
        self._c_page_closes = reg.counter(
            "kv_pool_page_closes_total", "OPEN -> CLOSED transitions")
        self._c_page_reopens = reg.counter(
            "kv_pool_page_reopens_total", "CLOSED -> OPEN transitions")
        self._c_page_renonces = reg.counter(
            "kv_pool_page_renonces_total",
            "pages re-sealed under a fresh nonce lane")
        self._c_cow_breaks = reg.counter(
            "kv_pool_cow_breaks_total",
            "shared pages copied-on-write into private pages",
            windowed=False)
        self.stats = StatsView(reg, {
            "allocs": "kv_pool_allocs_total",
            "frees": "kv_pool_frees_total",
            "peak_live": "kv_pool_peak_live_pages",
            "alloc_failures": "kv_pool_alloc_failures_total",
            "sealed_bytes_prefill": "kv_pool_sealed_bytes_prefill_total",
            "sealed_bytes_decode": "kv_pool_sealed_bytes_decode_total",
            "sealed_bytes_swap": "kv_pool_sealed_bytes_swap_total",
            "decode_tokens": "kv_pool_decode_tokens_total",
            "page_closes": "kv_pool_page_closes_total",
            "page_reopens": "kv_pool_page_reopens_total"})

    def reset_window(self) -> None:
        """Zero the windowed cost counters (sealing bytes, closes, tokens)."""
        for c in self._c_sealed.values():
            c.reset()
        self._c_decode_tokens.reset()
        self._c_page_closes.reset()
        self._c_page_reopens.reset()

    def _audit(self, kind: str, page: int | None = None, **detail) -> None:
        if self.audit is not None:
            tenant = self._owner.get(page) if page is not None else None
            if page is not None:
                detail["page"] = page
            self.audit.append(kind, tenant=tenant, **detail)

    def _idx(self, pages) -> torch.Tensor:
        return torch.as_tensor(list(pages), dtype=torch.int64,
                               device=self.device)

    # -- sizes -----------------------------------------------------------
    @property
    def slot_bytes(self) -> int:
        """Plaintext bytes of one token slot across all layers (k or v)."""
        return (self.n_layers * self.n_kv_heads * self.hd
                * self.dtype.itemsize)

    @property
    def page_bytes(self) -> int:
        return self.slot_bytes * self.page_size

    # -- allocator -------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return self.n_pages - 1 - len(self._free)

    def alloc(self, n: int, owner: str, key_words, nonces,
              span: int | None = None,
              spent: list[int] | None = None) -> list[int]:
        """Take ``n`` pages for ``owner``; brand them with the owner's key
        words and fresh per-page nonces.  Raises PoolExhausted if short.

        ``span``: consecutive nonce values reserved per page (close/reopen
        bumps are budgeted against it); ``spent``: bumps already consumed.
        New pages start OPEN with fill 0 when the pool seals open pages.
        """
        if n > len(self._free):
            self._c_alloc_failures.inc()
            raise PoolExhausted(f"need {n} pages, {len(self._free)} free")
        pages = [self._free.popleft() for _ in range(n)]
        idx = self._idx(pages)
        kw = _u32_words(key_words).reshape(1, 2).expand(n, 2)
        self.keys[idx] = kw.to(self.device)
        nn = _u32_words(nonces).reshape(-1).expand(n)
        self.nonces[idx] = nn.to(self.device)
        if self.open_pages:
            self.open_flags[idx] = True
            self.fill[idx] = 0
        for i, p in enumerate(pages):
            self._owner[p] = owner
            self._nonce_guard[p] = sealed_guard.NonceSpanGuard(
                span=span if span else self.page_size + 2,
                spent=spent[i] if spent else 0)
        self._c_allocs.inc(n)
        self._g_peak_live.set_max(self.live_pages)
        return pages

    def spend_nonce(self, page: int, n: int = 1) -> None:
        """Budget a host-driven nonce bump (close/reopen) for ``page``."""
        guard = self._nonce_guard.get(page)
        if guard is not None:
            guard.spend(n)
            self._audit("nonce_spend", page=page, n=n, spent=guard.spent,
                        span=guard.span)

    def nonce_spent(self, page: int) -> int:
        guard = self._nonce_guard.get(page)
        return guard.spent if guard is not None else 0

    def free(self, pages: list[int]) -> None:
        """Return pages to the free list and un-brand them.  Shared pages
        are never freed here (use unmap_shared / release_shared)."""
        if not pages:
            return
        shared = [p for p in pages if p in self._refs]
        if shared:
            raise ValueError(
                f"free() on shared pages {shared} — use unmap_shared / "
                "release_shared for refcounted prefix pages")
        idx = self._idx(pages)
        for arr in (self.keys, self.nonces, self.k_tags, self.v_tags,
                    self.k_stags, self.v_stags, self.fill):
            arr[idx] = 0
        self.open_flags[idx] = False
        for p in pages:
            self._owner.pop(p, None)
            self._nonce_guard.pop(p, None)
            self._free.append(p)
        self._c_frees.inc(len(pages))

    # -- shared (prefix-cache) pages -------------------------------------
    def make_shared(self, pages: list[int]) -> None:
        """Mark allocated pages as shared/read-only (refcount 0)."""
        for p in pages:
            if p not in self._owner:
                raise ValueError(f"page {p} is not allocated")
            if p in self._refs:
                raise ValueError(f"page {p} is already shared")
            self._refs[p] = 0

    def map_shared(self, pages: list[int]) -> None:
        """Take one read-only mapping per page for a request."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"page {p} is not a shared page")
            self._refs[p] += 1

    def unmap_shared(self, pages: list[int]) -> None:
        """Drop one mapping per page; retire pages whose publisher already
        released them once the last mapping drops."""
        retire = []
        for p in pages:
            if self._refs.get(p, 0) <= 0:
                raise ValueError(
                    f"unmap_shared on page {p} with no live mapping")
            self._refs[p] -= 1
            if self._refs[p] == 0 and p in self._pending_release:
                retire.append(p)
        if retire:
            self._retire_shared(retire)

    def release_shared(self, pages: list[int]) -> None:
        """Publisher retires shared pages: freed now if unmapped, else
        deferred until the last reader unmaps."""
        retire = []
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"page {p} is not a shared page")
            if self._refs[p] == 0:
                retire.append(p)
            else:
                self._pending_release.add(p)
        if retire:
            self._retire_shared(retire)

    def _retire_shared(self, pages: list[int]) -> None:
        for p in pages:
            del self._refs[p]
            self._pending_release.discard(p)
        self.free(pages)

    def is_shared(self, page: int) -> bool:
        return page in self._refs

    def ref_count(self, page: int) -> int:
        return self._refs.get(page, 0)

    @property
    def shared_pages(self) -> list[int]:
        return sorted(self._refs)

    def note_cow(self, src: int, dst: int, ok: bool) -> None:
        """Record a COW break (charged to the decode bucket)."""
        self._c_cow_breaks.inc()
        if self.sealed:
            self._c_sealed["decode"].inc(2 * self.page_bytes)
            self._charge("cow", self._owner.get(dst), 2 * self.page_bytes,
                         "decode")

    # -- §3.4 cost accounting (the engine reports, the pool owns) --------
    def _charge(self, phase: str, tenant: str | None, nbytes: int,
                bucket: str) -> None:
        if self.profiler is not None:
            self.profiler.ledger.charge(phase, tenant, nbytes, bucket,
                                        chunk_words=self.chunk_words)

    def note_prefill(self, pages_written: int, lanes=()) -> None:
        """Charge a batched prefill chunk: whole pages sealed, k+v."""
        if self.sealed:
            self._c_sealed["prefill"].inc(2 * self.page_bytes * pages_written)
            if lanes:
                for owner, n in lanes:
                    self._charge("prefill", owner, 2 * self.page_bytes * n,
                                 "prefill")
            elif pages_written:
                self._charge("prefill", None,
                             2 * self.page_bytes * pages_written, "prefill")

    def note_decode(self, n_tokens: int, owners=()) -> None:
        """Charge one decode step's write-backs (slot or whole-page)."""
        self._c_decode_tokens.inc(n_tokens)
        if self.sealed:
            per = 2 * (self.slot_bytes if self.open_pages
                       else self.page_bytes)
            self._c_sealed["decode"].inc(n_tokens * per)
            if owners:
                for owner in owners:
                    self._charge("decode", owner, per, "decode")
            elif n_tokens:
                self._charge("decode", None, n_tokens * per, "decode")

    def note_close(self, page: int, account: str, ok: bool) -> None:
        """Record an OPEN -> CLOSED transition (audit + cost counters)."""
        self._c_page_closes.inc()
        if self.sealed:
            self._c_sealed[account].inc(2 * self.page_bytes)
            self._charge("close", self._owner.get(page), 2 * self.page_bytes,
                         account)
        self._audit("page_close", page=page, account=account, ok=bool(ok))

    def note_reopen(self, page: int, ok: bool) -> None:
        """Record a CLOSED -> OPEN transition (swap-in tail page)."""
        self._c_page_reopens.inc()
        if self.sealed:
            self._c_sealed["swap"].inc(2 * self.page_bytes)
            self._charge("reopen", self._owner.get(page),
                         2 * self.page_bytes, "swap")
        self._audit("page_reopen", page=page, ok=bool(ok))

    def owner_of(self, page: int) -> str | None:
        return self._owner.get(page)

    def headroom(self) -> list[dict]:
        """Per-page nonce-span budget reports for every live page."""
        open_np = self.open_flags.cpu().numpy()
        out = []
        for page, guard in self._nonce_guard.items():
            owner = self._owner.get(page)
            if owner is None:
                continue
            h = guard.headroom()
            h.update(id=page, tenant=owner, open=bool(open_np[page]))
            out.append(h)
        return out

    def renonce_guard(self, page: int, span: int) -> None:
        """Reset ``page``'s nonce budget after a re-seal under a fresh lane."""
        self._nonce_guard[page] = sealed_guard.NonceSpanGuard(span=span)
        self._audit("nonce_refresh", page=page, span=span)

    def note_renonce(self, page: int, ok: bool) -> None:
        """Record a nonce-lane re-seal (charged to the decode bucket)."""
        self._c_page_renonces.inc()
        if self.sealed:
            self._c_sealed["decode"].inc(2 * self.page_bytes)
            self._charge("renonce", self._owner.get(page),
                         2 * self.page_bytes, "decode")
        self._audit("page_renonce", page=page, ok=bool(ok))

    def pages_of(self, owner: str) -> list[int]:
        return [p for p, o in self._owner.items() if o == owner]

    # -- device state ----------------------------------------------------
    def write_pages(self, pages: list[int], kct, vct, ktags, vtags) -> None:
        """Install freshly sealed CLOSED page contents (swap-in, tests):
        tensors, or the numpy arrays ``export_pages`` gave."""
        idx = self._idx(pages)
        for name, val in (("k_ct", kct), ("v_ct", vct), ("k_tags", ktags),
                          ("v_tags", vtags)):
            getattr(self, name)[idx] = torch.as_tensor(val).to(self.device)
        self.open_flags[idx] = False
        self.fill[idx] = 0

    def mark_open(self, pages: list[int], fill: int = 0) -> None:
        """Trusted-side state flip: pages become OPEN with ``fill`` slots."""
        if not pages:
            return
        idx = self._idx(pages)
        self.open_flags[idx] = True
        self.fill[idx] = fill

    def mark_closed(self, pages: list[int]) -> None:
        if not pages:
            return
        idx = self._idx(pages)
        self.open_flags[idx] = False
        self.fill[idx] = 0

    def export_pages(self, pages: list[int]) -> tuple[dict, np.ndarray]:
        """Verbatim host copies of sealed pages (storage dtypes of the
        port) and, separately, their nonces as uint32."""
        idx = self._idx(pages)
        chunks = {name: getattr(self, name)[idx].cpu().numpy()
                  for name in ("k_ct", "v_ct", "k_tags", "v_tags")}
        nonces = self.nonces[idx].cpu().numpy().view(np.uint32).copy()
        return chunks, nonces

    def arrays(self) -> tuple:
        """The pool state (same order as the reference's)."""
        return (self.k_ct, self.v_ct, self.k_tags, self.v_tags,
                self.k_stags, self.v_stags, self.nonces, self.keys,
                self.open_flags, self.fill)

    def update_arrays(self, arrays: tuple) -> None:
        (self.k_ct, self.v_ct, self.k_tags, self.v_tags,
         self.k_stags, self.v_stags, self.nonces, self.keys,
         self.open_flags, self.fill) = arrays
