"""Serving engines with sealed KV caches (torch port of ``repro.serve.engine``).

``ServeEngine`` — the fixed-slot engine: one sealed decode state per batch
(the [L, B, max_len] KV cache of the dense and VLM families, the
[units, lpu, B, max_len] cache of the MoE, the self and cross KV of the
encoder-decoder, the recurrent state of RWKV, the SSM states and
shared-attention KV of the hybrid), equal-length prompts, whole-batch
nonce epochs, over the family's
``prefill`` / ``decode_step`` from ``models.registry``.  With
``cfg.fused_sealed_attention`` the dense decode reads the sealed cache
through the sealed flash-decode kernel.

``PagedEngine`` — the multi-tenant engine behind the gateway: decodes at
variable occupancy over a shared paged KV pool: each active lane carries
its own sequence length, page table and tenant key (through page
branding), so mixed-length requests from mutually distrusting tenants
share one physical cache.  Model weights stay sealed under the provider
channel and are verified and decrypted inside every step — plaintext
weights are never kept between steps; KV pages are sealed under tenant
channels.  A failed weight verify poisons every lane, a failed page verify
only the lanes whose page table holds the page: their tokens become
``TOKEN_POISON``.

Same steps as the reference (chunked batched prefill, decode with OPEN
tail pages or legacy whole-page reseals, page close / reopen, nonce-lane
renonce, copy-on-write), run eagerly: the layer scan is a Python loop, the
vmapped page functions run as one batch per kernel launch, and the pool's
arrays are updated in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import sealed as sealed_lib
from ..core.channel import SecureChannel
from ..kernels import common
from ..models import layers as L
from ..models import registry, transformer
from ..obs import Profiler
from ..obs.trace import TRACER
from . import kv_pager

# domain separator for the fixed-slot engine's KV lane: weight-upload nonces
# and KV-epoch nonces live under different derived keys
KV_CACHE_DOMAIN = 0x4B5643  # "KVC"

TOKEN_POISON = int(np.iinfo(np.int32).min)  # sentinel for integrity-failed slots


def unseal_params(params, key: torch.Tensor, sealed: bool):
    """Verify and decrypt a sealed weight tree: (tree, ok bool tensor)."""
    if not sealed:
        return params, torch.ones((), dtype=torch.bool, device=key.device)
    return sealed_lib.unseal_tree(params, key)


# ---------------------------------------------------------------------------
# fixed-slot engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeEngine:
    """Greedy generation for a batch of equal-length prompts over one
    fixed-slot decode state, sealed under the channel's KV subkey when the
    channel's security is on.  The dense, MoE and encoder-decoder models
    update their caches in place; the recurrent families return new state
    dicts."""
    cfg: object
    params: object                  # sealed tree if channel.config.enabled
    channel: SecureChannel
    max_len: int

    def __post_init__(self):
        self.model = registry.get_model(self.cfg)
        self._sealed = self.channel.config.enabled
        self._kv_key = self.channel.subkey(KV_CACHE_DOMAIN)
        self._nonce_epoch = 1

    @property
    def device(self) -> torch.device:
        return self.channel.device

    def _gate(self, logits, ok):
        return torch.where(ok, logits, torch.full((), float("nan"),
                                                  dtype=logits.dtype,
                                                  device=logits.device))

    def _prefill(self, params_in, batch, nonce: int):
        params, ok = unseal_params(params_in, self.channel.jkey, self._sealed)
        seal_ctx = (self._kv_key, nonce) if self._sealed else None
        logits, cache = self.model.prefill(params, self.cfg, batch,
                                           self.max_len, seal_ctx=seal_ctx)
        return self._gate(logits, ok), cache

    def _decode(self, params_in, cache, tokens):
        params, ok = unseal_params(params_in, self.channel.jkey, self._sealed)
        seal_ctx = ((self._kv_key, cache["nonce"]) if self._sealed else None)
        logits, cache = self.model.decode_step(params, self.cfg, cache,
                                               tokens, seal_ctx=seal_ctx)
        return self._gate(logits, ok), cache

    def generate(self, batch: dict, n_new: int):
        """batch: {'tokens': int [B, S]} (and ``patch_embeds`` [B, n, D]
        for the VLM, ``frame_embeds`` [B, T_src, D] for the
        encoder-decoder; the launch record keeps every input's shape).
        Greedy decode -> numpy [B, n_new]."""
        batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                 for k, v in batch.items()}
        nonce = self._nonce_epoch & common.M32
        self._nonce_epoch += 1 + n_new
        self.channel.launch(lambda: None, {
            "op": "prefill", "arch": self.cfg.arch_id,
            "shape": {k: list(v.shape) for k, v in batch.items()},
            "max_len": self.max_len})
        logits, cache = self._prefill(self.params, batch, nonce)
        tok = logits.argmax(dim=-1)
        out = [tok.cpu().numpy().astype(np.int32)]
        for i in range(n_new - 1):
            self.channel.launch(lambda: None, {
                "op": "decode", "arch": self.cfg.arch_id, "step": i})
            logits, cache = self._decode(self.params, cache, tok)
            tok = logits.argmax(dim=-1)
            out.append(tok.cpu().numpy().astype(np.int32))
        return np.stack(out, axis=1)  # [B, n_new]


# ---------------------------------------------------------------------------
# paged engine (continuous batching over the shared sealed pool)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedEngine:
    """Variable-occupancy prefill/decode over a paged, per-tenant-sealed pool.

    Dense transformers only.  Every step computes all ``max_slots`` lanes
    with ``max_pages`` page-table columns; occupancy varies through the
    ``active`` mask.  ``open_pages`` on the pool selects the decode
    write-back: one sealed slot per token (True) or a whole-page reseal
    under a bumped nonce (False); both give the same tokens.
    """
    cfg: object
    params: object                  # sealed under the provider channel
    channel: SecureChannel          # provider channel (weights + launches)
    pool: kv_pager.PagedKVPool
    max_slots: int
    max_pages: int                  # page-table columns per sequence
    prefill_chunk: int = 0          # tokens per prefill chunk (0 = max seq)
    profiler: object = None         # obs.Profiler — synchronized phase timing

    def __post_init__(self):
        if self.profiler is None:
            self.profiler = Profiler(enabled=False)
        if self.cfg.family != "dense":
            raise ValueError(
                f"PagedEngine supports dense transformers, got "
                f"{self.cfg.family!r}")
        ps = self.pool.page_size
        if not self.prefill_chunk:
            self.prefill_chunk = self.max_pages * ps
        if self.prefill_chunk % ps:
            raise ValueError(
                f"prefill_chunk={self.prefill_chunk} must be a multiple of "
                f"page_size={ps} (chunks write whole pages)")
        self.prefill_chunk = min(self.prefill_chunk, self.max_pages * ps)
        self._sealed_params = self.channel.config.enabled

    @property
    def open_pages(self) -> bool:
        return self.pool.open_pages

    def _tensor(self, x, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.pool.device).to(dtype)

    def _unseal_params(self):
        """(plaintext tree, ok) — verified and decrypted for this step only."""
        return unseal_params(self.params, self.channel.jkey,
                             self._sealed_params)

    # -- shared gather: page-table walk + per-page verification ----------
    def _gather_unseal(self, page_tables, seq_lens, active, okp):
        """Gather + unseal the batch's pages.  Returns (kcache, vcache,
        ok_seq) with caches [L, B, T, K, hd] zeroed beyond seq_lens.

        CLOSED pages check their whole-page chunk tags, OPEN pages the
        slice tags of their written prefix (< fill).
        """
        cfg, pool = self.cfg, self.pool
        B, P = page_tables.shape
        ps = pool.page_size
        T = P * ps
        Lc, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        dev = pool.device
        flat_pt = page_tables.reshape(-1)
        kp_ct = pool.k_ct[flat_pt]
        vp_ct = pool.v_ct[flat_pt]
        if pool.sealed:
            kpl, vpl, ok_page = kv_pager.unseal_page(
                kp_ct, vp_ct, pool.k_tags[flat_pt], pool.v_tags[flat_pt],
                pool.keys[flat_pt], pool.nonces[flat_pt], cfg.act_dtype,
                pool.chunk_words)
        else:
            kpl = kp_ct.view(cfg.act_dtype)
            vpl = vp_ct.view(cfg.act_dtype)
            ok_page = torch.ones((B * P,), dtype=torch.bool, device=dev)
        ok_page = ok_page.reshape(B, P)
        if pool.sealed and self.open_pages:
            # only a lane's TAIL page can be OPEN, so the slice-tag path
            # runs on one page per lane; its verdict replaces the
            # whole-page check where the trusted state says OPEN
            tail_idx = torch.clamp(seq_lens // ps, 0, P - 1)
            tail_pp = page_tables.gather(1, tail_idx[:, None])[:, 0]
            ok_open = kv_pager.verify_open_page(
                pool.k_ct[tail_pp], pool.v_ct[tail_pp], pool.k_stags[tail_pp],
                pool.v_stags[tail_pp], pool.keys[tail_pp],
                pool.nonces[tail_pp], pool.fill[tail_pp], pool.chunk_words)
            ok_closed_tail = ok_page.gather(1, tail_idx[:, None])[:, 0]
            ok_tail = torch.where(pool.open_flags[tail_pp], ok_open,
                                  ok_closed_tail)
            ok_page[torch.arange(B, device=dev), tail_idx] = ok_tail
        page_used = (torch.arange(P, device=dev)[None, :] * ps
                     < seq_lens[:, None])
        ok_seq = ((ok_page | ~page_used).all(dim=1) & okp) | ~active

        # [B*P, L, ps, K, hd] -> [L, B, T, K, hd]
        def to_cache(pl):
            return pl.reshape(B, P, Lc, ps, K, hd).permute(
                2, 0, 1, 3, 4, 5).reshape(Lc, B, T, K, hd)

        # slots beyond each sequence's length hold keystream noise — zero them
        tmask = (torch.arange(T, device=dev)[None, :] < seq_lens[:, None])
        tmask = tmask[None, :, :, None, None]
        zero = torch.zeros((), dtype=cfg.act_dtype, device=dev)
        return (torch.where(tmask, to_cache(kpl), zero),
                torch.where(tmask, to_cache(vpl), zero), ok_seq)

    def _block(self, lp, x, positions, attend):
        return transformer._block(lp, self.cfg, x, positions, attend)

    def _emit(self, params, x_last, ok_seq, active):
        """Greedy tokens from [B, 1, D] states, poisoned where not ok."""
        logits = transformer.logits_of(params, self.cfg, x_last)[:, 0]
        logits = torch.where(ok_seq[:, None], logits,
                             torch.full((), float("nan"), device=x_last.device,
                                        dtype=logits.dtype))
        tok = logits.argmax(dim=-1).to(torch.int32)
        tok = torch.where(ok_seq, tok, torch.full_like(tok, TOKEN_POISON))
        return torch.where(active, tok, torch.zeros_like(tok))

    # -- chunked batched prefill -----------------------------------------
    def _chunk_prefill_impl(self, tokens, start, valid, active, page_tables):
        """Advance up to B prompts by one fixed-size chunk, batched.

        tokens [B, C]; start [B] (page-aligned prompt positions already in
        the cache); valid [B] (valid tokens in this chunk, 1..C); active
        [B] bool; page_tables [B, P].  Full pages written by the chunk seal
        CLOSED; a prompt's final partial page stays OPEN with slice tags.
        """
        cfg, pool = self.cfg, self.pool
        B, C = tokens.shape
        P = page_tables.shape[1]
        ps = pool.page_size
        n_cp = C // ps
        Lc, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        dev = pool.device
        ar = torch.arange(B, device=dev)

        with TRACER.span("engine.unseal_params", cat="engine", device=dev):
            params, okp = self._unseal_params()
        with TRACER.span("engine.gather_unseal", cat="engine", device=dev):
            kcache, vcache, ok_seq = self._gather_unseal(page_tables, start,
                                                         active, okp)
        x = params["embed"][tokens].to(cfg.act_dtype)
        positions = start[:, None] + torch.arange(C, device=dev)[None, :]
        ext = torch.zeros((B, C, K, hd), dtype=cfg.act_dtype, device=dev)
        nk, nv = [], []
        with TRACER.span("engine.layers", cat="engine", device=dev):
            for l, lp in zip(range(Lc), transformer.layer_stack(params)):
                def attend(q, kn, vn, l=l):
                    # the cache grows by C rows so an insert at any
                    # start <= T stays in bounds; rows past a lane's last
                    # valid query are causally masked
                    kc2 = torch.cat([kcache[l], ext], dim=1)
                    vc2 = torch.cat([vcache[l], ext], dim=1)
                    kc2[ar[:, None], positions] = kn
                    vc2[ar[:, None], positions] = vn
                    return L.gqa_attention(q, kc2, vc2, causal=True,
                                           q_block=cfg.q_block,
                                           base_pos=start), (kn, vn)
                x, (kn, vn) = self._block(lp, x, positions, attend)
                nk.append(kn)
                nv.append(vn)

        # first-token logits for lanes whose prompt completes in this chunk
        tok = self._emit(params, x[ar, valid - 1][:, None], ok_seq, active)

        # -- write back the chunk's pages -------------------------------
        def pages_of(n):              # [L, B, C, K, hd] -> [B*n_cp, L, ps, K, hd]
            nb = torch.stack(n).permute(1, 0, 2, 3, 4)
            return nb.reshape(B, Lc, n_cp, ps, K, hd).permute(
                0, 2, 1, 3, 4, 5).reshape(B * n_cp, Lc, ps, K, hd)

        kp_f, vp_f = pages_of(nk), pages_of(nv)
        cp_j = torch.arange(n_cp, device=dev)[None, :]
        lpid = torch.clamp(start[:, None] // ps + cp_j, 0, P - 1)
        ppid = page_tables.gather(1, lpid)                        # [B, n_cp]
        vip = torch.clamp(valid[:, None] - cp_j * ps, 0, ps)      # [B, n_cp]
        written = (vip > 0) & active[:, None]
        # unwritten chunk pages (prompt ended earlier) divert to scratch
        target = torch.where(written, ppid,
                             torch.full_like(ppid, kv_pager.SCRATCH_PAGE))
        tgt = target.reshape(-1)
        if pool.sealed:
            kct, vct, ktags, vtags = kv_pager.seal_page(
                kp_f, vp_f, pool.keys[tgt], pool.nonces[tgt],
                pool.chunk_words)
        else:
            kct, vct = kv_pager.bitcast_page(kp_f, vp_f)
            ktags = torch.zeros((B * n_cp, pool.n_tags), dtype=torch.int32,
                                device=dev)
            vtags = ktags
        pool.k_ct[tgt] = kct
        pool.v_ct[tgt] = vct
        pool.k_tags[tgt] = ktags
        pool.v_tags[tgt] = vtags
        if self.open_pages:
            # the page holding a prompt's boundary stays OPEN (decode
            # appends into it); full pages close with their chunk tags
            is_boundary = (vip > 0) & (vip < ps) & active[:, None]
            pool.open_flags[tgt] = is_boundary.reshape(-1)
            pool.fill[tgt] = torch.where(is_boundary, vip, 0).reshape(-1).to(
                pool.fill.dtype)
            if pool.sealed:
                bj = torch.clamp(valid // ps, 0, n_cp - 1)        # [B]
                has_b = ((valid % ps) > 0) & active
                b_tgt = torch.where(has_b, target[ar, bj],
                                    torch.full_like(bj, kv_pager.SCRATCH_PAGE))
                kct_b = kct.reshape(B, n_cp, Lc, ps, K, hd)[ar, bj]
                vct_b = vct.reshape(B, n_cp, Lc, ps, K, hd)[ar, bj]
                kst, vst = kv_pager.page_slot_tags(
                    kct_b, vct_b, pool.keys[b_tgt], pool.nonces[b_tgt],
                    pool.chunk_words)
                pool.k_stags[b_tgt] = kst
                pool.v_stags[b_tgt] = vst
        return tok, ok_seq

    def chunk_prefill(self, tokens, start, valid, active, page_tables):
        """Host-side wrapper for one batched prefill-chunk step.

        Returns numpy (tok [B], ok [B]): ``tok`` is each lane's first
        generated token, meaningful only for lanes whose prompt completed.
        """
        active_np = np.asarray(active, bool)
        valid_np = np.asarray(valid, np.int32)
        start_np = np.asarray(start, np.int32)
        pt_np = np.asarray(page_tables, np.int32)
        with TRACER.span("engine.chunk_prefill", cat="engine",
                         args={"lanes": int(active_np.sum())}), \
                self.profiler.phase("prefill") as ph:
            tok, ok = self._chunk_prefill_impl(
                self._tensor(tokens), self._tensor(start_np),
                self._tensor(valid_np), self._tensor(active_np, torch.bool),
                self._tensor(pt_np))
            ph.dispatch(tok)
        ps = self.pool.page_size
        lanes = [(self.pool.owner_of(int(pt_np[b, start_np[b] // ps])),
                  -(-int(valid_np[b]) // ps))
                 for b in range(active_np.shape[0]) if active_np[b]]
        self.pool.note_prefill(sum(n for _, n in lanes), lanes=lanes)
        return tok.cpu().numpy(), ok.cpu().numpy()

    # -- page close / reopen (open-page lifecycle) -----------------------
    def _close_impl(self, page: int):
        pool = self.pool
        kct2, vct2, ktags, vtags, ok = kv_pager.close_page(
            pool.k_ct[page], pool.v_ct[page], pool.k_stags[page],
            pool.v_stags[page], pool.keys[page], pool.nonces[page],
            pool.fill[page], self.cfg.act_dtype, pool.chunk_words)
        pool.k_ct[page] = kct2
        pool.v_ct[page] = vct2
        pool.k_tags[page] = ktags
        pool.v_tags[page] = vtags
        pool.k_stags[page] = 0
        pool.v_stags[page] = 0
        pool.nonces[page] = kv_pager.bump_nonce(pool.nonces[page])
        pool.open_flags[page] = False
        pool.fill[page] = 0
        return ok

    def close_page(self, page: int, account: str = "decode") -> bool:
        """Close an open page (page-close MAC + one nonce bump).

        Returns False if the page's slice tags failed verification — the
        caller must poison the owner; the written tags are corrupted.
        """
        if not self.open_pages:
            return True
        if not self.pool.sealed:
            self.pool.mark_closed([page])
            self.pool.note_close(page, account, True)
            return True
        with TRACER.span("engine.close_page", cat="engine",
                         args={"page": int(page), "account": account}), \
                self.profiler.phase("close",
                                    tenant=self.pool.owner_of(page)) as ph:
            self.pool.spend_nonce(page)
            ok = ph.dispatch(self._close_impl(int(page)))
        ok = bool(ok)
        self.pool.note_close(page, account, ok)
        return ok

    def _reopen_impl(self, page: int, fill_n: int):
        pool = self.pool
        kct2, vct2, kst, vst, ok = kv_pager.reopen_page(
            pool.k_ct[page], pool.v_ct[page], pool.k_tags[page],
            pool.v_tags[page], pool.keys[page], pool.nonces[page],
            self.cfg.act_dtype, pool.chunk_words)
        pool.k_ct[page] = kct2
        pool.v_ct[page] = vct2
        pool.k_tags[page] = 0
        pool.v_tags[page] = 0
        pool.k_stags[page] = kst
        pool.v_stags[page] = vst
        pool.nonces[page] = kv_pager.bump_nonce(pool.nonces[page])
        pool.open_flags[page] = True
        pool.fill[page] = fill_n
        return ok

    def reopen_page(self, page: int, fill: int) -> bool:
        """Reopen a closed partial page so decode can append (swap-in)."""
        if not self.open_pages:
            return True
        if not self.pool.sealed:
            self.pool.mark_open([page], fill)
            self.pool.note_reopen(page, True)
            return True
        with TRACER.span("engine.reopen_page", cat="engine",
                         args={"page": int(page)}), \
                self.profiler.phase("reopen",
                                    tenant=self.pool.owner_of(page)) as ph:
            self.pool.spend_nonce(page)
            ok = ph.dispatch(self._reopen_impl(int(page), int(fill)))
        ok = bool(ok)
        self.pool.note_reopen(page, ok)
        return ok

    def _renonce_impl(self, page: int, fresh: int):
        pool = self.pool
        k, v, ok = kv_pager.unseal_page(
            pool.k_ct[page], pool.v_ct[page], pool.k_tags[page],
            pool.v_tags[page], pool.keys[page], pool.nonces[page],
            self.cfg.act_dtype, pool.chunk_words)
        kct2, vct2, ktags2, vtags2 = kv_pager.seal_page(
            k, v, pool.keys[page], fresh, pool.chunk_words)
        # fail closed: a page that did not verify under its old nonce must
        # not come back verifiable under the fresh one
        pool.k_ct[page] = kct2
        pool.v_ct[page] = vct2
        pool.k_tags[page] = kv_pager._poison_tags(ktags2, ok, 0xA5A5A5A5)
        pool.v_tags[page] = kv_pager._poison_tags(vtags2, ok, 0xA5A5A5A5)
        pool.nonces[page] = kv_pager._u32_words(fresh)
        return ok

    def renonce_page(self, page: int, fresh_nonce: int, span: int) -> bool:
        """Re-seal ``page`` under a freshly reserved channel nonce lane.

        The nonce-headroom alert path: a tail page about to exhaust its
        reserved nonce span is closed (the last old-lane bump), whole-page
        re-sealed under the fresh lane's base nonce, its guard restarted at
        the new span, and reopened (the first new-lane bump).  The plaintext
        never changes, so the token stream is bitwise-identical to a run
        that never renonced.
        """
        pool = self.pool
        was_open = bool(pool.open_flags[page])
        fill_n = int(pool.fill[page])
        if not pool.sealed:
            pool.renonce_guard(page, span)
            pool.note_renonce(page, True)
            return True
        if was_open and fill_n == 0:
            # nothing written under the old lane yet: point the page at the
            # fresh lane directly, no crypto to carry over
            pool.nonces[page] = kv_pager._u32_words(fresh_nonce)
            pool.renonce_guard(page, span)
            pool.note_renonce(page, True)
            return True
        ok = True
        if was_open:
            ok = self.close_page(page, account="decode")
        with TRACER.span("engine.renonce_page", cat="engine",
                         args={"page": int(page)}), \
                self.profiler.phase("renonce",
                                    tenant=pool.owner_of(page)) as ph:
            ok2 = ph.dispatch(self._renonce_impl(int(page), int(fresh_nonce)))
        ok = ok and bool(ok2)
        pool.renonce_guard(page, span)
        pool.note_renonce(page, ok)
        if was_open:
            ok = self.reopen_page(page, fill_n) and ok
        return ok

    # -- copy-on-write break of a shared prefix page ---------------------
    def _cow_impl(self, src: int, dst: int, src_key: torch.Tensor,
                  fill_n: int):
        pool = self.pool
        kct2, vct2, kst, vst, ok = kv_pager.cow_page(
            pool.k_ct[src], pool.v_ct[src], pool.k_tags[src],
            pool.v_tags[src], src_key, pool.nonces[src], pool.keys[dst],
            pool.nonces[dst], self.cfg.act_dtype, pool.chunk_words)
        pool.k_ct[dst] = kct2
        pool.v_ct[dst] = vct2
        pool.k_tags[dst] = 0
        pool.v_tags[dst] = 0
        pool.k_stags[dst] = kst
        pool.v_stags[dst] = vst
        pool.open_flags[dst] = True
        pool.fill[dst] = fill_n
        return ok

    def cow_page(self, src: int, dst: int, src_key_words, fill: int) -> bool:
        """Copy-on-write: unseal shared page ``src`` under the (unwrapped)
        prefix key and re-seal its contents into the tenant-owned page
        ``dst`` as an OPEN page with ``fill`` valid slots.

        A tenant holding the wrong wrap unwraps garbage key words: the
        unseal MAC fails and the destination's slice tags are written
        corrupted (poison-on-use).  The shared original is untouched.
        """
        pool = self.pool
        if not pool.sealed:
            pool.k_ct[dst] = pool.k_ct[src]
            pool.v_ct[dst] = pool.v_ct[src]
            pool.mark_open([dst], fill)
            pool.note_cow(src, dst, True)
            return True
        src_key = kv_pager._u32_words(src_key_words).to(pool.device)
        with TRACER.span("engine.cow_page", cat="engine",
                         args={"src": int(src), "dst": int(dst)}), \
                self.profiler.phase("cow", tenant=pool.owner_of(dst)) as ph:
            ok = ph.dispatch(self._cow_impl(int(src), int(dst), src_key,
                                            int(fill)))
        ok = bool(ok)
        pool.note_cow(src, dst, ok)
        return ok

    # -- decode ----------------------------------------------------------
    def _decode_impl(self, tokens, seq_lens, active, page_tables, write_pp):
        """One continuous-batching decode step at variable occupancy.

        tokens [B] (last emitted token per lane, 0 for idle lanes);
        seq_lens [B] (tokens already cached; the new KV lands here); active
        [B] bool; page_tables [B, P]; write_pp [B] (physical page receiving
        this step's KV, SCRATCH_PAGE for idle lanes).
        """
        cfg, pool = self.cfg, self.pool
        B, P = page_tables.shape
        ps = pool.page_size
        Lc, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        dev = pool.device
        ar = torch.arange(B, device=dev)

        with TRACER.span("engine.unseal_params", cat="engine", device=dev):
            params, okp = self._unseal_params()
        with TRACER.span("engine.gather_unseal", cat="engine", device=dev):
            kcache, vcache, ok_seq = self._gather_unseal(
                page_tables, seq_lens, active, okp)
        x = params["embed"][tokens[:, None]].to(cfg.act_dtype)   # [B, 1, D]
        positions = seq_lens[:, None]
        nk, nv = [], []
        with TRACER.span("engine.layers", cat="engine", device=dev):
            for l, lp in zip(range(Lc), transformer.layer_stack(params)):
                def attend(q, kn, vn, l=l):
                    kc2, vc2 = kcache[l], vcache[l]     # updated in place
                    kc2[ar, seq_lens] = kn[:, 0]
                    vc2[ar, seq_lens] = vn[:, 0]
                    a = L.gqa_attention(q, kc2, vc2, causal=False,
                                        t_valid=seq_lens + 1)
                    # open mode writes back just the new slot; legacy needs
                    # the full updated cache to re-seal the whole tail page
                    return a, ((kn, vn) if self.open_pages else (kc2, vc2))
                x, (kk, vv) = self._block(lp, x, positions, attend)
                nk.append(kk)
                nv.append(vv)
        tok = self._emit(params, x, ok_seq, active)

        keys_w = pool.keys[write_pp]
        if self.open_pages:
            # -- write-back: seal ONLY the new token slot (§3.4) --------
            slot = seq_lens % ps
            k_slot = torch.stack(nk)[:, :, 0].permute(1, 0, 2, 3)  # [B,L,K,hd]
            v_slot = torch.stack(nv)[:, :, 0].permute(1, 0, 2, 3)
            if pool.sealed:
                kct_s, vct_s, ktag, vtag = kv_pager.seal_slot(
                    k_slot, v_slot, keys_w, pool.nonces[write_pp], slot, ps,
                    pool.chunk_words)
                pool.k_stags[write_pp, slot] = ktag
                pool.v_stags[write_pp, slot] = vtag
            else:
                kct_s, vct_s = kv_pager.bitcast_page(k_slot, v_slot)
            # idle lanes hit (SCRATCH_PAGE, slot 0); live lanes hold
            # distinct pages, so no meaningful scatter collisions
            pool.k_ct[write_pp, :, slot] = kct_s
            pool.v_ct[write_pp, :, slot] = vct_s
            pool.fill[write_pp] = (slot + 1).to(pool.fill.dtype)
        else:
            # -- legacy write-back: reseal the whole tail page ----------
            rows = (seq_lens // ps * ps)[:, None] + torch.arange(ps, device=dev)

            def tail_pages(n):        # [L, B, T, K, hd] -> [B, L, ps, K, hd]
                nb = torch.stack(n).permute(1, 0, 2, 3, 4)
                return nb[ar[:, None], :, rows].permute(0, 2, 1, 3, 4)

            k_new, v_new = tail_pages(nk), tail_pages(nv)
            nonce_w = kv_pager.bump_nonce(pool.nonces[write_pp])  # freshness
            if pool.sealed:
                kct_n, vct_n, ktags_n, vtags_n = kv_pager.seal_page(
                    k_new, v_new, keys_w, nonce_w, pool.chunk_words)
            else:
                kct_n, vct_n = kv_pager.bitcast_page(k_new, v_new)
                ktags_n = torch.zeros((B, pool.n_tags), dtype=torch.int32,
                                      device=dev)
                vtags_n = ktags_n
            pool.k_ct[write_pp] = kct_n
            pool.v_ct[write_pp] = vct_n
            pool.k_tags[write_pp] = ktags_n
            pool.v_tags[write_pp] = vtags_n
            pool.nonces[write_pp] = nonce_w
        return tok, ok_seq

    def decode_step(self, tokens, seq_lens, active, page_tables, write_pp):
        """Host-side wrapper: one decode step.  Returns numpy (tok, ok)."""
        active_np = np.asarray(active, bool)
        wp_np = np.asarray(write_pp, np.int32)
        n_act = int(active_np.sum())
        with TRACER.span("engine.decode_step", cat="engine",
                         args={"lanes": n_act}), \
                self.profiler.phase("decode") as ph:
            tok, ok = self._decode_impl(
                self._tensor(tokens), self._tensor(seq_lens),
                self._tensor(active_np, torch.bool), self._tensor(page_tables),
                self._tensor(wp_np))
            ph.dispatch(tok)
        # one charged token per active lane, attributed to the tenant that
        # owns the lane's write page
        owners = [self.pool.owner_of(int(p))
                  for p, a in zip(wp_np, active_np) if a]
        self.pool.note_decode(n_act, owners=owners)
        return tok.cpu().numpy(), ok.cpu().numpy()

