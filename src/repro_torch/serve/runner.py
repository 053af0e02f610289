"""Drive a PagedEngine the way the reference scheduler does.

The host loop of the port's serving path is the ported ``Scheduler``
(``serve/scheduler.py``, behind ``SecureGateway``).  ``Runner`` stays as
the engine-level test harness: a minimal loop without sessions, swap or
prefix sharing, which ``tests/test_torch_engine*.py`` and chip_smoke.py's
paged phase use to hold the engine itself against the reference.
``admit`` takes a free lane and allocates the request's pages under its
tenant channel (one ``fresh_nonce(span=page_size + 2)`` per page, as
``repro.serve.scheduler`` does); ``prefill_step`` advances every prefilling
lane by one chunk in one batched ``chunk_prefill`` under the provider's
MACed launch; ``decode_step`` runs one ``decode_step`` over the running
lanes and closes each tail page whose last slot was just written.  A lane
that emits ``TOKEN_POISON`` or finishes is evicted and its pages freed.

It only calls the engine's and the pool's public methods, so it drives the
reference engine the same way (the tests use that).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .engine import TOKEN_POISON
from .kv_pager import SCRATCH_PAGE


@dataclasses.dataclass
class Request:
    rid: int
    tenant: str
    prompt: np.ndarray
    max_new: int
    channel: object                 # the tenant's SecureChannel
    slot: int = -1
    pages: list = dataclasses.field(default_factory=list)
    prefill_pos: int = 0
    tokens_out: list = dataclasses.field(default_factory=list)
    status: str = "waiting"         # waiting|prefilling|running|done|poisoned

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def seq_len(self) -> int:
        """KV positions stored: the prefill high-water mark, then
        prompt + emitted - 1 (the latest token's KV lands on its decode)."""
        if not self.tokens_out:
            return self.prefill_pos
        return self.prompt_len + len(self.tokens_out) - 1


class Runner:
    def __init__(self, engine, provider):
        self.engine = engine
        self.pool = engine.pool
        self.provider = provider    # provider channel for the MACed launch
        self.slots: list[Request | None] = [None] * engine.max_slots

    @property
    def live(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    def admit(self, req: Request) -> None:
        """Give ``req`` a free lane and its pages (all it will need)."""
        slot = self.slots.index(None)
        ps = self.pool.page_size
        n_pages = -(-(req.prompt_len + req.max_new) // ps)
        if n_pages > self.engine.max_pages:
            raise ValueError(f"request {req.rid} needs {n_pages} pages, "
                             f"the engine maps {self.engine.max_pages}")
        ch = req.channel
        nonces = [ch.fresh_nonce(span=ps + 2) for _ in range(n_pages)]
        req.pages = self.pool.alloc(n_pages, req.tenant, ch.key_words,
                                    nonces, span=ps + 2)
        req.slot = slot
        req.status = "prefilling"
        self.slots[slot] = req

    def _evict(self, req: Request) -> None:
        self.slots[req.slot] = None
        req.slot = -1
        self.pool.free(req.pages)
        req.pages = []

    def _record(self, req: Request, tok: int, ok: bool, events: dict) -> None:
        req.tokens_out.append(tok)
        events["emitted"].append((req.rid, tok))
        if not ok or tok == TOKEN_POISON:
            req.status = "poisoned"
            events["poisoned"].append(req.rid)
            self._evict(req)
        elif len(req.tokens_out) >= req.max_new:
            req.status = "done"
            events["finished"].append(req.rid)
            self._evict(req)

    def prefill_step(self, events: dict) -> bool:
        """One batched chunk for every prefilling lane; False if none."""
        lanes = [r for r in self.live if r.status == "prefilling"]
        if not lanes:
            return False
        eng = self.engine
        B, P, C = eng.max_slots, eng.max_pages, eng.prefill_chunk
        tokens = np.zeros((B, C), np.int32)
        start = np.zeros((B,), np.int32)
        valid = np.ones((B,), np.int32)         # >=1 keeps idle slices legal
        active = np.zeros((B,), bool)
        page_tables = np.full((B, P), SCRATCH_PAGE, np.int32)
        descs = []
        for r in lanes:
            b = r.slot
            chunk = r.prompt[r.prefill_pos:r.prefill_pos + C]
            tokens[b, :len(chunk)] = chunk
            start[b] = r.prefill_pos
            valid[b] = len(chunk)
            active[b] = True
            page_tables[b, :len(r.pages)] = r.pages
            desc = {"rid": r.rid, "tenant": r.tenant,
                    "start": int(r.prefill_pos), "len": int(len(chunk)),
                    "pages": list(r.pages)}
            r.channel.launch(lambda: None, {"op": "prefill_chunk", **desc})
            descs.append(desc)
        tok, ok = self.provider.launch(
            eng.chunk_prefill, {"op": "prefill_chunk_batch", "lanes": descs},
            tokens, start, valid, active, page_tables)
        for r in lanes:
            b = r.slot
            r.prefill_pos += int(valid[b])
            if not bool(ok[b]):
                self._record(r, TOKEN_POISON, False, events)
            elif r.prefill_pos >= r.prompt_len:
                r.status = "running"
                self._record(r, int(tok[b]), True, events)
        return True

    def decode_step(self, events: dict) -> bool:
        """One decode step over the running lanes; False if none."""
        live = [r for r in self.live if r.status == "running"]
        if not live:
            return False
        eng = self.engine
        B, P = eng.max_slots, eng.max_pages
        ps = self.pool.page_size
        tokens = np.zeros((B,), np.int32)
        seq_lens = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        page_tables = np.full((B, P), SCRATCH_PAGE, np.int32)
        write_pp = np.full((B,), SCRATCH_PAGE, np.int32)
        writes = []
        for r in live:
            b = r.slot
            tokens[b] = r.tokens_out[-1]
            seq_lens[b] = r.seq_len
            active[b] = True
            page_tables[b, :len(r.pages)] = r.pages
            write_pp[b] = r.pages[r.seq_len // ps]
            writes.append((r, int(write_pp[b]), r.seq_len % ps))
        tok, ok = eng.decode_step(tokens, seq_lens, active, page_tables,
                                  write_pp)
        for r in live:
            self._record(r, int(tok[r.slot]), bool(ok[r.slot]), events)
        if eng.open_pages:
            # a tail page whose last slot was just written CLOSES
            for r, page, slot in writes:
                if slot == ps - 1 and r.status == "running":
                    if not eng.close_page(page):
                        self._record(r, TOKEN_POISON, False, events)
        return True

    def step(self) -> dict:
        """prefill chunk, then decode — one scheduler step."""
        events = {"emitted": [], "finished": [], "poisoned": []}
        self.prefill_step(events)
        self.decode_step(events)
        return events

    def run(self, requests: list[Request]) -> dict:
        """Admit every request, step until all finish; returns rid -> tokens.
        Every step emits a token per running lane, so this ends."""
        for r in requests:
            self.admit(r)
        while self.live:
            self.step()
        return {r.rid: list(r.tokens_out) for r in requests}
