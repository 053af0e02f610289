"""Sealed multi-tenant serving through the port's ``SecureGateway``, fed
by a closed loop of clients (``traffic.ClosedLoop``).

Set-up builds the kernels, makes the weights from the seed, seals them in
the gateway, runs each tenant's attested handshake and warms the engine's
two fixed shapes (a prefill chunk over every lane, a decode step over
every lane, and a page close).  The window submits one request per client
and steps the gateway until ``--seconds`` have passed; a client whose
request finishes submits its next one at once.  The check runs the plain
reference over a sample of the finished requests, drawn from the seed
with the longest among them, and reads how far each served token's logit
lies below the reference's best at its position.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchlib import reference, weights, yardstick
from benchlib.cell import port_config
from benchlib.harness import Check, setup_part
from benchlib.sizes import sizes_of
from benchlib.profiling import span, spanned, traced
from benchlib.traffic import ClosedLoop, rng_of


def make(cell, ctx):
    return Serve(cell, ctx)


class Serve:
    def __init__(self, cell, ctx):
        self.cell, self.ctx, self.t = cell, ctx, cell.traffic
        self.cfg = port_config(cell.config, smoke=ctx.smoke)
        self.sz = sizes_of(cell.config, smoke=ctx.smoke)
        self.check_s = 0.0
        self.setup_parts: dict = {}
        self.done: list = []          # (prompt, served tokens) finished
        self.failed = 0

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        ctx, e = self.ctx, self.t["engine"]

        def part(name):
            return setup_part(self.setup_parts, name, ctx.device)

        with part("imports"):
            from repro_torch.kernels import build
            from repro_torch.serve import SecureGateway

        if ctx.device != "cpu":
            with part("build"):
                build.build_all()
        with part("weights"):
            params = weights.make_tree(self.sz, ctx.seed, ctx.device)
        slots, per_seq = e["max_slots"], e["max_pages_per_seq"]
        with part("seal"):
            self.gw = gw = SecureGateway(
                self.cfg, params, security="trusted", max_slots=slots,
                page_size=e["page_size"], n_pages=slots * per_seq + 1,
                max_pages_per_seq=per_seq, chunk_words=e["chunk_words"],
                prefill_chunk=e["prefill_chunk"], device=ctx.device)
            del params
            gc.collect()
        eng = gw.engine
        self.calls = {"prefill": 0, "decode": 0}
        self.flops = 0.0
        sz = self.sz

        def prefill(tokens, start, valid, active, page_tables):
            self.calls["prefill"] += 1
            for b in np.flatnonzero(np.asarray(active)):
                self.flops += yardstick.forward_flops(
                    sz, int(valid[b]), int(start[b]))
            return inner_prefill(tokens, start, valid, active, page_tables)

        def decode(tokens, seq_lens, active, page_tables, write_pp):
            self.calls["decode"] += 1
            for b in np.flatnonzero(np.asarray(active)):
                self.flops += yardstick.forward_flops(sz, 1,
                                                      int(seq_lens[b]))
            return inner_decode(tokens, seq_lens, active, page_tables,
                                write_pp)

        inner_prefill = spanned(eng.chunk_prefill, "prefill")
        inner_decode = spanned(eng.decode_step, "decode")
        eng.chunk_prefill, eng.decode_step = prefill, decode
        eng.close_page = spanned(eng.close_page, "close_page")
        self.tenants = [f"tenant{i}" for i in range(self.t["tenants"])]
        with part("tenants"):
            for name in self.tenants:
                gw.register_tenant(name)
        # warm-up: every lane shape, the first token, and a page close
        rng = rng_of(ctx.seed, "warmup")
        with part("warmup"):
            for i, (plen, new) in enumerate(self.t["warmup"]):
                prompt = rng.integers(0, self.sz.vocab, size=plen)
                gw.submit(self.tenants[i % len(self.tenants)], prompt, new)
            gw.drain()
            gw.reset_metrics()

    # -- the window ------------------------------------------------------
    def _counts(self) -> int:
        from repro_torch.kernels.ctr_cipher import ops as ctr
        from repro_torch.kernels.tree_mac import ops as mac
        return ctr.ctr_xor.launches + mac.mac_tags.launches

    def window(self, seconds: float, holder) -> dict:
        gw = self.gw
        loop = ClosedLoop(self.t, self.ctx.seed, self.sz.vocab)
        sched = gw.scheduler
        info: dict = {}              # rid -> [request, submit time, 1st?]
        ttft_ms: list = []
        tokens = steps = 0
        trace_at = self.t["trace_steps"]

        def submit(client: int) -> None:
            r = loop.next(client)
            with span("submit"):
                rid = gw.submit(self.tenants[r.tenant], r.prompt, r.max_new)
            info[rid] = [r, time.perf_counter(), False]

        self.calls = dict.fromkeys(self.calls, 0)
        self.flops = 0.0
        launches0 = self._counts()
        t0 = time.perf_counter()
        for c in range(loop.clients):
            submit(c)
        traced_calls = None
        traced_s = traced_flops = 0.0   # the traced steps' wall and FLOPs
        while True:
            tracing = holder is not None and steps == trace_at[0]
            if tracing:
                calls0, flops0 = dict(self.calls), self.flops
                t_tr = time.perf_counter()
                cm = traced(holder)
                cm.__enter__()
            with span("step"):
                ev = gw.step()
            now = time.perf_counter()
            steps += 1
            for rid, tok in ev["emitted"]:
                tokens += 1
                rec = info.get(rid)
                if rec is not None and not rec[2]:
                    rec[2] = True
                    ttft_ms.append((now - rec[1]) * 1e3)
            for rid in ev["finished"] + ev["poisoned"]:
                rec = info.pop(rid, None)
                if rec is None:
                    continue
                req = sched.requests[rid]
                if req.status == "done":
                    self.done.append((rec[0].prompt,
                                      np.asarray(req.tokens_out, np.int64)))
                else:
                    self.failed += 1
                submit(rec[0].client)
            if holder is not None and steps == trace_at[0] + trace_at[1]:
                cm.__exit__(None, None, None)
                holder["trace"].steps = trace_at[1]
                traced_calls = {k: self.calls[k] - calls0[k]
                                for k in self.calls}
                traced_s = time.perf_counter() - t_tr
                traced_flops = self.flops - flops0
            if now - t0 >= seconds:
                break
        if holder is not None and traced_calls is None:
            raise RuntimeError("the window ended before its traced steps")
        window_s = now - t0
        m = gw.metrics()
        rows = gw.profiler.ledger.phase_totals()
        self.layer = {
            "sizes": self.sz, "traffic": self.t,
            "steps": steps, "window_s": window_s,
            "ttft_ms": ttft_ms,
            "prefill_occupancy_pct": m["prefill_chunk_occupancy_pct"],
            "phase_ms": {p: rows[p]["wall_us"] / rows[p]["calls"] / 1e3
                         for p in ("prefill", "decode") if p in rows
                         and rows[p]["calls"]},
            "seal_launches_per_step": (self._counts() - launches0) / steps,
            # the whole step's share counts the untraced steps only
            "flops": self.flops - traced_flops,
            "flops_s": window_s - traced_s,
        }
        if traced_calls is not None:
            per_call = self._bytes()
            self.layer["traced_bytes"] = {
                k: sum(n * per_call[c][k] for c, n in traced_calls.items())
                for k in ("ctr", "mac")}
        return {"serve_tok_s": tokens / window_s}

    def _bytes(self) -> dict:
        """Ciphertext bytes one engine call puts through the CTR and MAC
        kernels at least: the weight tree unsealed and verified, every
        page of every lane's table gathered, unsealed and verified, and
        what the call writes (a prefill chunk's pages; a decode step's
        one slot a lane), with the tail pages' slice tags."""
        from repro_torch.core import sealed as sealed_lib

        gw, e = self.gw, self.t["engine"]
        W = sum(leaf.ct.nbytes for leaf in
                sealed_lib.tree_leaves(gw.engine.params))
        pool = gw.pool
        pair = pool.k_ct[0].nbytes + pool.v_ct[0].nbytes
        B, P = e["max_slots"], e["max_pages_per_seq"]
        n_cp = e["prefill_chunk"] // e["page_size"]
        slot = pair // e["page_size"]
        gather = B * P * pair
        return {
            "prefill": {"ctr": W + gather + B * n_cp * pair,
                        "mac": W + gather + B * pair + B * n_cp * pair},
            "decode": {"ctr": W + gather + B * slot,
                       "mac": W + gather + B * pair + B * slot},
        }

    def layer_context(self) -> dict:
        return self.layer

    def release(self) -> None:
        del self.gw

    # -- the check -------------------------------------------------------
    def _sample(self) -> list:
        """Finished requests drawn from the seed, the longest first, until
        they hold ``check_tokens`` served tokens."""
        done = self.done
        if not done:
            return []
        longest = max(range(len(done)),
                      key=lambda i: len(done[i][0]) + len(done[i][1]))
        rest = [i for i in rng_of(self.ctx.seed, "check").permutation(
            len(done)) if i != longest]
        pick, n = [longest], len(done[longest][1])
        for i in rest:
            if n >= self.t["check_tokens"]:
                break
            pick.append(int(i))
            n += len(done[i][1])
        return [done[i] for i in pick]

    def check(self) -> tuple:
        sample = self._sample()
        gap = served_gap(self.sz, self.ctx.seed, self.ctx.device, sample)
        attempted = len(self.done) + self.failed
        limit = self.cell.limits["served_logit_gap"]
        checks = [Check("served_logit_gap",
                        gap if sample else float("inf"), limit)]
        return checks, attempted, self.failed


def readings(drv, ctx, control: bool) -> dict:
    """What ``bench/controls/readings.py`` records for one seed: the sound
    program's gap and, with ``control``, the float8 control's."""
    sample = drv._sample()
    out = {"sample_tokens": sum(len(s) for _, s in sample),
           "requests_done": len(drv.done), "failed": drv.failed,
           "served_logit_gap": served_gap(drv.sz, ctx.seed, ctx.device,
                                          sample)}
    if control:
        out["control_fp8"] = {"served_logit_gap": served_gap(
            drv.sz, ctx.seed, ctx.device, sample, control="fp8")}
    return out


def served_gap(sz, seed: int, device, sample: list,
               control: str | None = None) -> float:
    """The widest gap, over every served token of ``sample`` ([(prompt,
    served tokens)]), between the reference's best logit at the token's
    position and the logit it gives the token.  With ``control`` (a
    precision of ``reference.Ref``) the tokens judged are instead the ones
    that the reference in that precision puts first at each position."""
    params = weights.make_tree(sz, seed, device, dtype=torch.float32)
    ref = reference.Ref(sz, params)
    low = reference.Ref(sz, params, control) if control else None
    worst = 0.0
    with reference.exact_float32(), torch.no_grad():
        for prompt, served in sample:
            st = torch.as_tensor(served, device=device)
            if bool(((st < 0) | (st >= sz.vocab)).any()):
                return float("inf")
            toks = np.concatenate([prompt, served[:-1]]).astype(np.int64)
            x = torch.as_tensor(toks, device=device)[None]
            lg = ref.logits(ref.hidden(x)[0, len(prompt) - 1:])
            if low is not None:
                st = low.logits(low.hidden(x)[0, len(prompt) - 1:]).argmax(1)
            got = lg.gather(1, st[:, None])[:, 0]
            worst = max(worst, float((lg.max(dim=1).values - got).max()))
    return worst
