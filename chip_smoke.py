#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

From the root of a checkout:  python3 chip_smoke.py

1. builds the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
2. holds each kernel against its plain torch version, bit for bit, at the
   shapes of the main path: one page-batch gather (all B*P pages, per-page
   keys), one slot seal with explicit rows, every weight leaf (granite's
   unembed has an odd width; its MAC chunks are 2 words), and the flat
   tag_root of one slot — and times kernel and plain version with CUDA
   events;
3. serves granite-3-2b at its full published width and depth (40 layers,
   bf16, random weights from a seeded torch.Generator) through the sealed
   paged engine: two tenant channels, weights sealed under the provider
   channel, four requests with prompts of 9, 23, 40 and 64 tokens and 24
   new tokens each, so chunked prefill, decode across page boundaries and
   page closes all run; the kernels' launch counts are zeroed just before
   and read just after;
4. checks the result: no lane poisoned, every step launched both kernels,
   the sealed-byte counters add up, and the smoke config served on the
   card gives the same tokens as on the CPU;
5. tampers: one flipped bit in a page of each of tenant A's requests
   poisons exactly A's lanes; one flipped bit of a weight leaf poisons
   every lane;
6. prints the card's name and power limit, a ``{"kernels": [...]}`` line,
   and last ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero.  Without a CUDA
device, or outside a checkout, it exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks for the bound: HBM3 at 3.35 TB/s (data sheet), and 32-bit
# integer operations at 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
# (Hopper architecture white paper) = 16.7 T ops/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations in the kernels' arithmetic (counted from the source):
# a Threefry-2x32 block is 20 rounds of add/rotate/xor, 5 key injections of
# 2 adds, 2 initial adds and the 2 XORs with the data; a MAC word is two
# folds and the +1, a 64-bit product with two folds, and the 64-bit add.
CTR_OPS_PER_BLOCK = 20 * 3 + 5 * 2 + 2 + 2
MAC_OPS_PER_WORD = 20

N_PAGES, PAGE, CHUNK_WORDS = 64, 16, 128
SLOTS, MAX_PAGES, PREFILL_CHUNK = 4, 8, 64
PROMPTS, MAX_NEW = (9, 23, 40, 64), 24
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def device_ms(fn, reps: int = 10) -> float:
    """Median device time of ``fn`` (CUDA events) after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def kernel_checks(sealed, provider_key):
    """Every kernel against its plain version at the main path's shapes.

    Returns {kernel: [workload dicts]}, each with mismatches, max_abs_err,
    ms (kernel), plain_ms, bytes, ops, bound_ms and bound_by.
    """
    from repro_torch.core import cipher, mac, sealed as sealed_lib
    from repro_torch.kernels.ctr_cipher import ops as ctr_ops, ref as ctr_ref
    from repro_torch.kernels.tree_mac import ops as mac_ops, ref as mac_ref
    from repro_torch.serve import kv_pager

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def bits(shape, dtype):
        x = torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                          device="cuda", dtype=torch.int64)
        return x.to(dtype)

    def compare(out, ref):
        diff = (out.to(torch.int64) - ref.to(torch.int64)).abs()
        return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    results = {"ctr_cipher": [], "tree_mac": []}

    def ctr_case(name, x, tkeys, rows=None, step_share=1):
        out = ctr_ops.ctr_xor(x, tkeys, rows)
        ref = ctr_ref.ctr_xor_ref(x, tkeys, rows)
        mism, err = compare(out, ref)
        del out, ref
        ms = device_ms(lambda: ctr_ops.ctr_xor(x, tkeys, rows))
        plain_ms = device_ms(lambda: ctr_ref.ctr_xor_ref(x, tkeys, rows), reps=1)
        n, r, e = x.shape
        words = -(-e * x.element_size() // 4)
        blocks = n * r * ((words + 1) // 2)
        nbytes = 2 * x.numel() * x.element_size()
        b, by = bound(nbytes, blocks * CTR_OPS_PER_BLOCK)
        results["ctr_cipher"].append(dict(
            shape=name, dims=list(x.shape), mismatches=mism,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
            ops=blocks * CTR_OPS_PER_BLOCK, bound_ms=b, bound_by=by,
            per_step=step_share))
        torch.cuda.empty_cache()

    def mac_case(name, x, keys, step_share=1):
        cw = keys.shape[1]
        out = mac_ops.mac_tags(x, keys)
        ref = mac_ref.mac_tags_ref(x, keys, cw)
        mism, err = compare(out, ref)
        del ref
        ms = device_ms(lambda: mac_ops.mac_tags(x, keys))
        plain_ms = device_ms(lambda: mac_ref.mac_tags_ref(x, keys, cw), reps=1)
        n, r, e = x.shape
        words = n * r * (-(-e * x.element_size() // 4))
        nbytes = x.numel() * x.element_size() + out.numel() * 4
        b, by = bound(nbytes, words * MAC_OPS_PER_WORD)
        results["tree_mac"].append(dict(
            shape=name, dims=list(x.shape), cw=cw, mismatches=mism,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
            ops=words * MAC_OPS_PER_WORD, bound_ms=b, bound_by=by,
            per_step=step_share))
        del out
        torch.cuda.empty_cache()

    # one page-batch gather: all B*P pages of the step, each with its own
    # tenant key and nonce (k and v each: 2 per step)
    n_gather = SLOTS * MAX_PAGES
    page_rows = 40 * PAGE * 8
    page_keys = bits((n_gather, 2), torch.int32)
    nonces = bits((n_gather,), torch.int32)
    ct = bits((n_gather, page_rows, 64), torch.int16)
    ctr_case("page gather [32 pages x 40x16x8 rows x 64 bf16]", ct,
             cipher.derive_tensor_key(
                 cipher.derive_key(page_keys, kv_pager.KV_K_DOMAIN), nonces),
             step_share=2)
    mk = kv_pager._page_mac_key(page_keys, nonces)
    pw = page_rows * 64 // 2
    keys = mac.mac_keys(mk, pw // kv_pager.page_tag_count(pw, CHUNK_WORDS),
                        kv_pager.KV_K_DOMAIN)
    mac_case("page gather [32 pages x 163840 words, cw 128]",
             ct.reshape(n_gather, 1, -1), keys, step_share=2)
    del ct
    # one slot seal of the decode write-back: explicit, non-contiguous rows
    slots = torch.tensor([3, 7, 15, 0], device="cuda")
    rows = kv_pager.slot_rows(40, PAGE, 8, slots).reshape(SLOTS, -1)
    x = bits((SLOTS, 40 * 8, 64), torch.int16)
    ctr_case("slot seal [4 lanes x 320 rows x 64 bf16, explicit rows]", x,
             cipher.derive_tensor_key(page_keys[:SLOTS], nonces[:SLOTS]),
             rows.contiguous(), step_share=2)
    # flat tag_root over one slot: 10,240 words in chunks of 128, then the
    # 80 chunk tags padded to one more chunk
    words = bits((SLOTS, 1, 40 * 8 * 64 // 2), torch.int32)
    skeys = mac.mac_keys(mk[:SLOTS], CHUNK_WORDS, kv_pager.KV_K_DOMAIN)
    mac_case("tag_root of one slot [4 x 10240 words, cw 128]", words, skeys,
             step_share=2)
    mac_case("tag_root combine [4 x 128 words, cw 128]",
             bits((SLOTS, 1, CHUNK_WORDS), torch.int32), skeys, step_share=2)
    # every weight leaf, as unsealed inside each step
    for path, leaf in zip(_leaf_paths(sealed), sealed_lib.tree_leaves(sealed)):
        e = leaf.ct.shape[-1]
        x = leaf.ct.reshape(1, -1, e)
        tkey = cipher.derive_tensor_key(provider_key, leaf.nonce)[None]
        ctr_case(f"weight {path} {list(leaf.ct.shape)}", x,
                 tkey.contiguous())
        last_w = -(-e * x.element_size() // 4)
        cw = last_w // mac.chunk_count(last_w, leaf.spec.chunk_words)
        lkeys = mac.mac_keys(sealed_lib._mac_key(provider_key, leaf.nonce,
                                                 leaf.spec), cw,
                             leaf.spec.mac_domain)[None]
        mac_case(f"weight {path} {list(leaf.ct.shape)}", x, lkeys)
    return results


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def serve(cfg, sealed, provider, tenants, profiler):
    """The main path: four requests through the sealed paged engine."""
    from repro_torch.kernels.ctr_cipher import ops as ctr_ops
    from repro_torch.kernels.tree_mac import ops as mac_ops
    from repro_torch.serve.runner import Runner, Request
    from repro_torch.serve.engine import PagedEngine
    from repro_torch.serve.kv_pager import PagedKVPool

    pool = PagedKVPool(n_pages=N_PAGES, page_size=PAGE, n_layers=cfg.n_layers,
                       n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
                       dtype=cfg.act_dtype, chunk_words=CHUNK_WORDS,
                       open_pages=True, profiler=profiler, device="cuda")
    eng = PagedEngine(cfg=cfg, params=sealed, channel=provider, pool=pool,
                      max_slots=SLOTS, max_pages=MAX_PAGES,
                      prefill_chunk=PREFILL_CHUNK, profiler=profiler)
    runner = Runner(eng, provider=provider)
    rng = np.random.RandomState(SEED)
    names = sorted(tenants)
    reqs = [Request(i, names[i % 2],
                    rng.randint(0, cfg.vocab, n).astype(np.int32), MAX_NEW,
                    tenants[names[i % 2]]) for i, n in enumerate(PROMPTS)]
    for r in reqs:
        runner.admit(r)
    steps = []
    torch.cuda.synchronize()
    ctr_ops.ctr_xor.launches = 0
    mac_ops.mac_tags.launches = 0
    t0 = time.perf_counter()
    while runner.live:
        for kind, fn in (("prefill", runner.prefill_step),
                         ("decode", runner.decode_step)):
            c0, m0 = ctr_ops.ctr_xor.launches, mac_ops.mac_tags.launches
            closes0 = pool.stats["page_closes"]
            ev = {"emitted": [], "finished": [], "poisoned": []}
            if fn(ev):
                steps.append(dict(
                    kind=kind, ctr=ctr_ops.ctr_xor.launches - c0,
                    mac=mac_ops.mac_tags.launches - m0,
                    closes=pool.stats["page_closes"] - closes0,
                    poisoned=ev["poisoned"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ctr_cipher": ctr_ops.ctr_xor.launches,
                "tree_mac": mac_ops.mac_tags.launches}
    return eng, reqs, steps, wall, launches


def tamper(eng, tenants, provider, vocab):
    """Flip a page bit of tenant A, then a weight bit; read who poisons."""
    from repro_torch.serve.runner import Runner, Request

    runner = Runner(eng, provider=provider)
    rng = np.random.RandomState(SEED + 2)
    names = sorted(tenants)
    reqs = [Request(100 + i, names[i % 2],
                    rng.randint(0, vocab, n).astype(np.int32), 8,
                    tenants[names[i % 2]])
            for i, n in enumerate((9, 12, 10, 11))]
    for r in reqs:
        runner.admit(r)
    ev = {"emitted": [], "finished": [], "poisoned": []}
    runner.prefill_step(ev)
    profile = profile_step(lambda: runner.decode_step(ev))
    check(not ev["poisoned"], f"clean tamper-phase step poisoned {ev}")
    a_rids = sorted(r.rid for r in reqs if r.tenant == names[0])
    for r in reqs:
        if r.tenant == names[0]:
            eng.pool.k_ct[r.pages[0], 0, 0, 0, 0] ^= 1
    ev = {"emitted": [], "finished": [], "poisoned": []}
    runner.decode_step(ev)
    page_poisoned = sorted(ev["poisoned"])
    check(page_poisoned == a_rids,
          f"page tamper poisoned {page_poisoned}, tenant A holds {a_rids}")
    survivors = sorted(r.rid for r in runner.live)
    eng.params["layers"]["mlp"]["w_down"].ct[7, 100, 5] ^= 1 << 3
    ev = {"emitted": [], "finished": [], "poisoned": []}
    runner.decode_step(ev)
    check(sorted(ev["poisoned"]) == survivors and survivors,
          f"weight tamper poisoned {ev['poisoned']}, live {survivors}")
    eng.params["layers"]["mlp"]["w_down"].ct[7, 100, 5] ^= 1 << 3
    return {"page": page_poisoned, "weight": sorted(ev["poisoned"])}, profile


def profile_step(step):
    """One decode step under torch.profiler: wall ms, device-busy ms (sum of
    kernel self times), launches and the top operators by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "top": [{"op": e.key[:60], "device_ms": e.self_device_time_total
                     / 1e3, "count": e.count} for e in top]}


def smoke_reference():
    """The smoke config served on the card and on the CPU: same tokens."""
    from repro_torch import configs
    from repro_torch.core.channel import SecureChannel
    from repro_torch.core.policy import SecurityConfig
    from repro_torch.core.sealed import tree_leaves, tree_unflatten
    from repro_torch.models import transformer
    from repro_torch.serve.runner import Runner, Request
    from repro_torch.serve.engine import PagedEngine
    from repro_torch.serve.kv_pager import PagedKVPool

    cfg = configs.get_config("granite-3-2b", smoke=True)
    params = transformer.init(torch.Generator().manual_seed(SEED), cfg, "cpu")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 13, 20, 9)]
    keys = {"a": (1, 2), "b": (3, 4), "p": (5, 6)}
    outs = []
    for dev in ("cpu", "cuda"):
        ch = {t: SecureChannel(key_words=np.array(k, np.uint32),
                               key_bytes=bytes([i + 1]) * 32,
                               config=SecurityConfig(protect_launch=False),
                               session_id=40 + i, device=dev)
              for i, (t, k) in enumerate(keys.items())}
        p = tree_unflatten(params, [x.to(dev) for x in tree_leaves(params)])
        pool = PagedKVPool(n_pages=32, page_size=8, n_layers=cfg.n_layers,
                           n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
                           dtype=cfg.act_dtype, device=dev)
        eng = PagedEngine(cfg=cfg, params=ch["p"].upload_tree(p),
                          channel=ch["p"], pool=pool, max_slots=4,
                          max_pages=5, prefill_chunk=16)
        reqs = [Request(i, "ab"[i % 2], pr, 12, ch["ab"[i % 2]])
                for i, pr in enumerate(prompts)]
        outs.append((Runner(eng, ch["p"]).run(reqs), dict(
            (k, pool.stats[k]) for k in pool.stats)))
    return outs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import configs
    from repro_torch.core.channel import SecureChannel
    from repro_torch.kernels import build
    from repro_torch.models import transformer
    from repro_torch.obs import Profiler
    from repro_torch.serve.engine import TOKEN_POISON

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    for r in (build.library(n) for n in build.SOURCES):
        check(r is not None, "library did not load")
    regs = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for n, log in build.build_log.items()}
    print(f"build: {time.perf_counter() - t0:.1f} s for {list(build.SOURCES)};"
          f" ptxas {json.dumps(regs)}", flush=True)

    # 2. weights: full-width granite-3-2b, sealed by the provider ---------
    cfg = configs.get_config("granite-3-2b")
    t0 = time.perf_counter()
    provider = SecureChannel.establish(device="cuda")
    tenants = {"tenant_a": SecureChannel.establish(device="cuda"),
               "tenant_b": SecureChannel.establish(device="cuda")}
    params = transformer.init(torch.Generator(device="cuda").manual_seed(SEED),
                              cfg, "cuda")
    n_params = sum(x.numel() for x in _leaves(params))
    sealed = provider.upload_tree(params)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ct_bytes = sum(leaf.nbytes_ct for leaf in _leaves(sealed))
    print(f"weights: {n_params} params, {ct_bytes} ciphertext bytes, sealed in"
          f" {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against their plain versions -----------------------------
    results = kernel_checks(sealed, provider.jkey)
    for name, cases in results.items():
        for c in cases:
            print(f"check {name:10s} {c['shape']}: mismatches {c['mismatches']}"
                  f", kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.3f} ms, "
                  f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})",
                  flush=True)
            check(c["mismatches"] == 0,
                  f"{name} disagrees with its plain version on {c['shape']}")
    torch.cuda.empty_cache()

    # 4. serve ------------------------------------------------------------
    profiler = Profiler(chunk_words=CHUNK_WORDS)
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, steps, wall, launches = serve(cfg, sealed, provider, tenants,
                                             profiler)
    pool = eng.pool
    n_tokens = sum(len(r.tokens_out) for r in reqs)
    for r in reqs:
        check(r.status == "done", f"request {r.rid} ended {r.status}")
        check(len(r.tokens_out) == MAX_NEW, f"request {r.rid} short")
        check(all(0 <= t < cfg.vocab and t != TOKEN_POISON
                  for t in r.tokens_out), f"request {r.rid} bad tokens")
    for s in steps:
        check(s["ctr"] > 0 and s["mac"] > 0,
              f"a {s['kind']} step launched no kernel: {s}")
        check(not s["poisoned"], f"poisoned lanes {s}")
    st = pool.stats
    check(st["page_closes"] > 0, "no page closed")
    want = (st["decode_tokens"] * 2 * pool.slot_bytes
            + st["page_closes"] * 2 * pool.page_bytes)
    check(st["sealed_bytes_decode"] == want,
          f"sealed_bytes_decode {st['sealed_bytes_decode']} != {want}")
    phases = {p: {"calls": c["calls"], "ms": c["wall_us"] / 1e3}
              for p, c in profiler.ledger.phase_totals().items()}
    per_decode = sorted({(s["ctr"], s["mac"]) for s in steps
                         if s["kind"] == "decode" and s["closes"] == 0})
    print(f"serve: {len(reqs)} requests, {n_tokens} tokens in {wall:.3f} s = "
          f"{n_tokens / wall:.2f} tok/s; {len(steps)} engine steps; phases "
          f"{json.dumps(phases)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"serve: launches {json.dumps(launches)}; per decode step without a"
          f" close (ctr, mac) {per_decode}; sealed bytes "
          f"{json.dumps({k: st[k] for k in st})}", flush=True)
    print("serve: tokens " + json.dumps({r.rid: r.tokens_out[:8]
                                         for r in reqs}), flush=True)

    # 5. the smoke config on the card against the CPU ---------------------
    (cpu_tok, cpu_stats), (gpu_tok, gpu_stats) = smoke_reference()
    check(cpu_tok == gpu_tok, f"smoke tokens differ: {cpu_tok} vs {gpu_tok}")
    check(cpu_stats == gpu_stats, "smoke sealed-byte counters differ")
    print("reference: smoke config on cuda == cpu, "
          f"{sum(len(t) for t in gpu_tok.values())} tokens", flush=True)

    # 6. tamper -----------------------------------------------------------
    poisoned, profile = tamper(eng, tenants, provider, cfg.vocab)
    print(f"tamper: page bit of tenant_a poisoned {poisoned['page']}; "
          f"weight bit poisoned {poisoned['weight']}", flush=True)
    print(f"profile: one decode step (4 lanes) {json.dumps(profile)}",
          flush=True)

    # 7. report -----------------------------------------------------------
    sources = {"ctr_cipher": ("src/repro_torch/csrc/ctr_cipher.cu",
                              "src/repro/kernels/ctr_cipher/kernel.py:43"),
               "tree_mac": ("src/repro_torch/csrc/tree_mac.cu",
                            "src/repro/kernels/tree_mac/kernel.py:53")}
    per_step = {}
    if per_decode:
        per_step = {"ctr_cipher": per_decode[0][0],
                    "tree_mac": per_decode[0][1]}
    kernels = []
    for name, cases in results.items():
        # one decode step's work: the whole weight tree plus the k and v
        # page-batch gathers (the slot and tag_root work is kept apart)
        step = [c for c in cases
                if c["shape"].startswith(("weight", "page gather"))]
        ms = sum(c["ms"] * c["per_step"] for c in step)
        plain = sum(c["plain_ms"] * c["per_step"] for c in step)
        nbytes = sum(c["bytes"] * c["per_step"] for c in step)
        ops = sum(c["ops"] * c["per_step"] for c in step)
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "launches_per_decode_step": per_step.get(name),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "mismatches": sum(c["mismatches"] for c in cases),
            "ms": ms, "plain_ms": plain, "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": None,
            "workload": "weight tree + k and v page-batch gathers of one "
                        "decode step",
            "shapes": [{k: c[k] for k in ("shape", "ms", "plain_ms",
                                          "bound_ms", "bound_by")}
                       for c in cases]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    from repro_torch.core.sealed import tree_leaves
    return tree_leaves(tree)


if __name__ == "__main__":
    sys.exit(main())
