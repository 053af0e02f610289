"""Serving launcher of the port — the multi-tenant secure gateway.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --tenants 3 --requests 6 --max-new 12

Runs on the card; ``--device cpu`` runs the same path on the CPU with every
kernel's plain version.  Each tenant runs its own attestation handshake;
requests have mixed prompt lengths and share one sealed paged KV pool.
``--hi-every N`` marks every Nth request as high priority (class 5): when
slots or pages run out it preempts running low-priority requests, whose
sealed KV swaps verbatim into the SealedStore host tier and back.
``--engine fixed`` runs the fixed-slot ``ServeEngine`` over equal-length
prompts instead; the VLM, MoE, RWKV, hybrid and encoder-decoder families
have no paged path and always take it (with a message under ``--engine
gateway``).  ``--watch N``
prints the posture dashboard to stderr every N steps; ``--slo name=value``
tunes the streaming monitor's thresholds.  Weights, the VLM's patch
embeddings and the encoder-decoder's frame embeddings (one frame a prompt
position) are random, from a seeded ``torch.Generator`` and numpy.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import configs
from ..core.channel import SecureChannel, resolve_device
from ..models import registry
from ..obs import MonitorConfig, parse_slo_overrides, render_gateway
from ..serve import SecureGateway, ServeEngine


def _run_gateway(cfg, params, args, device) -> SecureGateway:
    mon_cfg = MonitorConfig()
    if args.slo:
        mon_cfg = mon_cfg.overridden(**parse_slo_overrides(args.slo))
    gw = SecureGateway(cfg, params, security=args.security,
                       max_slots=args.slots, page_size=args.page_size,
                       n_pages=args.pages, max_pages_per_seq=args.max_pages,
                       rotate_every=args.rotate_every,
                       open_pages=not args.whole_page_reseal,
                       prefill_chunk=args.prefill_chunk,
                       trace=bool(args.trace), monitor_config=mon_cfg,
                       device=device)
    rng = np.random.RandomState(0)
    rids = []
    for i in range(args.requests):
        tenant = f"tenant-{i % args.tenants}"
        plen = int(rng.randint(args.min_prompt, args.max_prompt + 1))
        prompt = rng.randint(0, cfg.vocab, plen)
        prio = 5 if (args.hi_every and (i + 1) % args.hi_every == 0) else 0
        rids.append(gw.submit(tenant, prompt, max_new=args.max_new,
                              priority=prio))
    if args.watch:
        steps = 0
        while not gw.scheduler.idle:
            gw.step()
            steps += 1
            if steps % args.watch == 0:
                print(render_gateway(gw), file=sys.stderr)
        print(render_gateway(gw), file=sys.stderr)
    else:
        gw.drain()
    for rid in rids:
        out = gw.collect(rid)
        req = gw.scheduler.requests[rid]
        swaps = f" swaps {req.swaps_out}/{req.swaps_in}" if req.swaps_out \
            else ""
        print(f"  req {rid} [{req.tenant_id}, prompt {req.prompt_len:3d}, "
              f"prio {req.priority}] "
              f"-> {out[:8].tolist()}{'...' if len(out) > 8 else ''} "
              f"({gw.status(rid)}{swaps})")
    m = gw.metrics()
    print(f"{m['tokens']} tokens in {m['elapsed_s']:.2f} s "
          f"({m['tok_per_s']:.1f} tok/s); "
          f"p50 {m['p50_token_ms']:.1f} ms  p95 {m['p95_token_ms']:.1f} ms  "
          f"ttft {m['mean_ttft_ms']:.1f} ms")
    print(f"pages peak {m['kv_pages_peak']}  occupancy "
          f"{m['pool_occupancy_pct']:.1f}%  swap out/in "
          f"{m['swap_outs']}/{m['swap_ins']}  "
          f"preempted {m['preempted_requests']} "
          f"(ttft {m['preempted_ttft_ms']:.1f} ms)")
    print(f"prefill chunks {m['prefill_chunks']} "
          f"(occupancy {m['prefill_chunk_occupancy_pct']:.0f}%)  "
          f"sealed bytes/decode-token {m['sealed_bytes_per_token']:.0f}  "
          f"page closes {m['page_closes']} reopens {m['page_reopens']}")
    print(f"rotations {m['rotations']}  "
          f"launches verified: {m['launches_verified']}")
    if args.trace:
        n = gw.export_trace(args.trace, fmt="chrome")
        print(f"trace: {args.trace} ({n} events — load at "
              "https://ui.perfetto.dev)")
        gw.close()             # the tracer off; its buffer kept
    if args.audit:
        n = gw.export_audit(args.audit, key_path=args.audit + ".key")
        report = gw.verify_audit()
        print(f"audit: {args.audit} ({n} records, key in "
              f"{args.audit}.key) — chain "
              f"{'OK' if report['ok'] else 'BROKEN: ' + str(report)}")
    return gw


def _run_fixed(cfg, params, args, device) -> ServeEngine:
    channel = (SecureChannel.establish(device=device)
               if args.security == "trusted"
               else SecureChannel.insecure(device=device))
    if args.security == "trusted":
        params = channel.upload_tree(params)
    # the patch embeddings take the cache's first slots (the reference
    # leaves them out of max_len)
    n_front = cfg.n_frontend_tokens if cfg.frontend == "patch" else 0
    max_len = n_front + args.max_prompt + args.max_new + 4
    engine = ServeEngine(cfg=cfg, params=params, channel=channel,
                         max_len=max_len)
    batch = {"tokens": np.random.RandomState(1).randint(
        0, cfg.vocab, (args.slots, args.max_prompt)).astype(np.int32)}
    if n_front:
        batch["patch_embeds"] = np.random.RandomState(2).standard_normal(
            (args.slots, n_front, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "frame":
        batch["frame_embeds"] = np.random.RandomState(2).standard_normal(
            (args.slots, args.max_prompt, cfg.d_model)).astype(np.float32)
    t0 = time.perf_counter()
    out = engine.generate(batch, n_new=args.max_new)
    dt = time.perf_counter() - t0
    print(out)
    print(f"{args.slots} x {args.max_new} tokens in {dt*1e3:.0f} ms "
          f"({args.slots*args.max_new/dt:.1f} tok/s); launches verified: "
          f"{channel.device_regs.last_nonce}")
    return engine


def main(argv=None):
    """Serve; returns the gateway, or the fixed-slot engine."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--engine", default="gateway",
                    choices=("gateway", "fixed"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pages", type=int, default=64)
    ap.add_argument("--max-pages", type=int, default=4)
    ap.add_argument("--rotate-every", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="tokens per batched prefill chunk (multiple of "
                         "page-size; 0 = whole-prompt chunks)")
    ap.add_argument("--whole-page-reseal", action="store_true",
                    help="legacy baseline: reseal the whole tail page per "
                         "decode token instead of slice-sealed open pages")
    ap.add_argument("--hi-every", type=int, default=0,
                    help="every Nth request is high priority (0 = never)")
    ap.add_argument("--trace", default="",
                    help="record a trace and write it here as a "
                         "Perfetto-loadable Chrome trace_event file")
    ap.add_argument("--audit", default="",
                    help="export the hash-chained audit log (JSONL + "
                         "<path>.key verification key) here")
    ap.add_argument("--watch", type=int, default=0, metavar="N",
                    help="print the posture dashboard (SLOs, alerts, "
                         "per-tenant state) to stderr every N steps")
    ap.add_argument("--slo", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="monitor threshold override, e.g. "
                         "--slo ttft_p95_ms=250 (repeatable; see "
                         "repro_torch.obs.MonitorConfig for field names)")
    ap.add_argument("--security", default="trusted", choices=("trusted", "off"))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    params = registry.get_model(cfg).init(
        torch.Generator(device=device).manual_seed(0), cfg, device)
    if args.engine == "gateway" and cfg.family == "dense":
        return _run_gateway(cfg, params, args, device)
    if args.engine == "gateway":
        print(f"{cfg.family} family has no paged path yet; "
              "falling back to the fixed-slot engine")
    return _run_fixed(cfg, params, args, device)


if __name__ == "__main__":
    main()
