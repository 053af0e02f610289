"""Quickstart on the PyTorch port: the paper's full flow in one page.

1. Trust establishment (attestation + signed DH -> session key K)
2. Seal model weights into untrusted memory (Rules 1/2)
3. Launch a protected inference step (Rule 3 register MAC)
4. Show that tampering with ciphertext poisons the output instead of
   silently computing on attacker-controlled data.
5. Multi-tenant serving: two tenants with their own session keys share one
   gateway (continuous batching over a sealed, paged KV pool).
6. Oversubscription: more requests than physical KV pages — high-priority
   traffic preempts, sealed pages swap verbatim into the host-tier
   SealedStore and back, and everything still completes.

Runs on the card; ``--device cpu`` runs the same flow with every kernel's
plain version.  Weights come from a seeded ``torch.Generator``, prompts
from seeded numpy generators.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import SecureChannel
from repro_torch.core.channel import resolve_device
from repro_torch.core.sealed import (SealedTensor, tree_leaves,
                                     tree_unflatten, unseal_tree)
from repro_torch.models import registry
from repro_torch.models.transformer import params_from_numpy
from repro_torch.serve import SecureGateway, ServeEngine


def _params(cfg, device, np_params):
    if np_params is None:
        return registry.get_model(cfg).init(
            torch.Generator(device=device).manual_seed(0), cfg, device)
    return params_from_numpy(np_params, device)


def run(device="cuda", params=None, gateway_params=None,
        prompt=None) -> dict:
    """The six sections; returns what ``main`` prints.

    params / gateway_params: the reference's qwen3-4b and granite-3-2b
    smoke parameter trees as numpy (default: random weights from a seeded
    generator on ``device``); prompt: int [2, 12] for section 3 (default:
    seeded numpy)."""
    device = resolve_device(device)
    out = {}
    # -- 1. handshake (paper §3.2) --------------------------------------
    channel = SecureChannel.establish(device_id="gpu-0", device=device)
    out["register_nonce"] = channel.device_regs.last_nonce

    # -- 2. build + seal a model ----------------------------------------
    cfg = configs.get_config("qwen3-4b", smoke=True)
    sealed_params = channel.upload_tree(_params(cfg, device, params))
    out["ciphertext_words"] = sum(
        x.ct.numel() for x in tree_leaves(sealed_params)
        if isinstance(x, SealedTensor))

    # -- 3. protected serving -------------------------------------------
    engine = ServeEngine(cfg=cfg, params=sealed_params, channel=channel,
                         max_len=48)
    if prompt is None:
        prompt = np.random.RandomState(1).randint(
            0, cfg.vocab, (2, 12)).astype(np.int32)
    out["prompt"] = prompt
    out["tokens"] = engine.generate({"tokens": prompt}, n_new=8)

    # -- 4. tamper -> poison ---------------------------------------------
    # one ciphertext word of a large leaf gains 1, in the ciphertext's own
    # signed storage dtype (the same bits as the reference's uint add)
    leaves = tree_leaves(sealed_params)
    i = next(i for i, l in enumerate(leaves) if l.ct.numel() > 1000)
    st = leaves[i]
    ct = st.ct.clone()
    ct.view(-1)[7] += 1
    leaves[i] = SealedTensor(ct, st.tags, st.nonce, st.dtype, st.spec)
    _, ok = unseal_tree(tree_unflatten(sealed_params, leaves), channel.jkey)
    out["tamper_ok"] = bool(ok)

    # -- 5. two tenants, one engine --------------------------------------
    # The gateway attests each tenant separately; their mixed-length
    # requests are continuously batched over one sealed paged KV pool, with
    # every tenant's pages sealed under its own session key.
    scfg = configs.get_config("granite-3-2b", smoke=True)
    sparams = _params(scfg, device, gateway_params)
    gw = SecureGateway(scfg, sparams, security="trusted",
                       max_slots=2, page_size=8, n_pages=16,
                       max_pages_per_seq=3, device=device)
    rng = np.random.RandomState(0)
    rid_a = gw.submit("alice", rng.randint(0, scfg.vocab, 5), max_new=6)
    rid_b = gw.submit("bob", rng.randint(0, scfg.vocab, 11), max_new=6)
    gw.drain()
    out["alice"], out["bob"] = gw.collect(rid_a), gw.collect(rid_b)
    m = gw.metrics()
    out["gateway"] = {k: m[k] for k in (
        "tokens", "tok_per_s", "kv_pages_peak", "sealed_bytes_per_token",
        "decode_tokens", "page_closes", "prefill_chunks")}
    out["gateway"]["tenant_sessions"] = len(m["tokens_per_tenant"])

    # -- 6. oversubscription via preemptive swap --------------------------
    # A pool of 4 usable pages, but 6 requests that reserve 2 pages each
    # (12 > 4).  Batch traffic admits first; interactive (priority 5)
    # requests preempt it — the victims' sealed pages move *verbatim*
    # (ciphertext + tags, never decrypted) into the SealedStore host tier,
    # and swap back in later to resume mid-sequence, bitwise identical.
    gw2 = SecureGateway(scfg, sparams, security="trusted",
                        max_slots=2, page_size=8, n_pages=5,
                        max_pages_per_seq=2, device=device)
    rids = [gw2.submit("batch", rng.randint(0, scfg.vocab, 9), max_new=4)
            for _ in range(2)]
    gw2.step()     # batch requests now hold every slot and page
    rids += [gw2.submit("live", rng.randint(0, scfg.vocab, 5), max_new=4,
                        priority=5) for _ in range(2)]
    rids += [gw2.submit("batch", rng.randint(0, scfg.vocab, 9), max_new=4)
             for _ in range(2)]
    gw2.drain()
    m2 = gw2.metrics()
    out["oversubscribed"] = {
        "requests": len(rids), "pages": gw2.pool.n_pages - 1,
        "statuses": [gw2.status(r) for r in rids],
        "swap_outs": m2["swap_outs"], "swap_ins": m2["swap_ins"],
        "occupancy_pct": m2["pool_occupancy_pct"],
        "tokens": [gw2.collect(r).tolist() for r in rids]}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    r = run(args.device)
    print(f"session established; register nonce={r['register_nonce']}")
    print(f"sealed {r['ciphertext_words']:,} ciphertext words into "
          "untrusted memory")
    print("generated tokens:\n", r["tokens"])
    print(f"tamper detected: ok={r['tamper_ok']} (outputs would be "
          "NaN-poisoned)")
    if r["tamper_ok"]:
        raise RuntimeError("the tampered ciphertext verified")
    g = r["gateway"]
    print("alice:", r["alice"], "| bob:", r["bob"])
    print(f"{g['tokens']} tokens at {g['tok_per_s']:.1f} tok/s over "
          f"{g['tenant_sessions']} tenant sessions "
          f"(KV pages peak {g['kv_pages_peak']})")
    # open-page sealing: each decode step sealed only the new token's slot
    # (plus one page-close per filled page) instead of a whole KV page —
    # per-token cost O(bytes written), the paper's §3.4 model.
    print(f"sealed bytes per decode token: {g['sealed_bytes_per_token']:.0f} "
          f"(page closes: {g['page_closes']}, "
          f"prefill chunks: {g['prefill_chunks']})")
    o = r["oversubscribed"]
    print(f"oversubscribed: {o['requests']} requests over {o['pages']} "
          f"pages -> {o['statuses'].count('done')}/{o['requests']} done, "
          f"swaps out/in {o['swap_outs']}/{o['swap_ins']}, "
          f"occupancy {o['occupancy_pct']:.0f}%")
    return r


if __name__ == "__main__":
    main()
