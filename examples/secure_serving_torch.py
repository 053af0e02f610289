"""Sealed batched serving on the PyTorch port: weights AND the growing KV
cache live in untrusted memory as ciphertext; every launch goes through
Rule-3 register protection.

Runs on the card; ``--device cpu`` runs the same path with every kernel's
plain version.  Weights come from a seeded ``torch.Generator``, prompts
from a seeded numpy generator.

Run:  PYTHONPATH=src python examples/secure_serving_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import SecureChannel
from repro_torch.core.channel import resolve_device
from repro_torch.models import registry
from repro_torch.models.transformer import params_from_numpy
from repro_torch.serve import ServeEngine

BATCH, PROMPT, N_NEW, MAX_LEN = 4, 16, 12, 64


def run(device="cuda", params=None, prompts=None) -> dict:
    """Sealed and plaintext generation of granite-3-2b's smoke config.

    params: the reference's parameter tree as numpy (default: random
    weights from a seeded generator on ``device``); prompts: int [4, 16]
    (default: seeded numpy)."""
    device = resolve_device(device)
    cfg = configs.get_config("granite-3-2b", smoke=True)
    if params is None:
        params = registry.get_model(cfg).init(
            torch.Generator(device=device).manual_seed(0), cfg, device)
    else:
        params = params_from_numpy(params, device)
    if prompts is None:
        prompts = np.random.RandomState(7).randint(
            0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)

    channel = SecureChannel.establish(device_id="serve-0", device=device)
    engine = ServeEngine(cfg=cfg, params=channel.upload_tree(params),
                         channel=channel, max_len=MAX_LEN)
    t0 = time.perf_counter()
    out = engine.generate({"tokens": prompts}, n_new=N_NEW)
    dt = time.perf_counter() - t0

    # plaintext engine must agree bit-for-bit (CTR is exact)
    plain = ServeEngine(cfg=cfg, params=params,
                        channel=SecureChannel.insecure(device=device),
                        max_len=MAX_LEN)
    plain_out = plain.generate({"tokens": prompts}, n_new=N_NEW)
    return {"prompts": prompts, "tokens": out, "plain_tokens": plain_out,
            "ms": dt * 1e3,
            "launches_verified": channel.device_regs.last_nonce,
            "sealed_equals_plain": bool((plain_out == out).all())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)
    r = run(args.device)
    print(f"sealed generation ({BATCH} requests x {N_NEW} tokens):")
    print(r["tokens"])
    print(f"{r['ms']:.0f} ms total; launch descriptors verified: "
          f"{r['launches_verified']}")
    if not r["sealed_equals_plain"]:
        raise RuntimeError("sealed tokens differ from the plaintext engine's")
    print("sealed == plaintext generation: verified")
    return r


if __name__ == "__main__":
    main()
