"""Training launcher of the port — sealed training on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --steps 20

Every architecture of ``configs.ARCH_IDS``, through ``steps.make_cell``,
the family's ``init`` (``models/registry.py``) and
``steps.make_train_step_fn`` (the config's moment and accumulation
dtypes).  Runs on the card; ``--device cpu`` runs the same path on the
CPU with every kernel's plain version.  The smoke config is the default;
``--full`` takes the published size (every block recomputed) and then
reseals the state in place to fit the card; the in-place step consumes
the state passed in, so the Supervisor then checkpoints the initial state
before the first step (a restart always has a checkpoint to restore).
The state (params and Adam moments) is sealed under the channel key; each
step unseals, trains ``--accum`` microbatches of ``--batch`` sequences of
``--seq`` tokens (with the VLM's patch embeddings or the
encoder-decoder's ``--seq`` frame embeddings), and reseals.  ``--fail-at
N`` injects a node failure at step N: the Supervisor restores the last
checkpoint from ``--ckpt-dir`` and replays.  Weights are random, from a
seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from .. import configs
from ..core.channel import SecureChannel, resolve_device
from ..core.policy import SecurityConfig
from ..data import SyntheticLM
from ..train import seal_state
from ..train.fault import FailureInjector, StragglerPolicy, Supervisor
from . import steps as steps_lib


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--security", default="trusted",
                    choices=("trusted", "ctr", "off"))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cell = steps_lib.make_cell(args.arch, "train_4k", smoke=args.smoke,
                               security=args.security, device=device)
    cfg, model = cell.cfg, cell.model
    in_place = not args.smoke
    if args.security == "off":
        channel = SecureChannel.insecure(device=device)
    else:
        channel = SecureChannel.establish(device=device)
    if args.security == "ctr":
        channel.config = SecurityConfig.ctr_only()
    cell.sec = channel.config
    cell.key = channel.jkey

    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, cfg, device)
    state = seal_state(cell.opt.init(params), channel.jkey, channel.config)
    del params
    step = steps_lib.make_train_step_fn(cell, in_place=in_place)
    extra = steps_lib.batch_extra(cfg, args.seq)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch)

    def batch_fn(i):
        mb = data.microbatches_at(i, args.accum, extra)
        return {k: torch.as_tensor(v, device=device) for k, v in mb.items()}

    def stepper(s, b):
        t0 = time.perf_counter()
        s, m = step(s, b)
        print(f"step loss={float(m['loss']):.4f} "
              f"seal_ok={bool(m['seal_ok'])} "
              f"({(time.perf_counter()-t0)*1e3:.0f} ms)", flush=True)
        return s, m

    injector = FailureInjector(fail_at_steps=(args.fail_at,)) \
        if args.fail_at >= 0 else None
    sup = Supervisor(step_fn=stepper, batch_fn=batch_fn,
                     ckpt_dir=args.ckpt_dir, key_bytes=channel.key_bytes,
                     save_every=10, injector=injector,
                     straggler=StragglerPolicy(), save_at_start=in_place)
    state, metrics, events = sup.run(state, args.steps, log=print)
    print("done:", events)
    return events


if __name__ == "__main__":
    main()
