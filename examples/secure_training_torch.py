"""End-to-end sealed training on the PyTorch port: ~100M-param LM, sealed
state, checkpoint/restart, failure injection, straggler policy.

Default runs a reduced step count so the example completes quickly; pass
--steps 300 for the full few-hundred-step run, --dim/--layers to scale,
--full100m for the ~100M-parameter model.  Runs on the card; ``--device
cpu`` runs the same flow with every kernel's plain version.  Weights come
from a seeded ``torch.Generator``.

Run:  PYTHONPATH=src python examples/secure_training_torch.py [--steps N]
"""
import argparse
import tempfile
import time

import torch

from repro_torch.core import SecureChannel
from repro_torch.core.channel import resolve_device
from repro_torch.core.sealed import tree_leaves
from repro_torch.data import SyntheticLM
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim import AdamW
from repro_torch.train import make_train_step, seal_state, unseal_state_host
from repro_torch.train.fault import FailureInjector, StragglerPolicy, Supervisor

FULL100M = dict(dim=768, layers=10, vocab=32768)


def demo_config(dim: int, layers: int, vocab: int) -> ModelConfig:
    return ModelConfig(
        arch_id="secure-train-demo", family="dense",
        n_layers=layers, d_model=dim, n_heads=dim // 64,
        n_kv_heads=max(1, dim // 128), d_ff=4 * dim,
        vocab=vocab, q_block=64, dtype="float32", param_dtype="float32")


def run(device="cuda", steps=30, dim=256, layers=4, vocab=4096, batch=8,
        seq=64, params=None) -> dict:
    """Sealed training through ``Supervisor`` with a failure injected at
    step ``steps // 2``; returns what ``main`` prints.

    params: the reference's parameter tree as numpy (default: random
    weights from a seeded generator on ``device``)."""
    device = resolve_device(device)
    cfg = demo_config(dim, layers, vocab)
    model = registry.get_model(cfg)

    channel = SecureChannel.establish(device=device)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            cfg, device)
    else:
        params = params_from_numpy(params, device)
    n = sum(x.numel() for x in tree_leaves(params))

    opt = AdamW(lr=3e-4, weight_decay=0.01)
    state = seal_state(opt.init(params), channel.jkey, channel.config)
    del params
    step = make_train_step(model, cfg, opt, channel.config, channel.jkey)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch)

    losses, seal_ok, step_s, log = [], [], [], []

    def stepper(s, b):
        t0 = time.perf_counter()
        s, m = step(s, b)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
        seal_ok.append(bool(m["seal_ok"]))
        if len(losses) % 10 == 1:
            log.append(f"  step {len(losses):4d}  loss {losses[-1]:.4f}  "
                       f"seal_ok={seal_ok[-1]}")
        return s, m

    def batch_fn(i):
        return {k: torch.as_tensor(v, device=device)
                for k, v in data.microbatches_at(i, 2).items()}

    with tempfile.TemporaryDirectory() as ckpt_dir:
        sup = Supervisor(
            step_fn=stepper, batch_fn=batch_fn, ckpt_dir=ckpt_dir,
            key_bytes=channel.key_bytes, save_every=10,
            injector=FailureInjector(fail_at_steps=(steps // 2,)),
            straggler=StragglerPolicy())
        state, _, events = sup.run(state, steps, log=log.append)

    final = unseal_state_host(state, channel.jkey, channel.config)
    return {"n_params": n, "losses": losses, "seal_ok": seal_ok,
            "step_s": step_s, "events": events, "log": log,
            "final_step": int(final.step), "final_state": final}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full100m", action="store_true",
                    help="~100M-param config (768 wide, 10 layers, "
                         "vocab 32768: 138.8M parameters)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    if args.full100m:
        vars(args).update(FULL100M)
    r = run(args.device, args.steps, args.dim, args.layers, args.vocab,
            args.batch, args.seq)
    print(f"model: {r['n_params']/1e6:.1f}M params, sealed training "
          f"(CTR+MAC on params & Adam moments)")
    for line in r["log"]:
        print(line)
    losses = r["losses"]
    print(f"\nevents: {r['events']}")
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({len(losses)} executed steps incl. replays)")
    print(f"final state verified + unsealed at step {r['final_step']}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("the loss did not fall")
    return r


if __name__ == "__main__":
    main()
