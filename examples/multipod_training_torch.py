"""Hierarchical multi-pod training with SEALED cross-pod collectives, on the
PyTorch port.

Trust boundary: inside a pod the links are trusted; the cross-pod link is
the paper's snoopable bus.  Per-pod gradients are int8-compressed,
CTR-sealed with (step, pod)-unique nonces, all-gathered across the pods,
and unsealed + combined inside each pod's trust boundary.

Each pod is a process of a gloo group (NCCL refuses two ranks on one
card): ``make_smoke_mesh(2, pods=2)`` gives the mesh (pod 2, data 1,
model 1).  The host runs the handshake once and hands the session key to
both pods; each seals the same initial state, trains on its half of every
batch through the sealed cross-pod gradient hook, and prints its loss.
After every step both pods hold the same sealed state, bit for bit.  Runs
on the card (both pods on the one card); ``--device cpu`` runs the same
flow with every kernel's plain version.  Weights come from a seeded
``torch.Generator``.

Run:  PYTHONPATH=src python examples/multipod_training_torch.py
"""
import argparse
import datetime
import hashlib
import json
import os
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import SecureChannel, SecurityConfig
from repro_torch.core.channel import resolve_device
from repro_torch.core.registers import DeviceRegisterFile, HostRegisterFile
from repro_torch.core.sealed import tree_leaves
from repro_torch.data import SyntheticLM
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.transformer import params_from_numpy
from repro_torch.parallel.collectives import make_crosspod_grad_hook
from repro_torch.train import make_train_step, seal_state

N_PODS, STEPS, SEQ, BATCH = 2, 8, 32, 8
TIMEOUT_S = 600


def state_digest(state) -> str:
    """SHA-256 over the step, every leaf's ciphertext, tags and nonce."""
    h = hashlib.sha256(str(int(state.step)).encode())
    for tree in (state.params, state.mu, state.nu):
        for st in tree_leaves(tree):
            h.update(st.ct.contiguous().cpu().numpy().tobytes())
            h.update(st.tags.contiguous().cpu().numpy().tobytes())
            h.update(str(st.nonce).encode())
    return h.hexdigest()


def pod_batch(data: SyntheticLM, i: int, pod: int, device) -> dict:
    """Pod ``pod``'s half of the batch axis of step ``i``'s two
    microbatches."""
    per = data.batch // N_PODS
    return {k: torch.as_tensor(np.ascontiguousarray(
                v[:, pod * per:(pod + 1) * per]), device=device)
            for k, v in data.microbatches_at(i, 2).items()}


def train_pod(pod: int, port: int, key_words, key_bytes: bytes,
              steps: int = STEPS, device="cuda", params=None) -> dict:
    """One pod's training: joins the gloo group at 127.0.0.1:``port`` as
    rank ``pod``, trains ``steps`` steps and leaves the group.

    key_words / key_bytes: the session key of the host's handshake;
    params: the reference's parameter tree as numpy (default: random
    weights from a seeded generator)."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=pod, world_size=N_PODS,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_smoke_mesh(N_PODS, pods=N_PODS,
                               device_type=device.type)
        cell = steps_lib.make_cell("granite-3-2b", "train_4k", smoke=True,
                                   device=device)
        cfg, model = cell.cfg, cell.model
        channel = SecureChannel(
            key_words=np.asarray(key_words, np.uint32), key_bytes=key_bytes,
            config=SecurityConfig(),
            host_regs=HostRegisterFile(key=key_bytes),
            device_regs=DeviceRegisterFile(key=key_bytes), device=device)
        if params is None:
            params = model.init(
                torch.Generator(device=device).manual_seed(0), cfg, device)
        else:
            params = params_from_numpy(params, device)
        state = seal_state(cell.opt.init(params), channel.jkey,
                           channel.config)
        del params

        # per-pod step: loss/grads over the pod's batch shard; sealed
        # combine
        hook = make_crosspod_grad_hook(channel.jkey, N_PODS, sealed=True,
                                       quantize=True)
        step = make_train_step(model, cfg, cell.opt, channel.config,
                               channel.jkey, grad_hook=hook)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH)
        losses, seal_ok, digests, step_s = [], [], [], []
        for i in range(steps):
            t0 = time.perf_counter()
            state, metrics = step(state, pod_batch(data, i, pod, device))
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t0)
            seal_ok.append(bool(metrics["seal_ok"]))
            digests.append(state_digest(state))
        return {"pod": pod, "mesh": dict(zip(mesh.mesh_dim_names,
                                             mesh.mesh.shape)),
                "losses": losses, "seal_ok": seal_ok, "digests": digests,
                "step_s": step_s}
    finally:
        dist.destroy_process_group()


def _pod_main(pod: int, port: int, out_dir: str, kwargs: dict):
    if kwargs["device"] == "cpu":        # the host's cores, split
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // N_PODS))
    res = train_pod(pod, port, **kwargs)
    with open(os.path.join(out_dir, f"pod{pod}.json"), "w") as f:
        json.dump(res, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(device="cuda", steps=STEPS, params=None) -> dict:
    """Both pods as two spawned processes; returns what ``main`` prints."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    channel = SecureChannel.establish(device=device)
    kwargs = dict(key_words=channel.key_words.tolist(),
                  key_bytes=channel.key_bytes, steps=steps,
                  device=str(device), params=params)
    with tempfile.TemporaryDirectory(prefix="multipod_") as out_dir:
        ctx = mp.start_processes(_pod_main,
                                 args=(_free_port(), out_dir, kwargs),
                                 nprocs=N_PODS, join=False,
                                 start_method="spawn")
        t_end = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=2):
            if time.monotonic() > t_end:
                for proc in ctx.processes:
                    proc.terminate()
                raise RuntimeError(f"the pods did not end in {TIMEOUT_S} s")
        pods = []
        for p in range(N_PODS):
            with open(os.path.join(out_dir, f"pod{p}.json")) as f:
                pods.append(json.load(f))
    return {"mesh": pods[0]["mesh"], "pods": pods,
            "states_equal": len({tuple(p["digests"]) for p in pods}) == 1,
            "loss_fell": all(p["losses"][-1] < p["losses"][0]
                             for p in pods)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda",
                    help="torch device of both pods (default: the card)")
    args = ap.parse_args(argv)
    r = run(args.device, args.steps)
    print("mesh:", r["mesh"])
    for i in range(args.steps):
        print(f"step {i}: " + "  ".join(
            f"pod {p['pod']} loss={p['losses'][i]:.4f} "
            f"seal_ok={p['seal_ok'][i]}" for p in r["pods"]))
    if not r["states_equal"]:
        raise RuntimeError("the pods' sealed states differ")
    if not r["loss_fell"]:
        raise RuntimeError("the loss did not fall on every pod")
    first = [p["losses"][0] for p in r["pods"]]
    last = [p["losses"][-1] for p in r["pods"]]
    print("sealed cross-pod training: pod states equal after every step, "
          "loss decreased on every pod "
          f"({' / '.join(f'{a:.3f} -> {b:.3f}' for a, b in zip(first, last))})")
    return r


if __name__ == "__main__":
    main()
