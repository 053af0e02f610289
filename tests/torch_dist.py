"""Helpers of the port's multi-process tests (not a test module).

``spawn`` runs ``fn(rank, port, out_dir, *args)`` in ``nprocs`` spawned
processes, which open a gloo group on 127.0.0.1 themselves, and fails the
test if they do not all end in ``timeout`` seconds, so a hang costs that
and not the suite's limit.  ``reference`` runs JAX code in a subprocess
with N host devices (the reference's mesh tests need them, and this
process's JAX has one).  Trees cross as .npz files of "/"-joined paths.
"""
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_gloo(rank: int, port: int, world: int) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))


def spawn(fn, nprocs: int, out_dir, *args, timeout: float = 120) -> None:
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(free_port(), str(out_dir), *args),
                             nprocs=nprocs, join=False, start_method="spawn")
    t_end = time.monotonic() + timeout
    while not ctx.join(timeout=2):
        if time.monotonic() > t_end:
            for proc in ctx.processes:
                proc.terminate()
            pytest.fail(f"{nprocs} processes did not end in {timeout} s")


def reference(code: str, n_devices: int, timeout: float = 300) -> str:
    """Run ``code`` with the JAX package and ``n_devices`` host devices;
    returns its standard output."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout


def flat(tree, prefix="") -> dict:
    """A nested dict as {"a/b/c": leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def nest(flat_tree: dict) -> dict:
    out = {}
    for path, v in flat_tree.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out
