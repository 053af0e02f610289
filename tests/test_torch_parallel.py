"""The port's cross-pod gradient exchange (``parallel/compress.py``,
``parallel/collectives.py``) against the JAX reference.

Bit for bit: the int8 block quantization (values and f32 scales) and its
inverse, on sizes that are and are not multiples of the 256-element block;
byte tensors sealed by ``cipher.seal_bits``; each pod's sealed payload at a
``nonce_base`` whose ``* n_pods`` wraps mod 2^32, quantize off and on.
Exact: the sealed all-reduce and the grad hook of two pods, run as two
gloo processes on the CPU, equal the mean that the reference's own cipher
and compress functions give for the same two parts (the two f32 parts sum
to the same value in either order); with one pod the hook returns its
input bit for bit.
"""
import os
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cipher as jcipher  # noqa: E402
from repro.parallel import compress as jcompress  # noqa: E402
from repro_torch.core import cipher as tcipher  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel import compress  # noqa: E402

torch.set_num_threads(1)

KEY = np.array([0x0BADF00D, 0xC0FFEE11], np.uint32)
WRAP_BASE = 0x80000003        # * 2 pods wraps mod 2^32
SHAPES = [(256,), (3, 100), (2, 256), (5, 7, 11), (1,)]
TREE_SHAPES = [(4, 300), (7,), (2, 3, 64)]


def tkey():
    return torch.from_numpy(KEY.view(np.int32).copy())


def u(t: torch.Tensor) -> np.ndarray:
    """A port tensor's bits as the reference's unsigned numpy dtype."""
    a = t.numpy()
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.itemsize])


def parts(seed, shape):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal(shape) * 10.0 ** p).astype(np.float32)
            for p in (0, -3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_quantization_matches_reference(shape):
    x = (np.random.RandomState(1).standard_normal(shape) * 3
         ).astype(np.float32)
    x.reshape(-1)[0] = np.abs(x).max() / 127 * 2.5     # a tie: round to even
    q, s = jcompress.quantize_int8(jnp.asarray(x))
    tq, ts = compress.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tq.shape == x.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(u(ts), np.asarray(s).view(np.uint32))
    back = compress.dequantize_int8(tq, ts)
    np.testing.assert_array_equal(
        u(back), np.asarray(jcompress.dequantize_int8(q, s)).view(np.uint32))


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 9), (4, 8)])
def test_byte_tensors_seal_as_in_the_reference(shape):
    x = np.random.RandomState(2).randint(-127, 128, shape).astype(np.int8)
    for nonce in (0, 5, 0xFFFFFFFF):
        want = jcipher.seal_bits(jnp.asarray(x), jnp.asarray(KEY),
                                 jnp.uint32(nonce))
        got = tcipher.seal_bits(torch.from_numpy(x), tkey(), nonce)
        np.testing.assert_array_equal(u(got), np.asarray(want))
        back = tcipher.unseal_bits(got, tkey(), nonce, torch.int8)
        np.testing.assert_array_equal(back.numpy(), x)


def ref_payload(x, nonce_base, pod, n_pods, quantize):
    """The reference's sealed contribution of one pod (its
    ``sealed_allreduce_pod`` body), as numpy."""
    k = jnp.asarray(KEY)
    nonce = jnp.uint32(nonce_base) * jnp.uint32(n_pods) + jnp.uint32(pod)
    if quantize:
        q, scale = jcompress.quantize_int8(jnp.asarray(x))
        return (np.asarray(jcipher.seal_bits(q, k, nonce * 2)),
                np.asarray(jcipher.seal_bits(scale, k, nonce * 2 + 1)))
    return np.asarray(jcipher.seal_bits(jnp.asarray(x, jnp.float32), k,
                                        nonce))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("pod", [0, 1])
def test_each_pods_payload_matches_reference(pod, quantize):
    x = parts(3, (5, 300))[pod]
    nonce = (WRAP_BASE * 2 + pod) & 0xFFFFFFFF
    assert nonce < WRAP_BASE
    got = collectives.seal_payload(torch.from_numpy(x), tkey(), nonce,
                                   quantize=quantize)
    want = ref_payload(x, WRAP_BASE, pod, 2, quantize)
    if quantize:
        np.testing.assert_array_equal(u(got[0]), want[0])
        np.testing.assert_array_equal(u(got[1]), want[1])
    else:
        np.testing.assert_array_equal(u(got), want)


def ref_mean(xs, nonce_base, quantize):
    """The reference's all-reduce of parts ``xs`` (one a pod): seal each
    under its pod's nonce, unseal every part, dequantize, sum, / P."""
    k = jnp.asarray(KEY)
    P = len(xs)
    out = []
    for p, x in enumerate(xs):
        nonce = jnp.uint32(nonce_base) * jnp.uint32(P) + jnp.uint32(p)
        if quantize:
            cq, cs = ref_payload(x, nonce_base, p, P, True)
            q = jcipher.unseal_bits(jnp.asarray(cq), k, nonce * 2, jnp.int8)
            s = jcipher.unseal_bits(jnp.asarray(cs), k, nonce * 2 + 1,
                                    jnp.float32)
            out.append(jcompress.dequantize_int8(q, s))
        else:
            ct = ref_payload(x, nonce_base, p, P, False)
            out.append(jcipher.unseal_bits(jnp.asarray(ct), k, nonce,
                                           jnp.float32))
    return np.asarray(jnp.stack(out).sum(axis=0) / P)


def _pod(rank, port, out_dir):
    """One pod of the two-process exchange: writes its results."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        key = tkey()
        res = {}
        x = torch.from_numpy(parts(3, (5, 300))[rank])
        for q in (False, True):
            res[f"allreduce_q{int(q)}"] = collectives.sealed_allreduce_pod(
                x, key, WRAP_BASE, 2, quantize=q).numpy()
        tree = {f"g{i}": torch.from_numpy(parts(10 + i, s)[rank])
                for i, s in enumerate(TREE_SHAPES)}
        for q in (False, True):
            hook = collectives.make_crosspod_grad_hook(key, 2, quantize=q)
            out = hook(tree, torch.tensor(3, dtype=torch.int32))
            for name, v in out.items():
                res[f"hook_q{int(q)}_{name}"] = v.numpy()
        plain = collectives.make_crosspod_grad_hook(key, 2, sealed=False)
        for name, v in plain(tree, torch.tensor(3)).items():
            res[f"plain_{name}"] = v.numpy()
        np.savez(os.path.join(out_dir, f"pod{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_pod_exchange_equals_the_reference_mean(tmp_path):
    """Two gloo processes: ``sealed_allreduce_pod`` (quantize off and on)
    and the grad hook over a three-leaf tree at step 3 (leaf i under nonce
    base 3 * 65536 + i) equal the reference's mean exactly on both pods;
    the plain hook gives the f32 mean."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_pod, args=(_free_port(), str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    t_end = time.monotonic() + 120
    while not ctx.join(timeout=5):
        if time.monotonic() > t_end:
            for proc in ctx.processes:
                proc.terminate()
            pytest.fail("the two-pod exchange did not end in 120 s")
    res = [dict(np.load(tmp_path / f"pod{r}.npz")) for r in range(2)]
    xs = parts(3, (5, 300))
    for q in (False, True):
        want = ref_mean(xs, WRAP_BASE, q)
        for r in range(2):
            np.testing.assert_array_equal(res[r][f"allreduce_q{int(q)}"],
                                          want)
    for i, shape in enumerate(TREE_SHAPES):
        leaf = parts(10 + i, shape)
        for q in (False, True):
            want = ref_mean(leaf, 3 * 65536 + i, q)
            for r in range(2):
                np.testing.assert_array_equal(
                    res[r][f"hook_q{int(q)}_g{i}"], want)
        for r in range(2):
            np.testing.assert_array_equal(res[r][f"plain_g{i}"],
                                          (leaf[0] + leaf[1]) / 2)
    # quantization costs precision: the sealed f32 mean is exact
    np.testing.assert_array_equal(res[0]["allreduce_q0"],
                                  (xs[0] + xs[1]) / np.float32(2))
    assert not np.array_equal(res[0]["allreduce_q1"], res[0]["allreduce_q0"])


def test_one_pod_hook_returns_its_input():
    """With one pod the hook seals, gathers, unseals and divides by 1:
    quantize off gives the gradients back bit for bit (signed zeros too),
    quantize on within half an int8 step of each block's scale (and the
    rounding of q * scale)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        rng = np.random.RandomState(5)
        tree = {"a": torch.from_numpy(rng.standard_normal((3, 300)).astype(
            np.float32)), "b": torch.tensor([-0.0, 0.0, 1e-30, -2.5])}
        same = collectives.make_crosspod_grad_hook(tkey(), 1, quantize=False)(
            tree, torch.tensor(9))
        for k in tree:
            np.testing.assert_array_equal(u(same[k]), u(tree[k]))
        q = collectives.make_crosspod_grad_hook(tkey(), 1, quantize=True)(
            tree, torch.tensor(9))
        for k, x in tree.items():
            _, scale = compress.quantize_int8(x)
            err = (q[k] - x).abs().reshape(-1)
            lim = scale.repeat_interleave(256)[:x.numel()] / 2
            assert (err <= lim * (1 + 1e-4)).all()     # q * scale rounds
    finally:
        dist.destroy_process_group()
