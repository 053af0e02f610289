"""Sealed matmul: the kernel wrapper and the sealing helpers.

``sealed_matmul`` is the wrapper of ``csrc/sealed_matmul.cu``: a CPU tensor
takes the plain version (``ref.py``); a CUDA tensor launches the kernel on
PyTorch's current stream, or raises.  ``seal_operand`` and ``matmul``
mirror ``repro.kernels.sealed_matmul.ops``: per-tensor keys are
``derive_tensor_key(master, nonce)``, and the MAC keys of both operands
come from the nonce-bound MAC key of ``nonce_a``.
"""
from __future__ import annotations

import ctypes

import torch

from ...core import cipher, mac
from .. import build
from .ref import CHUNK_WORDS, TILE, sealed_matmul_ref


# The kernel's output tile per block (csrc/sealed_matmul.cu BM, BN) and the
# cluster extents it runs in, largest first.  M is a multiple of 256, so
# M/128 is even and a cluster of 1 along M is never needed.
BLOCK_M, BLOCK_N = 128, 256
CLUSTER_M, CLUSTER_N = (4, 2), (2, 1)
# integer operations per Threefry block of four bf16 (common.cuh)
CTR_OPS_PER_BLOCK = 74


def cluster_shape(M: int, N: int) -> tuple[int, int]:
    """(cm, cn): the largest cluster extents along M and N that divide the
    kernel's grid of M/128 x N/256 blocks."""
    cm = next(c for c in CLUSTER_M if (M // BLOCK_M) % c == 0)
    cn = next(c for c in CLUSTER_N if (N // BLOCK_N) % c == 0)
    return cm, cn


def keystream_ops(M: int, K: int, N: int) -> float:
    """Integer operations of the keystream the kernel regenerates: every A
    tile once per cluster column of the grid, every B tile once per cluster
    row, so 18.5 M K N (1 / (BN cn) + 1 / (BM cm))."""
    cm, cn = cluster_shape(M, N)
    return (CTR_OPS_PER_BLOCK / 4 * M * K * N
            * (1 / (BLOCK_N * cn) + 1 / (BLOCK_M * cm)))


def _launcher():
    fn = build.library("sealed_matmul").sealed_matmul_launch
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 10 + [i32] * 6 + [vp]
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype):
    if t is None or tuple(t.shape) != shape or t.dtype != dtype:
        got = None if t is None else (t.dtype, tuple(t.shape))
        raise ValueError(f"{name} must be {dtype} {list(shape)}, got {got}")


def sealed_matmul(a_ct, b_ct, tags_a, tags_b, key_a, key_b, mkeys, *,
                  verify: bool = True):
    """C = unseal(a_ct) @ unseal(b_ct) with every MAC chunk checked.

    a_ct int16 [M, K], b_ct int16 [K, N] (bf16 ciphertext bits; M, K, N
    multiples of 256); tags_a int32 [M, K/256], tags_b int32 [K, N/256]
    (None when ``verify`` is off); key_a/key_b int32 [2] tensor keys; mkeys
    int32 [128] canonical MAC keys (None when ``verify`` is off).  Returns
    (C bf16 [M, N], bad int32 [M/256, N/256]).
    """
    if a_ct.dim() != 2 or b_ct.dim() != 2 or a_ct.shape[1] != b_ct.shape[0]:
        raise ValueError(f"operands must be [M, K] and [K, N], got "
                         f"{tuple(a_ct.shape)} and {tuple(b_ct.shape)}")
    M, K = a_ct.shape
    N = b_ct.shape[1]
    if M % TILE or K % TILE or N % TILE:
        raise ValueError(f"M, K, N must be multiples of {TILE}: {M, K, N}")
    _check("a_ct", a_ct, (M, K), torch.int16)
    _check("b_ct", b_ct, (K, N), torch.int16)
    _check("key_a", key_a, (2,), torch.int32)
    _check("key_b", key_b, (2,), torch.int32)
    checked = [a_ct, b_ct, key_a, key_b]
    if verify:
        _check("tags_a", tags_a, (M, K // TILE), torch.int32)
        _check("tags_b", tags_b, (K, N // TILE), torch.int32)
        _check("mkeys", mkeys, (CHUNK_WORDS,), torch.int32)
        checked += [tags_a, tags_b, mkeys]
    if any(t.device != a_ct.device for t in checked):
        raise ValueError("sealed_matmul operands must share one device")
    if a_ct.device.type == "cpu":
        return sealed_matmul_ref(a_ct, b_ct, tags_a, tags_b, key_a, key_b,
                                 mkeys, verify)
    if a_ct.device.type != "cuda":
        raise ValueError(f"sealed_matmul runs on cpu or cuda, not "
                         f"{a_ct.device}")
    dev = a_ct.device
    c = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    bad = torch.empty((M // TILE, N // TILE), dtype=torch.int32, device=dev)
    counts = torch.empty((M // TILE + N // TILE,), dtype=torch.int32,
                         device=dev)

    def aligned(t):
        t = t.contiguous()
        return t.clone() if t.data_ptr() % 16 else t

    a_ct, b_ct = aligned(a_ct), aligned(b_ct)
    key_a, key_b = key_a.contiguous(), key_b.contiguous()
    ptrs = [None, None, None]
    if verify:
        ptrs = [tags_a.contiguous(), tags_b.contiguous(), aligned(mkeys)]
    cm, cn = cluster_shape(M, N)
    with torch.cuda.device(dev):
        err = _launcher()(
            a_ct.data_ptr(), b_ct.data_ptr(),
            *[t.data_ptr() if t is not None else None for t in ptrs[:2]],
            key_a.data_ptr(), key_b.data_ptr(),
            ptrs[2].data_ptr() if verify else None, c.data_ptr(),
            bad.data_ptr(), counts.data_ptr(), M, K, N, cm, cn, int(verify),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sealed_matmul kernel launch failed: "
                           f"cudaError {err}")
    sealed_matmul.launches += 1
    return c, bad


sealed_matmul.launches = 0


def seal_operand(x: torch.Tensor, master_key: torch.Tensor, nonce,
                 chunk_words: int, mac_nonce=None,
                 domain: int = mac.MAC_DOMAIN):
    """Seal a bf16 matrix for the kernel: (ct int16, tags int32).

    mac_nonce: the launch's MAC-key nonce (both operands of one sealed
    matmul share it; defaults to ``nonce``)."""
    mac_nonce = nonce if mac_nonce is None else mac_nonce
    ct = cipher.seal_bits(x, master_key, nonce)
    tags = mac.block_tags(ct, mac.nonce_mac_key(master_key, mac_nonce,
                                                domain), chunk_words, domain)
    return ct, tags


def matmul(a_ct, b_ct, tags_a, tags_b, master_key, nonce_a, nonce_b, *,
           bm: int = TILE, bk: int = TILE, bn: int = TILE,
           verify: bool = True, domain: int = mac.MAC_DOMAIN):
    """C = unseal(a_ct) @ unseal(b_ct) with per-chunk MAC verification.

    The MAC key of both operands is bound to ``nonce_a``.  The kernel's
    data format is 256 x 256 tiles: ``bm``, ``bk`` and ``bn`` are checked,
    not chosen.  Returns (C bf16 [M, N], number of bad chunk checks, int32
    scalar: the sum of the kernel's ``bad`` grid)."""
    M, K = a_ct.shape
    N = b_ct.shape[1]
    cw = bk // 2
    assert K % bk == 0 and M % bm == 0 and N % bn == 0
    assert bn // 2 == cw, "kernel shares one MAC key vector: need bn == bk"
    if (bm, bk, bn) != (TILE, TILE, TILE):
        raise ValueError(f"the kernel takes {TILE}-tiles, not "
                         f"{bm}x{bk}x{bn}")
    key_a = cipher.derive_tensor_key(master_key, nonce_a)
    key_b = cipher.derive_tensor_key(master_key, nonce_b)
    mkeys = mac.mac_keys(mac.nonce_mac_key(master_key, nonce_a, domain), cw,
                         domain)
    c, bad = sealed_matmul(a_ct, b_ct, tags_a, tags_b, key_a, key_b, mkeys,
                           verify=verify)
    return c, bad.sum().to(torch.int32)
