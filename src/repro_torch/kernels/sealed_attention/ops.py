"""Sealed decode attention: the kernel wrapper and the sealing helpers.

``sealed_decode_attention`` is the wrapper of ``csrc/sealed_attention.cu``:
a CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel on PyTorch's current stream, or raises.  ``seal_cache`` and
``decode_attention`` mirror ``repro.kernels.sealed_attention.ops``: they
derive the tensor keys and the MAC key from a master key and nonces.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...core import cipher, mac
from .. import build
from .ref import sealed_decode_attention_words_ref

MAX_GROUP = 16      # query heads per KV head (shared memory per block)
KERNEL_HEAD_DIMS = (32, 64, 128)   # head_dim the CUDA kernel takes
# csrc/sealed_attention.cu: warps per block, rows of K and V per lane
WARPS, ROWS_PER_LANE = 4, 4


def _launcher():
    fn = build.library("sealed_attention").sealed_attention_launch
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 12 + [i32] * 8 + [ctypes.c_float, i32, vp]
        fn.restype = ctypes.c_int
    return fn


def chunk_rows(hd: int) -> int:
    """Cache rows of one warp's group in the kernel (its tile of T): lane l
    holds Threefry block l % (hd/4) of rows l // (hd/4) + (128/hd) e, e < 4."""
    return ROWS_PER_LANE * 32 // (hd // 4)


def split_plan(B: int, K: int, t_valid: int, hd: int, slots: int):
    """(n_split, chunk): the kernel's grid cuts T into n_split blocks of
    ``chunk`` rows (whole groups) per (b, k).  B K n_split stays within
    ``slots`` (the blocks the card holds at once) where it can, so the grid
    is at most one wave, and no split has fewer groups than the block has
    warps."""
    rows = chunk_rows(hd)
    groups = max(1, -(-t_valid // rows))
    per_pair = max(1, min(-(-groups // WARPS), slots // (B * K)))
    chunk = -(-groups // per_pair) * rows
    return max(1, -(-t_valid // chunk)), chunk


_sync: dict = {}     # (device, stream) -> counters its launches leave zero


def _counters(device, stream: int, pairs: int,
              capturing: bool) -> torch.Tensor:
    """The kernel's int32 counters, two per (b, k) pair (its blocks' ticket
    and bad count), zero at the launch; every launch leaves them zero.

    Outside a CUDA-graph capture, the launches on one stream (its
    ``cuda_stream`` handle) take turns on one buffer, so they need no
    memset; launches on two streams hold two buffers.  A launch captured
    into a graph gets counters of its own from the graph's pool, zeroed at
    every replay, so a replay on any stream never shares counters with a
    launch outside the graph."""
    if capturing:
        return torch.zeros(2 * pairs, dtype=torch.int32, device=device)
    buf = _sync.get((device, stream))
    if buf is None or buf.numel() < 2 * pairs:
        buf = _sync[(device, stream)] = torch.zeros(
            2 * pairs, dtype=torch.int32, device=device)
    return buf


@functools.lru_cache(maxsize=None)
def _slots(device, hd: int, G: int) -> int:
    """Blocks of the kernel the card holds at once at (hd, G)."""
    lib = build.library("sealed_attention")
    fn = lib.sealed_attention_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    per_sm = fn(hd, G)
    if per_sm <= 0:
        raise RuntimeError(f"sealed_attention kernel does not fit hd {hd}, "
                           f"G {G} on an SM")
    return per_sm * torch.cuda.get_device_properties(device) \
        .multi_processor_count


def sealed_decode_attention(q, k_ct, v_ct, k_tags, v_tags, key_k, key_v,
                            mkeys, t_valid: int, *, verify: bool = True):
    """Flash-decode over a sealed cache.

    On a CUDA tensor one launch on PyTorch's current stream computes the
    output and ``bad``: the last of its blocks for each (b, k) writes them,
    counted in counters that no concurrent launch shares (see
    ``_counters``).

    q bf16 [B, K, G, hd]; k_ct/v_ct int16 [B, T, K, hd] (bf16 ciphertext
    bits); k_tags/v_tags int32 [B, T, K, 1] (None when ``verify`` is off);
    key_k/key_v int32 [2] tensor keys; mkeys int32 [hd / 2] canonical MAC
    keys (None when ``verify`` is off); t_valid: valid cache rows.
    Returns (out bf16 [B, K, G, hd], bad int32 [B, K]).
    """
    if q.dim() != 4 or q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bf16 [B, K, G, hd], got {q.dtype} "
                         f"{tuple(q.shape)}")
    B, K, G, hd = q.shape
    for name, ct in (("k_ct", k_ct), ("v_ct", v_ct)):
        if (ct.dim() != 4 or ct.dtype != torch.int16 or ct.shape[0] != B
                or tuple(ct.shape[2:]) != (K, hd)):
            raise ValueError(f"{name} must be int16 [{B}, T, {K}, {hd}], got "
                             f"{ct.dtype} {tuple(ct.shape)}")
    T = k_ct.shape[1]
    if v_ct.shape[1] != T:
        raise ValueError("k_ct and v_ct differ in length")
    nb = hd // 4
    if hd % 4 or nb > 32 or nb & (nb - 1):
        raise ValueError(f"head_dim {hd}: the kernel takes hd = 4 * 2^j <= 128")
    if G > MAX_GROUP:
        raise ValueError(f"{G} query heads per KV head > {MAX_GROUP}")
    checked = [q, k_ct, v_ct, key_k, key_v]
    if verify:
        for name, t in (("k_tags", k_tags), ("v_tags", v_tags)):
            if t is None or tuple(t.shape) != (B, T, K, 1) or t.dtype != torch.int32:
                raise ValueError(f"{name} must be int32 [{B}, {T}, {K}, 1]")
        if mkeys is None or tuple(mkeys.shape) != (hd // 2,) \
                or mkeys.dtype != torch.int32:
            raise ValueError(f"mkeys must be int32 [{hd // 2}]")
        checked += [k_tags, v_tags, mkeys]
    for key in (key_k, key_v):
        if tuple(key.shape) != (2,) or key.dtype != torch.int32:
            raise ValueError("tensor keys must be int32 [2]")
    if any(t.device != q.device for t in checked):
        raise ValueError("sealed_decode_attention operands must share one "
                         "device")
    t_valid = max(0, min(int(t_valid), T))
    if q.device.type == "cpu":
        return sealed_decode_attention_words_ref(
            q, k_ct, v_ct, k_tags, v_tags, key_k, key_v, mkeys, t_valid,
            verify)
    if q.device.type != "cuda":
        raise ValueError(f"sealed_decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the CUDA kernel takes "
                         f"{KERNEL_HEAD_DIMS}")
    n_split, chunk = split_plan(B, K, t_valid, hd, _slots(q.device, hd, G))
    out = torch.empty((B, K, G, hd), dtype=torch.bfloat16, device=q.device)
    bad = torch.empty((B, K), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sync = _counters(q.device, stream, B * K,
                     torch.cuda.is_current_stream_capturing())
    part = torch.empty((B * K * n_split * G * (hd + 2),), dtype=torch.float32,
                       device=q.device)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    q, k_ct, v_ct = q.contiguous(), k_ct.contiguous(), v_ct.contiguous()
    if k_ct.data_ptr() % 8 or v_ct.data_ptr() % 8:
        k_ct, v_ct = k_ct.clone(), v_ct.clone()
    key_k, key_v = key_k.contiguous(), key_v.contiguous()
    if verify:
        k_tags, v_tags = k_tags.contiguous(), v_tags.contiguous()
        mkeys = mkeys.contiguous()
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k_ct.data_ptr(), v_ct.data_ptr(),
            ptr(k_tags) if verify else None, ptr(v_tags) if verify else None,
            key_k.data_ptr(), key_v.data_ptr(),
            ptr(mkeys) if verify else None, out.data_ptr(), bad.data_ptr(),
            part.data_ptr(), sync.data_ptr(), B, T, K, G, hd, t_valid, chunk,
            n_split, float(hd) ** -0.5, int(verify), stream)
    if err:
        raise RuntimeError(f"sealed_decode_attention kernel launch failed: "
                           f"cudaError {err}")
    sealed_decode_attention.launches += 1
    return out, bad


sealed_decode_attention.launches = 0


def seal_cache(k, v, master_key, nonce_k, nonce_v, mac_nonce=None):
    """Seal a [B, T, K, hd] bf16 KV pair -> (k_ct, v_ct, k_tags, v_tags)."""
    mac_nonce = nonce_k if mac_nonce is None else mac_nonce
    hd = k.shape[-1]
    k_ct = cipher.seal_bits(k, master_key, nonce_k)
    v_ct = cipher.seal_bits(v, master_key, nonce_v)
    mk = mac.nonce_mac_key(master_key, mac_nonce)
    k_tags = mac.block_tags(k_ct, mk, hd // 2)   # [B, T, K, 1]
    v_tags = mac.block_tags(v_ct, mk, hd // 2)
    return k_ct, v_ct, k_tags, v_tags


def decode_attention(q, k_ct, v_ct, k_tags, v_tags, master_key, nonce_k,
                     nonce_v, t_valid, *, mac_nonce=None, verify: bool = True):
    """Flash-decode over a sealed cache sealed by ``seal_cache``."""
    mac_nonce = nonce_k if mac_nonce is None else mac_nonce
    hd = q.shape[-1]
    key_k = cipher.derive_tensor_key(master_key, nonce_k)
    key_v = cipher.derive_tensor_key(master_key, nonce_v)
    mkeys = mac.mac_keys(mac.nonce_mac_key(master_key, mac_nonce), hd // 2)
    return sealed_decode_attention(q, k_ct, v_ct, k_tags, v_tags, key_k,
                                   key_v, mkeys, t_valid, verify=verify)
