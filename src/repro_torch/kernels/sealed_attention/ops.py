"""Sealed decode attention: the kernel wrapper and the sealing helpers.

``sealed_decode_attention`` is the wrapper of ``csrc/sealed_attention.cu``:
a CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel on PyTorch's current stream, or raises.  ``seal_cache`` and
``decode_attention`` mirror ``repro.kernels.sealed_attention.ops``: they
derive the tensor keys and the MAC key from a master key and nonces.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...core import cipher, mac
from .. import build
from .ref import sealed_decode_attention_words_ref

MAX_GROUP = 16      # query heads per KV head (shared memory per block)


def _launcher():
    fn = build.library("sealed_attention").sealed_attention_launch
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 11 + [i32] * 8 + [ctypes.c_float, i32, vp]
        fn.restype = ctypes.c_int
    return fn


def chunk_rows(hd: int) -> int:
    """Cache rows per block of the kernel (its split of T)."""
    return min(256, 4096 // hd)


def sealed_decode_attention(q, k_ct, v_ct, k_tags, v_tags, key_k, key_v,
                            mkeys, t_valid: int, *, verify: bool = True):
    """Flash-decode over a sealed cache.

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
    chunk = chunk_rows(hd)
    n_split = max(1, math.ceil(t_valid / chunk))
    out = torch.empty((B, K, G, hd), dtype=torch.bfloat16, device=q.device)
    bad = torch.zeros((B, K), dtype=torch.int32, device=q.device)
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
            part.data_ptr(), B, T, K, G, hd, t_valid, chunk, n_split,
            float(hd) ** -0.5, int(verify),
            torch.cuda.current_stream().cuda_stream)
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
