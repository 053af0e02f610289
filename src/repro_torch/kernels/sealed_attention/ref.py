"""Plain torch versions of sealed decode attention: unseal the whole cache,
zero the rows past ``t_valid``, masked f32 softmax.

``sealed_decode_attention_ref`` mirrors ``repro.kernels.sealed_attention.
ref``: it takes the master key and nonces and unseals through
``core.cipher.unseal_bits`` and verifies through ``mac.verify_block_tags``.
``sealed_decode_attention_words_ref`` takes what the kernel takes (tensor
keys and multilinear MAC keys) and runs the plain CTR and MAC versions
directly: it is the CPU path of the kernel wrapper and the yardstick the
CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch

from ...core import cipher, mac
from ..ctr_cipher.ref import ctr_xor_ref
from ..tree_mac.ref import mac_tags_ref

_NEG = -1e30

# The limit the kernel is held to against these plain versions.  Both take
# the softmax in f32 (summed in another order: ~1e-6 relative) and round
# the output to bf16 once, so they differ by at most a rounding step: two
# bf16 ulps of the value (rtol 2^-6), plus an atol for outputs near zero.
OUT_RTOL = 2.0 ** -6
OUT_ATOL = 1e-5


def out_excess(out: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |out - want| - (OUT_ATOL + OUT_RTOL |want|): <= 0 exactly
    when ``out`` is within the limit of ``want`` everywhere."""
    o, w = out.float(), want.float()
    return ((o - w).abs() - (OUT_ATOL + OUT_RTOL * w.abs())).max().item()


def _attend(q, kd, vd, t_valid):
    """q bf16 [B, K, G, hd]; kd/vd bf16 [B, T, K, hd] -> bf16 [B, K, G, hd]."""
    hd = q.shape[-1]
    T = kd.shape[1]
    valid = torch.arange(T, device=q.device) < t_valid
    zero = torch.zeros((), dtype=kd.dtype, device=q.device)
    kd = torch.where(valid[None, :, None, None], kd, zero)
    vd = torch.where(valid[None, :, None, None], vd, zero)
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), kd.float()) * (hd ** -0.5)
    s = torch.where(valid[None, None, None, :], s,
                    torch.full((), _NEG, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, vd.float())
    return out.to(torch.bfloat16), valid


def _bad(okk, okv, valid):
    """Mismatching valid rows of K plus V per (b, k); ok* bool [B, T, K]."""
    msk = valid[None, :, None]
    return ((~okk & msk).sum(dim=1) + (~okv & msk).sum(dim=1)).to(torch.int32)


def sealed_decode_attention_ref(q, k_ct, v_ct, k_tags, v_tags, master_key,
                                nonce_k, nonce_v, mac_key, t_valid,
                                verify: bool = True):
    """q bf16 [B, K, G, hd]; caches int16 [B, T, K, hd]; tags int32
    [B, T, K, 1].  Returns (out bf16 [B, K, G, hd], bad int32 [B, K])."""
    B, K = q.shape[:2]
    hd = q.shape[-1]
    kd = cipher.unseal_bits(k_ct, master_key, nonce_k, torch.bfloat16)
    vd = cipher.unseal_bits(v_ct, master_key, nonce_v, torch.bfloat16)
    out, valid = _attend(q, kd, vd, t_valid)
    bad = torch.zeros((B, K), dtype=torch.int32, device=q.device)
    if verify:
        cw = hd // 2
        okk = mac.verify_block_tags(k_ct, mac_key, cw, k_tags)[..., 0]
        okv = mac.verify_block_tags(v_ct, mac_key, cw, v_tags)[..., 0]
        bad = _bad(okk, okv, valid)
    return out, bad


def sealed_decode_attention_words_ref(q, k_ct, v_ct, k_tags, v_tags, key_k,
                                      key_v, mkeys, t_valid,
                                      verify: bool = True):
    """The kernel's contract in plain torch: key_k/key_v int32 [2] tensor
    keys, mkeys int32 [hd / 2] canonical MAC keys; tags may be None when
    ``verify`` is off."""
    B, T, K, hd = k_ct.shape
    rows = B * T * K

    def unseal(ct, key):
        x = ctr_xor_ref(ct.reshape(1, rows, hd), key.reshape(1, 2))
        return x.reshape(B, T, K, hd).view(torch.bfloat16)

    out, valid = _attend(q, unseal(k_ct, key_k), unseal(v_ct, key_v), t_valid)
    bad = torch.zeros((B, K), dtype=torch.int32, device=q.device)
    if verify:
        def ok(ct, tags):
            got = mac_tags_ref(ct.reshape(1, rows, hd), mkeys.reshape(1, -1),
                               hd // 2)
            return got.reshape(B, T, K) == tags.reshape(B, T, K)
        bad = _bad(ok(k_ct, k_tags), ok(v_ct, v_tags), valid)
    return out, bad
