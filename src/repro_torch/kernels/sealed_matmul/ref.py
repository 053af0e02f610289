"""Plain torch version of the sealed matmul: what the Pallas kernel
computes, on the kernel's arguments (tensor keys and multilinear MAC keys).

C is the f32 product of the two unsealed bf16 operands, rounded to bf16
once.  ``bad`` is the Pallas kernel's grid, int32 [M/256, N/256]: output
tile (i, j) counts every mismatched MAC chunk of A's rows 256i..256i+255
and of B's chunk column j, because the Pallas grid step (i, j, k) checks
the A and B tiles it fetches.  So a bad A chunk counts once for each
column tile and a bad B chunk once for each row tile; the JAX oracle
(``repro.kernels.sealed_matmul.ref``) counts each chunk once, and the two
agree only at 256^3.  This is the CPU path of the kernel wrapper and the
yardstick the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch

from ..ctr_cipher.ref import ctr_xor_ref
from ..tree_mac.ref import mac_tags_ref

TILE = 256                 # bf16 per tile side and per MAC chunk
CHUNK_WORDS = TILE // 2

# The limit C is held to against this plain version.  Both sum the K exact
# bf16 products in f32, in other orders, and round to bf16 once: the two
# roundings differ by at most one step, so two bf16 ulps of the value
# (rtol 2^-6) cover them.  Near zero that relative limit vanishes while
# the f32 sums still differ.  Each of the K additions rounds by at most
# 2^-24 of its partial sum, which for products of random sign grows like
# sqrt(K) times their spread; the K rounding errors, of random sign too,
# add up like sqrt(K) of them.  So the two sums differ by about K 2^-24
# times the products' spread, and ``c_atol`` = K 2^-24 max|A| max|B|,
# many times that spread, bounds the difference with room to spare.
C_RTOL = 2.0 ** -6


def c_atol(K: int, a_max: float, b_max: float) -> float:
    return K * 2.0 ** -24 * a_max * b_max


def c_excess(out: torch.Tensor, want: torch.Tensor, atol: float) -> float:
    """Largest |out - want| - (atol + C_RTOL |want|): <= 0 exactly when
    ``out`` is within the limit everywhere (inf for a non-finite output)."""
    o, w = out.float(), want.float()
    if not bool(torch.isfinite(o).all()):
        return float("inf")
    return ((o - w).abs() - (atol + C_RTOL * w.abs())).max().item()


def unseal_operand(ct: torch.Tensor, tkey: torch.Tensor) -> torch.Tensor:
    """int16 [R, C] bf16 ciphertext bits, int32 [2] tensor key -> bf16."""
    return ctr_xor_ref(ct[None], tkey.reshape(1, 2))[0].view(torch.bfloat16)


def chunk_mismatches(ct: torch.Tensor, tags: torch.Tensor,
                     mkeys: torch.Tensor) -> torch.Tensor:
    """bool [R, C/256]: the 128-word chunks whose tag does not verify."""
    got = mac_tags_ref(ct[None], mkeys.reshape(1, -1), CHUNK_WORDS)[0]
    return got != tags


def bad_grid(flag_a: torch.Tensor, flag_b: torch.Tensor) -> torch.Tensor:
    """bad[i, j] = sum of flag_a over A's rows 256i..256i+255 plus the sum
    of flag_b over B's chunk column j."""
    per_a = flag_a.reshape(flag_a.shape[0] // TILE, -1).sum(dim=1)
    per_b = flag_b.sum(dim=0)
    return (per_a[:, None] + per_b[None, :]).to(torch.int32)


def sealed_matmul_ref(a_ct, b_ct, tags_a, tags_b, key_a, key_b, mkeys,
                      verify: bool = True):
    """a_ct int16 [M, K], b_ct int16 [K, N]; tags int32 [M, K/256] and
    [K, N/256]; key_a/key_b int32 [2] tensor keys; mkeys int32 [128].
    Returns (C bf16 [M, N], bad int32 [M/256, N/256])."""
    a = unseal_operand(a_ct, key_a).float()
    b = unseal_operand(b_ct, key_b).float()
    c = (a @ b).to(torch.bfloat16)
    M, N = a_ct.shape[0], b_ct.shape[1]
    if not verify:
        return c, torch.zeros((M // TILE, N // TILE), dtype=torch.int32,
                              device=c.device)
    return c, bad_grid(chunk_mismatches(a_ct, tags_a, mkeys),
                       chunk_mismatches(b_ct, tags_b, mkeys))
