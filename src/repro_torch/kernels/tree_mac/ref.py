"""Plain torch version of the tree MAC kernel (bit-exact, int64 arithmetic).

The reference reduces each chunk with 16-bit-limb mulmods and a tree of
addmods; every step there is exact mod p = 2^31 - 1, so this version sums
the exact products (each < 2^62, reduced before the sum) in int64 and takes
one residue: the canonical tags are the same.
"""
from __future__ import annotations

import torch

from .. import common


def words_view(x: torch.Tensor) -> torch.Tensor:
    """int16/int32 [..., E] -> int64 uint32 words [..., ceil(E*size/4)],
    16-bit rows zero-padded to a whole word (low half first)."""
    if x.dtype == torch.int32:
        return common.u32(x)
    if x.shape[-1] % 2:
        x = torch.nn.functional.pad(x, (0, 1))
    h = common.u32(x).reshape(*x.shape[:-1], -1, 2)
    return h[..., 0] | (h[..., 1] << 16)


def mac_tags_ref(x: torch.Tensor, keys: torch.Tensor, cw: int) -> torch.Tensor:
    """x int16/int32 [N, R, E]; keys int32 [N, cw] canonical.  Returns the
    int32 tags [N, R, W / cw] (W = words per row)."""
    N, R, _ = x.shape
    w = words_view(x)
    nc = w.shape[-1] // cw
    k = common.u32(keys)
    v = common.fold32(common.fold32(w) + 1)
    prod = (v.reshape(N, R, nc, cw) * k[:, None, None, :]) % common.P31
    s = prod.sum(dim=-1) % common.P31
    idx = torch.arange(R * nc, dtype=torch.int64,
                       device=x.device).reshape(R, nc)
    pos = common.canon(common.mul_u32(idx, common.POS_MIX))
    tag = (s + ((pos + 1) * k[:, 0, None, None]) % common.P31) % common.P31
    return common.i32(tag)
