"""Shared primitives: Threefry-2x32 rounds and Mersenne-31 modular ops.

Plain torch functions on int64 tensors that hold uint32 values in
[0, 2**32): every add, multiply and left shift is masked back to 32 bits, so
each function computes exactly the uint32 arithmetic of
``src/repro/kernels/common.py``.  The CUDA kernels use the same functions as
``__device__`` inlines in ``csrc/common.cuh``.

Storage convention of the port: torch's CPU ``uint32`` has no add or shift,
so unsigned words are kept in ``torch.int32`` (and 16-bit halves in
``torch.int16``) with the same bits.  ``u32`` widens such bits to int64
values and ``i32`` narrows them back.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
M16 = 0xFFFF
ROTS_A = (13, 15, 26, 6)
ROTS_B = (17, 29, 16, 24)
PARITY = 0x1BD11BDA

P31 = 0x7FFFFFFF
_M15 = 0x7FFF
POS_MIX = 0x9E3779B1   # chunk-position multiplier of the tree MAC


def u32(x) -> torch.Tensor:
    """uint32 bits (int32 / int64 tensor, or a Python int) -> int64 value."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(int(x), dtype=torch.int64)
    if x.dtype == torch.int16:
        return x.to(torch.int64) & M16
    return x.to(torch.int64) & M32


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 uint32 value -> int32 tensor with the same 32 bits."""
    return (((x & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def i16(x: torch.Tensor) -> torch.Tensor:
    """int64 uint16 value -> int16 tensor with the same 16 bits."""
    return (((x & M16) ^ 0x8000) - 0x8000).to(torch.int16)


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 uint32 values (broadcasting)."""
    k2 = k0 ^ k1 ^ PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for block in range(5):
        for r in (ROTS_A if block % 2 == 0 else ROTS_B):
            x0 = (x0 + x1) & M32
            x1 = rotl(x1, r)
            x1 = x0 ^ x1
        x0 = (x0 + ks[(block + 1) % 3]) & M32
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & M32
    return x0, x1


# --- Mersenne-31 ops (see core.mac) ---------------------------------------

def fold32(x: torch.Tensor) -> torch.Tensor:
    return (x >> 31) + (x & P31)


def addmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fold32((fold32(fold32(a)) + fold32(fold32(b))) & M32)


def mulmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^31-1 with the 16-bit limb steps of the reference."""
    a = fold32(a)
    b = fold32(b)
    a0, a1 = a & M16, a >> 16
    b0, b1 = b & M16, b >> 16
    hi = (a1 * b1) & M32
    mid = (fold32((a1 * b0) & M32) + fold32((a0 * b1) & M32)) & M32
    lo = (a0 * b0) & M32
    mid_f = fold32(mid)
    mid_red = ((mid_f >> 15) + ((mid_f & _M15) << 16)) & M32
    hi_red = fold32((fold32(hi) * 2) & M32)
    out = fold32((hi_red + mid_red) & M32)
    return fold32((out + fold32(lo)) & M32)


def canon(x: torch.Tensor) -> torch.Tensor:
    x = fold32(fold32(x))
    return torch.where(x == P31, torch.zeros_like(x), x)


def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x, c < 2^32 without int64 overflow."""
    lo = x * (c & M16)
    hi = ((x * (c >> 16)) & M16) << 16
    return (lo + hi) & M32
