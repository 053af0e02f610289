"""Gradient compression for the cross-pod hop (torch port of
``repro.parallel.compress``).

Block-scaled int8 quantization: round half to even with a per-block f32
scale (block = 256 consecutive elements of the flattened tensor).  Composes
with sealing: the int8 payload and the scales are what gets encrypted and
shipped across the pod boundary — 4x fewer sealed bytes and 4x fewer bytes
on the link (the paper's §3.4: crypto cost rides on bytes moved).  Bit for
bit the reference's values and scales.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """x's elements as f32 [n_blocks, BLOCK], the last block zero-padded."""
    xf = x.reshape(-1).float()
    return F.pad(xf, (0, (-xf.numel()) % BLOCK)).reshape(-1, BLOCK)


def quantize_int8(x: torch.Tensor):
    """x: float tensor -> (q int8 of x's shape, scale f32 [n_blocks])."""
    xb = _blocks(x)
    scale = torch.clamp(xb.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(-1)[:x.numel()].reshape(x.shape), scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    x = (_blocks(q) * scale[:, None]).reshape(-1)[:q.numel()]
    return x.reshape(q.shape).to(dtype)
