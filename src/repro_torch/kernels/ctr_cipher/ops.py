"""Wrapper of the CTR kernel: checks, dispatch by device, launch count.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
``csrc/ctr_cipher.cu`` on PyTorch's current stream, or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import ctr_xor_ref

MAX_ITEMS = 65535   # one item per blockIdx.y


def _launcher():
    fn = build.library("ctr_cipher").ctr_xor_launch
    if fn.argtypes is None:
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [vp, vp, vp, vp, i64, i64, i64, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


def ctr_xor(x: torch.Tensor, tkeys: torch.Tensor,
            rows: torch.Tensor | None = None) -> torch.Tensor:
    """Seal/unseal N word lattices at once.

    x: int16 or int32 [N, R, E] (the bits of uint16/uint32 ciphertext or
    plaintext); tkeys: int32 [N, 2] per-item tensor keys; rows: optional
    int32 [N, R] counter-row ids (default: row r is r).  Returns a new
    tensor of x's shape and dtype.
    """
    if x.dim() != 3 or x.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"ctr_xor takes int16/int32 [N, R, E], got "
                         f"{x.dtype} {tuple(x.shape)}")
    N, R, E = x.shape
    if tuple(tkeys.shape) != (N, 2) or tkeys.dtype != torch.int32:
        raise ValueError(f"tkeys must be int32 [{N}, 2], got "
                         f"{tkeys.dtype} {tuple(tkeys.shape)}")
    if rows is not None and (tuple(rows.shape) != (N, R)
                             or rows.dtype != torch.int32):
        raise ValueError(f"rows must be int32 [{N}, {R}]")
    for t in (tkeys, rows):
        if t is not None and t.device != x.device:
            raise ValueError("ctr_xor operands must share one device")
    if x.device.type == "cpu":
        return ctr_xor_ref(x, tkeys, rows)
    if x.device.type != "cuda":
        raise ValueError(f"ctr_xor runs on cpu or cuda, not {x.device}")
    if N > MAX_ITEMS:
        raise ValueError(f"ctr_xor takes at most {MAX_ITEMS} items, got {N}")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    x = x.contiguous()
    if x.data_ptr() % 8:
        x = x.clone()
    tkeys = tkeys.contiguous()
    rows = rows.contiguous() if rows is not None else None
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), out.data_ptr(), tkeys.data_ptr(),
            rows.data_ptr() if rows is not None else None, N, R, E,
            x.element_size(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ctr_xor kernel launch failed: cudaError {err}")
    ctr_xor.launches += 1
    return out


ctr_xor.launches = 0
