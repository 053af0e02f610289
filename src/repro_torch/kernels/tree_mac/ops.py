"""Wrapper of the tree MAC kernel: checks, dispatch by device, launch count.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
``csrc/tree_mac.cu`` on PyTorch's current stream, or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import mac_tags_ref

MAX_ITEMS = 65535   # one item per blockIdx.y


def _launcher():
    fn = build.library("tree_mac").mac_tags_launch
    if fn.argtypes is None:
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i64, i64, i64, i32, i32, vp]
        fn.restype = ctypes.c_int
    return fn


def mac_tags(x: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Per-chunk tags of N word lattices at once.

    x: int16 or int32 [N, R, E] ciphertext bits; a row is
    W = ceil(E * size / 4) words, 16-bit rows zero-padded to a whole word.
    keys: int32 [N, cw] canonical per-item MAC keys, with W % cw == 0.
    Returns int32 [N, R, W // cw] canonical tags.
    """
    if x.dim() != 3 or x.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"mac_tags takes int16/int32 [N, R, E], got "
                         f"{x.dtype} {tuple(x.shape)}")
    N, R, E = x.shape
    if keys.dim() != 2 or keys.shape[0] != N or keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32 [{N}, cw], got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    cw = keys.shape[1]
    words = -(-E * x.element_size() // 4)
    if cw < 1 or words % cw:
        raise ValueError(f"chunk of {cw} words must divide the row's "
                         f"{words} words")
    if keys.device != x.device:
        raise ValueError("mac_tags operands must share one device")
    if x.device.type == "cpu":
        return mac_tags_ref(x, keys, cw)
    if x.device.type != "cuda":
        raise ValueError(f"mac_tags runs on cpu or cuda, not {x.device}")
    if N > MAX_ITEMS:
        raise ValueError(f"mac_tags takes at most {MAX_ITEMS} items, got {N}")
    out = torch.empty((N, R, words // cw), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    x = x.contiguous()
    if x.data_ptr() % 8:
        x = x.clone()
    keys = keys.contiguous()
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), keys.data_ptr(), out.data_ptr(), N, R, E,
            x.element_size(), cw, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mac_tags kernel launch failed: cudaError {err}")
    mac_tags.launches += 1
    return out


mac_tags.launches = 0
