"""Wrapper of the tree MAC kernel: checks, dispatch by device, launch count.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
``csrc/tree_mac.cu`` on PyTorch's current stream, or raises.  The kernel
indexes an item's words in 32 bits, so an item of more than
``MAX_ITEM_WORDS`` words is launched as slabs of rows, each under the
limit, with the slab's first row passed as ``row0`` (the tags' positions).
A tensor on the meta device (the dry run, ``launch/dryrun.py``) gets an
empty result of the right shape, and ``mac_tags.meta_launches`` counts the
launches the card would make: nothing is computed or launched, and
``mac_tags.launches`` counts real launches only.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import build
from .ref import mac_tags_ref

MAX_ITEMS = 65535   # one item per blockIdx.y or .z
MAX_ITEM_WORDS = 2**31 - 4   # words a launch's item may hold (32-bit indices)


def _launcher():
    fn = build.library("tree_mac").mac_tags_launch
    if fn.argtypes is None:
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i64, i64, i64, i32, i32, ctypes.c_uint32,
                       vp]
        fn.restype = ctypes.c_int
    return fn


def slab_rows(n_rows: int, row_bytes: int) -> int:
    """Rows a launch may take of an item with rows of ``row_bytes``: all of
    them if they fit ``MAX_ITEM_WORDS`` words, else the most that fit,
    rounded down so that every slab starts 16 bytes past the previous."""
    words = -(-row_bytes // 4)
    if n_rows * words <= MAX_ITEM_WORDS:
        return n_rows
    align = 16 // math.gcd(row_bytes, 16)
    rows = MAX_ITEM_WORDS // words // align * align
    if rows < 1:
        raise ValueError(f"a row of {words} words is too wide for mac_tags")
    return rows


def _launch(x, keys, out, row0: int) -> None:
    """One kernel launch over x [N, R, E] into out: the kernel reads the
    flat buffer (rows of any width start anywhere in it) and the wide
    path's keys as aligned 16-byte vectors."""
    N, R, E = x.shape
    if x.data_ptr() % 16:
        x = x.clone()
    if keys.data_ptr() % 16:
        keys = keys.clone()
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), keys.data_ptr(), out.data_ptr(), N, R, E,
            x.element_size(), keys.shape[1], row0,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mac_tags kernel launch failed: cudaError {err}")
    mac_tags.launches += 1


def mac_tags(x: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Per-chunk tags of N word lattices at once.

    x: int16 or int32 [N, R, E] ciphertext bits; a row is
    W = ceil(E * size / 4) words, 16-bit rows zero-padded to a whole word.
    keys: int32 [N, cw] canonical per-item MAC keys, with W % cw == 0.
    Returns int32 [N, R, W // cw] canonical tags.  An item of more than
    ``MAX_ITEM_WORDS`` words takes one launch per slab of ``slab_rows``
    rows (and per item); the tags are the same.
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
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"mac_tags runs on cpu or cuda, not {x.device}")
    if N > MAX_ITEMS:
        raise ValueError(f"mac_tags takes at most {MAX_ITEMS} items, got {N}")
    out = torch.empty((N, R, words // cw), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    rows = slab_rows(R, E * x.element_size())
    if x.device.type == "meta":
        mac_tags.meta_launches += 1 if rows == R else N * -(-R // rows)
        return out
    x = x.contiguous()
    keys = keys.contiguous()
    if rows == R:
        _launch(x, keys, out, 0)
    else:
        for n in range(N):
            for r0 in range(0, R, rows):
                r1 = min(R, r0 + rows)
                _launch(x[n:n + 1, r0:r1], keys[n:n + 1],
                        out[n:n + 1, r0:r1], r0)
    return out


mac_tags.launches = 0
mac_tags.meta_launches = 0
