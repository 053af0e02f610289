"""Counter-mode cipher for sealing tensors: Threefry-2x32 CTR (torch port).

Same functions and bits as ``repro.core.cipher``:

  * keystream block i  =  threefry2x32(key, (nonce, i))          (2 words / block)
  * seal / unseal      =  XOR with keystream                      (size-preserving)
  * shaped sealing     =  per-(tensor, nonce) key, counter (row, block) where
                          row is the flattened leading index of the tensor

Every keystream XOR of a tensor goes through the CTR kernel wrapper
(``kernels/ctr_cipher/ops.py``): the CUDA kernel for tensors on the card,
its plain torch version for tensors on the CPU.  The flat lattice
(``keystream_words``/``xor_words``, x0 = nonce, x1 = block) is the shaped
lattice of a single row whose row id is the nonce, so one kernel serves
both.

Conventions of the port:

  * uint32 and uint16 data live in ``torch.int32`` / ``torch.int16`` with
    the same bits (torch's CPU ``uint32`` has no add or shift); keys are
    int32 [2].
  * Batching takes the place of ``jax.vmap``: a key of shape [N, 2] (with a
    nonce that is an int or an [N] tensor) seals N tensors stacked on the
    leading axis of ``x`` in one kernel launch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import common
from ..kernels.ctr_cipher import ops as ctr_ops
from ..obs.trace import TRACER

DERIVE_KEY_TWEAK = 0x5EA1ED
TENSOR_KEY_TWEAK = 0x7E4503


def u32_of(x, device) -> torch.Tensor:
    """A uint32 value (int, numpy scalar or int32/int64 tensor) as int64."""
    if isinstance(x, torch.Tensor):
        return common.u32(x.to(device))
    return torch.tensor(int(x) & common.M32, dtype=torch.int64, device=device)


def threefry2x32(key: torch.Tensor, x0, x1):
    """Threefry-2x32 block function.

    key: int32 [..., 2] (k0, k1), broadcasting against the counter words
    x0, x1 (ints or int32 tensors).  Returns (y0, y1) int32 tensors.
    """
    k = common.u32(key)
    y0, y1 = common.threefry2x32(k[..., 0], k[..., 1], u32_of(x0, key.device),
                                 u32_of(x1, key.device))
    return common.i32(y0), common.i32(y1)


def keystream_blocks(key: torch.Tensor, nonce, block_ids: torch.Tensor):
    """int32 [n, 2]: the two keystream words of each counter block."""
    y0, y1 = threefry2x32(key, nonce, block_ids)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def _items(key: torch.Tensor, nonce):
    """(keys [N, 2], nonces int64 [N], batched?) from a [2] or [N, 2] key."""
    batched = key.dim() == 2
    keys = key.reshape(-1, 2)
    nonces = u32_of(nonce, key.device).reshape(-1).expand(keys.shape[0])
    return keys, nonces, batched


def keystream_words(key: torch.Tensor, nonce, n_words: int,
                    word_offset: int = 0) -> torch.Tensor:
    """Flat int32 keystream of ``n_words`` words starting at ``word_offset``
    (words of threefry2x32(key, (nonce, block))).  A [N, 2] key gives
    [N, n_words]."""
    keys, nonces, batched = _items(key, nonce)
    zeros = torch.zeros((keys.shape[0], 1, word_offset + n_words),
                        dtype=torch.int32, device=key.device)
    ks = ctr_ops.ctr_xor(zeros, keys.contiguous(),
                         common.i32(nonces)[:, None].contiguous())
    ks = ks[:, 0, word_offset:]
    return ks if batched else ks[0]


# ---------------------------------------------------------------------------
# dtype <-> uint32 word packing
# ---------------------------------------------------------------------------

def words_for(shape, dtype) -> int:
    """Number of uint32 words a tensor packs into (padded)."""
    n_bytes = math.prod(shape) * dtype.itemsize if len(shape) else dtype.itemsize
    return (n_bytes + 3) // 4


def pack_words(x: torch.Tensor) -> torch.Tensor:
    """Bitcast any-dtype tensor to a flat int32 word array (zero-padded)."""
    flat = x.reshape(-1)
    isz = x.dtype.itemsize
    if isz < 4:
        pad = (-flat.shape[0]) % (4 // isz)
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.contiguous().view(torch.int32)


def unpack_words(w: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Inverse of pack_words."""
    n_elems = math.prod(shape) if len(shape) else 1
    return w.contiguous().view(dtype)[:n_elems].reshape(shape)


# ---------------------------------------------------------------------------
# seal / unseal (XOR with keystream) — Rule 1 & Rule 2 of the paper
# ---------------------------------------------------------------------------

def xor_words(words: torch.Tensor, key: torch.Tensor, nonce) -> torch.Tensor:
    """XOR a flat int32 word array ([n], or [N, n] with a [N, 2] key) with
    the (key, nonce) keystream.  Involutive."""
    keys, nonces, batched = _items(key, nonce)
    x = words.reshape(keys.shape[0], 1, -1)
    out = ctr_ops.ctr_xor(x, keys.contiguous(),
                          common.i32(nonces)[:, None].contiguous())
    return out.reshape(words.shape)


def encrypt(x: torch.Tensor, key: torch.Tensor, nonce) -> torch.Tensor:
    """Counter-mode encrypt a tensor -> flat int32 ciphertext words."""
    return xor_words(pack_words(x), key, nonce)


def decrypt(ct_words: torch.Tensor, key: torch.Tensor, nonce, shape,
            dtype) -> torch.Tensor:
    """Counter-mode decrypt flat int32 ciphertext words -> tensor."""
    return unpack_words(xor_words(ct_words, key, nonce), shape, dtype)


def derive_key(master: torch.Tensor, domain: int) -> torch.Tensor:
    """Derive an int32 [..., 2] subkey from a master key for a domain."""
    with TRACER.span("seal.derive", cat="seal"):
        y0, y1 = threefry2x32(master, domain, DERIVE_KEY_TWEAK)
        return torch.stack([y0, y1], dim=-1)


def derive_tensor_key(master: torch.Tensor, nonce) -> torch.Tensor:
    """Per-(tensor, version) key: counter space is then (row, word) within it."""
    with TRACER.span("seal.derive", cat="seal"):
        y0, y1 = threefry2x32(master, nonce, TENSOR_KEY_TWEAK)
        y0, y1 = torch.broadcast_tensors(y0, y1)
        return torch.stack([y0, y1], dim=-1)


# ---------------------------------------------------------------------------
# SHAPED sealing — ciphertext keeps the tensor shape.
#
# Counter block for element [i0,...,ik, e] (last axis e):
#     row   = flattened leading index (i0..ik)
#     block = (e // elems_per_word) // 2
# ---------------------------------------------------------------------------

_UINT_FOR_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def uint_dtype_for(dtype):
    """Storage dtype of a tensor's ciphertext bits (same width)."""
    return _UINT_FOR_SIZE[dtype.itemsize]


def _ctr(raw: torch.Tensor, key: torch.Tensor, nonce, rows=None,
         col0: int = 0):
    """XOR unsigned bits ``raw`` ([*shape], or [N, *shape] with a [N, 2]
    key) with the shaped keystream; ``rows`` overrides the counter rows
    (shape ``raw.shape[:-1]``), ``col0`` is raw's first column in them."""
    if raw.element_size() == 1:
        # byte e of a row is byte e % 4 of the row's word e // 4 (the words
        # are little-endian): XOR the rows padded to whole words
        if col0 % 4:
            raise ValueError(f"a byte lattice's col0 must be a whole word, "
                             f"got {col0}")
        e = raw.shape[-1]
        wide = F.pad(raw, (0, (-e) % 4)).contiguous().view(torch.int32)
        return _ctr(wide, key, nonce, rows, col0 // 4).view(
            raw.dtype)[..., :e]
    keys, nonces, batched = _items(key, nonce)
    n = keys.shape[0]
    tkeys = derive_tensor_key(keys, nonces)
    e = raw.shape[-1]
    x3 = raw.reshape(n, -1, e)
    rows3 = (common.i32(u32_of(rows, raw.device)).reshape(n, -1).contiguous()
             if rows is not None else None)
    return ctr_ops.ctr_xor(x3, tkeys, rows3, col0).reshape(raw.shape)


def keystream_like(key: torch.Tensor, nonce, shape, dtype) -> torch.Tensor:
    """Keystream with the tensor's own shape, as the matching storage dtype."""
    shape = tuple(shape) if len(shape) else (1,)
    zeros = torch.zeros(shape, dtype=uint_dtype_for(dtype), device=key.device)
    return _ctr(zeros, key, nonce)


def keystream_for_rows(key: torch.Tensor, nonce, rows: torch.Tensor,
                       last: int, dtype) -> torch.Tensor:
    """Keystream for an arbitrary row-slice of a sealed tensor: shape
    ``rows.shape + (last,)``, rows are indices into the full tensor's
    leading-dim lattice."""
    zeros = torch.zeros(tuple(rows.shape) + (last,),
                        dtype=uint_dtype_for(dtype), device=key.device)
    return _ctr(zeros, key, nonce, rows)


def seal_bits_slice(x: torch.Tensor, key: torch.Tensor, nonce,
                    rows: torch.Tensor, col0: int = 0) -> torch.Tensor:
    """Seal a row-slice (x: rows.shape + (last,)) against full-tensor
    counters; ``col0``: x's first column in the full rows (a block of a
    tensor sharded on its last axis).  XOR, so it also unseals."""
    return _ctr(x.contiguous().view(uint_dtype_for(x.dtype)), key, nonce,
                rows, col0)


def seal_bits(x: torch.Tensor, key: torch.Tensor, nonce) -> torch.Tensor:
    """Shaped CTR encryption: same-shape ciphertext bits."""
    if x.dim() == 0:
        x = x.reshape(1)
    return _ctr(x.contiguous().view(uint_dtype_for(x.dtype)), key, nonce)


def unseal_bits(ct: torch.Tensor, key: torch.Tensor, nonce,
                dtype) -> torch.Tensor:
    """Inverse of seal_bits."""
    return _ctr(ct, key, nonce).view(dtype)
