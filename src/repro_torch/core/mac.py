"""Chunked multilinear Mersenne-31 MAC (torch port of ``repro.core.mac``).

  * per-word map:    m_i = (w_i + 1) * k_i  mod  p,   p = 2^31 - 1
  * chunk tag:       sum of m_i mod p, plus a position term (pos + 1) * k_0
  * cross-chunk tag: the chunk tags are themselves a word vector, hashed
                     again until one root tag remains

Every chunk-tag computation goes through the tree MAC kernel wrapper
(``kernels/tree_mac/ops.py``), and the multilinear keys come from the CTR
keystream (``cipher.keystream_words``).  Tags are canonical residues in
int32 storage.  As in ``core/cipher.py``, a key of shape [N, 2] MACs N
tensors stacked on the leading axis in one launch.
"""
from __future__ import annotations

import math

import torch

from ..kernels import common
from ..kernels.tree_mac import ops as mac_ops
from . import cipher

MAC_DOMAIN = 0xA11CE


def mac_keys(key: torch.Tensor, n_words: int,
             domain: int = MAC_DOMAIN) -> torch.Tensor:
    """int32 [n_words] (or [N, n_words]) multilinear keys in [0, p)."""
    sub = cipher.derive_key(key, domain)
    ks = cipher.keystream_words(sub, 0, n_words)
    return common.i32(common.canon(common.u32(ks)))


def chunk_tags(words: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Per-chunk tags of words int32 [m, s] with keys [s] (or [N, m, s] with
    [N, s]).  The chunk index is mixed in as an affine term."""
    s = words.shape[-1]
    n = keys.reshape(-1, s).shape[0]
    tags = mac_ops.mac_tags(words.reshape(n, -1, s).contiguous(),
                            keys.reshape(n, s).contiguous())
    return tags.reshape(words.shape[:-1])


def combine_tags(tags: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Fold per-chunk tags ([m] or [N, m]) into one root tag each, in
    groups of len(keys), until a single word remains."""
    s = keys.shape[-1]
    while tags.shape[-1] > 1:
        m = tags.shape[-1]
        groups = -(-m // s)
        pad = groups * s - m
        if pad:
            tags = torch.nn.functional.pad(tags, (0, pad))
        tags = chunk_tags(tags.reshape(*tags.shape[:-1], groups, s), keys)
    return tags[..., 0]


def mac_tensor_words(words: torch.Tensor, key: torch.Tensor,
                     chunk_words: int, domain: int = MAC_DOMAIN):
    """MAC a flat int32 word array ([n], or [N, n] with a [N, 2] key) in
    chunks of ``chunk_words``, zero-padding the stream to whole chunks.
    Returns (tags [.., m], root [..])."""
    n = words.shape[-1]
    m = -(-n // chunk_words)
    pad = m * chunk_words - n
    if pad:
        words = torch.nn.functional.pad(words, (0, pad))
    keys = mac_keys(key, chunk_words, domain)
    tags = chunk_tags(words.reshape(*words.shape[:-1], m, chunk_words), keys)
    return tags, combine_tags(tags, keys)


def verify_tags(words: torch.Tensor, key: torch.Tensor, chunk_words: int,
                tags: torch.Tensor, domain: int = MAC_DOMAIN) -> torch.Tensor:
    """Recompute chunk tags and compare. Returns bool per chunk."""
    got, _ = mac_tensor_words(words, key, chunk_words, domain)
    return got == tags


def tag_root(words: torch.Tensor, key: torch.Tensor, chunk_words: int,
             domain: int = MAC_DOMAIN) -> torch.Tensor:
    """One root tag over a flat word array (chunk tags + tree combine)."""
    _, root = mac_tensor_words(words, key, chunk_words, domain)
    return root


def chunk_count(last_w: int, chunk_words: int) -> int:
    """Smallest chunk count >= words/chunk_words that divides the words."""
    n = -(-last_w // chunk_words)
    while last_w % n:
        n += 1
    return n


def block_tags(ct: torch.Tensor, key: torch.Tensor, chunk_words: int,
               domain: int = MAC_DOMAIN) -> torch.Tensor:
    """Per-chunk tags along the last axis of int16/int32 ciphertext bits.

    ct [..., last] (or [N, ..., last] with a [N, 2] key).  Returns int32
    [..., n_chunks].  Chunking is divisor-aligned: the chunk count is the
    smallest one >= words/chunk_words that divides the row's word count.
    """
    batched = key.dim() == 2
    n = key.shape[0] if batched else 1
    shp = ct.shape[1:] if batched else ct.shape
    last = shp[-1]
    last_w = -(-last * ct.element_size() // 4)
    nc = chunk_count(last_w, chunk_words)
    keys = mac_keys(key.reshape(n, 2), last_w // nc, domain)
    rows = math.prod(shp[:-1])
    tags = mac_ops.mac_tags(ct.reshape(n, rows, last).contiguous(), keys)
    return tags.reshape(*ct.shape[:-1], nc)


def verify_block_tags(ct: torch.Tensor, key: torch.Tensor, chunk_words: int,
                      tags: torch.Tensor,
                      domain: int = MAC_DOMAIN) -> torch.Tensor:
    """Elementwise tag comparison; reduce with .all() for a scalar verdict."""
    return block_tags(ct, key, chunk_words, domain) == tags
