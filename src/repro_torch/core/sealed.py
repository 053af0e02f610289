"""SealedTensor — ciphertext-at-rest representation of a tensor in device memory.

Torch port of ``repro.core.sealed`` (paper Rules 1 & 2): a tensor that
leaves the trust boundary exists only as counter-mode ciphertext plus a
sidecar of per-chunk MAC tags.  The ciphertext keeps the tensor's shape, as
the same-width storage dtype (bf16 -> int16 bits, f32 -> int32 bits), and
tags are chunked along the last axis.

Trees are nested dicts (and lists/tuples) of tensors.  Their leaves are
walked in sorted-key order, the order of ``jax.tree_util`` flattening, so
leaf ``i`` of a tree gets the same nonce ``base + 131 * i`` as in the
reference and every weight ciphertext is bit-identical to it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..kernels import common
from . import cipher, mac
from .policy import Protection, SealedSpec


@dataclasses.dataclass
class SealedTensor:
    ct: torch.Tensor         # int16/int32 [shape] ciphertext bits
    tags: torch.Tensor       # int32 [..., n_chunks] block tags (empty if CTR/NONE)
    nonce: int               # uint32 — counter uniqueness + freshness
    dtype: Any               # plaintext torch dtype
    spec: SealedSpec

    @property
    def shape(self):
        return self.ct.shape

    @property
    def nbytes_ct(self) -> int:
        return self.ct.numel() * self.ct.element_size()

    @property
    def nbytes_meta(self) -> int:
        return self.tags.numel() * 4 + 4


def _mac_key(key: torch.Tensor, nonce: int, spec: SealedSpec) -> torch.Tensor:
    """Nonce-bound MAC key => replaying an old (ct, tags) pair fails."""
    y0, y1 = cipher.threefry2x32(key, nonce, spec.mac_domain)
    return torch.stack([y0, y1])


def seal(x: torch.Tensor, key: torch.Tensor, nonce: int,
         spec: SealedSpec) -> SealedTensor:
    """Seal a tensor: CTR-encrypt + per-chunk MAC over the *ciphertext*."""
    nonce = int(nonce) & common.M32
    empty = torch.zeros((0,), dtype=torch.int32, device=x.device)
    if spec.protection is Protection.NONE:
        ct = x.contiguous().view(cipher.uint_dtype_for(x.dtype))
        return SealedTensor(ct, empty, nonce, x.dtype, spec)
    ct = cipher.seal_bits(x, key, nonce)
    tags = empty
    if spec.protection.authenticates:
        tags = mac.block_tags(ct, _mac_key(key, nonce, spec),
                              spec.chunk_words, spec.mac_domain)
    return SealedTensor(ct, tags, nonce, x.dtype, spec)


def unseal(st: SealedTensor, key: torch.Tensor):
    """Verify chunk tags, decrypt.  Returns (tensor, ok) with ``ok`` a bool
    tensor on the device: callers gate outputs on it rather than branch."""
    ok = torch.ones((), dtype=torch.bool, device=st.ct.device)
    if st.spec.protection is Protection.NONE:
        return st.ct.view(st.dtype), ok
    if st.spec.protection.authenticates:
        ok = mac.verify_block_tags(st.ct, _mac_key(key, st.nonce, st.spec),
                                   st.spec.chunk_words, st.tags,
                                   st.spec.mac_domain).all()
    return cipher.unseal_bits(st.ct, key, st.nonce, st.dtype), ok


def reseal(st: SealedTensor, x: torch.Tensor, key: torch.Tensor) -> SealedTensor:
    """Write a new value into a sealed slot: bump nonce, re-encrypt, re-MAC."""
    return seal(x, key, (st.nonce + 1) & common.M32, st.spec)


# ---------------------------------------------------------------------------
# nonce-lane budget: seal_tree spaces leaf nonces TREE_LEAF_STRIDE apart and
# reseal bumps +1, so more than TREE_LEAF_STRIDE - 1 resealings under one key
# would reuse keystream across leaves.  The budget is enforced host-side.
# ---------------------------------------------------------------------------

TREE_LEAF_STRIDE = 131
MAX_TREE_RESEALS = TREE_LEAF_STRIDE - 1


class NonceLaneExhausted(RuntimeError):
    """The next reseal would walk a leaf's nonce into the next leaf's lane."""


@dataclasses.dataclass
class ResealCounter:
    """Host-side guard for a sealed tree's per-leaf nonce lanes."""
    limit: int = MAX_TREE_RESEALS
    count: int = 0

    @property
    def remaining(self) -> int:
        return self.limit - self.count

    @property
    def exhausted(self) -> bool:
        return self.count >= self.limit

    def headroom(self) -> dict:
        return {"source": "reseal_lanes", "limit": self.limit,
                "count": self.count, "remaining": self.remaining}

    def note(self, n: int = 1) -> None:
        if self.count + n > self.limit:
            raise NonceLaneExhausted(
                f"reseal #{self.count + n} would cross the {self.limit}-"
                "reseal nonce-lane budget (keystream reuse across leaves) — "
                "bump the epoch / re-seal the tree under fresh nonces first")
        self.count += n

    def reset(self) -> None:
        self.count = 0


@dataclasses.dataclass
class NonceSpanGuard:
    """Host-side budget for a reserved nonce span (e.g. one KV page's lane):
    at most ``span - 1`` bumps of the base nonce."""
    span: int
    spent: int = 0

    @property
    def remaining(self) -> int:
        return max(0, self.span - 1 - self.spent)

    def headroom(self) -> dict:
        return {"source": "page_nonce", "span": self.span,
                "spent": self.spent, "remaining": self.remaining}

    def spend(self, n: int = 1) -> None:
        if self.spent + n > self.span - 1:
            raise NonceLaneExhausted(
                f"nonce bump #{self.spent + n} would cross the reserved "
                f"span of {self.span} (keystream reuse with the next "
                "reservation) — reseal under a fresh nonce lane first")
        self.spent += n


# ---------------------------------------------------------------------------
# tree helpers: nested dicts / lists / tuples, sorted-key leaf order
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _build(t, it):
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (tree_leaves order).

    A module-level recursion: a self-referencing closure would form a
    reference cycle that keeps every step's plaintext weights alive until
    the cycle collector runs."""
    return _build(tree, iter(leaves))


def is_sealed(x) -> bool:
    return isinstance(x, SealedTensor)


def seal_tree(tree, key: torch.Tensor, spec: SealedSpec, nonce_base: int = 0):
    """Seal every leaf, with per-leaf nonces TREE_LEAF_STRIDE apart."""
    sealed = [seal(x, key, nonce_base + TREE_LEAF_STRIDE * i, spec)
              for i, x in enumerate(tree_leaves(tree))]
    return tree_unflatten(tree, sealed)


def unseal_tree(tree, key: torch.Tensor):
    """Unseal every SealedTensor leaf.  Returns (tree, all_ok bool tensor)."""
    outs, oks = [], []
    for leaf in tree_leaves(tree):
        if is_sealed(leaf):
            x, ok = unseal(leaf, key)
            outs.append(x)
            oks.append(ok)
        else:
            outs.append(leaf)
    all_ok = (torch.stack(oks).all() if oks
              else torch.ones((), dtype=torch.bool, device=key.device))
    return tree_unflatten(tree, outs), all_ok

