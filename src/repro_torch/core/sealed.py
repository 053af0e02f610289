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

A leaf may be a DTensor (``parallel/sharding.py``): each rank then seals,
verifies and unseals only its own block, and the block's bits are the
same block of the one-process ciphertext.  Its counter rows are the
block's rows in the whole tensor and its columns start at the block's
column offset (``Block``).  Tags chunk whole rows, so a leaf sharded on
its last axis holds them on every rank of the row block (its tags drop
that axis's sharding); ``tags_of`` takes them from the rank's own chunks
or, where a chunk straddles two ranks, from the row block's ciphertext
gathered whole.  Only tags and ciphertext cross (``gather_block``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels import common
from ..kernels.tree_mac import ops as mac_ops
from . import cipher, mac
from .policy import Protection, SealedSpec


class ConsumedSealedTensor(RuntimeError):
    """The SealedTensor's buffer was overwritten by an in-place reseal."""


@dataclasses.dataclass
class SealedTensor:
    ct: torch.Tensor         # int16/int32 [shape] ciphertext bits
    tags: torch.Tensor       # int32 [..., n_chunks] block tags (empty if CTR/NONE)
    nonce: int               # uint32 — counter uniqueness + freshness
    dtype: Any               # plaintext torch dtype
    spec: SealedSpec
    # Set by an in-place reseal, which writes the next nonce's ciphertext
    # into ``ct``: ``nonce`` and ``tags`` no longer describe it, and a
    # reseal from this object would put a second plaintext under that next
    # nonce's keystream.  ``unseal`` and ``reseal`` refuse it.
    consumed: bool = False

    def check_live(self) -> None:
        if self.consumed:
            raise ConsumedSealedTensor(
                f"sealed tensor (nonce {self.nonce:#x}) was consumed by an "
                "in-place reseal; use the state that step returned, or "
                "restore a checkpoint")

    @property
    def shape(self):
        return self.ct.shape

    @property
    def nbytes_ct(self) -> int:
        return self.ct.numel() * self.ct.element_size()

    @property
    def nbytes_meta(self) -> int:
        return self.tags.numel() * 4 + 4


# ---------------------------------------------------------------------------
# a rank's block of a DTensor leaf
# ---------------------------------------------------------------------------

def block_of(shape, mesh, placements, coord) -> tuple[list, list]:
    """(offsets, sizes) of the block that the rank at mesh coordinate
    ``coord`` holds of a tensor of ``shape``.  The placements split evenly
    (``sharding.fit_placements``); a tensor dim over several mesh dims is
    split in the mesh's order, major first, as DTensor does."""
    offs, sizes = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            sizes[p.dim] //= mesh.size(i)
            offs[p.dim] += coord[i] * sizes[p.dim]
    return offs, sizes


def block_rows(shape, offs, sizes, device=None) -> torch.Tensor:
    """int64 [prod(sizes[:-1])]: the counter rows of the block at ``offs``
    of ``sizes`` in a tensor of ``shape``, i.e. its rows' flattened
    leading indices in the whole tensor (not contiguous when a dim after
    the first is split)."""
    rows = torch.zeros((), dtype=torch.int64)
    for d in range(len(shape) - 1):
        rows = rows[..., None] * shape[d] + torch.arange(offs[d],
                                                         offs[d] + sizes[d])
    return rows.reshape(-1).to(device)


@dataclasses.dataclass(frozen=True)
class Region:
    """A rank's block of a whole tensor of ``shape``: its offsets and
    sizes (``block_of``).  A model that computes the whole tensor seals
    only this block (``take``) against the whole tensor's counters: the
    rows of each item of the dims from ``lead`` on, and ``col0``."""
    shape: tuple
    offs: tuple
    sizes: tuple

    def take(self, x: torch.Tensor) -> torch.Tensor:
        return x[tuple(slice(o, o + n) for o, n in zip(self.offs,
                                                       self.sizes))]

    def rows(self, lead: int, device) -> torch.Tensor:
        return block_rows(self.shape[lead:], self.offs[lead:],
                          self.sizes[lead:], device)

    @property
    def col0(self) -> int:
        return self.offs[-1]


def seal_items(x: torch.Tensor, key: torch.Tensor, nonce,
               region: Region | None = None, lead: int = 1) -> torch.Tensor:
    """CTR-seal ``x`` as items along its first ``lead`` dims (0: one item;
    1: one per index of dim 0, with ``key`` [N, 2] and ``nonce`` [N]); with
    ``region``, only that block of ``x``, against the whole items'
    counters (the block spans dim 0 whole when ``lead`` is 1)."""
    if region is None:
        return cipher.seal_bits(x, key, nonce)
    blk = region.take(x)
    rows = region.rows(lead, x.device)
    if lead:
        rows = rows.expand(blk.shape[0], -1)
    return cipher.seal_bits_slice(blk, key, nonce, rows, region.col0)


def whole(x):
    """A DTensor's whole tensor on every rank (its blocks all-gathered,
    FSDP-style); anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    return gather_block(x, range(x.dim()))


def take_block(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's block of the whole tensor ``full``, in ``like``'s (a
    DTensor's) placements; ``full`` as it is for anything else."""
    if not isinstance(like, DTensor):
        return full
    mesh = like.device_mesh
    offs, sizes = block_of(tuple(like.shape), mesh, like.placements,
                           mesh.get_coordinate())
    return Region(tuple(like.shape), tuple(offs), tuple(sizes)).take(full)


def all_ranks_ok(ok: torch.Tensor) -> torch.Tensor:
    """The AND of every rank's verdict (an int all-reduce over the whole
    group): one bad tag anywhere is a bad verdict everywhere."""
    bad = (~ok).to(torch.int32)
    dist.all_reduce(bad)
    return bad == 0


def wrap(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A rank's block as a DTensor of the (contiguous) global ``shape``."""
    shape = tuple(shape)
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def gather_block(x: DTensor, dims) -> torch.Tensor:
    """This rank's block of ``x`` with the tensor dims ``dims`` whole: the
    blocks along them, from the ranks that hold them, in one all_gather of
    the blocks' bytes over the mesh's ranks (the whole process group).
    No collective when no mesh dim of more than one rank splits ``dims``."""
    mesh, pl, shape = x.device_mesh, x.placements, tuple(x.shape)
    local = x.to_local()
    dims = {d % len(shape) for d in dims}
    if not any(isinstance(p, Shard) and p.dim in dims and mesh.size(i) > 1
               for i, p in enumerate(pl)):
        return local
    world = dist.get_world_size()
    if mesh.size() != world:
        raise ValueError(f"the mesh holds {mesh.size()} of the group's "
                         f"{world} ranks")
    flat = local.contiguous().reshape(-1).view(torch.uint8)
    got = torch.empty(world * flat.numel(), dtype=torch.uint8,
                      device=local.device)
    dist.all_gather_into_tensor(got, flat)
    got = got.view(local.dtype).reshape(world, *local.shape)
    mine, _ = block_of(shape, mesh, pl, mesh.get_coordinate())
    out_shape = [shape[d] if d in dims else local.shape[d]
                 for d in range(len(shape))]
    out = torch.empty(out_shape, dtype=local.dtype, device=local.device)
    ranks = mesh.mesh
    for r in range(world):
        coord = [int(c) for c in (ranks == r).nonzero()[0]]
        offs, sizes = block_of(shape, mesh, pl, coord)
        if all(offs[d] == mine[d] for d in range(len(shape)) if d not in dims):
            out[tuple(slice(o, o + n) if d in dims else slice(None)
                      for d, (o, n) in enumerate(zip(offs, sizes)))] = got[r]
    return out


class Block:
    """A DTensor leaf's block on this rank: its place in the counter
    lattice (its rows' global row ids, its first column)."""

    def __init__(self, x: DTensor):
        self.mesh, self.placements = x.device_mesh, tuple(x.placements)
        self.shape = tuple(x.shape)
        offs, sizes = block_of(self.shape, self.mesh, self.placements,
                               self.mesh.get_coordinate())
        self.col0 = offs[-1]
        self.rows = block_rows(self.shape, offs, sizes,
                               x.to_local().device)             # int64

    def tags_placements(self) -> tuple:
        """The tags' placements: the leaf's, its last axis unsplit."""
        last = len(self.shape) - 1
        return tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                     else p for p in self.placements)

    def xor(self, bits: torch.Tensor, key, nonce) -> torch.Tensor:
        """CTR over the block's bits against its global rows and first
        column (seal and unseal alike)."""
        b2 = bits.reshape(-1, bits.shape[-1])
        return cipher.seal_bits_slice(b2, key, nonce, self.rows,
                                      self.col0).reshape(bits.shape)

    def wrap(self, local: torch.Tensor) -> DTensor:
        """``local`` as this block of a DTensor of the leaf's shape."""
        return wrap(local, self.mesh, self.placements, self.shape)


def tags_of(ct, key: torch.Tensor, nonce: int, spec: SealedSpec):
    """The chunk tags of a sealed leaf's ciphertext.

    A DTensor gives the tags of this rank's row block, over whole rows, as
    a DTensor of the tags' placements.  Where the block's columns are
    whole chunks of the row (the shard boundary falls on a chunk's), the
    rank tags its own chunks and the ranks of the row block all-gather the
    tags; else they all-gather the row block's ciphertext and each tags
    the whole rows.  Either way one kernel launch takes the lattice, and
    ``mac.reposition`` moves its tags to the chunks' global positions."""
    mk = mac.nonce_mac_key(key, nonce, spec.mac_domain)
    if not isinstance(ct, DTensor):
        return mac.block_tags(ct, mk, spec.chunk_words, spec.mac_domain)
    blk = Block(ct)
    local = ct.to_local()
    size = local.element_size()
    last_w = -(-blk.shape[-1] * size // 4)
    nc = mac.chunk_count(last_w, spec.chunk_words)
    chunk = 4 * (last_w // nc)                      # bytes a chunk
    own = (blk.col0 * size) % chunk == 0 \
        and (local.shape[-1] * size) % chunk == 0
    lat = local if own else gather_block(ct, (-1,))
    c0 = blk.col0 * size // chunk if own else 0
    keys = mac.mac_keys(mk, chunk // 4, spec.mac_domain)
    tags = mac_ops.mac_tags(lat.reshape(1, -1, lat.shape[-1]).contiguous(),
                            keys[None])[0]
    n = tags.shape[-1]
    cols = torch.arange(n, device=tags.device)
    here = torch.arange(tags.shape[0], device=tags.device)[:, None] * n
    tags = mac.reposition(tags, keys[0], here + cols,
                          blk.rows[:, None] * nc + c0 + cols)
    tags = tags.reshape(*local.shape[:-1], n)
    whole = blk.shape[:-1] + (nc,)
    if n < nc:                        # this rank's chunks of each row
        tags = gather_block(wrap(tags, blk.mesh, blk.placements, whole),
                            (-1,))
    return wrap(tags, blk.mesh, blk.tags_placements(), whole)


def verify(st: "SealedTensor", key: torch.Tensor) -> torch.Tensor:
    """The chunk tags of ``st`` check out (no decryption): a bool tensor on
    the device; for a DTensor leaf, those of this rank's row block."""
    st.check_live()
    if not st.spec.protection.authenticates:
        return torch.ones((), dtype=torch.bool, device=_local(st.ct).device)
    got = tags_of(st.ct, key, st.nonce, st.spec)
    return (_local(got) == _local(st.tags)).all()


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def seal(x: torch.Tensor, key: torch.Tensor, nonce: int,
         spec: SealedSpec) -> SealedTensor:
    """Seal a tensor: CTR-encrypt + per-chunk MAC over the *ciphertext*.
    A DTensor is sealed block by block: each rank encrypts its own."""
    nonce = int(nonce) & common.M32
    if isinstance(x, DTensor):
        return _seal_block(x, key, nonce, spec)
    empty = torch.zeros((0,), dtype=torch.int32, device=x.device)
    if spec.protection is Protection.NONE:
        ct = x.contiguous().view(cipher.uint_dtype_for(x.dtype))
        return SealedTensor(ct, empty, nonce, x.dtype, spec)
    if x.device.type == "meta":
        return _abstract_seal(x, nonce, spec)
    ct = cipher.seal_bits(x, key, nonce)
    tags = empty
    if spec.protection.authenticates:
        tags = mac.block_tags(ct, mac.nonce_mac_key(key, nonce,
                                                    spec.mac_domain),
                              spec.chunk_words, spec.mac_domain)
    return SealedTensor(ct, tags, nonce, x.dtype, spec)


def _seal_block(x: DTensor, key, nonce: int, spec: SealedSpec):
    if x.dim() == 0:
        raise ValueError("a DTensor leaf to seal has at least one dim")
    blk, local = Block(x), x.to_local()
    bits = local.contiguous().view(cipher.uint_dtype_for(local.dtype))
    if spec.protection is not Protection.NONE:
        bits = blk.xor(bits, key, nonce)
    ct = blk.wrap(bits)
    tags = torch.zeros((0,), dtype=torch.int32, device=local.device)
    if spec.protection.authenticates:
        tags = tags_of(ct, key, nonce, spec)
    return SealedTensor(ct, tags, nonce, x.dtype, spec)


def _abstract_seal(x: torch.Tensor, nonce: int,
                   spec: SealedSpec) -> SealedTensor:
    """The SealedTensor of a meta tensor: the ciphertext's and tags' shapes
    and dtypes, no crypto (the abstract states of ``launch/steps.py``)."""
    shape = tuple(x.shape) or (1,)
    ct = torch.empty(shape, dtype=cipher.uint_dtype_for(x.dtype),
                     device="meta")
    tags = torch.empty((0,), dtype=torch.int32, device="meta")
    if spec.protection.authenticates:
        last_w = -(-shape[-1] * ct.element_size() // 4)
        tags = torch.empty(shape[:-1] + (mac.chunk_count(
            last_w, spec.chunk_words),), dtype=torch.int32, device="meta")
    return SealedTensor(ct, tags, nonce, x.dtype, spec)


def unseal(st: SealedTensor, key: torch.Tensor):
    """Verify chunk tags, decrypt.  Returns (tensor, ok) with ``ok`` a bool
    tensor on the device: callers gate outputs on it rather than branch.
    A DTensor leaf gives this rank's plaintext block as a DTensor of the
    same placements, and the verdict on its row block only (the caller
    takes the AND over the ranks)."""
    ok = verify(st, key)
    encrypted = st.spec.protection is not Protection.NONE
    if isinstance(st.ct, DTensor):
        blk, bits = Block(st.ct), st.ct.to_local()
        if encrypted:
            bits = blk.xor(bits, key, st.nonce)
        return blk.wrap(bits.view(st.dtype)), ok
    if not encrypted:
        return st.ct.view(st.dtype), ok
    return cipher.unseal_bits(st.ct, key, st.nonce, st.dtype), ok


def reseal(st: SealedTensor, x: torch.Tensor, key: torch.Tensor) -> SealedTensor:
    """Write a new value into a sealed slot: bump nonce, re-encrypt, re-MAC."""
    st.check_live()
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


def reseal_tree(sealed_old, new_tree, key: torch.Tensor):
    """Reseal a plaintext tree of the same structure into existing sealed
    slots (nonce bump per leaf)."""
    out = [reseal(o, n, key) if is_sealed(o) else n
           for o, n in zip(tree_leaves(sealed_old), tree_leaves(new_tree))]
    return tree_unflatten(sealed_old, out)

