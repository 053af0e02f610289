"""Sharding context and logical-axis helpers on DTensor (torch port of
``repro.parallel.sharding``).

Model code names *logical* axes: "data" (the batch, and FSDP's parameter
dim), "model" (tensor parallelism) and "pod".  The active ``ShardingCtx``
maps "data" to the mesh's data axes (("pod", "data") on the multi-pod mesh,
("data",) on one pod) and "model" to the tensor-parallel axis.  Where the
reference builds a ``PartitionSpec`` (one entry per tensor dim), the port
builds DTensor placements (one per mesh dim): a tensor dim resolved to
("pod", "data") is ``Shard(d)`` on both mesh dims, pod major, which is the
block the reference's spec gives.  An axis whose size does not divide its
dimension is dropped (``fit_pspec``), so no placement is ever uneven.

With no active context every helper is a no-op, so the same model code
runs on one device and under a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from ..core.sealed import SealedTensor

_ACTIVE: Optional["ShardingCtx"] = None


class Sharding(NamedTuple):
    """A leaf's sharding: the mesh and one placement per mesh dim (the
    counterpart of the reference's ``NamedSharding``)."""
    mesh: DeviceMesh
    placements: tuple


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: DeviceMesh
    data_axes: tuple          # e.g. ('pod', 'data') or ('data',)
    model_axis: str = "model"

    def resolve(self, logical) -> object:
        """Map one logical spec element to mesh axis name(s)."""
        if logical is None:
            return None
        if logical == "data":
            return (self.data_axes if len(self.data_axes) > 1
                    else self.data_axes[0])
        if logical == "model":
            return self.model_axis
        if logical == "pod":
            return "pod" if "pod" in self.mesh.mesh_dim_names else None
        if isinstance(logical, (tuple, list)):
            parts = []
            for item in logical:
                r = self.resolve(item)
                if r is None:
                    continue
                parts.extend(r if isinstance(r, tuple) else (r,))
            return tuple(parts) if parts else None
        return logical

    def placements(self, *logical, shape) -> tuple:
        """One placement per mesh dim for a tensor of ``shape`` whose dims
        carry ``logical`` axes (indivisible axes dropped)."""
        return to_placements(self.mesh, fit_pspec(self, logical, shape))

    def named(self, *logical, shape) -> Sharding:
        return Sharding(self.mesh, self.placements(*logical, shape=shape))


def to_placements(mesh: DeviceMesh, spec: tuple) -> tuple:
    """Placements of a resolved spec (one entry per tensor dim: None, a
    mesh axis name or a tuple of them, major first).  A tensor dim over
    several mesh dims takes them in the mesh's order, as DTensor shards."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"tensor dim {d} is sharded over {axes}, not "
                             f"in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(d)
    return tuple(out)


def active() -> Optional[ShardingCtx]:
    return _ACTIVE


@contextlib.contextmanager
def use(ctx: Optional[ShardingCtx]):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = ctx
    try:
        yield ctx
    finally:
        _ACTIVE = prev


def make_ctx(mesh: DeviceMesh, manual_axes: tuple = ()) -> ShardingCtx:
    """manual_axes: axes the caller handles itself (e.g. ('pod',) for the
    pipeline's stage axis) — excluded from 'data'."""
    names = mesh.mesh_dim_names
    data_axes = tuple(a for a in ("pod", "data")
                      if a in names and a not in manual_axes)
    return ShardingCtx(mesh=mesh, data_axes=data_axes or ("data",))


def axes_size(mesh: DeviceMesh, resolved) -> int:
    if resolved is None:
        return 1
    if isinstance(resolved, str):
        return mesh.size(mesh.mesh_dim_names.index(resolved))
    return math.prod(axes_size(mesh, a) for a in resolved)


def fit_pspec(ctx: ShardingCtx, logical, shape) -> tuple:
    """Resolve logical axes and DROP any whose shard count does not divide
    the dimension; logical axes beyond ``len(shape)`` are dropped too."""
    elems = []
    for d in range(len(shape)):
        r = ctx.resolve(logical[d] if d < len(logical) else None)
        if r is not None and shape[d] % axes_size(ctx.mesh, r) != 0:
            r = None
        elems.append(r)
    return tuple(elems)


def fit_placements(mesh: DeviceMesh, placements, shape) -> tuple:
    """``placements`` with every tensor dim whose shard count does not
    divide it replicated instead."""
    count = {}
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            count[p.dim] = count.get(p.dim, 1) * mesh.size(i)
    return tuple(Replicate() if isinstance(p, Shard)
                 and (p.dim >= len(shape) or shape[p.dim] % count[p.dim])
                 else p for p in placements)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute(x: torch.Tensor, sharding: Sharding) -> DTensor:
    """``x`` (the whole tensor, on every rank, on any device) as a DTensor
    on the mesh's device of which this rank holds a copy of its own block
    and nothing more: no communication."""
    mesh = sharding.mesh
    pl = fit_placements(mesh, sharding.placements, x.shape)
    size, off = compute_local_shape_and_global_offset(x.shape, mesh, pl)
    block = x[tuple(slice(o, o + n) for o, n in zip(off, size))]
    local = block.to(mesh_device(mesh), memory_format=torch.contiguous_format,
                     copy=True)
    stride = [1] * x.dim()
    for d in range(x.dim() - 2, -1, -1):
        stride[d] = stride[d + 1] * x.shape[d + 1]
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=x.shape, stride=tuple(stride))


def shard(x, *logical):
    """Redistribute a DTensor activation to the logical axes (a no-op
    without an active context, and on a plain tensor)."""
    ctx = _ACTIVE
    if ctx is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx.mesh, ctx.placements(*logical, shape=x.shape))


def is_spec_leaf(s) -> bool:
    """Logical-spec leaves: a tuple of axis names, or 'r' (replicated)."""
    return isinstance(s, tuple) or (isinstance(s, str) and s == "r")


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, (Replicate(),) * mesh.ndim)


def tree_named_shardings(spec_tree, mesh: DeviceMesh, like=None):
    """A tree of logical-spec tuples (or 'r') as a tree of ``Sharding``.

    Without ``like`` the placements are shape-free and fitted to each leaf
    when it is distributed (``distribute``).  With ``like`` (the tree the
    shardings are for, real or on the meta device) the result follows its
    exact structure and each placement is fitted to its leaf's shape.
    ``spec_tree`` follows the PLAINTEXT structure; where ``like`` holds a
    SealedTensor the spec is expanded: ct keeps the plaintext spec (shaped
    ciphertext => same placements), tags drop the last axis' sharding
    (they chunk along it), nonce is replicated."""
    ctx = make_ctx(mesh)
    rep = replicated(mesh)

    def conv(spec, shape):
        if shape is None:
            return Sharding(mesh, to_placements(
                mesh, tuple(ctx.resolve(ax) for ax in spec)))
        return ctx.named(*spec, shape=shape)

    def f(spec, node):
        if isinstance(node, SealedTensor):
            sp = spec if isinstance(spec, tuple) else ()
            if node.tags.dim() == 0 or tuple(node.tags.shape) == (0,):
                tags = rep
            else:
                tags = ctx.named(*sp[:-1], None, shape=node.tags.shape)
            return SealedTensor(ct=conv(sp, node.ct.shape), tags=tags,
                                nonce=rep, dtype=node.dtype, spec=node.spec)
        if isinstance(spec, dict):
            return {k: f(spec[k], None if node is None else node[k])
                    for k in (spec if node is None else node)}
        if dataclasses.is_dataclass(spec):           # e.g. TrainState
            return type(spec)(**{
                fl.name: f(getattr(spec, fl.name),
                           None if node is None else getattr(node, fl.name))
                for fl in dataclasses.fields(spec)})
        if not isinstance(spec, tuple):              # 'r' or None
            return rep
        return conv(spec, None if node is None else node.shape)

    return f(spec_tree, like)
