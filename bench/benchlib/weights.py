"""Weights made from ``--seed``, in the port's parameter layout.

Every leaf has a generator of its own, seeded from the run's seed and the
leaf's path, so any one leaf can be made again on its own (the reference
and the training check do so) and comes out bit for bit the same.  A leaf
is drawn in one call on the device it lives on, in float32, scaled, and
stored in the type it is served in: a few large calls per model.

The layouts are the port's, as each family's file gives them (stacked
[n_layers, ...] leaves under ``layers``).  The values are the benchmark's
own: norm scales are drawn too, so that every leaf the model reads shapes
its output.
"""
from __future__ import annotations

import dataclasses
import math
import zlib

import torch

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    path: tuple                   # ("layers", "attn", "wq")
    shape: tuple
    dtype: torch.dtype
    # "normal" (times scale), "embed" (the same), "norm" (1 + 0.1 x), or a
    # function of the float32 standard-normal draws (a family's own leaf)
    kind: object
    scale: float = 1.0


def leaf_specs(sz) -> list:
    """Every leaf of the parameter tree, from the configuration's family
    file (``bench/families/<family>.py``)."""
    return sz.fam.leaf_specs(sz)


def _leaf_seed(seed: int, path: tuple) -> int:
    h = zlib.crc32("/".join(path).encode())
    return (int(seed) * 0x9E3779B1 + h) % (1 << 63)


def make_leaf(spec: LeafSpec, seed: int, device, dtype=None) -> torch.Tensor:
    """One leaf from its own generator: float32 draws, scaled, stored in
    ``spec.dtype`` (then ``dtype``, when given: the reference's float32
    copy of the very values the program got)."""
    g = torch.Generator(device=device)
    g.manual_seed(_leaf_seed(seed, spec.path))
    x = torch.randn(spec.shape, generator=g, dtype=_F32, device=device)
    if spec.kind == "normal" or spec.kind == "embed":
        x.mul_(spec.scale)
    elif spec.kind == "norm":
        x.mul_(0.1).add_(1.0)
    elif callable(spec.kind):
        x = spec.kind(x)
    else:
        raise ValueError(f"unknown leaf kind {spec.kind!r}")
    x = x.to(spec.dtype)
    return x if dtype is None else x.to(dtype)


def set_path(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_tree(sz, seed: int, device, dtype=None) -> dict:
    """The whole parameter tree of ``sz`` from ``seed``."""
    tree: dict = {}
    for spec in leaf_specs(sz):
        set_path(tree, spec.path, make_leaf(spec, seed, device, dtype))
    return tree


def n_params(sz) -> int:
    return sum(math.prod(s.shape) for s in leaf_specs(sz))
