"""AdamW with dtype-configurable moment states (torch port of
``repro.optim.adamw``).

The update math runs in f32 and re-rounds to the parameter and moment
dtypes, in the reference's order.  ``update_leaf`` is the update of one
leaf (or one row slice of it), so the sealed train step
(``train/trainer.py``) can apply it leaf by leaf between decrypting and
resealing; ``apply`` runs it over whole trees.  Trees are nested dicts of
tensors, walked in the reference's (sorted-key) leaf order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..core.sealed import tree_leaves, tree_unflatten
from ..models.config import DTYPES


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor            # int32 scalar
    params: Any
    mu: Any
    nu: Any


def global_norm(grads) -> torch.Tensor:
    """f32 sqrt of the sum of squares over every leaf, summed leaf by leaf
    in tree order as the reference does."""
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    clipped = [(g.float() * scale).to(g.dtype) for g in tree_leaves(grads)]
    return tree_unflatten(grads, clipped), gn


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Any = 3e-4                 # float or schedule fn(step) -> float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # moment dtype ("bfloat16" to halve memory)

    def init(self, params) -> TrainState:
        dt = DTYPES[self.state_dtype]
        leaves = tree_leaves(params)
        zeros = [torch.zeros(p.shape, dtype=dt, device=p.device)
                 for p in leaves]
        step = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
        return TrainState(step=step, params=params,
                          mu=tree_unflatten(params, zeros),
                          nu=tree_unflatten(params, [z.clone()
                                                     for z in zeros]))

    def scalars(self, step: torch.Tensor):
        """(new step, lr, c1, c2) of the update after ``step``."""
        step = step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        t = step.to(torch.float32)
        c1 = 1.0 - self.b1 ** t
        c2 = 1.0 - self.b2 ** t
        return step, lr, c1, c2

    def clip(self, grads):
        """(clip scale, global norm): the scale is 1 without clipping."""
        gn = global_norm(grads)
        return clip_scale(gn, self.grad_clip or math.inf), gn

    def update_leaf(self, p, g, m, v, lr, c1, c2, decay: bool):
        """One leaf's (or row slice's) update -> (p, m, v) in the stored
        dtypes.  ``decay``: the whole leaf has ndim >= 2 (the reference
        decays those, stacked norm scales included)."""
        dt = DTYPES[self.state_dtype]
        b1, b2 = self.b1, self.b2
        gf = g.float()
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + torch.square(gf) * (1 - b2)
        u = (mf / c1) / (torch.sqrt(vf / c2) + self.eps)
        pf = p.float()
        if decay:
            u = u + self.weight_decay * pf
        return (pf - lr * u).to(p.dtype), mf.to(dt), vf.to(dt)

    def apply(self, state: TrainState, grads) -> tuple[TrainState, dict]:
        step, lr, c1, c2 = self.scalars(state.step)
        grads, gnorm = clip_by_global_norm(grads, self.grad_clip or math.inf)
        out = [self.update_leaf(p, g, m, v, lr, c1, c2, p.dim() >= 2)
               for p, g, m, v in zip(tree_leaves(state.params),
                                     tree_leaves(grads),
                                     tree_leaves(state.mu),
                                     tree_leaves(state.nu))]
        new = [tree_unflatten(state.params, [o[i] for o in out])
               for i in range(3)]
        return (TrainState(step=step, params=new[0], mu=new[1], nu=new[2]),
                {"grad_norm": gnorm,
                 "lr": torch.as_tensor(lr, dtype=torch.float32)})
