"""Expert-parallel MoE dispatch on ``torch.distributed`` (torch port of
``repro.models.moe_ep``).

Every rank of the mesh runs the same program on the same whole token
batch, as the reference's model code does outside its ``shard_map``:
the activations entering the MoE layer are replicated.  Inside,
rank (d, m) takes data shard d of the tokens and the experts
[m E_l, (m+1) E_l) of model rank m, capacity-scatters only the tokens
routed to its own experts (a local capacity ``C_l`` from the shard's
``T_l`` tokens, as the reference), runs its experts as batched products
and contributes a partial [T_l, D] output.  The partials are summed over
the model group and the data shards gathered, so every rank gets the
whole [B, S, D] back.

Gradients (the reference's ``shard_map`` transpose inserts these sums;
measured there as a 0.31 max-gradient error when they were dropped):

* the loss is computed whole on every rank and every rank seeds its own
  backward, so the cotangent of the combined output is already whole on
  each rank: the combine's backward only takes the rank's own rows (an
  all-reduce whose backward is again an all-reduce would count the
  gradient mn times);
* ``x`` and the router enter replicated, but each rank's backward sees
  only the share through its own tokens and experts: their gradients are
  summed over the model and the data group (``_Enter``);
* each expert block is replicated over the data group: its gradient is
  summed over the data group.

So every gradient comes out whole on every rank (each expert block on the
ranks that hold it), equal to the global dispatch's.  The partial
outputs cross in float32 and are rounded once to the activation dtype,
as the global dispatch rounds its float32 sum over the k choices once.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F


class _Enter(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over each of
    ``groups``: a tensor every rank holds whole, of which each rank's
    backward sees only its own share."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        groups = [gr for gr in ctx.groups if dist.get_world_size(gr) > 1]
        if groups:
            g = g.contiguous().clone()        # all_reduce writes in place
            for group in groups:
                dist.all_reduce(g, group=group)
        return g, None


class _Combine(torch.autograd.Function):
    """Forward: the partial [T_l, D] outputs summed over the model group,
    then the data shards gathered into the whole [dn T_l, D] on every
    rank.  Backward: the rank's own rows of the (already whole)
    cotangent."""

    @staticmethod
    def forward(ctx, y_partial, model_group, data_group, d):
        y = y_partial.contiguous().clone()
        if dist.get_world_size(model_group) > 1:
            dist.all_reduce(y, group=model_group)
        dn = dist.get_world_size(data_group)
        ctx.rows = (d * y.shape[0], (d + 1) * y.shape[0])
        if dn == 1:
            return y
        out = torch.empty((dn * y.shape[0], *y.shape[1:]), dtype=y.dtype,
                          device=y.device)
        dist.all_gather_into_tensor(out, y, group=data_group)
        return out

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[lo:hi], None, None, None


def _x_grad_groups(model_group, data_group) -> tuple:
    """The groups over which the entering activations' gradient is
    summed."""
    return model_group, data_group


def local_capacity(cfg, n_local_tokens: int) -> int:
    """C_l: the capacity of one expert for one data shard's tokens."""
    m = cfg.moe
    c = int(math.ceil(n_local_tokens * m.top_k / m.n_experts
                      * m.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _local_experts(w: torch.Tensor, e0: int, e_l: int,
                   n_experts: int) -> torch.Tensor:
    """This rank's [E_l, ...] block of an expert leaf given whole
    [E, ...] or already as the block."""
    if w.shape[0] == n_experts and n_experts != e_l:
        return w[e0:e0 + e_l]
    if w.shape[0] != e_l:
        raise ValueError(f"an expert leaf of {w.shape[0]} experts, neither "
                         f"{n_experts} nor this rank's {e_l}")
    return w


def moe_ffn_ep(p, cfg, x, mesh, data_axis="data", model_axis="model"):
    """Drop-in EP replacement for ``moe.moe_ffn``: x [B, S, D] (the same on
    every rank) -> [B, S, D].  ``p``'s router is whole; its expert leaves
    are whole [E, ...] or this rank's [E_l, ...] block.

    Requires E % model shards == 0 and (B*S) % data shards == 0."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    names = mesh.mesh_dim_names
    dn = mesh.size(names.index(data_axis))
    mn = mesh.size(names.index(model_axis))
    if E % mn:
        raise ValueError(f"{E} experts do not split over {mn} model ranks")
    T = B * S
    if T % dn:
        raise ValueError(f"{T} tokens do not split over {dn} data ranks")
    E_l, T_l = E // mn, T // dn
    C_l = local_capacity(cfg, T_l)
    d = mesh.get_local_rank(data_axis)
    e0 = mesh.get_local_rank(model_axis) * E_l
    mg, dg = mesh.get_group(model_axis), mesh.get_group(data_axis)
    dev = x.device

    xt = _Enter.apply(x.reshape(T, D), _x_grad_groups(mg, dg))
    xt = xt[d * T_l:(d + 1) * T_l]
    router = _Enter.apply(p["router"], (mg, dg))
    wg, wu, wd = (_Enter.apply(_local_experts(p[n], e0, E_l, E), (dg,))
                  for n in ("w_gate", "w_up", "w_down"))

    gates = torch.softmax(xt.float() @ router, dim=-1)
    gv, gi = torch.topk(gates, k, dim=-1, sorted=True)                # [T_l,k]
    gv = gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9)
    flat_e = gi.reshape(-1)                                          # [T_l*k]
    mine = (flat_e >= e0) & (flat_e < e0 + E_l)
    loc_e = torch.where(mine, flat_e - e0, 0)
    onehot = ((loc_e[:, None] == torch.arange(E_l, device=dev)[None, :])
              & mine[:, None]).to(torch.int64)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = mine & (pos < C_l) & (pos >= 0)
    slot_e = torch.where(keep, loc_e, 0)
    slot_c = torch.where(keep, pos, 0)

    x_rep = xt.repeat_interleave(k, dim=0) * keep[:, None].to(xt.dtype)
    buf = torch.zeros((E_l, C_l, D), dtype=xt.dtype, device=dev)
    buf.index_put_((slot_e, slot_c), x_rep, accumulate=True)
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out_buf = torch.bmm(h, wd)

    w = (gv.reshape(-1) * keep).to(xt.dtype)
    y_rep = out_buf[slot_e, slot_c] * w[:, None]
    y_partial = y_rep.float().reshape(T_l, k, D).sum(dim=1)   # my experts
    y = _Combine.apply(y_partial, mg, dg, d)
    return y.to(x.dtype).reshape(B, S, D)
