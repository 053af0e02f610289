"""Pipeline parallelism with SEALED stage boundaries (torch port of
``repro.parallel.pipeline``).

One process per stage on the mesh's ``axis`` group (the multi-pod mesh's
'pod' axis doubles as the pipeline axis): each stage owns a contiguous
slice of the layer stack, and the activations crossing the stage-to-stage
link — the paper's untrusted bus — are CTR-sealed before they are sent
and unsealed on arrival (Rule 1 at the pipeline boundary).  Counter mode
is exact bitwise XOR, so the pipelined loss and gradients are the
unpipelined model's.  The hop is encrypted, not authenticated: no tag is
computed, as in the reference.

Schedule: GPipe fill-drain over M + S - 1 ticks; at tick t stage s runs
microbatch t - s (a stage idles in the ticks outside its microbatches).
Stage 0 embeds, the last stage computes the loss.  The hop of tick t
from stage s is sealed under nonce ``t*16 + s`` (domain 0); its gradient
goes back sealed under ``t*16 + (s+1) + 8`` (domain 8), and the receiver
unseals with the nonce it recomputes, as the reference's ``_hop``.

Backward: ``_Send`` (the sender's side of a hop) returns a zero scalar
that joins the stage's objective; its backward receives the activation's
gradient from the next stage.  ``_Recv`` (the receiver's side) hangs the
received activation on an anchor leaf; its backward seals the gradient
and sends it back.  Every stage seeds its own objective (the last stage's
loss plus the zero scalars), and autograd runs each stage's microbatches
from the last to the first, so the reverse hops pair up in order.

Point-to-point transfers go through ``dist.batch_isend_irecv``; on a gloo
group a tensor on the card is staged through host memory (the bytes are
sealed, so they may cross any link).  Dense family only, as the
reference.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import cipher
from ..core.sealed import tree_leaves, tree_unflatten
from ..kernels import common
from ..models import layers as L
from ..models import transformer as TF

FWD_DOMAIN, BWD_DOMAIN = 0, 8


def _map(fn, tree):
    return tree_unflatten(tree, [fn(a) for a in tree_leaves(tree)])


def stack_params_by_stage(params, n_stages: int):
    """Re-group a dense LM param tree: layer leaves [n_layers, ...] become
    [n_stages, layers_per_stage, ...]; embed, final_norm and unembed stay
    whole (stage 0 and the last stage use them)."""
    def regroup(a):
        nl = a.shape[0]
        if nl % n_stages:
            raise ValueError(f"{nl} layers do not split into {n_stages} "
                             "stages")
        return a.reshape(n_stages, nl // n_stages, *a.shape[1:])
    out = dict(params)
    out["layers"] = _map(regroup, params["layers"])
    return out


def hop_nonce(tick: int, sender: int, domain: int) -> int:
    return (tick * 16 + sender + domain) & common.M32


def _seal_hop(x, key, tick: int, sender: int, domain: int):
    return cipher.seal_bits(x, key, hop_nonce(tick, sender, domain))


def _unseal_hop(ct, key, tick: int, sender: int, domain: int, dtype):
    return cipher.unseal_bits(ct, key, hop_nonce(tick, sender, domain),
                              dtype)


def _staged(group, device) -> bool:
    """Whether a transfer on ``group`` goes through host memory."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


class _Link:
    """One stage's point-to-point traffic on the pipeline group: sends are
    posted and awaited at ``drain`` (their buffers kept alive until
    then), receives complete before they return."""

    def __init__(self, group, stage: int):
        self.group = group
        self.stage = stage
        self.pending = []

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def send(self, t: torch.Tensor, stage: int) -> None:
        buf = t.cpu() if _staged(self.group, t.device) else t.contiguous()
        op = dist.P2POp(dist.isend, buf, self._peer(stage), self.group)
        self.pending.append((dist.batch_isend_irecv([op]), buf))

    def recv(self, shape, dtype, device, stage: int) -> torch.Tensor:
        host = _staged(self.group, device)
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if host else device)
        op = dist.P2POp(dist.irecv, buf, self._peer(stage), self.group)
        for work in dist.batch_isend_irecv([op]):
            work.wait()
        return buf.to(device) if host else buf

    def drain(self) -> None:
        for works, _ in self.pending:
            for work in works:
                work.wait()
        self.pending = []


class _Send(torch.autograd.Function):
    """Forward: send ``y`` (sealed when ``key`` is given) to the next
    stage; returns a zero scalar for the stage's objective.  Backward:
    receive (and unseal) ``y``'s gradient from the next stage."""

    @staticmethod
    def forward(ctx, y, link, key, tick):
        ctx.link, ctx.key, ctx.tick = link, key, tick
        ctx.meta = (y.shape, y.dtype, y.device)
        me = link.stage
        link.send(y if key is None else
                  _seal_hop(y, key, tick, me, FWD_DOMAIN), me + 1)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        link, key, tick = ctx.link, ctx.key, ctx.tick
        shape, dtype, device = ctx.meta
        nxt = link.stage + 1
        if key is None:
            return link.recv(shape, dtype, device, nxt), None, None, None
        ct = link.recv(shape, cipher.uint_dtype_for(dtype), device, nxt)
        return (_unseal_hop(ct, key, tick, nxt, BWD_DOMAIN, dtype), None,
                None, None)


class _Recv(torch.autograd.Function):
    """Forward: receive (and unseal) the activation the previous stage
    sent at ``tick``.  Backward: seal its gradient and send it back."""

    @staticmethod
    def forward(ctx, anchor, link, key, tick, shape, dtype):
        ctx.link, ctx.key, ctx.tick = link, key, tick
        dev, prev = anchor.device, link.stage - 1
        if key is None:
            return link.recv(shape, dtype, dev, prev)
        ct = link.recv(shape, cipher.uint_dtype_for(dtype), dev, prev)
        return _unseal_hop(ct, key, tick, prev, FWD_DOMAIN, dtype)

    @staticmethod
    def backward(ctx, g):
        link, key = ctx.link, ctx.key
        me = link.stage
        link.send(g if key is None else
                  _seal_hop(g, key, ctx.tick, me, BWD_DOMAIN), me - 1)
        return None, None, None, None, None, None


def make_pipelined_loss(cfg, mesh, n_stages: int, n_micro: int,
                        seal_key=None, axis: str = "pod"):
    """Returns loss(params_staged, batch): this process runs stage
    ``mesh.get_local_rank(axis)`` of ``n_stages`` and every stage returns
    the same loss.  batch: tokens/labels [n_micro, B_micro, S] (the same
    on every stage).  seal_key: int32 [2] or None — when given, the
    stage-boundary activations and their gradients are sealed across the
    hop.  ``loss.value_and_grad(params_staged, batch)`` gives (loss,
    grads): ``grads["layers"]`` is this stage's block [layers_per_stage,
    ...] of the stacked gradient, the whole leaves' gradients are summed
    over the stages."""
    names = mesh.mesh_dim_names
    if mesh.size(names.index(axis)) != n_stages:
        raise ValueError(f"the {axis!r} axis has "
                         f"{mesh.size(names.index(axis))} ranks, not "
                         f"{n_stages} stages")
    group = mesh.get_group(axis)
    sid = mesh.get_local_rank(axis)
    last = n_stages - 1

    def local_objective(params, layers, batch, link):
        """Run this stage's ticks; returns (objective, loss sum)."""
        tokens, labels = batch["tokens"], batch["labels"]
        M, Bm, S = tokens.shape
        if M != n_micro:
            raise ValueError(f"{M} microbatches, the pipeline has {n_micro}")
        dev = tokens.device
        positions = torch.arange(S, device=dev)
        my_layers = TF.unbind_tree(layers)
        anchor = torch.zeros((), device=dev,
                             requires_grad=torch.is_grad_enabled())
        shape = (Bm, S, cfg.d_model)

        def attend(q, k, v):
            return L.gqa_attention(q, k, v, causal=True,
                                   q_block=cfg.q_block), None

        objective = torch.zeros((), dtype=torch.float32, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for tick in range(M + n_stages - 1):
            j = tick - sid
            if not 0 <= j < M:
                continue
            if sid == 0:
                x = params["embed"][tokens[j]].to(cfg.act_dtype)
            else:
                x = _Recv.apply(anchor, link, seal_key, tick - 1, shape,
                                cfg.act_dtype)
            for lp in my_layers:
                x, _ = TF._block(lp, cfg, x, positions, attend)
            if sid == last:
                lab = labels[j]
                mb_loss = L.softmax_xent(TF.logits_of(params, cfg, x),
                                         torch.clamp(lab, min=0),
                                         mask=lab >= 0)
                loss_sum = loss_sum + mb_loss
            else:
                objective = objective + _Send.apply(x, link, seal_key, tick)
        return objective + loss_sum / M, loss_sum

    def whole(loss_sum, M):
        out = loss_sum.detach().clone()
        dist.all_reduce(out, group=group)    # only the last stage's is > 0
        return out / M

    def staged(params_staged, batch):
        link = _Link(group, sid)
        layers = _map(lambda a: a[sid], params_staged["layers"])
        with torch.no_grad():
            _, loss_sum = local_objective(params_staged, layers, batch, link)
        link.drain()
        return whole(loss_sum, n_micro)

    def value_and_grad(params_staged, batch):
        link = _Link(group, sid)
        params = {k: _map(lambda a: a.detach().requires_grad_(True),
                                  v)
                  for k, v in params_staged.items() if k != "layers"}
        layers = _map(lambda a: a[sid].detach().requires_grad_(True),
                              params_staged["layers"])
        objective, loss_sum = local_objective(params, layers, batch, link)
        objective.backward()
        link.drain()

        def grad(a):
            return a.grad if a.grad is not None else torch.zeros_like(a)

        grads = {"layers": _map(grad, layers)}
        for k, v in params.items():
            def summed(a):
                g = grad(a).contiguous()
                dist.all_reduce(g, group=group)
                return g
            grads[k] = _map(summed, v)
        return whole(loss_sum, n_micro), grads

    staged.value_and_grad = value_and_grad
    return staged
