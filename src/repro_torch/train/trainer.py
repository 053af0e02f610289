"""Training step builder — the paper's secure-offload loop (torch port of
``repro.train.trainer``).

One ``train_step`` is one accelerator "launch" in the paper's terms:
  1. Sealed state (params + Adam moments) sits in untrusted device memory
     as ciphertext.
  2. The step unseals the params (decrypt + MAC verify), runs forward and
     backward over ``n_accum`` microbatches, verifies every tag of the
     moments, applies AdamW and re-seals with bumped nonces (freshness).
  3. Everything written is gated on the verification predicate: a tampered
     ciphertext yields poisoned (NaN) state, never silent computation.

The function is the reference's; the order is chosen to fit a 2.6 B
parameter state on one 80 GB card.  The reference holds the plaintext
moments, the new state and its new ciphertext all at once (~121 GB for
granite-3-2b).  Here the moments' tags are verified first, so ``ok`` is
known before anything is written, and then each leaf is updated row slice
by row slice: decrypt the slice of mu and nu, apply AdamW, gate, encrypt
under the bumped nonce, and the leaf's new tags are taken over its new
ciphertext.  With ``in_place=True`` the new ciphertext overwrites the old
one and the state passed in is marked consumed: its leaves no longer match
their nonces and tags, and a step from it would put a second plaintext
under the next nonce's keystream, so unsealing it raises
``ConsumedSealedTensor`` (a restart must restore a checkpoint; see
``Supervisor.save_at_start``).  The default writes new tensors and leaves
the state passed in intact.

The batch may itself arrive sealed (Rule 1 ingestion); gradient cross-pod
reduction goes through ``grad_hook`` (``parallel.collectives``), which seals
the payloads crossing the pod trust boundary.

A sharded state (``launch/steps.py::train_state_shardings``: every ct and
tags a DTensor holding this rank's block, e.g. from ``elastic_restore``)
takes the same step on every rank of the mesh, FSDP-style: each rank
verifies and decrypts its own blocks (``core/sealed.py``), the plaintext
blocks are all-gathered into whole parameters for the unchanged model
code, and the rank runs its share of the batch (a DTensor batch leaf: its
local block).  The loss is averaged over the ranks, and each f32 gradient
mean over the mesh dims the batch is split on and those along which its
leaf is replicated (``_grad_dims``), so every rank holds the whole mean
gradient; the clip takes its global norm from them, each leaf once.  The
update then runs on the rank's own block, against the block's global CTR
counters, and the new tags cover the row block's whole rows
(``core/sealed.py::tags_of``).  The verdict is the AND over the ranks:
one bad tag anywhere poisons the new state on all of them.  An unsealed
sharded state (security off) takes the same step without the crypto.
"""
from __future__ import annotations

import itertools
import math
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ..core import cipher
from ..core import sealed as sealed_lib
from ..core.channel import poison_unless
from ..core.policy import Protection, SecurityConfig
from ..kernels.ctr_cipher import ops as ctr_ops
from ..kernels import common
from ..models.config import DTYPES
from ..obs.trace import TRACER
from ..optim import AdamW, TrainState

# elements per row slice of the leaf-by-leaf update: 64 MiB of f32, so the
# update's f32 transients stay a few hundred MiB for any leaf
SLICE_ELEMS = 1 << 24


def seal_state(state: TrainState, key, sec: SecurityConfig,
               nonce_base: int = 0) -> TrainState:
    """Seal a TrainState's tensors for device residency (once).

    nonce_base: offset added to every region's nonce lanes — the epoch-bump
    hook for re-sealing after the reseal-count guard (core/sealed.py) spends
    a tree's lane budget.  Callers refreshing must pass a base that clears
    all previously used lanes (e.g. refresh_count << 20).
    """
    if not sec.enabled:
        return state
    nb = int(nonce_base)
    return TrainState(
        step=state.step,
        params=sealed_lib.seal_tree(state.params, key, sec.weights,
                                    nb + (1 << 8)),
        mu=sealed_lib.seal_tree(state.mu, key, sec.grads, nb + (1 << 16)),
        nu=sealed_lib.seal_tree(state.nu, key, sec.grads, nb + (1 << 17)),
    )


def refresh_sealed_state(state: TrainState, key, sec: SecurityConfig,
                         refresh_count: int) -> TrainState:
    """Re-seal a sealed TrainState under fresh nonce lanes (epoch bump).

    Verify + decrypt (raises on tamper — a corrupt state is never
    re-signed), then seal again with a lane base no previous incarnation
    has touched.  ``refresh_count`` MUST strictly increase across calls
    under one key.  Use ``make_refresh_fn`` for the Supervisor wiring."""
    plain = unseal_state_host(state, key, sec)
    return seal_state(plain, key, sec, nonce_base=refresh_count << 20)


def make_refresh_fn(key, sec: SecurityConfig) -> Callable:
    """Supervisor ``refresh_fn`` with the refresh ordinal tracked inside —
    each call re-seals under a strictly fresher nonce-lane base."""
    counter = itertools.count(1)

    def refresh(state: TrainState) -> TrainState:
        return refresh_sealed_state(state, key, sec, next(counter))

    return refresh


def unseal_state_host(state: TrainState, key, sec: SecurityConfig) -> TrainState:
    """Unseal the whole state (e.g. for export); raises on MAC failure."""
    if not sec.enabled:
        return state
    params, ok1 = sealed_lib.unseal_tree(state.params, key)
    mu, ok2 = sealed_lib.unseal_tree(state.mu, key)
    nu, ok3 = sealed_lib.unseal_tree(state.nu, key)
    ok = ok1 & ok2 & ok3
    # a verdict on the meta device (the dry run's) has no value to read
    if ok.device.type != "meta" and not bool(ok):
        raise RuntimeError("sealed train state failed integrity verification")
    return TrainState(step=state.step, params=params, mu=mu, nu=nu)


def _microbatches(batch_stack):
    """A dict of [n_accum, B, ...] leaves, or a sequence of microbatch
    dicts (which may be sealed trees)."""
    if isinstance(batch_stack, dict):
        n = next(iter(batch_stack.values())).shape[0]
        return [{k: v[i] for k, v in batch_stack.items()} for i in range(n)]
    return list(batch_stack)


class _Lattice:
    """A sealed leaf's ciphertext (this rank's block of a DTensor) as its
    [rows, last] counter lattice, with the tensor key of one nonce:
    decrypt / encrypt any row slice against its global counters."""

    def __init__(self, ct, key, nonce: int, spec, blk=None):
        local = ct.to_local() if isinstance(ct, DTensor) else ct
        self.ct2 = local.reshape(-1, local.shape[-1])
        self.plain = spec.protection is Protection.NONE
        self.tkey = (None if self.plain
                     else cipher.derive_tensor_key(key, nonce)[None])
        self.blk = blk

    def xor(self, bits: torch.Tensor, r0: int) -> torch.Tensor:
        if self.plain:
            return bits
        r1 = r0 + bits.shape[0]
        if self.blk is None:
            rows, col0 = torch.arange(r0, r1, dtype=torch.int32,
                                      device=bits.device), 0
        else:
            rows, col0 = self.blk.rows[r0:r1].int(), self.blk.col0
        return ctr_ops.ctr_xor(bits[None], self.tkey, rows[None], col0)[0]


def _reseal_update(opt: AdamW, key, ok, lr, c1, c2, scale, p, g,
                   sp: sealed_lib.SealedTensor, sm: sealed_lib.SealedTensor,
                   sv: sealed_lib.SealedTensor, in_place: bool):
    """Update one leaf row slice by row slice and reseal params, mu and nu
    under their bumped nonces (in place: into the old ciphertext, whose
    SealedTensors are marked consumed first).  Returns the three new
    SealedTensors."""
    olds = (sp, sm, sv)
    if in_place:
        for st in olds:
            st.consumed = True
    blk = (sealed_lib.Block(sp.ct) if isinstance(sp.ct, DTensor)
           else None)
    nonces = [(st.nonce + 1) & common.M32 for st in olds]
    outs = [st.ct if in_place else _like(st.ct) for st in olds]
    read = [_Lattice(st.ct, key, st.nonce, st.spec, blk) for st in (sm, sv)]
    write = [_Lattice(o, key, n, st.spec, blk)
             for o, n, st in zip(outs, nonces, olds)]
    decay = p.dim() >= 2
    last = p.shape[-1] if p.dim() else 1
    p2, g2 = p.reshape(-1, last), g.reshape(-1, last)
    step_rows = max(1, SLICE_ELEMS // last)
    for r0 in range(0, p2.shape[0], step_rows):
        r1 = min(r0 + step_rows, p2.shape[0])
        m, v = (lat.xor(lat.ct2[r0:r1], r0).view(st.dtype)
                for lat, st in zip(read, (sm, sv)))
        gs = (g2[r0:r1].float() * scale).to(g.dtype)
        new = opt.update_leaf(p2[r0:r1], gs, m, v, lr, c1, c2, decay)
        new = poison_unless(ok, list(new))
        for lat, x in zip(write, new):
            bits = x.contiguous().view(lat.ct2.dtype)
            lat.ct2[r0:r1] = lat.xor(bits, r0)
    out = []
    for o, n, st in zip(outs, nonces, olds):
        tags = st.tags
        if st.spec.protection.authenticates:
            tags = sealed_lib.tags_of(o, key, n, st.spec)
        out.append(sealed_lib.SealedTensor(o, tags, n, st.dtype, st.spec))
    return out


def _summed_into(acc: torch.Tensor):
    """A post-accumulate hook that adds a leaf's gradient into ``acc`` and
    drops it, so a backward pass never holds every gradient at once.  The
    gradient takes the accumulator's dtype first (an f32 accumulator adds
    it as it is: the widening is exact, and no f32 copy is made)."""
    def hook(p: torch.Tensor) -> None:
        g = p.grad
        acc.add_(g if acc.dtype == torch.float32 else g.to(acc.dtype))
        p.grad = None
    return hook


def _like(ct):
    """A new buffer for a leaf's ciphertext (a DTensor: for this rank's
    block, in the same placements)."""
    if not isinstance(ct, DTensor):
        return torch.empty_like(ct)
    return sealed_lib.Block(ct).wrap(torch.empty_like(ct.to_local()))


def _mean_over(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """The f32 mean of ``x`` over the ranks along the mesh dims ``dims``
    (all_reduce writes in place)."""
    x = x.float().contiguous()
    for i in dims:
        dist.all_reduce(x, group=mesh.get_group(i))
    return x.div_(math.prod(mesh.size(i) for i in dims))


def _grad_dims(like: DTensor, split: set) -> list:
    """The mesh dims over which a leaf's gradient is averaged: those the
    batch is split on (each rank has a share of it) and those along which
    the leaf's block is replicated (its holders keep equal copies).  Along
    the others a rank's whole gradient is its neighbours', and it keeps
    only its own block of it."""
    mesh = like.device_mesh
    return [i for i, p in enumerate(like.placements) if mesh.size(i) > 1
            and (i in split or not isinstance(p, Shard))]


def _local_batch(batch_stack):
    """(A batch's DTensor leaves as this rank's blocks (its share), the
    mesh dims they are split on)."""
    if not isinstance(batch_stack, dict):
        return batch_stack, set()
    split = {i for v in batch_stack.values() if isinstance(v, DTensor)
             for i, p in enumerate(v.placements) if isinstance(p, Shard)}
    return {k: v.to_local() if isinstance(v, DTensor) else v
            for k, v in batch_stack.items()}, split


def _plain_blocks_update(opt: AdamW, state: TrainState, grads, loss, ok):
    """AdamW on an unsealed sharded state: each rank updates its own block
    of every leaf from the whole mean gradients, clipped by their global
    norm (the sealed update's order, without the crypto)."""
    step0 = state.step
    if isinstance(step0, DTensor):
        step0 = step0.to_local()
    step, lr, c1, c2 = opt.scalars(step0)
    scale, gnorm = opt.clip(grads)
    new = [[], [], []]
    for p, g, m, v in zip(*map(sealed_lib.tree_leaves,
                               (state.params, grads, state.mu, state.nu))):
        gb = (sealed_lib.take_block(g, p).float() * scale).to(g.dtype)
        out = opt.update_leaf(p.to_local(), gb, m.to_local(), v.to_local(),
                              lr, c1, c2, p.dim() >= 2)
        for tree, x, like in zip(new, out, (p, m, v)):
            tree.append(sealed_lib.wrap(x, like.device_mesh, like.placements,
                                        like.shape))
    if isinstance(state.step, DTensor):
        step = sealed_lib.wrap(step, state.step.device_mesh,
                               state.step.placements, ())
    new_state = TrainState(step=step, **{
        f: sealed_lib.tree_unflatten(state.params, leaves)
        for f, leaves in zip(("params", "mu", "nu"), new)})
    return new_state, {"grad_norm": gnorm,
                       "lr": torch.as_tensor(lr, dtype=torch.float32),
                       "loss": loss, "seal_ok": ok}


def make_train_step(model, cfg, opt: AdamW, sec: SecurityConfig, key=None,
                    grad_hook: Callable | None = None,
                    acc_dtype: str = "float32", in_place: bool = False):
    """Build the train step.

    model: family module (``loss(params, cfg, batch)``); opt: AdamW;
    sec: SecurityConfig; key: int32 [2] cipher key (required if
    sec.enabled); grad_hook: optional fn(grads, step) -> grads (the sealed
    cross-pod reduction, ``parallel.collectives.make_crosspod_grad_hook``),
    applied to the float32 means of the accumulated gradients before they
    take the parameter dtype; acc_dtype: the dtype each microbatch's
    gradient is summed in; in_place: reseal into the old ciphertext (see
    the module docstring).  The step takes (state, batch_stack) with
    batch_stack a dict of [n_accum, B, S] tensors, or a list of
    microbatches that may be sealed, and returns (new state, metrics).
    """
    sealed_mode = sec.enabled
    if sealed_mode:
        assert key is not None
    acc_dt = DTYPES[acc_dtype]

    def loss_fn(params, mb):
        if sealed_mode and sealed_lib.is_sealed(next(iter(mb.values()))):
            mb, _ = sealed_lib.unseal_tree(mb, key)
        return model.loss(params, cfg, mb)

    def train_step(state: TrainState, batch_stack):
        dev = state.step.device
        if sealed_mode:
            with TRACER.span("train.unseal", cat="train", device=dev):
                params, ok = sealed_lib.unseal_tree(state.params, key)
        else:
            params = state.params
            ok = torch.ones((), dtype=torch.bool, device=dev)
        sharded = any(isinstance(p, DTensor)
                      for p in sealed_lib.tree_leaves(params))
        if sharded:
            batch_stack, split = _local_batch(batch_stack)
            # each leaf's blocks (its ciphertext's, sealed)
            likes = [st.ct if sealed_mode else st
                     for st in sealed_lib.tree_leaves(state.params)]
            mesh = likes[0].device_mesh
        leaves = [sealed_lib.whole(p).detach().requires_grad_(True)
                  for p in sealed_lib.tree_leaves(params)]
        del params
        ptree = sealed_lib.tree_unflatten(state.params, leaves)
        acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
               for p in leaves]
        hooks = [p.register_post_accumulate_grad_hook(_summed_into(a))
                 for p, a in zip(leaves, acc)]
        l_sum = torch.zeros((), dtype=torch.float32, device=ok.device)
        mbs = _microbatches(batch_stack)
        for mb in mbs:
            with TRACER.span("train.forward", cat="train", device=dev):
                l = loss_fn(ptree, mb)
            with TRACER.span("train.backward", cat="train", device=dev):
                l.backward()
            l_sum = l_sum + l.detach()
        for h in hooks:                  # the hooks hold the accumulators
            h.remove()
        del l, hooks
        n = len(mbs)
        loss = l_sum / n
        if sharded:
            loss = _mean_over(loss, mesh, range(mesh.ndim))
        # the mean over microbatches in f32 (and over the ranks), the hook,
        # then the parameter dtype (the reference's order); leaf by leaf
        # without a hook
        grads = []
        for i, p in enumerate(leaves):
            a, acc[i] = acc[i], None
            g = a.div_(n) if a.dtype == torch.float32 else a.float() / n
            if sharded:
                g = _mean_over(g, mesh, _grad_dims(likes[i], split))
            grads.append(g if grad_hook is not None else g.to(p.dtype))
        if grad_hook is not None:
            grads = sealed_lib.tree_leaves(grad_hook(
                sealed_lib.tree_unflatten(state.params, grads), state.step))
            for i, p in enumerate(leaves):
                grads[i] = grads[i].to(p.dtype)
        leaves = [p.detach() for p in leaves]
        del ptree

        if not sealed_mode and sharded:
            return _plain_blocks_update(opt, state, grads, loss, ok)
        if not sealed_mode:
            plain = TrainState(step=state.step, params=state.params,
                               mu=state.mu, nu=state.nu)
            new_state, metrics = opt.apply(
                plain, sealed_lib.tree_unflatten(state.params, grads))
            metrics.update(loss=loss, seal_ok=ok)
            return new_state, metrics

        # the moments' verification, AdamW and the reseal, leaf by leaf
        with TRACER.span("train.update", cat="train", device=dev):
            mus = sealed_lib.tree_leaves(state.mu)
            nus = sealed_lib.tree_leaves(state.nu)
            # every tag of the moments checks out before anything is written
            ok = torch.stack([ok] + [sealed_lib.verify(st, key)
                                     for st in mus + nus]).all()
            step0 = state.step
            if isinstance(step0, DTensor):
                step0 = step0.to_local()
            if sharded:                      # the AND over the ranks
                ok = sealed_lib.all_ranks_ok(ok)
            step, lr, c1, c2 = opt.scalars(step0)
            scale, gnorm = opt.clip(grads)
            new = [[], [], []]
            sps = sealed_lib.tree_leaves(state.params)
            for i, (sp, sm, sv) in enumerate(zip(sps, mus, nus)):
                p, g = (sealed_lib.take_block(x, sp.ct)
                        for x in (leaves[i], grads[i]))
                leaves[i] = grads[i] = None
                for acc_tree, st in zip(new, _reseal_update(
                        opt, key, ok, lr, c1, c2, scale, p, g, sp, sm, sv,
                        in_place)):
                    acc_tree.append(st)
                p = g = None
        if isinstance(state.step, DTensor):
            step = sealed_lib.wrap(step, state.step.device_mesh,
                                   state.step.placements, ())
        new_state = TrainState(
            step=step,
            params=sealed_lib.tree_unflatten(state.params, new[0]),
            mu=sealed_lib.tree_unflatten(state.mu, new[1]),
            nu=sealed_lib.tree_unflatten(state.nu, new[2]))
        metrics = {"grad_norm": gnorm,
                   "lr": torch.as_tensor(lr, dtype=torch.float32),
                   "loss": loss, "seal_ok": ok}
        return new_state, metrics

    return train_step


def make_eval_step(model, cfg, sec: SecurityConfig, key=None):
    sealed_mode = sec.enabled

    def eval_step(state: TrainState, batch):
        params = state.params
        if sealed_mode:
            params, _ = sealed_lib.unseal_tree(params, key)
        with torch.no_grad():
            return model.loss(params, cfg, batch)

    return eval_step
