"""Wrappers of the RWKV-6 WKV scan kernels: checks, dispatch by device,
launch counts, autograd and FLOP formulas.

``wkv6_scan`` is the models' entry point: a differentiable scan whose
forward is ``wkv6_forward`` and whose backward is ``wkv6_backward``.  Each
wraps a ``torch.library`` custom op (``repro_torch::wkv6_forward``,
``repro_torch::wkv6_backward``), so that a dispatch mode (the dry run's
``Tally``, ``FlopCounterMode``) sees one op with its FLOP formula, and a
non-reentrant checkpoint, with or without a selective policy, recomputes
it as one op; ``kernels/scan.py`` holds what this and the SSD's wrappers
share.

The decay enters as its log, ``lw`` (w = exp(lw)), so the backward gives
dlw without dividing by a decay that may be 0.  A CPU tensor takes the
plain chunked algorithm (``ref.wkv6_forward_chunked``,
``ref.wkv6_backward_chunked``); a CUDA tensor launches
``csrc/wkv6_scan.cu`` on PyTorch's current stream, or raises: three
kernels a call (the chunks' own parts, the carry across chunks, the
chunks' outputs or gradients), counted as one launch of the wrapper, whose
``last_plan`` then holds the grids the launcher used.  The forward op
always computes the checkpoints, the state before every chunk of
``CHUNK`` (64) tokens, and each chunk's decay; the wrapper returns the
checkpoints only when asked to keep them.  The backward's scratch (the
gradient of every chunk's end state and the chunks' decays) is made by the
wrapper, and du comes back one partial a chunk, which the wrapper sums.
So a tensor on the meta device makes every buffer the card's call makes,
and the dry run counts their bytes; ``<wrapper>.meta_launches`` counts the
call the card would make; ``<wrapper>.launches`` counts real calls only.
"""
from __future__ import annotations

import ctypes

import torch

from .. import scan
from . import ref

CHUNK = ref.CHUNK
HEAD_DIM = 64          # the kernels' head dim (every RWKV-6 config's)
# FLOPs a state entry a token, counted from the per-token equations of
# ref.py (the function's own work, the yardstick of the bound; the
# chunked form does more): the forward's k v^T, u * kv, the add, r's
# contraction and w * S + kv (7); the backward's state recompute (3),
# adjoint update (3) and the four contractions dr, dk, dv, dlw (2 each)
FWD_FLOPS, BWD_FLOPS = 7, 14
# the kernels of one call of each wrapper, in launch order (the names the
# profiler gives them)
FORWARD_KERNELS = ("wkv6_local_kernel<false>", "wkv6_carry_kernel<false>",
                   "wkv6_output_kernel")
BACKWARD_KERNELS = ("wkv6_local_kernel<true>", "wkv6_carry_kernel<true>",
                    "wkv6_grad_kernel")
PLAN_INTS = 10         # kPlanInts of csrc/wkv6_scan.cu


def forward_flops(B: int, S: int, H: int, hd: int) -> int:
    return FWD_FLOPS * B * S * H * hd * hd


def backward_flops(B: int, S: int, H: int, hd: int) -> int:
    return BWD_FLOPS * B * S * H * hd * hd


def _ck_shape(r):
    B, S, H, hd = r.shape
    return (B, ref.n_chunks(S), H, hd, hd)


def _dec(r):
    """The decay across every chunk, a channel: [B, nch, H, hd]."""
    B, S, H, hd = r.shape
    return r.new_empty((B, ref.n_chunks(S), H, hd))


def _launch(wrapper, entry, kernels, tensors, r) -> None:
    """One call of ``entry`` on ``tensors``; ``wrapper.last_plan`` gets the
    threads a block and each kernel's grid the launcher reports having
    used."""
    B, S, H, _ = r.shape
    plan = (ctypes.c_int * PLAN_INTS)()
    scan.launch(wrapper, "wkv6_scan", entry,
                [t.data_ptr() for t in tensors] + [ctypes.addressof(plan)],
                [B, S, H], r.device)
    wrapper.last_plan = {
        "kernels_per_call": len(kernels), "threads": plan[0],
        "grids": {k: list(plan[1 + 3 * i:4 + 3 * i])
                  for i, k in enumerate(kernels)}}


@torch.library.custom_op("repro_torch::wkv6_forward", mutates_args=())
def _forward_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """-> (y, final state, checkpoints, the decay across every chunk)."""
    if r.device.type == "cpu":
        return ref.wkv6_forward_chunked(r, k, v, lw, u, s0)
    r, k, v, lw, u, s0 = scan.on_card(r, k, v, lw, u, s0)
    outs = (torch.empty_like(r), torch.empty_like(s0),
            r.new_empty(_ck_shape(r)), _dec(r))
    _launch(wkv6_forward, "wkv6_forward_launch", FORWARD_KERNELS,
            (r, k, v, lw, u, s0, *outs), r)
    return outs


@_forward_op.register_fake
def _(r, k, v, lw, u, s0):
    return (torch.empty_like(r), torch.empty_like(s0),
            r.new_empty(_ck_shape(r)), _dec(r))


def _grad_shapes(r, ds):
    """Empty (dr, dk, dv, dlw, du one partial a chunk [B, nch, H, hd],
    ds0)."""
    return (*(torch.empty_like(r) for _ in range(4)), _dec(r),
            torch.empty_like(ds))


@torch.library.custom_op("repro_torch::wkv6_backward",
                         mutates_args=("gb", "dec"))
def _backward_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lw: torch.Tensor, u: torch.Tensor, ck: torch.Tensor,
                 dy: torch.Tensor, ds: torch.Tensor, gb: torch.Tensor,
                 dec: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor, torch.Tensor]:
    """gb and dec: the card's scratch (unused on the CPU)."""
    if r.device.type == "cpu":
        return ref.wkv6_backward_chunked(r, k, v, lw, u, ck, dy, ds)
    ins = scan.on_card(r, k, v, lw, u, ck, dy, ds)
    outs = _grad_shapes(r, ds)
    _launch(wkv6_backward, "wkv6_backward_launch", BACKWARD_KERNELS,
            (*ins, *outs, gb, dec), r)
    return outs


@_backward_op.register_fake
def _(r, k, v, lw, u, ck, dy, ds, gb, dec):
    return _grad_shapes(r, ds)


def _grads(r, k, v, lw, u, ck, dy, ds):
    dr, dk, dv, dlw, du, ds0 = wkv6_backward(r, k, v, lw, u, ck, dy, ds)
    return dr, dk, dv, dlw, du.sum(0), ds0


scan.register_autograd(_forward_op, "wkv6_forward", 5, _grads)
scan.register_flops(torch.ops.repro_torch.wkv6_forward, forward_flops,
                    lambda r, *_: r)
scan.register_flops(torch.ops.repro_torch.wkv6_backward, backward_flops,
                    lambda r, *_: r)


def _check(r, k, v, lw, u, state):
    if r.dim() != 4 or r.shape[1] == 0:
        raise ValueError(f"wkv6 takes r, k, v, lw [B, S >= 1, H, hd], got "
                         f"{tuple(r.shape)}")
    B, _, H, hd = r.shape
    for name, t, shape in (("k", k, r.shape), ("v", v, r.shape),
                           ("lw", lw, r.shape), ("u", u, (H, hd)),
                           ("state", state, (B, H, hd, hd))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"wkv6: {name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    scan.check_operands("wkv6", r, (r, k, v, lw, u, state))
    if r.device.type == "cuda" and hd != HEAD_DIM:
        raise ValueError(f"the wkv6 kernels take head dim {HEAD_DIM}, got "
                         f"{hd}")


@scan.counted
def wkv6_forward(r, k, v, lw, u, state, save: bool = False):
    """r, k, v, lw (the log decay): float32 [B, S, H, hd]; u [H, hd]; state
    [B, H, hd, hd] -> (y [B, S, H, hd], final state, checkpoints [B,
    ceil(S / CHUNK), H, hd, hd] when ``save``, else an empty tensor)."""
    _check(r, k, v, lw, u, state)
    scan.count_meta(wkv6_forward, r)
    y, s_out, ck, _ = _forward_op(r, k, v, lw, u, state)
    return y, s_out, ck if save else ck.new_empty((0,))


wkv6_forward.last_plan = None


@scan.counted
def wkv6_backward(r, k, v, lw, u, ck, dy, ds):
    """The forward's inputs and checkpoints, dy and the final state's
    gradient -> (dr, dk, dv, dlw, du per (b, h) [B, H, hd], the initial
    state's gradient)."""
    _check(r, k, v, lw, u, ds)
    if tuple(ck.shape) != _ck_shape(r) or tuple(dy.shape) != tuple(r.shape):
        raise ValueError(f"wkv6_backward: checkpoints {tuple(ck.shape)} or "
                         f"dy {tuple(dy.shape)} do not fit r "
                         f"{tuple(r.shape)}")
    scan.count_meta(wkv6_backward, r)
    # the card's scratch: the gradient of every chunk's end state, the
    # chunks' decays
    dr, dk, dv, dlw, du, ds0 = _backward_op(r, k, v, lw, u, ck, dy, ds,
                                            r.new_empty(_ck_shape(r)),
                                            _dec(r))
    # du's partials, one a chunk, summed in order
    return dr, dk, dv, dlw, du.sum(1), ds0


wkv6_backward.last_plan = None


def wkv6_scan(r, k, v, lw, u, state):
    """The differentiable scan of the log decay ``lw``: -> (y, final
    state).  The forward keeps checkpoints only when autograd records."""
    y, s_out, _ = wkv6_forward(r, k, v, lw, u, state,
                               scan.records(r, k, v, lw, u, state))
    return y, s_out
