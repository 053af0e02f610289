"""Wrappers of Mamba-2's SSD scan kernels: checks, dispatch by device,
launch counts, autograd and FLOP formulas.

``ssd_scan`` is the models' entry point: a differentiable scan whose
forward is ``ssd_forward`` and whose backward is ``ssd_backward``, each a
``torch.library`` custom op (``repro_torch::ssd_forward``,
``repro_torch::ssd_backward``) with a FLOP formula, as in
``kernels/wkv6_scan/ops.py``; ``kernels/scan.py`` holds what the two
share.

The decay enters as its log, ``la`` (a = exp(la)), so the backward gives
dla without dividing by a decay that may be 0.  A CPU tensor takes the
plain chunked algorithm (``ref.ssd_forward_chunked``,
``ref.ssd_backward_chunked``); a CUDA tensor launches ``csrc/ssd_scan.cu``
on PyTorch's current stream, or raises: three kernels a call (the chunks'
own parts, the carry across chunks, the chunks' outputs or gradients),
counted as one launch of the wrapper, whose ``last_plan`` then holds the
grids the launcher used.  The forward op always computes the checkpoints,
the state before every chunk of ``CHUNK`` (64) tokens, and the decay
across every chunk; the wrapper returns the checkpoints only when asked
to keep them.  The backward's scratch (the gradient of every chunk's end
state and the chunks' decays) is made by the wrapper.  So a tensor on the
meta device makes every buffer the card's call makes, and the dry run
counts their bytes; ``<wrapper>.meta_launches`` counts the call the card
would make; ``<wrapper>.launches`` counts real calls only.
"""
from __future__ import annotations

import ctypes

import torch

from .. import scan
from . import ref

CHUNK = ref.CHUNK
MAX_DIM = 64           # the kernels take p <= 64 and N <= 64
# FLOPs a state entry a token, counted from the per-token equations of
# ref.py (the function's own work, the yardstick of the bound; the
# chunked form does more): the forward's dtx B^T, a * h, the add and C's
# contraction (5); the backward's state recompute (3), adjoint update (3)
# and the four contractions ddtx, dB, dC, dla (2 each)
FWD_FLOPS, BWD_FLOPS = 5, 14
# the kernels of one call of each wrapper, in launch order (the names the
# profiler gives them)
FORWARD_KERNELS = ("ssd_local_kernel<false>", "ssd_carry_kernel<false>",
                   "ssd_output_kernel")
BACKWARD_KERNELS = ("ssd_local_kernel<true>", "ssd_carry_kernel<true>",
                    "ssd_grad_kernel")
PLAN_INTS = 11         # kPlanInts of csrc/ssd_scan.cu


def forward_flops(B: int, S: int, H: int, P: int, N: int) -> int:
    return FWD_FLOPS * B * S * H * P * N


def backward_flops(B: int, S: int, H: int, P: int, N: int) -> int:
    return BWD_FLOPS * B * S * H * P * N


def _ck_shape(dtx, N):
    B, S, H, P = dtx.shape
    return (B, ref.n_chunks(S), H, P, N)


def _dec(dtx):
    B, S, H, _ = dtx.shape
    return dtx.new_empty((B, ref.n_chunks(S), H))


def heads_per_block(B: int, S: int, H: int, sms: int) -> int:
    """Heads a block of the chunk kernels walks (it forms B, C and C B^T
    once for them and copies the next head's inputs in while one runs):
    the most of 8, 4, 2 that still gives each of the card's ``sms``
    multiprocessors a block, else 1.  ``tools/ssd_heads_sweep.py`` times
    every choice from decode to 32768 tokens."""
    for g in (8, 4, 2):
        if B * ref.n_chunks(S) * -(-H // g) >= sms:
            return g
    return 1


def _launch(wrapper, entry, kernels, tensors, dtx, N) -> None:
    """One call of ``entry`` on ``tensors``; ``wrapper.last_plan`` gets the
    heads a block, threads a block and each kernel's grid the launcher
    reports having used."""
    B, S, H, P = dtx.shape
    sms = torch.cuda.get_device_properties(dtx.device).multi_processor_count
    plan = (ctypes.c_int * PLAN_INTS)()
    scan.launch(wrapper, "ssd_scan", entry,
                [t.data_ptr() for t in tensors] + [ctypes.addressof(plan)],
                [B, S, H, P, N, heads_per_block(B, S, H, sms)], dtx.device)
    wrapper.last_plan = {
        "kernels_per_call": len(kernels), "heads_per_block": plan[0],
        "threads": plan[1],
        "grids": {k: list(plan[2 + 3 * i:5 + 3 * i])
                  for i, k in enumerate(kernels)}}


@torch.library.custom_op("repro_torch::ssd_forward", mutates_args=())
def _forward_op(la: torch.Tensor, dtx: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, h0: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """-> (y, final state, checkpoints, the decay across every chunk)."""
    if la.device.type == "cpu":
        return ref.ssd_forward_chunked(la, dtx, b, c, h0)
    N = b.shape[-1]
    la, dtx, b, c, h0 = scan.on_card(la, dtx, b, c, h0)
    outs = (torch.empty_like(dtx), torch.empty_like(h0),
            dtx.new_empty(_ck_shape(dtx, N)), _dec(dtx))
    _launch(ssd_forward, "ssd_forward_launch", FORWARD_KERNELS,
            (la, dtx, b, c, h0, *outs), dtx, N)
    return outs


@_forward_op.register_fake
def _(la, dtx, b, c, h0):
    return (torch.empty_like(dtx), torch.empty_like(h0),
            dtx.new_empty(_ck_shape(dtx, b.shape[-1])), _dec(dtx))


def _grad_shapes(la, dtx, b, dh):
    """Empty (dla, ddtx, dB and dC per head [B, S, H, N], dh0)."""
    B, S, H, _ = dtx.shape
    db = dtx.new_empty((B, S, H, b.shape[-1]))
    return (torch.empty_like(la), torch.empty_like(dtx), db,
            torch.empty_like(db), torch.empty_like(dh))


@torch.library.custom_op("repro_torch::ssd_backward",
                         mutates_args=("gb", "dec"))
def _backward_op(la: torch.Tensor, dtx: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, ck: torch.Tensor, dy: torch.Tensor,
                 dh: torch.Tensor, gb: torch.Tensor, dec: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """gb and dec: the card's scratch (unused on the CPU)."""
    if la.device.type == "cpu":
        return ref.ssd_backward_chunked(la, dtx, b, c, ck, dy, dh)
    ins = scan.on_card(la, dtx, b, c, ck, dy, dh)
    outs = _grad_shapes(la, dtx, b, dh)
    _launch(ssd_backward, "ssd_backward_launch", BACKWARD_KERNELS,
            (*ins, *outs, gb, dec), dtx, b.shape[-1])
    return outs


@_backward_op.register_fake
def _(la, dtx, b, c, ck, dy, dh, gb, dec):
    return _grad_shapes(la, dtx, b, dh)


def _grads(la, dtx, b, c, ck, dy, dh):
    dla, ddtx, db, dc, dh0 = ssd_backward(la, dtx, b, c, ck, dy, dh)
    return dla, ddtx, db.sum(2), dc.sum(2), dh0


def _dims(la, dtx, b, *_):
    return (*dtx, b[-1])


scan.register_autograd(_forward_op, "ssd_forward", 4, _grads)
scan.register_flops(torch.ops.repro_torch.ssd_forward, forward_flops, _dims)
scan.register_flops(torch.ops.repro_torch.ssd_backward, backward_flops,
                    _dims)


def _check(la, dtx, b, c, state):
    if dtx.dim() != 4 or dtx.shape[1] == 0:
        raise ValueError(f"ssd takes dtx [B, S >= 1, H, p], got "
                         f"{tuple(dtx.shape)}")
    B, S, H, P = dtx.shape
    N = b.shape[-1]
    for name, t, shape in (("la", la, (B, S, H)), ("b", b, (B, S, N)),
                           ("c", c, (B, S, N)),
                           ("state", state, (B, H, P, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    scan.check_operands("ssd", dtx, (la, dtx, b, c, state))
    if dtx.device.type == "cuda" and (P > MAX_DIM or N > MAX_DIM):
        raise ValueError(f"the ssd kernels take p and N up to {MAX_DIM}, got "
                         f"{P} and {N}")


@scan.counted
def ssd_forward(la, dtx, b, c, state, save: bool = False):
    """la (the log decay): float32 [B, S, H]; dtx [B, S, H, p]; b, c [B,
    S, N]; state [B, H, p, N] -> (y [B, S, H, p], final state, checkpoints
    [B, ceil(S / CHUNK), H, p, N] when ``save``, else an empty tensor)."""
    _check(la, dtx, b, c, state)
    scan.count_meta(ssd_forward, dtx)
    y, h_out, ck, _ = _forward_op(la, dtx, b, c, state)
    return y, h_out, ck if save else ck.new_empty((0,))


ssd_forward.last_plan = None


@scan.counted
def ssd_backward(la, dtx, b, c, ck, dy, dh):
    """The forward's inputs and checkpoints, dy and the final state's
    gradient -> (dla, ddtx, dB and dC per head [B, S, H, N], the initial
    state's gradient)."""
    _check(la, dtx, b, c, dh)
    if tuple(ck.shape) != _ck_shape(dtx, b.shape[-1]) \
            or tuple(dy.shape) != tuple(dtx.shape):
        raise ValueError(f"ssd_backward: checkpoints {tuple(ck.shape)} or dy "
                         f"{tuple(dy.shape)} do not fit dtx "
                         f"{tuple(dtx.shape)}")
    scan.count_meta(ssd_backward, dtx)
    # the card's scratch: the gradient of every chunk's end state, the
    # chunks' decays
    return _backward_op(la, dtx, b, c, ck, dy, dh,
                        dtx.new_empty(_ck_shape(dtx, b.shape[-1])), _dec(dtx))


ssd_backward.last_plan = None


def ssd_scan(la, dtx, b, c, state):
    """The differentiable scan of the log decay ``la``: -> (y, final
    state).  The forward keeps checkpoints only when autograd records."""
    y, h_out, _ = ssd_forward(la, dtx, b, c, state,
                              scan.records(la, dtx, b, c, state))
    return y, h_out
