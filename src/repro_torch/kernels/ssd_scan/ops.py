"""Wrappers of Mamba-2's SSD scan kernels: checks, dispatch by device,
launch counts, autograd and FLOP formulas.

``ssd_scan`` is the models' entry point: a differentiable scan whose
forward is ``ssd_forward`` and whose backward is ``ssd_backward``, each a
``torch.library`` custom op (``repro_torch::ssd_forward``,
``repro_torch::ssd_backward``) with a FLOP formula, as in
``kernels/wkv6_scan/ops.py``; ``kernels/scan.py`` holds what the two
share.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
``csrc/ssd_scan.cu`` on PyTorch's current stream, or raises.  A tensor on
the meta device gets outputs of the right shapes (the checkpoints and the
per-head dB, dC partials included) and ``<wrapper>.meta_launches`` counts
the launch the card would make; ``<wrapper>.launches`` counts real
launches only.
"""
from __future__ import annotations

import torch

from .. import scan
from . import ref

CHUNK = ref.CHUNK
MAX_DIM = 64           # the kernels take p <= 64 and N <= 64
# FLOPs a state entry a token, counted from ref.py's equations: the
# forward's dtx B^T, a * h, the add and C's contraction (5); the
# backward's state recompute (3), adjoint update (3) and the four
# contractions ddtx, dB, dC, da (2 each)
FWD_FLOPS, BWD_FLOPS = 5, 14


def forward_flops(B: int, S: int, H: int, P: int, N: int) -> int:
    return FWD_FLOPS * B * S * H * P * N


def backward_flops(B: int, S: int, H: int, P: int, N: int) -> int:
    return BWD_FLOPS * B * S * H * P * N


def _ck_shape(dtx, N):
    B, S, H, P = dtx.shape
    return (B, ref.n_chunks(S), H, P, N)


@torch.library.custom_op("repro_torch::ssd_forward", mutates_args=())
def _forward_op(a: torch.Tensor, dtx: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, h0: torch.Tensor, save: bool
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if a.device.type == "cpu":
        return ref.ssd_forward_ref(a, dtx, b, c, h0, save)
    B, S, H, P = dtx.shape
    N = b.shape[-1]
    a, dtx, b, c, h0 = scan.on_card(a, dtx, b, c, h0)
    y, h_out = torch.empty_like(dtx), torch.empty_like(h0)
    ck = dtx.new_empty(_ck_shape(dtx, N) if save else (0,))
    scan.launch(ssd_forward, "ssd_scan", "ssd_forward_launch",
                [t.data_ptr() for t in (a, dtx, b, c, h0, y, h_out)]
                + [ck.data_ptr() if save else None], [B, S, H, P, N],
                a.device)
    return y, h_out, ck


@_forward_op.register_fake
def _(a, dtx, b, c, h0, save):
    ck = dtx.new_empty(_ck_shape(dtx, b.shape[-1]) if save else (0,))
    return torch.empty_like(dtx), torch.empty_like(h0), ck


def _grad_shapes(a, dtx, b, dh):
    """Empty (da, ddtx, dB and dC per head [B, S, H, N], dh0)."""
    B, S, H, _ = dtx.shape
    db = dtx.new_empty((B, S, H, b.shape[-1]))
    return (torch.empty_like(a), torch.empty_like(dtx), db,
            torch.empty_like(db), torch.empty_like(dh))


@torch.library.custom_op("repro_torch::ssd_backward", mutates_args=())
def _backward_op(a: torch.Tensor, dtx: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, ck: torch.Tensor, dy: torch.Tensor,
                 dh: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    if a.device.type == "cpu":
        return ref.ssd_backward_ref(a, dtx, b, c, ck, dy, dh)
    B, S, H, P = dtx.shape
    ins = scan.on_card(a, dtx, b, c, ck, dy, dh)
    outs = _grad_shapes(a, dtx, b, dh)
    scan.launch(ssd_backward, "ssd_scan", "ssd_backward_launch",
                [t.data_ptr() for t in (*ins, *outs)],
                [B, S, H, P, b.shape[-1]], a.device)
    return outs


@_backward_op.register_fake
def _(a, dtx, b, c, ck, dy, dh):
    return _grad_shapes(a, dtx, b, dh)


def _grads(a, dtx, b, c, ck, dy, dh):
    da, ddtx, db, dc, dh0 = ssd_backward(a, dtx, b, c, ck, dy, dh)
    return da, ddtx, db.sum(2), dc.sum(2), dh0


def _dims(a, dtx, b, *_):
    return (*dtx, b[-1])


scan.register_autograd(_forward_op, "ssd_forward", 4, _grads)
scan.register_flops(torch.ops.repro_torch.ssd_forward, forward_flops, _dims)
scan.register_flops(torch.ops.repro_torch.ssd_backward, backward_flops,
                    _dims)


def _check(a, dtx, b, c, state):
    if dtx.dim() != 4 or dtx.shape[1] == 0:
        raise ValueError(f"ssd takes dtx [B, S >= 1, H, p], got "
                         f"{tuple(dtx.shape)}")
    B, S, H, P = dtx.shape
    N = b.shape[-1]
    for name, t, shape in (("a", a, (B, S, H)), ("b", b, (B, S, N)),
                           ("c", c, (B, S, N)),
                           ("state", state, (B, H, P, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    scan.check_operands("ssd", dtx, (a, dtx, b, c, state))
    if dtx.device.type == "cuda" and (P > MAX_DIM or N > MAX_DIM):
        raise ValueError(f"the ssd kernels take p and N up to {MAX_DIM}, got "
                         f"{P} and {N}")


@scan.counted
def ssd_forward(a, dtx, b, c, state, save: bool = False):
    """a: float32 [B, S, H]; dtx [B, S, H, p]; b, c [B, S, N]; state
    [B, H, p, N] -> (y [B, S, H, p], final state, checkpoints [B,
    ceil(S / CHUNK), H, p, N] when ``save``, else an empty tensor)."""
    _check(a, dtx, b, c, state)
    scan.count_meta(ssd_forward, dtx)
    return _forward_op(a, dtx, b, c, state, save)


@scan.counted
def ssd_backward(a, dtx, b, c, ck, dy, dh):
    """The forward's inputs and checkpoints, dy and the final state's
    gradient -> (da, ddtx, dB and dC per head [B, S, H, N], the initial
    state's gradient)."""
    _check(a, dtx, b, c, dh)
    if tuple(ck.shape) != _ck_shape(dtx, b.shape[-1]) \
            or tuple(dy.shape) != tuple(dtx.shape):
        raise ValueError(f"ssd_backward: checkpoints {tuple(ck.shape)} or dy "
                         f"{tuple(dy.shape)} do not fit dtx "
                         f"{tuple(dtx.shape)}")
    scan.count_meta(ssd_backward, dtx)
    return _backward_op(a, dtx, b, c, ck, dy, dh)


def ssd_scan(a, dtx, b, c, state):
    """The differentiable scan: -> (y, final state).  The forward keeps
    checkpoints only when autograd records."""
    y, h_out, _ = ssd_forward(a, dtx, b, c, state,
                              scan.records(a, dtx, b, c, state))
    return y, h_out
