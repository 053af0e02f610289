"""Wrappers of the RWKV-6 WKV scan kernels: checks, dispatch by device,
launch counts, autograd and FLOP formulas.

``wkv6_scan`` is the models' entry point: a differentiable scan whose
forward is ``wkv6_forward`` and whose backward is ``wkv6_backward``.  Each
wraps a ``torch.library`` custom op (``repro_torch::wkv6_forward``,
``repro_torch::wkv6_backward``), so that a dispatch mode (the dry run's
``Tally``, ``FlopCounterMode``) sees one op with its FLOP formula, and a
non-reentrant checkpoint, with or without a selective policy, recomputes
it as one op.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
``csrc/wkv6_scan.cu`` on PyTorch's current stream, or raises
(``kernels/scan.py`` holds what the two scans' wrappers share).  A tensor on
the meta device (the dry run) gets outputs of the right shapes, the
checkpoints included, and ``<wrapper>.meta_launches`` counts the launch
the card would make; ``<wrapper>.launches`` counts real launches only.
"""
from __future__ import annotations

import torch

from .. import scan
from . import ref

CHUNK = ref.CHUNK
HEAD_DIM = 64          # the kernels' head dim (every RWKV-6 config's)
# FLOPs a state entry a token, counted from ref.py's equations: the
# forward's k v^T, u * kv, the add, r's contraction and w * S + kv (7);
# the backward's state recompute (3), adjoint update (3) and the four
# contractions dr, dk, dv, dw (2 each)
FWD_FLOPS, BWD_FLOPS = 7, 14


def forward_flops(B: int, S: int, H: int, hd: int) -> int:
    return FWD_FLOPS * B * S * H * hd * hd


def backward_flops(B: int, S: int, H: int, hd: int) -> int:
    return BWD_FLOPS * B * S * H * hd * hd


def _ck_shape(r):
    B, S, H, hd = r.shape
    return (B, ref.n_chunks(S), H, hd, hd)


@torch.library.custom_op("repro_torch::wkv6_forward", mutates_args=())
def _forward_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                save: bool) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    if r.device.type == "cpu":
        return ref.wkv6_forward_ref(r, k, v, w, u, s0, save)
    B, S, H, _ = r.shape
    r, k, v, w, u, s0 = scan.on_card(r, k, v, w, u, s0)
    y, s_out = torch.empty_like(r), torch.empty_like(s0)
    ck = r.new_empty(_ck_shape(r) if save else (0,))
    scan.launch(wkv6_forward, "wkv6_scan", "wkv6_forward_launch",
                [t.data_ptr() for t in (r, k, v, w, u, s0, y, s_out)]
                + [ck.data_ptr() if save else None], [B, S, H], r.device)
    return y, s_out, ck


@_forward_op.register_fake
def _(r, k, v, w, u, s0, save):
    ck = r.new_empty(_ck_shape(r) if save else (0,))
    return torch.empty_like(r), torch.empty_like(s0), ck


@torch.library.custom_op("repro_torch::wkv6_backward", mutates_args=())
def _backward_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, ck: torch.Tensor,
                 dy: torch.Tensor, ds: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor, torch.Tensor]:
    if r.device.type == "cpu":
        return ref.wkv6_backward_ref(r, k, v, w, u, ck, dy, ds)
    B, S, H, hd = r.shape
    ins = scan.on_card(r, k, v, w, u, ck, dy, ds)
    outs = (*(torch.empty_like(r) for _ in range(4)),
            r.new_empty((B, H, hd)), torch.empty_like(ds))
    scan.launch(wkv6_backward, "wkv6_scan", "wkv6_backward_launch",
                [t.data_ptr() for t in (*ins, *outs)], [B, S, H], r.device)
    return outs


@_backward_op.register_fake
def _(r, k, v, w, u, ck, dy, ds):
    B, S, H, hd = r.shape
    return (*(torch.empty_like(r) for _ in range(4)),
            r.new_empty((B, H, hd)), torch.empty_like(ds))


def _grads(r, k, v, w, u, ck, dy, ds):
    dr, dk, dv, dw, du, ds0 = wkv6_backward(r, k, v, w, u, ck, dy, ds)
    return dr, dk, dv, dw, du.sum(0), ds0


scan.register_autograd(_forward_op, "wkv6_forward", 5, _grads)
scan.register_flops(torch.ops.repro_torch.wkv6_forward, forward_flops,
                    lambda r, *_: r)
scan.register_flops(torch.ops.repro_torch.wkv6_backward, backward_flops,
                    lambda r, *_: r)


def _check(r, k, v, w, u, state):
    if r.dim() != 4 or r.shape[1] == 0:
        raise ValueError(f"wkv6 takes r, k, v, w [B, S >= 1, H, hd], got "
                         f"{tuple(r.shape)}")
    B, _, H, hd = r.shape
    for name, t, shape in (("k", k, r.shape), ("v", v, r.shape),
                           ("w", w, r.shape), ("u", u, (H, hd)),
                           ("state", state, (B, H, hd, hd))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"wkv6: {name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    scan.check_operands("wkv6", r, (r, k, v, w, u, state))
    if r.device.type == "cuda" and hd != HEAD_DIM:
        raise ValueError(f"the wkv6 kernels take head dim {HEAD_DIM}, got "
                         f"{hd}")


@scan.counted
def wkv6_forward(r, k, v, w, u, state, save: bool = False):
    """r, k, v, w: float32 [B, S, H, hd]; u [H, hd]; state [B, H, hd, hd]
    -> (y [B, S, H, hd], final state, checkpoints [B, ceil(S / CHUNK), H,
    hd, hd] when ``save``, else an empty tensor)."""
    _check(r, k, v, w, u, state)
    scan.count_meta(wkv6_forward, r)
    return _forward_op(r, k, v, w, u, state, save)


@scan.counted
def wkv6_backward(r, k, v, w, u, ck, dy, ds):
    """The forward's inputs and checkpoints, dy and the final state's
    gradient -> (dr, dk, dv, dw, du per (b, h) [B, H, hd], the initial
    state's gradient)."""
    _check(r, k, v, w, u, ds)
    if tuple(ck.shape) != _ck_shape(r) or tuple(dy.shape) != tuple(r.shape):
        raise ValueError(f"wkv6_backward: checkpoints {tuple(ck.shape)} or "
                         f"dy {tuple(dy.shape)} do not fit r "
                         f"{tuple(r.shape)}")
    scan.count_meta(wkv6_backward, r)
    return _backward_op(r, k, v, w, u, ck, dy, ds)


def wkv6_scan(r, k, v, w, u, state):
    """The differentiable scan: -> (y, final state).  The forward keeps
    checkpoints only when autograd records."""
    y, s_out, _ = wkv6_forward(r, k, v, w, u, state,
                               scan.records(r, k, v, w, u, state))
    return y, s_out
