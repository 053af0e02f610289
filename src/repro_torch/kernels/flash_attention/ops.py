"""Causal grouped-query attention: the kernel wrappers, their autograd
rule and FLOP formulas.

``flash_attention(q, k, v, base_pos)`` is ``models/layers.py``'s fused
path for bf16 causal attention over a whole sequence or a prefill chunk
(``gqa_attention`` takes it when ``takes`` says the kernel takes the
call).  ``flash_forward`` and ``flash_backward`` wrap a pair of
``torch.library`` custom ops (``repro_torch::flash_forward``,
``repro_torch::flash_backward``), the scans' convention
(``kernels/scan.py``): autograd runs the backward op, a dispatch mode (the
dry run's ``Tally``, ``FlopCounterMode``) sees one op with the causal FLOP
count, and a checkpoint, selective or not, recomputes the forward as one
op.  A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches ``csrc/flash_attention.cu`` on PyTorch's current stream, or
raises; a meta tensor gets empty results of the card's shapes.
``flash_forward.launches`` counts forward calls (one kernel each) and
``flash_backward.launches`` backward calls (three kernels each: D, dK/dV,
dQ); ``meta_launches`` the calls on meta tensors.  The forward writes the
float32 output and the log-sum-exp only when a backward will read them.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import scan
from . import ref

KERNEL_DEVICE = "cuda"     # the device type the kernels run on
HEAD_DIMS = (64, 128)      # head_dim the CUDA kernels take
MAX_GROUP = 16             # query heads per KV head
# FLOPs a visible (query, key) pair and a channel of one head: q k^T and
# P v forward; dP, dV, dK and dQ backward (the recompute of S and the
# split's second products are the kernels' extra work, not counted)
FWD_FLOPS, BWD_FLOPS = 4, 8


def takes(q, k, v) -> bool:
    """Whether the kernels take these operands: bf16 on the card (or on
    the meta device, the dry run's model of the card), q [B, S, H, hd]
    with S > 1 and hd in HEAD_DIMS, k and v [B, T, K, hd] with H = K G and
    G <= MAX_GROUP.  Causality and the absence of a cache-length mask are
    the caller's to check."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        return False
    B, S, H, hd = q.shape
    K = k.shape[2]
    return (q.device.type in (KERNEL_DEVICE, "meta")
            and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and S > 1 and hd in HEAD_DIMS and k.shape[0] == B
            and k.shape[3] == hd and k.shape[1] > 0 and K > 0
            and H % K == 0 and H // K <= MAX_GROUP)


def visible_pairs(S: int, T: int, at_end: bool) -> int:
    """(query, key) pairs of one lane and head that the causal mask keeps:
    queries at 0..S-1 (``at_end`` False: training, base 0) or at T-S..T-1
    (``at_end``: a prefill chunk whose lanes' bases the formula cannot
    read, counted as the last S of T positions, the most they can see)."""
    first = T - S if at_end else 0
    return sum(min(T, first + s + 1) for s in range(S))


def forward_flops(B, S, T, H, hd, at_end) -> int:
    return FWD_FLOPS * hd * H * B * visible_pairs(S, T, at_end)


def backward_flops(B, S, T, H, hd, at_end) -> int:
    return BWD_FLOPS * hd * H * B * visible_pairs(S, T, at_end)


def _dims(q, k, v, base, *_):
    """The formulas' dims from the ops' argument shapes."""
    return q[0], q[1], k[1], q[2], q[3], base is not None


def _saved(q, save: bool):
    """Empty (O float32, log-sum-exp [B, H, S]), or two tensors of no
    entries when there is no backward to read them."""
    B, S, H, _ = q.shape
    if not save:
        return tuple(q.new_empty((0,), dtype=torch.float32) for _ in "ol")
    return (q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty((B, H, S), dtype=torch.float32))


def _ptr(t):
    return None if t is None or t.numel() == 0 else t.data_ptr()


@torch.library.custom_op("repro_torch::flash_forward", mutates_args=())
def _forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                base: Optional[torch.Tensor], save: bool
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (O in q's dtype, O float32, log-sum-exp); the last two empty
    when not ``save``."""
    if q.device.type == "cpu":
        o, o32, lse = ref.forward(q, k, v, base)
        if o is o32:               # float32 operands: outputs alias no other
            o = o.clone()
        return (o, o32, lse) if save else (o, *_saved(q, False))
    B, S, H, hd = q.shape
    q, k, v = scan.on_card(q, k, v)
    o = torch.empty_like(q)
    o32, lse = _saved(q, save)
    scan.launch(flash_forward, "flash_attention", "flash_attn_forward",
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(base),
                 o.data_ptr(), _ptr(o32), _ptr(lse)],
                [B, S, k.shape[1], H, k.shape[2], hd], q.device)
    return o, o32, lse


@_forward_op.register_fake
def _(q, k, v, base, save):
    return (torch.empty_like(q), *_saved(q, save))


@torch.library.custom_op("repro_torch::flash_backward",
                         mutates_args=("dsum",))
def _backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 base: Optional[torch.Tensor], o32: torch.Tensor,
                 lse: torch.Tensor, dout: torch.Tensor, dsum: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dsum: the card's scratch for D (unused on the CPU)."""
    if q.device.type == "cpu":
        dq, dk, dv = ref.backward(q, k, v, base, o32, lse, dout)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    B, S, H, hd = q.shape
    q, k, v = scan.on_card(q, k, v)
    (dout,) = scan.on_card(dout.to(q.dtype))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scan.launch(flash_backward, "flash_attention", "flash_attn_backward",
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(base),
                 o32.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                 dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr()],
                [B, S, k.shape[1], H, k.shape[2], hd], q.device)
    return dq, dk, dv


@_backward_op.register_fake
def _(q, k, v, base, o32, lse, dout, dsum):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup(ctx, inputs, output):
    q, k, v, base, _ = inputs
    ctx.save_for_backward(q, k, v, base, output[1], output[2])
    # the float32 output and log-sum-exp feed only the backward: no zeros
    # are made for their gradients
    ctx.set_materialize_grads(False)


def _backward(ctx, dout, *_):
    q, k, v, base, o32, lse = ctx.saved_tensors
    if dout is None:
        return None, None, None, None, None
    if o32.numel() == 0:
        raise RuntimeError("flash_forward ran with save=False: no float32 "
                           "output or log-sum-exp for the backward")
    dq, dk, dv = flash_backward(q, k, v, base, o32, lse, dout)
    return dq, dk, dv, None, None


_forward_op.register_autograd(_backward, setup_context=_setup)
scan.register_flops(torch.ops.repro_torch.flash_forward, forward_flops,
                    _dims)
scan.register_flops(torch.ops.repro_torch.flash_backward, backward_flops,
                    _dims)


def _check(q, k, v) -> None:
    if q.device.type != "cpu" and not takes(q, k, v):
        raise ValueError(f"the flash kernels do not take q {q.dtype} "
                         f"{tuple(q.shape)} on {q.device}, k {k.dtype} "
                         f"{tuple(k.shape)}")


@scan.counted
def flash_forward(q, k, v, base=None, *, save: bool = True):
    """q [B, S, H, hd], k and v [B, T, K, hd]; base None or int32 [B] (each
    lane's first query position) -> (O in q's dtype, O float32, log-sum-exp
    float32 [B, H, S]); the last two None when not ``save``."""
    _check(q, k, v)
    scan.count_meta(flash_forward, q)
    o, o32, lse = _forward_op(q, k, v, base, save)
    return (o, o32, lse) if save else (o, None, None)


@scan.counted
def flash_backward(q, k, v, base, o32, lse, dout):
    """The forward's inputs, its float32 output and log-sum-exp, and dout
    [B, S, H, hd] -> (dq, dk, dv) in the inputs' dtype."""
    _check(q, k, v)
    scan.count_meta(flash_backward, q)
    B, S, H, _ = q.shape
    dsum = q.new_empty((B, H, S), dtype=torch.float32)
    return _backward_op(q, k, v, base, o32, lse, dout, dsum)


def lane_bases(base_pos, B: int, device):
    """base_pos (an int or a [B] tensor) -> None (every lane at 0) or an
    int32 [B] tensor on ``device``."""
    if isinstance(base_pos, torch.Tensor):
        return base_pos.to(device=device, dtype=torch.int32).reshape(B) \
            .contiguous()
    if int(base_pos) == 0:
        return None
    return torch.full((B,), int(base_pos), dtype=torch.int32, device=device)


def flash_attention(q, k, v, base_pos=0):
    """Causal attention of q [B, S, H, hd] over k, v [B, T, K, hd]: query s
    of lane b sits at position base_pos (+ b's entry) + s and sees keys t
    <= that position.  Differentiable in q, k and v."""
    base = lane_bases(base_pos, q.shape[0], q.device)
    return flash_forward(q, k, v, base,
                         save=scan.records(q, k, v))[0]
