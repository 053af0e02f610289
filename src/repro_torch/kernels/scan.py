"""What the wrappers of the recurrence scans (``wkv6_scan/ops.py``,
``ssd_scan/ops.py``) share: operand checks, the launch on the card, the
launch counts, the autograd rule, the FLOP formulas, and when the forward
keeps checkpoints.

Each scan is a pair of ``torch.library`` custom ops.  The forward op takes
the tensors its backward reads, then the initial state (and, where it
keeps checkpoints only on request, ``save``), and returns (y, final
state, checkpoints, and any scratch it makes); the backward op takes
those tensors, the checkpoints, dy and the final state's gradient.
Nothing here runs at import but the registrations.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build


def counted(fn):
    """Give a wrapper its counts: ``launches`` (kernels launched on the
    card) and ``meta_launches`` (calls on meta tensors, the launches the
    card would make)."""
    fn.launches = 0
    fn.meta_launches = 0
    return fn


def check_operands(name: str, lead: torch.Tensor, tensors) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} runs in float32, got {t.dtype}")
        if t.device != lead.device:
            raise ValueError(f"{name} operands must share one device")
    if lead.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name} runs on cpu or cuda, not {lead.device}")


def count_meta(wrapper, lead: torch.Tensor) -> None:
    if lead.device.type == "meta":
        wrapper.meta_launches += 1


def on_card(*tensors) -> list:
    """Contiguous operands whose addresses are multiples of 16 bytes (the
    kernels stage 16-byte words with cp.async): a copy where needed."""
    out = []
    for t in tensors:
        t = t.contiguous()
        out.append(t.clone() if t.data_ptr() % 16 else t)
    return out


def launch(wrapper, lib: str, entry: str, ptrs, ints,
           device: torch.device) -> None:
    """Call ``entry(*ptrs, *ints, stream)`` of ``lib<lib>.so`` on the
    current stream of ``device``; raise on the CUDA error it returns, else
    count one launch of ``wrapper``."""
    fn = getattr(build.library(lib), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * len(ptrs)
                       + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                           f"cudaError {err}")
    wrapper.launches += 1


def register_autograd(forward_op, name: str, n_saved: int, grads) -> None:
    """The backward of ``forward_op`` (the wrapper ``name``): ``grads(
    *saved, checkpoints, dy, d_final_state)`` gives one gradient a tensor
    input, where ``saved`` are the op's first ``n_saved`` inputs; the
    inputs that are not tensors get None.  A forward that ran with
    save=False kept no checkpoints, and its backward raises."""
    def setup(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:n_saved], output[2])
        ctx.n_flags = sum(not isinstance(x, torch.Tensor) for x in inputs)

    def backward(ctx, dy, ds, *_):
        *saved, ck = ctx.saved_tensors
        if ck.numel() == 0:
            raise RuntimeError(f"{name} ran with save=False: no "
                               f"checkpoints for the backward")
        return (*grads(*saved, ck, dy, ds), *(None,) * ctx.n_flags)

    forward_op.register_autograd(backward, setup_context=setup)


def register_flops(op, flops, dims) -> None:
    """The FLOP formula of ``op``: ``flops(*dims(*shapes of its
    arguments))``, for FlopCounterMode and the dry run's tally."""
    def formula(*shapes, out_shape=None, **kwargs):
        return flops(*dims(*shapes))

    register_flop_formula(op)(formula)


def records(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``: only then does the
    forward keep checkpoints for the backward."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
