"""The yardstick: the card's published peaks and the operation and byte
counts that rooflines and model FLOP utilisation are taken against.

Frozen copies of the arithmetic the port's chip smoke run used
(``bound_of``, the CTR and MAC operation counts), so that a later change
to the program cannot move the yardstick it is measured with.  A model's
own counts (the parameters that multiply a token, its attention layers)
come from its family's file, ``bench/families/<family>.py``.
"""
from __future__ import annotations

# H100 SXM, NVIDIA's data sheet (dense rates, 700 W): HBM3 bandwidth, bf16
# on the tensor cores, float32 outside them, and 32-bit integer operations
# at 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# ALU-pipe operations a Threefry-2x32 block (8 bytes of keystream) and a
# MAC word (4 bytes) must issue: 20 rotates, 20 XORs and the 2 data XORs
# of a block; the folds, +1 and 64-bit adds of a word (the adds and the
# 64-bit product can issue on the FMA pipe beside them).
CTR_ALU_OPS_PER_BLOCK = 42
MAC_ALU_OPS_PER_WORD = 14

def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """Least seconds of a kernel: its bytes at the HBM rate or its
    operations at ``ops_per_s``, whichever is slower."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def ctr_bound_s(ct_bytes: float) -> float:
    """Least seconds to XOR ``ct_bytes`` with the keystream: each byte
    read once and written once, a Threefry block per 8 bytes."""
    return bound_s(2 * ct_bytes, ct_bytes / 8 * CTR_ALU_OPS_PER_BLOCK,
                   INT32_OPS_PER_S)


def mac_bound_s(ct_bytes: float) -> float:
    """Least seconds to tag ``ct_bytes``: each byte read once (the tags
    written are a 1/cw share and left out), a MAC word per 4 bytes."""
    return bound_s(ct_bytes, ct_bytes / 4 * MAC_ALU_OPS_PER_WORD,
                   INT32_OPS_PER_S)


# ---------------------------------------------------------------------------
# model FLOPs (a multiply-add counts 2)
# ---------------------------------------------------------------------------

def matmul_params(sz) -> int:
    """Parameters that multiply each token once in a forward pass."""
    return sz.fam.matmul_params(sz)


def attention_flops(sz, q_len: int, ctx_start: int) -> float:
    """Forward FLOPs of causal attention for ``q_len`` queries at positions
    ctx_start .. ctx_start + q_len - 1, each against the keys up to its own
    position: QK^T and PV, 2 * 2 * hd FLOPs per head per (query, key)."""
    keys = q_len * ctx_start + q_len * (q_len + 1) / 2
    return 4.0 * sz.n_heads * sz.hd * keys * sz.fam.attention_layers(sz)


def forward_flops(sz, q_len: int, ctx_start: int = 0) -> float:
    """Model FLOPs of one sequence's forward over ``q_len`` new tokens
    after ``ctx_start`` cached ones: 2N per token plus attention, plus what
    the family's file counts beside them (``extra_forward_flops``, such as
    a scan's, where it has one)."""
    extra = getattr(sz.fam, "extra_forward_flops", None)
    return (2.0 * matmul_params(sz) * q_len
            + attention_flops(sz, q_len, ctx_start)
            + (extra(sz, q_len) if extra else 0.0))


def train_flops(sz, seq_len: int) -> float:
    """Model FLOPs of one sequence's forward and backward: three times the
    forward (6N per token plus attention), recomputation not counted."""
    return 3.0 * forward_flops(sz, seq_len)
