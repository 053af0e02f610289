"""Plain torch versions of Mamba-2's SSD scan: the forward and an explicit
backward that follows the kernel's algorithm.

Per (b, h) the state h is float32 [p, N]; B_t and C_t ([B, S, N]) are
shared by every head, and y reads the updated state:

    h_t = a_t h_{t-1} + dtx_t B_t^T
    y_t = h_t C_t

The forward can keep the state before every ``CHUNK``-th token (the
checkpoints, [B, ceil(S / CHUNK), H, p, N]).  The backward starts from
them: it recomputes a chunk's states, then runs G_t = dL/dh_t back through
the chunk, from the final state's incoming gradient, with

    G_t      = a_{t+1} G_{t+1} + dy_t C_t^T
    ddtx_t   = G_t B_t
    dB_t     = sum_h G_t^T dtx_t
    dC_t     = sum_h h_t^T dy_t
    da_t     = sum G_t * h_{t-1}

and the initial state's gradient a_0 G_0.  dB and dC come back per head
([B, S, H, N]); the caller sums them over heads.
"""
from __future__ import annotations

import torch

CHUNK = 8   # tokens between two state checkpoints
# limits of a scan against another summation order (the kernel, the JAX
# package): the outputs within FWD_RTOL of their largest entry plus
# FWD_ATOL, each gradient within GRAD_RTOL of its largest entry (float32
# sums over up to 4096 tokens, kept bounded by the decay)
FWD_RTOL, FWD_ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-4


def n_chunks(seq_len: int) -> int:
    return -(-seq_len // CHUNK)


def ssd_forward_ref(a, dtx, b, c, h0, save: bool = False):
    """a: float32 [B, S, H]; dtx: [B, S, H, p]; b, c: [B, S, N]; h0:
    [B, H, p, N] -> (y [B, S, H, p], final state, checkpoints or an empty
    tensor)."""
    Bsz, S, H, P = dtx.shape
    N = b.shape[-1]
    ys = torch.empty_like(dtx)
    ck = (dtx.new_empty((Bsz, n_chunks(S), H, P, N)) if save
          else dtx.new_empty((0,)))
    h = h0
    for t in range(S):
        if save and t % CHUNK == 0:
            ck[:, t // CHUNK] = h
        h = (a[:, t, :, None, None] * h
             + torch.einsum("bhp,bn->bhpn", dtx[:, t], b[:, t]))
        ys[:, t] = torch.einsum("bhpn,bn->bhp", h, c[:, t])
    return ys, h, ck


def ssd_backward_ref(a, dtx, b, c, ck, dy, dh):
    """The forward's inputs, its checkpoints, dy [B, S, H, p] and the final
    state's gradient dh [B, H, p, N] -> (da [B, S, H], ddtx, dB and dC per
    head [B, S, H, N], the initial state's gradient)."""
    Bsz, S, H, P = dtx.shape
    N = b.shape[-1]
    da = a.new_empty((Bsz, S, H))
    ddtx = torch.empty_like(dtx)
    db = dtx.new_empty((Bsz, S, H, N))
    dc = torch.empty_like(db)
    G = dh.clone()                          # a_{t+1} G_{t+1}
    for ch in reversed(range(n_chunks(S))):
        t0, t1 = ch * CHUNK, min(S, (ch + 1) * CHUNK)
        states = [ck[:, ch]]                # h_{t0-1}, ...
        for t in range(t0, t1 - 1):
            states.append(a[:, t, :, None, None] * states[-1]
                          + torch.einsum("bhp,bn->bhpn", dtx[:, t], b[:, t]))
        for t in reversed(range(t0, t1)):
            prev = states[t - t0]           # h_{t-1}
            h = (a[:, t, :, None, None] * prev
                 + torch.einsum("bhp,bn->bhpn", dtx[:, t], b[:, t]))
            G = G + torch.einsum("bhp,bn->bhpn", dy[:, t], c[:, t])
            ddtx[:, t] = torch.einsum("bhpn,bn->bhp", G, b[:, t])
            db[:, t] = torch.einsum("bhpn,bhp->bhn", G, dtx[:, t])
            dc[:, t] = torch.einsum("bhpn,bhp->bhn", h, dy[:, t])
            da[:, t] = (G * prev).sum((-2, -1))
            G = a[:, t, :, None, None] * G
    return da, ddtx, db, dc, G
