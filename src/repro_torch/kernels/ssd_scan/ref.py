"""Plain torch versions of Mamba-2's SSD scan: the per-token loop with its
checkpointed backward, and the kernels' chunked algorithm.

Per (b, h) the state h is float32 [p, N]; B_t and C_t ([B, S, N]) are
shared by every head; the decay is given by its log, la_t (a_t =
exp(la_t), 0 where la_t <= -104 underflows); y reads the updated state:

    h_t = a_t h_{t-1} + dtx_t B_t^T
    y_t = h_t C_t

The per-token forward keeps on request, and the chunked one always
returns, the state before every ``CHUNK``-th token (the checkpoints, [B,
ceil(S / CHUNK), H, p, N]).

The per-token loop (``ssd_forward_ref``, ``ssd_backward_ref``) is the
yardstick the kernels are held to.  Its backward starts from the
checkpoints: it recomputes a chunk's states, then runs G_t = dL/dh_t back
through the chunk, from the final state's incoming gradient, with

    G_t      = a_{t+1} G_{t+1} + dy_t C_t^T
    ddtx_t   = G_t B_t
    dB_t     = sum_h G_t^T dtx_t
    dC_t     = sum_h h_t^T dy_t
    dla_t    = a_t sum G_t * h_{t-1}

and the initial state's gradient a_0 G_0.

The chunked form (``ssd_forward_chunked``, ``ssd_backward_chunked``) is
``csrc/ssd_scan.cu``'s algorithm, which the ops run for CPU tensors.  In a
chunk of CHUNK tokens, seg[t, s] = la_{s+1} + ... + la_t is a masked
running sum (never a difference of two cumulative sums), M[t, s] =
exp(seg[t, s]) on and below the diagonal, E_t = exp(la_0 + ... + la_t),
w_s = M[-1, s]; with X the chunk's dtx and h0 the state before it:

    Y        = (M o C B^T) X + diag(E) C h0^T
    h_end    = E_end h0 + X^T diag(w) B
    G_before = E_end G + dY^T diag(E) C           (G: dL/dh_end)
    ddtx     = (M o C B^T)^T dY + diag(w) B G^T
    dB       = (M o D)^T C + diag(w) X G          (D = dY X^T)
    dC       = diag(E) dY h0 + (M o D) B
    dla_r    = sum over t >= r > s of dL/dseg[t, s]   (s = -1: the start)

with no division, so a decay of 0 is exact.  dB and dC come back per head
([B, S, H, N]); the caller sums them over heads.
"""
from __future__ import annotations

import torch

CHUNK = 64   # tokens a chunk of the kernels, and between two checkpoints
# limits of a scan against another summation order (the kernel, the JAX
# package): the outputs within FWD_RTOL of their largest entry plus
# FWD_ATOL, each gradient within GRAD_RTOL of its largest entry (float32
# sums over up to 4096 tokens, kept bounded by the decay)
FWD_RTOL, FWD_ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-4


def n_chunks(seq_len: int) -> int:
    return -(-seq_len // CHUNK)


def _outer(x, b):
    return torch.einsum("bhp,bn->bhpn", x, b)


def ssd_forward_ref(la, dtx, b, c, h0, save: bool = False):
    """la: float32 [B, S, H]; dtx: [B, S, H, p]; b, c: [B, S, N]; h0:
    [B, H, p, N] -> (y [B, S, H, p], final state, checkpoints or an empty
    tensor), token by token."""
    Bsz, S, H, P = dtx.shape
    N = b.shape[-1]
    a = torch.exp(la)
    ys = torch.empty_like(dtx)
    ck = (dtx.new_empty((Bsz, n_chunks(S), H, P, N)) if save
          else dtx.new_empty((0,)))
    h = h0
    for t in range(S):
        if save and t % CHUNK == 0:
            ck[:, t // CHUNK] = h
        h = a[:, t, :, None, None] * h + _outer(dtx[:, t], b[:, t])
        ys[:, t] = torch.einsum("bhpn,bn->bhp", h, c[:, t])
    return ys, h, ck


def ssd_backward_ref(la, dtx, b, c, ck, dy, dh):
    """The forward's inputs, its checkpoints, dy [B, S, H, p] and the final
    state's gradient dh [B, H, p, N] -> (dla [B, S, H], ddtx, dB and dC per
    head [B, S, H, N], the initial state's gradient), token by token."""
    Bsz, S, H, P = dtx.shape
    N = b.shape[-1]
    a = torch.exp(la)
    dla = la.new_empty((Bsz, S, H))
    ddtx = torch.empty_like(dtx)
    db = dtx.new_empty((Bsz, S, H, N))
    dc = torch.empty_like(db)
    G = dh.clone()                          # a_{t+1} G_{t+1}
    for ch in reversed(range(n_chunks(S))):
        t0, t1 = ch * CHUNK, min(S, (ch + 1) * CHUNK)
        states = [ck[:, ch]]                # h_{t0-1}, ...
        for t in range(t0, t1 - 1):
            states.append(a[:, t, :, None, None] * states[-1]
                          + _outer(dtx[:, t], b[:, t]))
        for t in reversed(range(t0, t1)):
            prev = states[t - t0]           # h_{t-1}
            h = a[:, t, :, None, None] * prev + _outer(dtx[:, t], b[:, t])
            G = G + _outer(dy[:, t], c[:, t])
            ddtx[:, t] = torch.einsum("bhpn,bn->bhp", G, b[:, t])
            db[:, t] = torch.einsum("bhpn,bhp->bhn", G, dtx[:, t])
            dc[:, t] = torch.einsum("bhpn,bhp->bhn", h, dy[:, t])
            dla[:, t] = a[:, t] * (G * prev).sum((-2, -1))
            G = a[:, t, :, None, None] * G
    return dla, ddtx, db, dc, G


def _chunks(x, S):
    """[B, S, ...] -> [B, nch, CHUNK, ...], zeros past S."""
    pad = n_chunks(S) * CHUNK - S
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)
    return x.reshape((x.shape[0], -1, CHUNK) + x.shape[2:])


def _unchunk(x, S):
    """[B, nch, CHUNK, ...] -> [B, S, ...]."""
    return x.reshape((x.shape[0], -1) + x.shape[3:])[:, :S]


def _decays(la, S):
    """la [B, S, H] -> (M [B, nch, H, t, s], E [B, nch, H, t], w [B, nch,
    H, s]): M[t, s] = exp(la_{s+1} + ... + la_t) for s <= t, else 0, each
    column s a running sum of the terms past s; E_t = exp(la_0 + ... +
    la_t); w_s = M[-1, s].  Tokens past S have la 0."""
    lc = _chunks(la, S).permute(0, 1, 3, 2)               # [B, nch, H, r]
    r = torch.arange(CHUNK)
    past = (r[None, :] > r[:, None]).to(la.device)        # [s, r]: r > s
    terms = torch.where(past, lc[..., None, :], lc.new_zeros(()))
    seg = torch.cumsum(terms, -1)                        # [.., s, t]
    M = torch.where(past.T | torch.eye(CHUNK, dtype=torch.bool,
                                       device=la.device),
                    torch.exp(seg).transpose(-1, -2), lc.new_zeros(()))
    E = torch.exp(torch.cumsum(lc, -1))
    return M, E, M[..., -1, :]


def _carry(start, local, decay, reverse: bool):
    """states[c] = the carried value before chunk c (walking backward when
    ``reverse``): start, then decay[c] * it + local[c] at each step.
    start [B, H, p, N]; local [B, nch, H, p, N]; decay [B, nch, H].
    Returns (states [B, nch, H, p, N], the last value)."""
    nch = local.shape[1]
    states = torch.empty_like(local)
    st = start
    for k in range(nch):
        c = nch - 1 - k if reverse else k
        states[:, c] = st
        st = decay[:, c, :, None, None] * st + local[:, c]
    return states, st


def ssd_forward_chunked(la, dtx, b, c, h0):
    """``ssd_forward_ref``'s function by the kernels' chunked algorithm:
    -> (y, final state, the checkpoints, the decay across every chunk [B,
    ceil(S / CHUNK), H]), what the forward kernels leave."""
    S = dtx.shape[1]
    M, E, w = _decays(la, S)
    X, Bc, Cc = _chunks(dtx, S), _chunks(b, S), _chunks(c, S)
    local = torch.einsum("bchs,bcshp,bcsn->bchpn", w, X, Bc)
    states, h_out = _carry(h0, local, E[..., -1], reverse=False)
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    y = (torch.einsum("bchts,bcts,bcshp->bcthp", M, cb, X)
         + torch.einsum("bcht,bctn,bchpn->bcthp", E, Cc, states))
    return _unchunk(y, S), h_out, states, E[..., -1]


def ssd_backward_chunked(la, dtx, b, c, ck, dy, dh):
    """``ssd_backward_ref``'s function by the kernels' chunked algorithm,
    from the same checkpoints."""
    S = dtx.shape[1]
    M, E, w = _decays(la, S)
    X, Bc, Cc, dY = (_chunks(t, S) for t in (dtx, b, c, dy))
    local = torch.einsum("bcht,bcthp,bctn->bchpn", E, dY, Cc)
    G, dh0 = _carry(dh, local, E[..., -1], reverse=True)  # G: end of chunk
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    A = M * cb[:, :, None]                                # [B, nch, H, t, s]
    MD = M * torch.einsum("bcthp,bcshp->bchts", dY, X)
    ddtx = (torch.einsum("bchts,bcthp->bcshp", A, dY)
            + torch.einsum("bchs,bcsn,bchpn->bcshp", w, Bc, G))
    xg = torch.einsum("bcshp,bchpn->bchsn", X, G)
    db = (torch.einsum("bchts,bctn->bcshn", MD, Cc)
          + torch.einsum("bchs,bchsn->bcshn", w, xg))
    dyh = torch.einsum("bcthp,bchpn->bchtn", dY, ck)
    dc = (torch.einsum("bcht,bchtn->bcthn", E, dyh)
          + torch.einsum("bchts,bcsn->bcthn", MD, Bc))
    # Q[t, s] = dL/dseg[t, s]: column 0 is s = -1 (the chunk's start),
    # column s + 1 is s; row -1 (the chunk's end) gains the end state's
    # terms
    Q = torch.zeros(M.shape[:-1] + (CHUNK + 1,), dtype=M.dtype,
                    device=M.device)
    strict = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                                   device=M.device), -1)
    Q[..., 1:] = torch.where(strict, MD * cb[:, :, None], Q.new_zeros(()))
    Q[..., 0] = E * torch.einsum("bchtn,bctn->bcht", dyh, Cc)
    Q[..., -1, 1:CHUNK] += (w * torch.einsum("bchsn,bcsn->bchs", xg,
                                             Bc))[..., :CHUNK - 1]
    Q[..., -1, 0] += E[..., -1] * (G * ck).sum((-2, -1))
    # dla_r = sum over t >= r of R[t, r], R[t, r] = sum over s < r of Q
    R = torch.cumsum(Q, -1)[..., :CHUNK]                  # [.., t, r]
    on = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                               device=M.device))
    dla = torch.where(on, R, R.new_zeros(())).sum(-2)      # [B, nch, H, r]
    return (_unchunk(dla.permute(0, 1, 3, 2), S), _unchunk(ddtx, S),
            _unchunk(db, S), _unchunk(dc, S), dh0)
