"""Plain torch versions of RWKV-6's WKV scan: the per-token loop with its
checkpointed backward, and the kernels' chunked algorithm.

Per (b, h) the state S is float32 [hd_k, hd_v]; the decay is given by its
log, lw_t (w_t = exp(lw_t), 0 where lw_t <= -104 underflows), one a
channel; token t reads the state before its own update:

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

The per-token forward keeps on request, and the chunked one always
returns, the state before every ``CHUNK``-th token (the checkpoints, [B,
ceil(S / CHUNK), H, hd, hd]).

The per-token loop (``wkv6_forward_ref``, ``wkv6_backward_ref``) is the
yardstick the kernels are held to.  Its backward starts from the
checkpoints: it recomputes a chunk's states, then runs the adjoint
G_t = dL/dS_t back through the chunk, from the final state's incoming
gradient, with

    dr_t[i]  = sum_j dy_t[j] (S_{t-1}[i,j] + u_i k_t[i] v_t[j])
    dk_t     = (G_t + diag(u) r_t dy_t^T) v_t
    dv_t     = (G_t + diag(u) r_t dy_t^T)^T k_t
    dlw_t[i] = w_t[i] sum_j G_t[i,j] S_{t-1}[i,j]
    du[i]   += r_t[i] k_t[i] (dy_t . v_t)
    G_{t-1}  = diag(w_t) G_t + r_t dy_t^T

and the initial state's gradient is G before token 0.

The chunked form (``wkv6_forward_chunked``, ``wkv6_backward_chunked``) is
``csrc/wkv6_scan.cu``'s algorithm, which the ops run for CPU tensors.  A
chunk of CHUNK tokens splits into NSUB sub-chunks of SUB; with S0 the state
before the chunk, and every exponent a running sum of lw over the tokens
it spans (never a difference of two cumulative sums, which loses the small
terms and gives -inf - -inf):

    y_t    = (r_t o e^{lw_0 + .. + lw_{t-1}})^T S0 + sum_{s<=t} A[t,s] v_s
    A[t,s] = sum_i r_t[i] k_s[i] e^{lw_{s+1} + .. + lw_{t-1}}[i]   (s < t)
    A[t,t] = sum_i r_t[i] u[i] k_t[i]
    S_end  = diag(e^{lw_0 + .. + lw_63}) S0 + kappa^T V,
    kappa_s = k_s o e^{lw_{s+1} + .. + lw_63}

Inside a sub-chunk (the diagonal blocks of A) the decay is taken channel
by channel.  Between sub-chunks, for t in sub-chunk T after s's sub-chunk
q, it is split at the sub-chunks' edges into three factors, each <= 1:
e^{pre_t} (from T's start to t - 1: R~ = r o e^{pre}), e^{suf_s} (from
s + 1 to q's end: K^ = k o e^{suf}), and g[q, T] = e^{tot_{q+1} + .. +
tot_{T-1}} (the whole sub-chunks between), so A's off-diagonal blocks are
products R~ diag(g[q, T]) K^^T.  They can only underflow, which is exact
in the limit.

The backward, with G the gradient of the chunk's end state (carried back
across chunks: G_before = diag(e^{lw_0 + .. + lw_63}) G + Q^T dY, Q = r o
e^{lw_0 + .. + lw_{t-1}}) and dA = dY V^T: dv = A^T dY + kappa G; dr and dk
from the state terms (dY S0^T, V G^T), the blocks of dA (through R~, K^
and g off the diagonal, channel by channel on it) and the bonus; and
dlw_m[i], the sum over every exponent whose span holds m of (its term's
gradient times the term), taken part by part as running sums: the state
terms' over t > m and s < m, the end decay's, the spans through m's whole
sub-chunk, the spans that start or end in it, and those inside it.  No
division anywhere, so a decay of exactly 0 (lw <= -104 or -inf) is exact.
``du`` comes back one partial a chunk per (b, h) ([B, nch, H, hd]); the
caller sums it.
"""
from __future__ import annotations

import torch

CHUNK = 64   # tokens a chunk of the kernels, and between two checkpoints
SUB = 16     # tokens a sub-chunk
NSUB = CHUNK // SUB
# limits of a scan against another summation order (the kernel, the JAX
# package): the outputs within FWD_RTOL of their largest entry plus
# FWD_ATOL, each gradient within GRAD_RTOL of its largest entry (float32
# sums over up to 4096 tokens, kept bounded by the decay)
FWD_RTOL, FWD_ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-4


def n_chunks(seq_len: int) -> int:
    return -(-seq_len // CHUNK)


def wkv6_forward_ref(r, k, v, lw, u, s0, save: bool = False):
    """r, k, v, lw (the log decay): float32 [B, S, H, hd]; u: [H, hd]; s0:
    [B, H, hd, hd] -> (y [B, S, H, hd], final state, checkpoints or an
    empty tensor), token by token."""
    B, S, H, hd = r.shape
    w = torch.exp(lw)
    ys = torch.empty_like(r)
    ck = (r.new_empty((B, n_chunks(S), H, hd, hd)) if save
          else r.new_empty((0,)))
    uu = u[None, :, :, None]
    state = s0
    for t in range(S):
        if save and t % CHUNK == 0:
            ck[:, t // CHUNK] = state
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys[:, t] = torch.einsum("bhk,bhkv->bhv", r[:, t], state + uu * kv)
        state = w[:, t, :, :, None] * state + kv
    return ys, state, ck


def wkv6_backward_ref(r, k, v, lw, u, ck, dy, ds):
    """The forward's inputs, its checkpoints, dy [B, S, H, hd] and the final
    state's gradient ds [B, H, hd, hd] -> (dr, dk, dv, dlw, du per (b, h)
    [B, H, hd], the initial state's gradient), token by token."""
    B, S, H, hd = r.shape
    w = torch.exp(lw)
    dr, dk, dv, dlw = (torch.empty_like(r) for _ in range(4))
    du = r.new_zeros((B, H, hd))
    uu = u[None, :, :, None]
    G = ds.clone()
    for c in reversed(range(n_chunks(S))):
        t0, t1 = c * CHUNK, min(S, (c + 1) * CHUNK)
        states = [ck[:, c]]                                # S_{t0-1}, ...
        for t in range(t0, t1 - 1):
            states.append(w[:, t, :, :, None] * states[-1]
                          + k[:, t, :, :, None] * v[:, t, :, None, :])
        for t in reversed(range(t0, t1)):
            prev = states[t - t0]                          # S_{t-1}
            kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
            rdy = torch.einsum("bhk,bhv->bhkv", r[:, t], dy[:, t])
            gkv = G + uu * rdy
            dr[:, t] = torch.einsum("bhv,bhkv->bhk", dy[:, t],
                                    prev + uu * kv)
            dk[:, t] = torch.einsum("bhkv,bhv->bhk", gkv, v[:, t])
            dv[:, t] = torch.einsum("bhkv,bhk->bhv", gkv, k[:, t])
            dlw[:, t] = w[:, t] * (G * prev).sum(-1)
            du += (rdy * kv).sum(-1)
            G = w[:, t, :, :, None] * G + rdy
    return dr, dk, dv, dlw, du, G


def _chunks(x, S):
    """[B, S, H, hd] -> [B, nch, H, CHUNK, hd], zeros past S."""
    pad = n_chunks(S) * CHUNK - S
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)
    B, _, H, hd = x.shape
    return x.reshape(B, -1, CHUNK, H, hd).transpose(2, 3)


def _unchunk(x, S):
    """[B, nch, H, CHUNK, hd] -> [B, S, H, hd]."""
    B, _, H, _, hd = x.shape
    return x.transpose(2, 3).reshape(B, -1, H, hd)[:, :S]


def _subs(x):
    """[..., CHUNK, hd] -> [..., NSUB, SUB, hd]."""
    return x.reshape(x.shape[:-2] + (NSUB, SUB, x.shape[-1]))


def _shift(x, dim, reverse=False):
    """x moved one place along ``dim`` (towards the end, or the start when
    ``reverse``), a zero in the freed place."""
    n = x.shape[dim]
    z = torch.zeros_like(x.narrow(dim, 0, 1))
    if reverse:
        return torch.cat([x.narrow(dim, 1, n - 1), z], dim)
    return torch.cat([z, x.narrow(dim, 0, n - 1)], dim)


def _exclusive(x, dim, reverse=False):
    """The running sum along ``dim`` of the terms strictly before each
    place (after it, when ``reverse``)."""
    x = _shift(x, dim, reverse)
    if reverse:
        return torch.flip(torch.cumsum(torch.flip(x, [dim]), dim), [dim])
    return torch.cumsum(x, dim)


class _Decays:
    """The running sums of one chunk's log decays and their exponentials,
    lw [B, nch, H, CHUNK, hd]; a sub-chunk is [NSUB, SUB]."""

    def __init__(self, lw):
        ls = _subs(lw)                                  # [.., q, SUB, hd]
        self.lw = ls
        tot = ls.sum(-2)                                # [.., q, hd]
        pre = _exclusive(ls, -2)                        # q's start .. t - 1
        suf = _exclusive(ls, -2, reverse=True)          # s + 1 .. q's end
        before = _exclusive(tot, -2)[..., None, :]      # earlier sub-chunks
        after = _exclusive(tot, -2, reverse=True)[..., None, :]
        self.e_pre, self.e_suf = torch.exp(pre), torch.exp(suf)
        self.e_in = torch.exp(before + pre)             # chunk's start .. t-1
        self.e_out = torch.exp(suf + after)             # s + 1 .. chunk's end
        self.dec = torch.exp(tot.sum(-2))               # [.., hd]
        # g[q, T]: the whole sub-chunks strictly between q and T (T = NSUB:
        # the chunk's end), 0 where q >= T
        g = lw.new_zeros(tot.shape[:-2] + (NSUB, NSUB + 1, tot.shape[-1]))
        for q in range(NSUB):
            run = torch.zeros_like(tot[..., 0, :])
            for T in range(q + 1, NSUB + 1):
                g[..., q, T, :] = torch.exp(run)
                if T < NSUB:
                    run = run + tot[..., T, :]
        self.g = g
        # E[q, t, s] = e^{lw_{s+1} + .. + lw_{t-1}} inside sub-chunk q, s < t
        j = torch.arange(SUB, device=lw.device)
        past = j[None, :] > j[:, None]                  # [s, m]: m > s
        terms = torch.where(past[:, :, None], ls[..., None, :, :],
                            ls.new_zeros(()))           # [.., q, s, m, hd]
        seg = _shift(torch.cumsum(terms, -2), -2)       # [.., q, s, t, hd]
        self.E = torch.where(past[:, :, None], torch.exp(seg),
                             ls.new_zeros(())).transpose(-3, -2)


def _flat(x):
    """[..., NSUB, SUB, hd] -> [..., CHUNK, hd]."""
    return x.reshape(x.shape[:-3] + (CHUNK, x.shape[-1]))


def _blocks(x):
    """[..., NSUB, NSUB, SUB, SUB] (blocks [T, q] of rows t, columns s) ->
    [..., CHUNK, CHUNK]."""
    return x.transpose(-3, -2).reshape(x.shape[:-4] + (CHUNK, CHUNK))


def _unblocks(x):
    """[..., CHUNK, CHUNK] -> [..., NSUB, NSUB, SUB, SUB]."""
    return x.reshape(x.shape[:-2] + (NSUB, SUB, NSUB, SUB)).transpose(-3, -2)


def _tri(n, device, strict):
    """[n, n] of rows > columns (>= unless ``strict``)."""
    i = torch.arange(n, device=device)
    return i[:, None] > i[None, :] if strict else i[:, None] >= i[None, :]


def _intra(R, K, u, d):
    """A (its blocks between sub-chunks through R~, K^ and g, inside them
    channel by channel) with the bonus on its diagonal: [B, nch, H, CHUNK,
    CHUNK] from R, K [B, nch, H, CHUNK, hd] and u [H, hd]."""
    Rs, Ks = _subs(R), _subs(K)
    off = torch.einsum("...Tti,...qsi,...qTi->...Tqts", Rs * d.e_pre,
                       Ks * d.e_suf, d.g[..., :NSUB, :])
    off = off * _tri(NSUB, R.device, True)[:, :, None, None]
    diag = torch.einsum("...qti,...qsi,...qtsi->...qts", Rs, Ks, d.E)
    blocks = off.clone()
    for q in range(NSUB):
        blocks[..., q, q, :, :] = diag[..., q, :, :]
    bonus = (R * u[:, None, :] * K).sum(-1)
    return _blocks(blocks) + torch.diag_embed(bonus)


def _carry(start, local, dec, reverse: bool):
    """states[c] = the carried value before chunk c (walking backward when
    ``reverse``): start, then diag(dec[c]) it + local[c] at each step.
    start [B, H, hd, hd]; local [B, nch, H, hd, hd]; dec [B, nch, H, hd]
    (a decay a row).  Returns (states [B, nch, H, hd, hd], the last
    value)."""
    nch = local.shape[1]
    states = torch.empty_like(local)
    st = start
    for j in range(nch):
        c = nch - 1 - j if reverse else j
        states[:, c] = st
        st = dec[:, c, :, :, None] * st + local[:, c]
    return states, st


def wkv6_forward_chunked(r, k, v, lw, u, s0):
    """``wkv6_forward_ref``'s function by the kernels' chunked algorithm:
    -> (y, final state, the checkpoints, the decay across every chunk [B,
    ceil(S / CHUNK), H, hd]), what the forward kernels leave."""
    S = r.shape[1]
    R, K, V, LW = (_chunks(t, S) for t in (r, k, v, lw))
    d = _Decays(LW)
    kappa = K * _flat(d.e_out)
    local = torch.einsum("...si,...sj->...ij", kappa, V)
    states, s_out = _carry(s0, local, d.dec, reverse=False)
    y = (torch.einsum("...ti,...ij->...tj", R * _flat(d.e_in), states)
         + torch.einsum("...ts,...sj->...tj", _intra(R, K, u, d), V))
    return _unchunk(y, S), s_out, states, d.dec


def wkv6_backward_chunked(r, k, v, lw, u, ck, dy, ds):
    """``wkv6_backward_ref``'s function by the kernels' chunked algorithm,
    from the same checkpoints: -> (dr, dk, dv, dlw, du one partial a chunk
    [B, nch, H, hd], the initial state's gradient)."""
    S = r.shape[1]
    R, K, V, LW, DY = (_chunks(t, S) for t in (r, k, v, lw, dy))
    d = _Decays(LW)
    e_in, e_out = _flat(d.e_in), _flat(d.e_out)
    local = torch.einsum("...ti,...tj->...ij", R * e_in, DY)
    G, ds0 = _carry(ds, local, d.dec, reverse=True)   # G: at the chunk's end
    dA = torch.einsum("...tj,...sj->...ts", DY, V)
    dbeta = torch.diagonal(dA, 0, -2, -1)              # the bonus's
    dA = dA * _tri(CHUNK, r.device, True)
    dV = (torch.einsum("...ts,...tj->...sj", _intra(R, K, u, d), DY)
          + torch.einsum("...si,...ij->...sj", K * e_out, G))
    dr_state = e_in * torch.einsum("...tj,...ij->...ti", DY, ck)
    dk_state = e_out * torch.einsum("...sj,...ij->...si", V, G)
    # between sub-chunks: X[T, q] (dA K^ diag(g)) per block, dr's and dk's
    Rs, Ks = _subs(R), _subs(K)
    Rt = Rs * d.e_pre
    blocks = _unblocks(dA)                             # [.., T, q, t, s]
    off = blocks * _tri(NSUB, r.device, True)[:, :, None, None]
    g = d.g[..., :NSUB, :]                             # [.., q, T, hd]
    X = torch.einsum("...Tqts,...qsi,...qTi->...Tqti", off,
                     Ks * d.e_suf, g)
    dr_off = d.e_pre * X.sum(-3)
    dk_off = d.e_suf * torch.einsum("...Tqts,...Tti,...qTi->...qsi", off,
                                    Rt, g)
    # inside sub-chunks, channel by channel
    inside = torch.diagonal(blocks, 0, -4, -3).movedim(-1, -3)
    P = (inside[..., None] * Rs[..., :, None, :] * Ks[..., None, :, :]
         * d.E)                                        # [.., q, t, s, hd]
    dr_in = torch.einsum("...qts,...qsi,...qtsi->...qti", inside, Ks, d.E)
    dk_in = torch.einsum("...qts,...qti,...qtsi->...qsi", inside, Rs, d.E)
    bonus = dbeta[..., None] * u[:, None, :]
    dR = dr_state + _flat(dr_off + dr_in) + bonus * K
    dK = dk_state + _flat(dk_off + dk_in) + bonus * R
    du = torch.einsum("...t,...ti,...ti->...i", dbeta, R, K)
    # dlw_m: every exponent's span that holds m, part by part
    j = torch.arange(SUB, device=r.device)
    holds = ((j[None, :, None] < j[:, None, None])
             & (j[None, None, :] < j[None, :, None]))   # [t, m, s]: s<m<t
    i = torch.arange(NSUB, device=r.device)
    through = ((i[None, None, :] < i[:, None, None])
               & (i[:, None, None] < i[None, :, None]))  # [Q, T, q]: q<Q<T
    Z = torch.einsum("...Tti,...Tqti->...Tqi", Rt, X)
    dLW = (_exclusive(R * dr_state, -2, reverse=True)
           + _exclusive(K * dk_state, -2)
           + (d.dec * (G * ck).sum(-1))[..., None, :]
           + _flat(torch.einsum("...Tqi,QTq->...Qi", Z, through.to(Z.dtype))
                   [..., None, :]
                   + _exclusive(Rs * dr_off, -2, reverse=True)
                   + _exclusive(Ks * dk_off, -2)
                   + torch.einsum("...qtsi,tms->...qmi", P,
                                  holds.to(P.dtype))))
    return (*(_unchunk(x, S) for x in (dR, dK, dV, dLW)), du, ds0)
