"""Plain torch versions of RWKV-6's WKV scan: the forward and an explicit
backward that follows the kernel's algorithm.

Per (b, h) the state S is float32 [hd_k, hd_v]; token t reads the state
before its own update:

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

The forward can keep the state before every ``CHUNK``-th token (the
checkpoints, [B, ceil(S / CHUNK), H, hd, hd]).  The backward starts from
them: it recomputes a chunk's states, then runs the adjoint
G_t = dL/dS_t back through the chunk, from the final state's incoming
gradient, with

    dr_t[i] = sum_j dy_t[j] (S_{t-1}[i,j] + u_i k_t[i] v_t[j])
    dk_t    = (G_t + diag(u) r_t dy_t^T) v_t
    dv_t    = (G_t + diag(u) r_t dy_t^T)^T k_t
    dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
    du[i]  += r_t[i] k_t[i] (dy_t . v_t)
    G_{t-1} = diag(w_t) G_t + r_t dy_t^T

and the initial state's gradient is G before token 0.  ``du`` comes back
per (b, h); the caller sums it over b.
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


def wkv6_forward_ref(r, k, v, w, u, s0, save: bool = False):
    """r, k, v, w: float32 [B, S, H, hd]; u: [H, hd]; s0: [B, H, hd, hd]
    -> (y [B, S, H, hd], final state, checkpoints or an empty tensor)."""
    B, S, H, hd = r.shape
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


def wkv6_backward_ref(r, k, v, w, u, ck, dy, ds):
    """The forward's inputs, its checkpoints, dy [B, S, H, hd] and the final
    state's gradient ds [B, H, hd, hd] -> (dr, dk, dv, dw, du per (b, h)
    [B, H, hd], the initial state's gradient)."""
    B, S, H, hd = r.shape
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
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
            dw[:, t] = (G * prev).sum(-1)
            du += (rdy * kv).sum(-1)
            G = w[:, t, :, :, None] * G + rdy
    return dr, dk, dv, dw, du, G
