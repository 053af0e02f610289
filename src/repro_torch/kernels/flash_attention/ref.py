"""Plain PyTorch version of ``csrc/flash_attention.cu``: causal grouped-
query attention as tiled online softmax, and its tiled backward.

The kernels' algorithm, written for tensors on any device:

* ``forward`` walks the keys in tiles of ``KEYS`` (64): logits q k^T in
  float32, scaled into the log2 domain (times hd^-1/2 log2 e), masked to
  keys t <= base[b] + s, the running row maximum and sum of the online
  softmax, and O += P_hi v + P_lo v, where P_hi = bf16(P) and P_lo =
  bf16(P - P_hi) (``split``): P carried to 16 significant bits against
  the bf16 v, each product exact.  Returns O in q's dtype, O in float32
  and the row log-sum-exp [B, H, S] (natural log).
* ``backward`` forms D = rowsum(dO o O_f32) from the float32 output, then
  walks the key tiles in order: P again from the saved log-sum-exp, dP =
  dO v^T, dS = P o (dP - D), dV = P_hi^T dO + P_lo^T dO, dK = (dS_hi^T q
  + dS_lo^T q) hd^-1/2 and dQ += (dS_hi k + dS_lo k) hd^-1/2 tile by tile.
  Gradients come back in float32; the wrapper rounds them to the inputs'
  dtype once.

The kernels skip key tiles above a block's causal diagonal; here such a
tile's P is 0 and leaves every sum as it was, so the two differ only in
the order of the float32 sums inside a tile.
"""
from __future__ import annotations

import math

import torch

KEYS = 64                  # keys of a streamed K/V tile (kKeys)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def split(x: torch.Tensor):
    """float32 x -> (bf16(x), bf16(x - bf16(x))) as float32 values."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def positions(B: int, S: int, base, device) -> torch.Tensor:
    """[B, S] query positions: base (None, an int or a [B] tensor) + s."""
    s = torch.arange(S, device=device)
    if base is None:
        return s.expand(B, S)
    return torch.as_tensor(base, device=device).reshape(-1, 1).long() + s


def _tiles(k, v, T):
    for t0 in range(0, T, KEYS):
        t1 = min(T, t0 + KEYS)
        yield (t0, t1, torch.arange(t0, t1, device=k.device),
               k[:, t0:t1].float(), v[:, t0:t1].float())


def forward(q, k, v, base=None):
    """q [B, S, H, hd], k and v [B, T, K, hd] -> (O [B, S, H, hd] in q's
    dtype, O in float32, log-sum-exp float32 [B, H, S])."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    c = hd ** -0.5 * LOG2E
    qf = q.float().reshape(B, S, K, G, hd)
    pos = positions(B, S, base, q.device)
    m = torch.full((B, S, K, G), -math.inf, device=q.device)
    l = torch.zeros((B, S, K, G), device=q.device)
    acc = torch.zeros((B, S, K, G, hd), device=q.device)
    for _, _, tpos, kt, vt in _tiles(k, v, T):
        x = torch.einsum("bskgd,btkd->bskgt", qf, kt) * c
        vis = (tpos[None, None, :] <= pos[:, :, None])[:, :, None, None, :]
        x = torch.where(vis, x, -math.inf)
        mn = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(x - mn[..., None])
        l = l * alpha + p.sum(-1)
        hi, lo = split(p)
        acc = (acc * alpha[..., None]
               + torch.einsum("bskgt,btkd->bskgd", hi, vt)
               + torch.einsum("bskgt,btkd->bskgd", lo, vt))
        m = mn
    o32 = (acc * (1.0 / l)[..., None]).reshape(B, S, H, hd)
    lse = ((m + torch.log2(l)) * LN2).reshape(B, S, H)
    return o32.to(q.dtype), o32, lse.permute(0, 2, 1).contiguous()


def backward(q, k, v, base, o32, lse, dout):
    """The forward's inputs, its float32 output and log-sum-exp, and dout
    [B, S, H, hd] -> (dq, dk, dv) in float32."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5
    c = scale * LOG2E
    qf = q.float().reshape(B, S, K, G, hd)
    dof = dout.float().reshape(B, S, K, G, hd)
    d = (dof * o32.reshape(B, S, K, G, hd)).sum(-1)
    lse2 = (lse.permute(0, 2, 1) * LOG2E).reshape(B, S, K, G)
    pos = positions(B, S, base, q.device)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((B, T, K, hd), device=q.device)
    dv = torch.zeros((B, T, K, hd), device=q.device)
    for t0, t1, tpos, kt, vt in _tiles(k, v, T):
        x = torch.einsum("bskgd,btkd->bskgt", qf, kt) * c
        vis = (tpos[None, None, :] <= pos[:, :, None])[:, :, None, None, :]
        p = torch.where(vis, torch.exp2(x - lse2[..., None]), 0.0)
        dp = torch.einsum("bskgd,btkd->bskgt", dof, vt)
        ds = p * (dp - d[..., None])
        phi, plo = split(p)
        dhi, dlo = split(ds)
        dv[:, t0:t1] = (torch.einsum("bskgt,bskgd->btkd", phi, dof)
                        + torch.einsum("bskgt,bskgd->btkd", plo, dof))
        dk[:, t0:t1] = (torch.einsum("bskgt,bskgd->btkd", dhi, qf)
                        + torch.einsum("bskgt,bskgd->btkd", dlo, qf)) * scale
        dq += (torch.einsum("bskgt,btkd->bskgd", dhi, kt)
               + torch.einsum("bskgt,btkd->bskgd", dlo, kt))
    return (dq * scale).reshape(B, S, H, hd), dk, dv
