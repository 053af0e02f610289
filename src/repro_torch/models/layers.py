"""Model building blocks: norms, RoPE, blocked GQA attention, SwiGLU and
the cross-entropy loss.

Torch port of the dense subset of ``repro.models.layers``, with the
reference's layouts ([B, S, H, hd] queries, [B, T, K, hd] caches).  Scores,
softmax and norms are computed in float32 as in the reference.  Parameter
initializers take an explicit ``torch.Generator`` and device, and a
``lead`` shape for stacked [n_layers, ...] leaves.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               device, lead: tuple = ()) -> torch.Tensor:
    w = torch.randn(lead + (d_in, d_out), generator=generator,
                    dtype=torch.float32, device=device)
    return w.mul_(d_in ** -0.5).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm over head_dim. x: [..., H, hd]."""
    return rms_norm(x, scale, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [S] or [B, S]."""
    half = x.shape[-1] // 2
    freq = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    freq = torch.from_numpy(np.asarray(freq, np.float32)).to(x.device)
    ang = positions.float()[..., None] * freq      # [S, half] | [B, S, half]
    ang = ang[None, :, None, :] if positions.dim() == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x0, x1 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x0 * cos - x1 * sin, x1 * cos + x0 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

_NEG_INF = -1e30


@contextlib.contextmanager
def _tf32_matmuls():
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        yield
    finally:
        matmul.allow_tf32 = before


def qk_logits(q, k):
    """q: [B,qb,K,G,hd]; k: [B,T,K,hd] -> float32 [B,qb,K,G,T], the
    reference's bf16 x bf16 product with a float32 result.  On the card
    bf16 operands run on the tensor cores in TF32, which holds every bf16
    value exactly (8 significand bits of its 11), so the products are exact
    and only the order of the float32 sum differs; float32 operands (the
    parity configs) stay full float32."""
    exact_in_tf32 = q.is_cuda and q.dtype == k.dtype == torch.bfloat16
    with _tf32_matmuls() if exact_in_tf32 else contextlib.nullcontext():
        return torch.einsum("bqkgd,btkd->bqkgt", q.float(), k.float())


def _attend_block(q, k, v, qpos, tpos, causal: bool, t_valid=None):
    """q: [B,qb,K,G,hd]; k,v: [B,T,K,hd]; qpos [qb] or [B,qb]; tpos [T]
    -> [B,qb,K,G,hd].  t_valid: None, an int, or a [B] tensor."""
    scale = q.shape[-1] ** -0.5
    logits = qk_logits(q, k) * scale
    if causal:
        mask = tpos[None, :] <= qpos[..., :, None]          # [qb,T] | [B,qb,T]
    else:
        mask = torch.ones((qpos.shape[-1], tpos.shape[0]), dtype=torch.bool,
                          device=q.device)
    bmask = mask if mask.dim() == 3 else mask[None]          # [B|1, qb, T]
    if t_valid is not None:
        tv = torch.as_tensor(t_valid, device=q.device)
        tv = tv[:, None, None] if tv.dim() else tv
        bmask = bmask & (tpos[None, None, :] < tv)
    logits = torch.where(bmask[:, :, None, None, :], logits,
                         torch.full((), _NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bqkgt,btkd->bqkgd", probs, v.float()).to(v.dtype)


def gqa_attention(q, k, v, *, causal: bool = True, q_block: int = 512,
                  base_pos=0, t_valid=None):
    """Blocked grouped-query attention.

    q: [B, S, H, hd];  k, v: [B, T, K, hd] with H = K * G.
    base_pos: int query offset, or a [B] tensor when each sequence resumes
    at its own position (chunked prefill over a shared cache).
    t_valid: optional number of valid cache positions — an int, or a [B]
    tensor when sequences in the batch have different lengths.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    dev = q.device
    tpos = torch.arange(T, device=dev)
    base = torch.as_tensor(base_pos, device=dev)
    if base.dim():
        base = base[:, None]
    if S == 1 or S <= q_block:
        qpos = base + torch.arange(S, device=dev)
        return _attend_block(qg, k, v, qpos, tpos, causal,
                             t_valid).reshape(B, S, H, hd)
    pad = (-S) % q_block
    if pad:
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
    outs = []
    for i in range((S + pad) // q_block):
        qpos = base + i * q_block + torch.arange(q_block, device=dev)
        outs.append(_attend_block(qg[:, i * q_block:(i + 1) * q_block], k, v,
                                  qpos, tpos, causal, t_valid))
    out = torch.cat(outs, dim=1).reshape(B, S + pad, H, hd)
    return out[:, :S]


# ---------------------------------------------------------------------------
# attention block params + apply
# ---------------------------------------------------------------------------


def attn_params(generator: torch.Generator, cfg, device, lead: tuple = ()):
    d, hd, H, K = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.p_dtype
    p = {
        "wq": dense_init(generator, d, H * hd, dt, device, lead),
        "wk": dense_init(generator, d, K * hd, dt, device, lead),
        "wv": dense_init(generator, d, K * hd, dt, device, lead),
        "wo": dense_init(generator, H * hd, d, dt, device, lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dt, device=device)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dt, device=device)
    return p


def attn_specs(cfg):
    """Logical axes of ``attn_params``' leaves (``parallel/sharding.py``)."""
    p = {
        "wq": (None, "model"), "wk": (None, "model"),
        "wv": (None, "model"), "wo": ("model", None),
    }
    if cfg.qk_norm:
        p["q_norm"] = (None,)
        p["k_norm"] = (None,)
    return p


def project_qkv(p, cfg, x, positions):
    """x: [B,S,D] -> q [B,S,H,hd], k,v [B,S,K,hd] with RoPE + optional qk-norm."""
    B, S, _ = x.shape
    hd, H, K = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attn_out(p, x_attn, B, S):
    return x_attn.reshape(B, S, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu_params(generator: torch.Generator, d_model: int, d_ff: int, dtype,
                  device, lead: tuple = ()):
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype, device, lead),
        "w_up": dense_init(generator, d_model, d_ff, dtype, device, lead),
        "w_down": dense_init(generator, d_ff, d_model, dtype, device, lead),
    }


def swiglu_specs():
    return {"w_gate": (None, "model"), "w_up": (None, "model"),
            "w_down": ("model", None)}


def swiglu(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# LM head / loss
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    """logits [B,S,V] (any float dtype), labels [B,S] int. Mean NLL."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()
