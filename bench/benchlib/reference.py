"""The plain reference: the models' forward, loss and AdamW in plain
PyTorch, float32, with TF32 off.

It holds the pieces a model is built of (RMSNorm, RoPE on split halves,
grouped-query causal attention, a pre-norm attention and SwiGLU block),
and takes the order in which a model applies them from its family's file
(``bench/families/<family>.py``, ``layers``).  It imports nothing of the
program and takes nothing the program made: the weights come again from the seed
(``weights.make_tree``), and whatever the program derives from them is
derived here again.

``precision="fp8"`` is the control: every weight product runs on inputs
rounded to float8 e4m3 (weights per output column, activations per row,
each scaled to the format's range), the step below the configurations'
bfloat16.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

_E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions inside the block."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (m.allow_tf32, c.allow_tf32)
    m.allow_tf32 = c.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = before


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along ``dim`` (a
    straight-through rounding: gradients pass unchanged)."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = _E4M3_MAX / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    return x + (q - x).detach()


class Ref:
    """One model's reference: ``cfg`` (the configuration's sizes,
    ``sizes.Sizes``), the float32 weight tree and the precision."""

    def __init__(self, cfg, params: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        self.p = params
        self.fp8 = precision == "fp8"

    # -- pieces ----------------------------------------------------------
    def mm(self, x, w):
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w

    def rms(self, x, scale):
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.cfg.norm_eps) * scale

    def rope(self, x, pos):
        """x [B, S, H, hd]; pos [S]."""
        half = x.shape[-1] // 2
        freq = self.cfg.rope_theta ** (
            -torch.arange(half, dtype=torch.float64, device=x.device) / half)
        ang = pos.double()[:, None] * freq[None, :]
        cos = torch.cos(ang).float()[None, :, None, :]
        sin = torch.sin(ang).float()[None, :, None, :]
        x0, x1 = x[..., :half], x[..., half:]
        return torch.cat([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)

    def attention(self, q, k, v):
        """Causal GQA. q [B, S, H, hd]; k, v [B, S, K, hd]."""
        B, S, H, hd = q.shape
        K = k.shape[2]
        G = H // K
        qg = q.reshape(B, S, K, G, hd)
        logits = torch.einsum("bskgd,btkd->bkgst", qg, k) * hd ** -0.5
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v)
        return out.reshape(B, S, H * hd)

    def attn_mlp(self, lp, x, pos):
        """A pre-norm transformer block's two residual branches."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        h = self.rms(x, lp["ln1"])
        a = lp["attn"]
        q = self.rope(self.mm(h, a["wq"]).reshape(B, S, H, hd), pos)
        k = self.rope(self.mm(h, a["wk"]).reshape(B, S, K, hd), pos)
        v = self.mm(h, a["wv"]).reshape(B, S, K, hd)
        x = x + self.mm(self.attention(q, k, v), a["wo"])
        h2 = self.rms(x, lp["ln2"])
        m = lp["mlp"]
        g = F.silu(self.mm(h2, m["w_gate"])) * self.mm(h2, m["w_up"])
        return x + self.mm(g, m["w_down"])

    # -- whole models ----------------------------------------------------
    def hidden(self, tokens, remat: bool = False):
        """Final-normed hidden states [B, S, D] of tokens [B, S]."""
        P = self.p
        x = P["embed"][tokens]
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        ck = _checkpointed if remat else _direct
        x = self.cfg.fam.layers(self, x, pos, ck)
        return self.rms(x, P["final_norm"])

    def logits(self, h):
        return self.mm(h, self.p["unembed"])

    def loss(self, tokens, labels, remat: bool = True):
        """Mean next-token cross-entropy over [B, S] (every label valid)."""
        h = self.hidden(tokens, remat=remat)
        nll = []
        for b in range(h.shape[0]):         # one sequence's logits at a time
            lg = self.logits(h[b])
            nll.append(torch.logsumexp(lg, -1)
                       - lg.gather(-1, labels[b, :, None].long())[:, 0])
        return torch.cat(nll).mean()


def _direct(fn, x):
    return fn(x)


def _checkpointed(fn, x):
    return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)


def per_layer(stacked: dict) -> list:
    """The per-layer trees of a stacked [n_layers, ...] tree."""
    def unbind(t):
        if isinstance(t, dict):
            return {k: unbind(v) for k, v in t.items()}
        return t.unbind(0)
    u = unbind(stacked)
    n = len(_first_leaf(u))

    def pick(t, i):
        return ({k: pick(v, i) for k, v in t.items()} if isinstance(t, dict)
                else t[i])
    return [pick(u, i) for i in range(n)]


def _first_leaf(t):
    while isinstance(t, dict):
        t = next(iter(t.values()))
    return t


# ---------------------------------------------------------------------------
# AdamW, as the configurations state it: float32 arithmetic, parameters
# stored in their own dtype, float32 moments, gradients taken in the
# parameter dtype and clipped by their global norm, decay on every leaf of
# two or more dimensions
# ---------------------------------------------------------------------------

class AdamW:
    def __init__(self, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip = weight_decay, grad_clip

    def step(self, t: int, params: list, grads: list, mu: list, nu: list,
             dtypes: list) -> None:
        """Update lists of float32 leaves in place at step ``t`` (1-based):
        ``params[i]`` holds values of ``dtypes[i]``."""
        gs = [g.to(dt) for g, dt in zip(grads, dtypes)]
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gs))
        scale = torch.clamp(self.clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        c1, c2 = 1 - self.b1 ** t, 1 - self.b2 ** t
        for i, (p, g) in enumerate(zip(params, gs)):
            gf = (g.float() * scale).to(dtypes[i]).float()
            mu[i].mul_(self.b1).add_(gf * (1 - self.b1))
            nu[i].mul_(self.b2).add_(gf * gf * (1 - self.b2))
            u = (mu[i] / c1) / (torch.sqrt(nu[i] / c2) + self.eps)
            if p.dim() >= 2:
                u = u + self.wd * p
            p.copy_((p - self.lr * u).to(dtypes[i]).float())
