"""Mamba-2 (SSD) blocks and the Zamba2-style hybrid stack (torch port of
``repro.models.ssm``).

Mamba-2 head recurrence (scalar decay per head, state N):
    h_t = a_t * h_{t-1} + (dt_t * x_t) (x) B_t        h: [p, N]
    y_t = h_t . C_t + D * x_t
with a_t = exp(-softplus(dt_t) * exp(A_log)), a causal depthwise conv over
the (x, B, C) stream, and a silu(z) output gate.  The recurrence runs in
float32 through ``kernels.ssd_scan`` (a chunked CUDA scan with its backward
on the card, the same algorithm in plain torch on the CPU), which takes
the log decay.

Zamba2 hybrid: a stack of Mamba-2 blocks with ONE shared full-attention
transformer block (its own weights, reused) invoked before every group of
``attn_every`` layers and before the tail group, on concat([x, x0]) — x0 is
the embedding output.  Each invocation keeps its own KV cache.

Sealed serving: the four state fields are resealed whole every decode step
under the bumped nonce n + 1 (field i at nonce 8n + i, mod 2^32), CTR only,
and the unsealed KV beyond ``pos`` (keystream noise) is zeroed, as in the
reference.  ``decode_step`` returns a new state dict.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import cipher
from ..core import sealed as sealed_lib
from ..core.channel import resolve_device
from ..kernels import common
from ..kernels.ssd_scan import ops as ssd_ops
from . import layers as L
from . import transformer as TF

# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------


def _m2_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = s.n_heads or d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.d_state


def m2_init(generator, cfg, device, lead: tuple = ()):
    d_inner, H, _, N = _m2_dims(cfg)
    D, dt = cfg.d_model, cfg.p_dtype
    conv_dim = d_inner + 2 * N
    f32 = torch.float32
    conv_w = torch.randn(lead + (cfg.ssm.conv_width, conv_dim),
                         generator=generator, dtype=f32, device=device)
    return {
        "in_proj": L.dense_init(generator, D, 2 * d_inner + 2 * N + H, dt,
                                device, lead),
        "conv_w": conv_w.mul_(0.1).to(dt),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dt, device=device),
        "A_log": torch.zeros(lead + (H,), dtype=f32, device=device),
        "dt_bias": torch.zeros(lead + (H,), dtype=f32, device=device),
        "D": torch.ones(lead + (H,), dtype=f32, device=device),
        "norm": torch.ones(lead + (d_inner,), dtype=dt, device=device),
        "out_proj": L.dense_init(generator, d_inner, D, dt, device, lead),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: [B,S,C]; w: [W,C]; state: [B,W-1,C] or None.
    Returns (y [B,S,C], new_state [B,W-1,C])."""
    W = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    new_state = xp[:, -(W - 1):, :] if W > 1 else state
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return F.silu(y + b[None, None, :]), new_state


def m2_forward(p, cfg, x, ssm_state=None, conv_state=None):
    """x: [B,S,D] -> (y [B,S,D], ssm_state [B,H,p,N] f32, conv_state)."""
    d_inner, H, hp, N = _m2_dims(cfg)
    B, S, _ = x.shape
    z, xr, Bc, Cc, dt = torch.split(x @ p["in_proj"],
                                    [d_inner, d_inner, N, N, H], dim=-1)
    xbc = torch.cat([xr, Bc, Cc], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"].float().to(xbc.dtype),
                                   p["conv_b"], conv_state)
    xr, Bc, Cc = torch.split(xbc, [d_inner, N, N], dim=-1)
    xh = xr.reshape(B, S, H, hp).float()
    dt = dt.float() + p["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros((), device=dt.device))  # softplus
    la = -dt * torch.exp(p["A_log"])[None, None, :]   # log decay [B,S,H]
    Bf, Cf = Bc.float(), Cc.float()
    if ssm_state is None:
        ssm_state = torch.zeros((B, H, hp, N), dtype=torch.float32,
                                device=x.device)
    dtx = dt[..., None] * xh                                        # [B,S,H,p]
    # the SSD recurrence of the decay exp(la): one scan op (the card's
    # chunked kernels, their algorithm in plain torch on the CPU, shapes
    # only on the meta device)
    y, h = ssd_ops.ssd_scan(la, dtx, Bf, Cf, ssm_state)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], h, conv_state


# ---------------------------------------------------------------------------
# Zamba2 hybrid stack
# ---------------------------------------------------------------------------

def _shared_attn_init(generator, cfg, device):
    """Shared transformer block over concat([x, x0]) (2D -> D projection)."""
    D, dt = cfg.d_model, cfg.p_dtype
    return {
        "concat_proj": L.dense_init(generator, 2 * D, D, dt, device),
        "ln1": torch.ones((D,), dtype=dt, device=device),
        "attn": L.attn_params(generator, cfg, device),
        "ln2": torch.ones((D,), dtype=dt, device=device),
        "mlp": L.swiglu_params(generator, D, cfg.d_ff, dt, device),
    }


def init(generator: torch.Generator, cfg, device="cuda"):
    """Random weights for ``cfg`` on ``device`` (generator on that device),
    with the reference's tree: Mamba-2 leaves stacked [n_layers, ...]."""
    device = resolve_device(device)
    lead = (cfg.n_layers,)
    dt = cfg.p_dtype
    return {
        "embed": L.embed_init(generator, cfg.vocab, cfg.d_model, dt, device),
        "layers": {"ln": torch.ones(lead + (cfg.d_model,), dtype=dt,
                                    device=device),
                   "m2": m2_init(generator, cfg, device, lead)},
        "shared_attn": _shared_attn_init(generator, cfg, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "unembed": L.dense_init(generator, cfg.d_model, cfg.vocab, dt, device),
    }


def m2_specs(cfg):
    return {
        "in_proj": ("data", "model"), "conv_w": (None, "model"),
        "conv_b": ("model",), "A_log": (None,), "dt_bias": (None,),
        "D": (None,), "norm": ("model",), "out_proj": ("model", "data"),
    }


def param_specs(cfg):
    block = {"ln": (None,), "m2": m2_specs(cfg)}
    shared = {"concat_proj": (None, "model"), "ln1": (None,),
              "attn": L.attn_specs(cfg), "ln2": (None,),
              "mlp": L.swiglu_specs()}
    return {"embed": ("model", "data"), "layers": TF.stack_specs(block),
            "shared_attn": shared, "final_norm": (None,),
            "unembed": ("data", "model")}


def n_attn_invocations(cfg) -> int:
    return (cfg.n_layers + cfg.hybrid.attn_every - 1) // cfg.hybrid.attn_every


def _shared_attn(sp, cfg, x, x0, positions, kv_cache=None, pos: int = 0):
    """Returns (y, (k, v)): without a cache causal over its own K/V; with
    one, the new K/V written at ``pos`` of copies of the cache [B,T,K,hd]
    and attended causally by absolute position."""
    B, S, _ = x.shape
    h = torch.cat([x, x0], dim=-1) @ sp["concat_proj"]
    h1 = L.rms_norm(h, sp["ln1"], cfg.norm_eps)
    q, k, v = L.project_qkv(sp["attn"], cfg, h1, positions)
    if kv_cache is None:
        a = L.gqa_attention(q, k, v, causal=True, q_block=cfg.q_block)
        new_kv = (k, v)
    else:
        kc, vc = (c.clone() for c in kv_cache)
        if pos + S > kc.shape[1]:
            raise ValueError(f"positions {pos}..{pos + S - 1} exceed the "
                             f"{kc.shape[1]}-slot cache")
        kc[:, pos:pos + S] = k
        vc[:, pos:pos + S] = v
        a = L.gqa_attention(q, kc, vc, causal=True, base_pos=pos,
                            q_block=cfg.q_block)
        new_kv = (kc, vc)
    h = h + L.attn_out(sp["attn"], a, B, S)
    h2 = L.rms_norm(h, sp["ln2"], cfg.norm_eps)
    return h + L.swiglu(sp["mlp"], h2), new_kv


def _group(sp, lps, cfg, x, x0, positions, kv=None, pos: int = 0,
           states=None):
    """One shared-attention invocation, then its group's Mamba-2 layers
    ``lps``.  kv: the invocation's KV cache or None; states: each layer's
    (ssm, conv) state or None (zeros).  Returns (x, (k, v), [(ssm, conv)
    of each layer])."""
    y, new_kv = _shared_attn(sp, cfg, x, x0, positions, kv_cache=kv,
                             pos=pos)
    x = x + y
    new = []
    for i, lp in enumerate(lps):
        h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
        st = (None, None) if states is None else states[i]
        y, s_ssm, s_conv = m2_forward(lp["m2"], cfg, h, *st)
        new.append((s_ssm, s_conv))
        x = x + y
    return x, new_kv, new


def _stack(params, cfg, x, positions, states=None, pos: int = 0):
    """The hybrid stack: before each group of ``attn_every`` Mamba-2 layers
    (and the tail group) one shared-attention invocation.  With ``states``
    each layer's SSM and conv state and each invocation's KV cache are read
    and returned; without, every state starts at zero, none is kept, and
    each whole group runs under ``cfg.remat`` (the tail group does not, as
    in the reference).  Returns (x, new states or None)."""
    ae = cfg.hybrid.attn_every
    x0 = x
    sp = params["shared_attn"]
    layers = TF.layer_stack(params)
    starts = range(0, len(layers), ae)
    if states is None:
        group = TF._maybe_remat(
            lambda xx, lps: _group(sp, lps, cfg, xx, x0, positions)[0], cfg)
        for l0 in starts:
            lps = layers[l0:l0 + ae]
            x = (group(x, lps) if len(lps) == ae
                 else _group(sp, lps, cfg, x, x0, positions)[0])
        return x, None
    new = {"ssm": [], "conv": [], "attn_k": [], "attn_v": []}
    for g, l0 in enumerate(starts):
        lps = layers[l0:l0 + ae]
        x, (nk, nv), per_layer = _group(
            sp, lps, cfg, x, x0, positions,
            kv=(states["attn_k"][g], states["attn_v"][g]), pos=pos,
            states=[(states["ssm"][l], states["conv"][l])
                    for l in range(l0, l0 + len(lps))])
        new["attn_k"].append(nk)
        new["attn_v"].append(nv)
        for s_ssm, s_conv in per_layer:
            new["ssm"].append(s_ssm)
            new["conv"].append(s_conv)
    new_states = {f: torch.stack(v) for f, v in new.items()}
    new_states["pos"] = pos + positions.shape[-1]
    return x, new_states


def _embed(params, cfg, tokens):
    return params["embed"][tokens].to(cfg.act_dtype)


def loss(params, cfg, batch):
    """Next-token CE. batch: tokens [B,S], labels [B,S] (-1 = masked)."""
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    x, _ = _stack(params, cfg, x,
                  torch.arange(tokens.shape[1], device=tokens.device))
    logits = TF.logits_of(params, cfg, x)
    labels = batch["labels"]
    return L.softmax_xent(logits, torch.clamp(labels, min=0),
                          mask=labels >= 0)


def init_state(cfg, batch: int, max_len: int, device="cuda"):
    d_inner, H, hp, N = _m2_dims(cfg)
    conv_dim = d_inner + 2 * N
    ninv = n_attn_invocations(cfg)
    K, hd, dt = cfg.n_kv_heads, cfg.hd, cfg.act_dtype
    device = resolve_device(device)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, H, hp, N),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm.conv_width - 1,
                             conv_dim), dtype=dt, device=device),
        "attn_k": torch.zeros((ninv, batch, max_len, K, hd), dtype=dt,
                              device=device),
        "attn_v": torch.zeros((ninv, batch, max_len, K, hd), dtype=dt,
                              device=device),
        "pos": 0,
    }


def state_specs(cfg, sealed: bool = False):
    s = {"ssm": (None, "data", "model", None, None),
         "conv": (None, "data", None, "model"),
         "attn_k": (None, "data", "model", None, None),
         "attn_v": (None, "data", "model", None, None),
         "pos": "r"}
    if sealed:
        s["nonce"] = "r"
    return s


_SEAL_FIELDS = ("ssm", "conv", "attn_k", "attn_v")


def init_state_sealed(cfg, batch: int, max_len: int, device="cuda"):
    """Sealed-state structure (ciphertext dtypes), zeros."""
    st = init_state(cfg, batch, max_len, device)
    udt = cipher.uint_dtype_for(cfg.act_dtype)
    out = {f: torch.zeros_like(st[f], dtype=torch.int32 if f == "ssm"
                               else udt) for f in _SEAL_FIELDS}
    out.update(pos=0, nonce=0)
    return out


def _seal_states(states, key, nonce, regions=None):
    """CTR-seal the four state fields under nonces 8n + i (each field one
    item); ``regions``: only a rank's block of each."""
    n = int(nonce) & common.M32
    regions = regions or {}
    out = dict(states)
    for i, f in enumerate(_SEAL_FIELDS):
        out[f] = sealed_lib.seal_items(states[f], key,
                                       (n * 8 + i) & common.M32,
                                       regions.get(f), lead=0)
    out["nonce"] = n
    return out


def _unseal_states(states, key, cfg):
    n = int(states["nonce"])
    dts = {"ssm": torch.float32, "conv": cfg.act_dtype,
           "attn_k": cfg.act_dtype, "attn_v": cfg.act_dtype}
    out = {"pos": states["pos"]}
    for i, f in enumerate(_SEAL_FIELDS):
        out[f] = cipher.unseal_bits(states[f], key, (n * 8 + i) & common.M32,
                                    dts[f])
    # KV beyond pos is keystream noise (possibly NaN bits): zero it
    T = out["attn_k"].shape[2]
    dev = out["attn_k"].device
    tmask = (torch.arange(T, device=dev) < int(states["pos"]))[
        None, None, :, None, None]
    zero = torch.zeros((), dtype=cfg.act_dtype, device=dev)
    out["attn_k"] = torch.where(tmask, out["attn_k"], zero)
    out["attn_v"] = torch.where(tmask, out["attn_v"], zero)
    return out


def prefill(params, cfg, batch, max_len: int, seal_ctx=None, blocks=None):
    """Run the prompt with live states (KV caches of ``max_len`` slots);
    return (last-token logits, states), sealed under ``seal_ctx``;
    blocks: only these blocks of the states (``transformer.prefill``)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    states = init_state(cfg, B, max_len, device=x.device)
    x, new_states = _stack(params, cfg, x,
                           torch.arange(S, device=x.device), states=states,
                           pos=0)
    logits = TF.logits_of(params, cfg, x[:, -1:, :])[:, 0]
    if seal_ctx is not None:
        key, nonce = seal_ctx
        new_states = _seal_states(new_states, key, nonce, blocks)
    elif blocks is not None:
        new_states.update(TF.plain_blocks(
            {f: new_states[f] for f in _SEAL_FIELDS}, blocks))
    return logits, new_states


def decode_step(params, cfg, states, tokens, seal_ctx=None):
    """One token for the whole stack. tokens: int [B].  Returns (logits
    [B, V], new states); a sealed state comes back under nonce n + 1."""
    sealed = seal_ctx is not None
    if sealed:
        key = seal_ctx[0]
        nonce = int(states["nonce"])
        states = _unseal_states(states, key, cfg)
    B = tokens.shape[0]
    pos = int(states["pos"])
    x = _embed(params, cfg, tokens[:, None])
    positions = torch.full((B, 1), pos, dtype=torch.int64,
                           device=tokens.device)
    x, new_states = _stack(params, cfg, x, positions, states=states, pos=pos)
    logits = TF.logits_of(params, cfg, x)[:, 0]
    if sealed:
        new_states = _seal_states(new_states, key, nonce + 1)
    return logits, new_states
