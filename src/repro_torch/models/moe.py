"""Token-choice top-k MoE transformer (torch port of ``repro.models.moe``):
moonshot (64 experts, top-6, a shared expert) and llama4 (128 experts,
top-1, dense and MoE layers interleaved).

Dispatch is capacity-bounded scatter/gather: a token's position in its
expert comes from a cumsum down the token-major [T*k, E] assignment
matrix, tokens past capacity are dropped (they scatter zeros into slot
(0, 0) and gather nothing back), and the experts' FFNs run as batched
products over the [E, C, D] buffer.  The router runs in float32.

Two stack modes, as in the reference:
  * moe_every=1 (moonshot): every layer is attention + MoE (+ shared expert).
  * moe_every=2 (llama4): a unit is a PAIR of layers (attention + dense
    MLP, then attention + MoE), so 48 layers are 24 units.

Parameters are nested dicts with the reference's keys; unit leaves are
stacked [units, ...] (the pair's attention and norms [units, 2, ...]) and
taken apart with ``unbind`` (``TF.unbind_tree``), so a unit's backward
writes only its own slice of a stacked gradient.  In training each unit
runs under ``cfg.remat``.
Serving caches are [units, lpu, B, T, K, hd] (lpu: layers per unit); a
sealed unit is sealed whole under nonces 2 sub and 2 sub + 1 of the
unit's ``_layer_nonce``, and a decode slot's counter rows are
((j B + b) T + pos) K + k for layer j of the unit.

Port specifics (as ``transformer``): the unit scan is a Python loop;
``pos`` and ``nonce`` are host ints; ``decode_step`` writes the new slot
into the cache's tensors in place.  With ``cfg.moe_ep`` set, an active
sharding context (``parallel/sharding.py``) whose mesh has a model axis
that divides the expert count, the routed experts take the
expert-parallel dispatch of ``moe_ep.py``, as in the reference; without
such a mesh ``moe_ep`` is ignored.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core import cipher
from ..core.channel import resolve_device
from ..kernels import common
from . import layers as L
from . import transformer as TF

# a stacked expert leaf larger than this is drawn a unit at a time, so that
# init's float32 temporary stays one unit's size
_INIT_SLAB_ELEMS = 1 << 28


# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------

def _normal(generator, lead: tuple, shape: tuple, scale: float, dtype,
            device) -> torch.Tensor:
    """N(0, scale^2) weights of shape lead + shape, drawn in float32 and
    cast; one leading index at a time when the leaf is large."""
    full = lead + shape
    if not lead or math.prod(full) <= _INIT_SLAB_ELEMS:
        w = torch.randn(full, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dtype)
    out = torch.empty(full, dtype=dtype, device=device)
    for i in range(lead[0]):
        out[i] = _normal(generator, lead[1:], shape, scale, dtype, device)
    return out


def moe_params(generator, cfg, device, lead: tuple = ()):
    m = cfg.moe
    E, D, Fh = m.n_experts, cfg.d_model, cfg.d_ff
    dt = cfg.p_dtype
    p = {
        "router": L.dense_init(generator, D, E, torch.float32, device, lead),
        "w_gate": _normal(generator, lead, (E, D, Fh), D ** -0.5, dt, device),
        "w_up": _normal(generator, lead, (E, D, Fh), D ** -0.5, dt, device),
        "w_down": _normal(generator, lead, (E, Fh, D), Fh ** -0.5, dt,
                          device),
    }
    if m.shared_expert:
        p["shared"] = L.swiglu_params(generator, D, m.d_ff_shared or Fh, dt,
                                      device, lead)
    return p


def moe_specs(cfg):
    p = {
        "router": (None, None),
        "w_gate": ("model", "data", None),
        "w_up": ("model", "data", None),
        "w_down": ("model", None, "data"),
    }
    if cfg.moe.shared_expert:
        p["shared"] = L.swiglu_specs()
    return p


def capacity(cfg, n_tokens: int) -> int:
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8


def moe_ffn(p, cfg, x):
    """x: [B, S, D] -> [B, S, D] routed-expert output (shared expert
    separate)."""
    m = cfg.moe
    B, S, D = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    C = capacity(cfg, T)
    xt = x.reshape(T, D)
    dev = x.device

    gates = torch.softmax(xt.float() @ p["router"], dim=-1)
    gv, gi = torch.topk(gates, k, dim=-1, sorted=True)                # [T,k]
    gv = gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9)

    flat_e = gi.reshape(-1)                              # [T*k] token-major
    onehot = (flat_e[:, None] == torch.arange(E, device=dev)[None, :]
              ).to(torch.int64)
    ds = cfg.moe_dispatch_shards
    if ds > 1 and (T * k) % ds == 0:
        # shard-local dispatch: each of ds token segments packs its own
        # slice of Cl slots of every expert (more drops under imbalance)
        seg = (T * k) // ds
        Cl = max(8, C // ds)
        oh = onehot.reshape(ds, seg, E)
        pos_l = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1           # [ds,seg]
        keep = (pos_l < Cl).reshape(-1)
        base = (torch.arange(ds, device=dev) * Cl)[:, None]
        slot_c = (torch.where(pos_l < Cl, pos_l, 0) + base).reshape(-1)
        C = Cl * ds
    else:
        pos_in_e = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1  # [T*k]
        keep = pos_in_e < C
        slot_c = torch.where(keep, pos_in_e, 0)
    slot_e = torch.where(keep, flat_e, 0)

    x_rep = xt.repeat_interleave(k, dim=0) * keep[:, None].to(xt.dtype)
    buf = torch.zeros((E, C, D), dtype=xt.dtype, device=dev)
    buf.index_put_((slot_e, slot_c), x_rep, accumulate=True)

    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"])

    w = (gv.reshape(-1) * keep).to(xt.dtype)
    y_rep = out_buf[slot_e, slot_c] * w[:, None]
    y = y_rep.reshape(T, k, D).sum(dim=1)
    return y.reshape(B, S, D)


def _apply_moe(lp_moe, cfg, h2):
    from ..parallel import sharding as shd
    ctx = shd.active()
    names = () if ctx is None else ctx.mesh.mesh_dim_names
    if (cfg.moe_ep and "model" in names and cfg.moe.n_experts
            % ctx.mesh.size(names.index("model")) == 0):
        from . import moe_ep
        y = moe_ep.moe_ffn_ep(lp_moe, cfg, h2, ctx.mesh)
    else:
        y = moe_ffn(lp_moe, cfg, h2)
    if cfg.moe.shared_expert:
        y = y + L.swiglu(lp_moe["shared"], h2)
    return y


# ---------------------------------------------------------------------------
# stack units (single layer, or dense/MoE pair for moe_every=2)
# ---------------------------------------------------------------------------

def _unit_layers(cfg) -> tuple[int, int]:
    """(scan_units, layers_per_unit)."""
    if cfg.moe.moe_every == 2:
        if cfg.n_layers % 2:
            raise ValueError(f"moe_every=2 needs an even layer count, got "
                             f"{cfg.n_layers}")
        return cfg.n_layers // 2, 2
    return cfg.n_layers, 1


def _attn_sub(lp, cfg, x, positions, attend):
    """Pre-norm attention sub-block; ``attend(q, k, v)`` returns the
    attention output and the (k, v) to keep.  Returns (x, kept)."""
    B, S, _ = x.shape
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L.project_qkv(lp["attn"], cfg, h, positions)
    a, kept = attend(q, k, v)
    return x + L.attn_out(lp["attn"], a, B, S), kept


def _unit_init(generator, cfg, device, lead: tuple):
    dt = cfg.p_dtype
    D = cfg.d_model
    if cfg.moe.moe_every == 2:
        pair = lead + (2,)
        return {
            "ln1": torch.ones(pair + (D,), dtype=dt, device=device),
            "ln2": torch.ones(pair + (D,), dtype=dt, device=device),
            "attn": L.attn_params(generator, cfg, device, pair),
            "mlp": L.swiglu_params(generator, D,
                                   cfg.moe.d_ff_dense or 2 * cfg.d_ff, dt,
                                   device, lead),
            "moe": moe_params(generator, cfg, device, lead),
        }
    return {
        "ln1": torch.ones(lead + (D,), dtype=dt, device=device),
        "attn": L.attn_params(generator, cfg, device, lead),
        "ln2": torch.ones(lead + (D,), dtype=dt, device=device),
        "moe": moe_params(generator, cfg, device, lead),
    }


def _unit_specs(cfg):
    if cfg.moe.moe_every == 2:
        return {"ln1": (None, None), "ln2": (None, None),
                "attn": TF.stack_specs(TF._fsdp(L.attn_specs(cfg))),
                "mlp": TF._fsdp(L.swiglu_specs()),
                "moe": moe_specs(cfg)}
    return {"ln1": (None,), "attn": TF._fsdp(L.attn_specs(cfg)),
            "ln2": (None,), "moe": moe_specs(cfg)}


def _unit_apply(lp, cfg, x, positions, attend):
    """Apply one unit.  ``attend(j, q, k, v)`` is layer j's attention.
    Returns (x, [kept of each layer])."""
    if cfg.moe.moe_every == 2:
        ln1 = lp["ln1"].unbind(0)
        attn = TF.unbind_tree(lp["attn"])
        lp0 = {"ln1": ln1[0], "attn": attn[0]}
        lp1 = {"ln1": ln1[1], "attn": attn[1]}
        ln2 = lp["ln2"].unbind(0)
        x, kv0 = _attn_sub(lp0, cfg, x, positions,
                           lambda q, k, v: attend(0, q, k, v))
        h = L.rms_norm(x, ln2[0], cfg.norm_eps)
        x = x + L.swiglu(lp["mlp"], h)
        x, kv1 = _attn_sub(lp1, cfg, x, positions,
                           lambda q, k, v: attend(1, q, k, v))
        h = L.rms_norm(x, ln2[1], cfg.norm_eps)
        return x + _apply_moe(lp["moe"], cfg, h), [kv0, kv1]
    x, kv = _attn_sub(lp, cfg, x, positions,
                      lambda q, k, v: attend(0, q, k, v))
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _apply_moe(lp["moe"], cfg, h), [kv]


# ---------------------------------------------------------------------------
# params / forward / loss
# ---------------------------------------------------------------------------

def init(generator: torch.Generator, cfg, device="cuda"):
    """Random weights for ``cfg`` on ``device`` (generator on that device);
    stacked expert leaves are drawn a unit at a time."""
    device = resolve_device(device)
    units, _ = _unit_layers(cfg)
    dt = cfg.p_dtype
    return {
        "embed": L.embed_init(generator, cfg.vocab, cfg.d_model, dt, device),
        "layers": _unit_init(generator, cfg, device, (units,)),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "unembed": L.dense_init(generator, cfg.d_model, cfg.vocab, dt,
                                device),
    }


def param_specs(cfg):
    return {"embed": ("model", "data"),
            "layers": TF.stack_specs(_unit_specs(cfg)),
            "final_norm": (None,), "unembed": ("data", "model")}


def _forward(params, cfg, x, positions):
    """Causal forward through the units (prefill / loss, no cache read),
    each unit under ``cfg.remat``.  Returns (x, (k, v)) with k, v
    [units, lpu, B, S, K, hd]."""
    def causal(j, q, k, v):
        return L.gqa_attention(q, k, v, causal=True,
                               q_block=cfg.q_block), (k, v)

    f = TF._maybe_remat(
        lambda xx, lp: _unit_apply(lp, cfg, xx, positions, causal), cfg)
    ks, vs = [], []
    for lp in TF.layer_stack(params):
        x, kept = f(x, lp)
        ks.append(torch.stack([k for k, _ in kept]))
        vs.append(torch.stack([v for _, v in kept]))
    return x, (torch.stack(ks), torch.stack(vs))


def loss(params, cfg, batch):
    """Next-token CE. batch: tokens [B,S], labels [B,S] (-1 = masked)."""
    x, n_front = TF._embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _forward(params, cfg, x, positions)
    logits = TF.logits_of(params, cfg, x[:, n_front:])
    labels = batch["labels"]
    return L.softmax_xent(logits, torch.clamp(labels, min=0),
                          mask=labels >= 0)


# ---------------------------------------------------------------------------
# serving — cache layout [units, lpu, B, T, K, hd]
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, sealed: bool = False,
               device="cuda"):
    units, lpu = _unit_layers(cfg)
    shape = (units, lpu, batch, max_len, cfg.n_kv_heads, cfg.hd)
    device = resolve_device(device)
    cache = {"pos": 0}
    if sealed:
        udt = cipher.uint_dtype_for(cfg.act_dtype)
        cache["k_ct"] = torch.zeros(shape, dtype=udt, device=device)
        cache["v_ct"] = torch.zeros(shape, dtype=udt, device=device)
        cache["nonce"] = 0
    else:
        cache["k"] = torch.zeros(shape, dtype=cfg.act_dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=cfg.act_dtype, device=device)
    return cache


def cache_specs(cfg, sealed: bool = False):
    kv = (None, None, "data", "model", None, None)
    out = {"pos": "r"}
    if sealed:
        out.update({"k_ct": kv, "v_ct": kv, "nonce": "r"})
    else:
        out.update({"k": kv, "v": kv})
    return out


def _slot_rows(lpu: int, B: int, T: int, K: int, pos: int,
               device) -> torch.Tensor:
    """Counter rows ((j*B + b)*T + pos)*K + k of one token slot of a unit,
    int64 [lpu, B, 1, K]."""
    j = torch.arange(lpu, dtype=torch.int64, device=device)[:, None, None,
                                                            None]
    b = torch.arange(B, dtype=torch.int64, device=device)[None, :, None, None]
    k = torch.arange(K, dtype=torch.int64, device=device)[None, None, None, :]
    return (((j * B + b) * T + pos) * K + k) & common.M32


def prefill(params, cfg, batch, max_len: int, seal_ctx=None, blocks=None):
    """Run the full prompt; return (last-token logits, cache at ``max_len``).
    seal_ctx: (key int32 [2], nonce int) seals each unit's cache whole —
    the padding rows too, as the reference does.  blocks: only these
    blocks of the cache (``transformer.prefill``)."""
    x, _ = TF._embed_inputs(params, cfg, batch)
    S = x.shape[1]
    pad = max_len - S
    if pad < 0:
        raise ValueError(f"a prompt of {S} positions exceeds the "
                         f"{max_len}-slot cache")
    x, (ks, vs) = _forward(params, cfg, x, torch.arange(S, device=x.device))
    ks = F.pad(ks, (0, 0, 0, 0, 0, pad))
    vs = F.pad(vs, (0, 0, 0, 0, 0, pad))
    cache = {"pos": S}
    if seal_ctx is not None:
        key, nonce = seal_ctx
        # a unit [lpu, B, T, K, hd] is one item: rows run over (j, b, t, k)
        k_ct, v_ct = TF.seal_layers(ks, vs, key, nonce, blocks)
        cache.update({"k_ct": k_ct, "v_ct": v_ct,
                      "nonce": int(nonce) & common.M32})
    else:
        cache.update(TF.plain_blocks({"k": ks, "v": vs}, blocks))
    logits = TF.logits_of(params, cfg, x[:, -1:, :])
    return logits[:, 0], cache


def decode_step(params, cfg, cache, tokens, seal_ctx=None):
    """One decode step. tokens: int [B].  Returns (logits [B, V], cache):
    the new slot is written into the cache's tensors in place."""
    B = tokens.shape[0]
    pos = int(cache["pos"])
    sealed = seal_ctx is not None
    kall = cache["k_ct"] if sealed else cache["k"]
    _, lpu, _, T, K, _ = kall.shape
    if pos >= T:
        raise ValueError(f"decode position {pos} is past the {T}-slot cache")
    dev = tokens.device
    dt = cfg.act_dtype
    x = params["embed"][tokens[:, None]].to(dt)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=dev)
    key = seal_ctx[0] if sealed else None
    rows = _slot_rows(lpu, B, T, K, pos, dev) if sealed else None
    for u, lp in enumerate(TF.layer_stack(params)):
        if sealed:
            kc, vc = cache["k_ct"][u], cache["v_ct"][u]  # [lpu, B, T, K, hd]
            nk, nv = TF._kv_nonces(cache["nonce"], u)
            kcache = cipher.unseal_bits(kc, key, nk, dt)
            vcache = cipher.unseal_bits(vc, key, nv, dt)
            # slots at or past pos hold keystream noise: zero them
            tmask = (torch.arange(T, device=dev) < pos)[None, None, :, None,
                                                        None]
            zero = torch.zeros((), dtype=dt, device=dev)
            kcache = torch.where(tmask, kcache, zero)
            vcache = torch.where(tmask, vcache, zero)
        else:
            kcache, vcache = cache["k"][u], cache["v"][u]  # updated in place

        def attend(j, q, k, v):
            kcache[j, :, pos] = k[:, 0]
            vcache[j, :, pos] = v[:, 0]
            a = L.gqa_attention(q, kcache[j], vcache[j], causal=False,
                                t_valid=pos + 1)
            return a, None

        x, _ = _unit_apply(lp, cfg, x, positions, attend)
        if sealed:
            # write back only the new slot of each of the unit's layers
            new_k = kcache[:, :, pos:pos + 1]
            new_v = vcache[:, :, pos:pos + 1]
            kc[:, :, pos:pos + 1] = cipher.seal_bits_slice(new_k, key, nk,
                                                           rows)
            vc[:, :, pos:pos + 1] = cipher.seal_bits_slice(new_v, key, nv,
                                                           rows)
    logits = TF.logits_of(params, cfg, x)[:, 0]
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits, new_cache
