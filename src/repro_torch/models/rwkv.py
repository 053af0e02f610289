"""RWKV-6 "Finch" (torch port of ``repro.models.rwkv``): attention-free
linear RNN with data-dependent decay.

Per head (dim hd), the WKV state S is [hd_k, hd_v]:
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
with w_t = exp(-exp(w_base + LoRA_w(x~_t))) the data-dependent decay,
token-shift mixing x~ = lerp(x_t, x_{t-1}, mu + LoRA(x)), and a
channel-mix FFN (squared ReLU).  The recurrence runs in float32 through
``kernels.wkv6_scan`` (CUDA chunked-scan kernels with their backward on
the card, the same chunked algorithm in torch on the CPU), which takes the
log decay -exp(w_base + LoRA_w(x~_t)); the layer scan is a Python loop over
layers; decode carries (S, shift states), O(1) state.

Sealed serving: the state is resealed whole every decode step under the
bumped nonce n + 1 (``wkv`` at nonce 4n, ``tm_x`` 4n + 1, ``cm_x`` 4n + 2,
mod 2^32), CTR only, as in the reference.  ``decode_step`` returns a new
state dict; nothing is written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import cipher
from ..core import sealed as sealed_lib
from ..core.channel import resolve_device
from ..kernels import common
from ..kernels.wkv6_scan import ops as wkv_ops
from . import layers as L
from . import transformer as TF

_MIX = ("r", "k", "v", "w", "g")
_MIX_LORA = 32           # rank of the five mix streams' LoRA (fixed)


def _normal(generator, shape, scale, dtype, device):
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)


def _tm_init(generator, cfg, device, lead):
    D = cfg.d_model
    hd = cfg.rwkv.head_dim
    H = D // hd
    r = cfg.rwkv.decay_lora
    dt = cfg.p_dtype

    def dense(d_in, d_out):
        return L.dense_init(generator, d_in, d_out, dt, device, lead)

    return {
        "mu": torch.full(lead + (len(_MIX), D), 0.5, dtype=dt, device=device),
        "mix_lora_a": dense(D, _MIX_LORA * len(_MIX)),
        "mix_lora_b": _normal(generator, lead + (len(_MIX), _MIX_LORA, D),
                              0.01, dt, device),
        "wr": dense(D, D), "wk": dense(D, D), "wv": dense(D, D),
        "wg": dense(D, D), "wo": dense(D, D),
        # data-dependent decay: w_t = exp(-exp(w_base + B(tanh(A x~_w))))
        "w_base": torch.full(lead + (D,), -6.0, dtype=dt, device=device),
        "w_lora_a": dense(D, r),
        "w_lora_b": _normal(generator, lead + (r, D), 0.01, dt, device),
        "u": _normal(generator, lead + (H, hd), 0.1, dt, device),
        "ln_x": torch.ones(lead + (D,), dtype=dt, device=device),
    }


def _cm_init(generator, cfg, device, lead):
    D, Fd, dt = cfg.d_model, cfg.d_ff, cfg.p_dtype
    return {
        "mu_k": torch.full(lead + (D,), 0.5, dtype=dt, device=device),
        "mu_r": torch.full(lead + (D,), 0.5, dtype=dt, device=device),
        "wk": L.dense_init(generator, D, Fd, dt, device, lead),
        "wv": L.dense_init(generator, Fd, D, dt, device, lead),
        "wr": L.dense_init(generator, D, D, dt, device, lead),
    }


def init(generator: torch.Generator, cfg, device="cuda"):
    """Random weights for ``cfg`` on ``device`` (generator on that device),
    with the reference's tree: layer leaves stacked [n_layers, ...]."""
    device = resolve_device(device)
    lead = (cfg.n_layers,)
    dt = cfg.p_dtype
    return {
        "embed": L.embed_init(generator, cfg.vocab, cfg.d_model, dt, device),
        "layers": {
            "ln1": torch.ones(lead + (cfg.d_model,), dtype=dt, device=device),
            "tm": _tm_init(generator, cfg, device, lead),
            "ln2": torch.ones(lead + (cfg.d_model,), dtype=dt, device=device),
            "cm": _cm_init(generator, cfg, device, lead),
        },
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "unembed": L.dense_init(generator, cfg.d_model, cfg.vocab, dt, device),
    }


def param_specs(cfg):
    tm = {
        "mu": (None, None), "mix_lora_a": (None, None),
        "mix_lora_b": (None, None, None),
        "wr": ("data", "model"), "wk": ("data", "model"),
        "wv": ("data", "model"), "wg": ("data", "model"),
        "wo": ("model", "data"),
        "w_base": (None,), "w_lora_a": (None, None), "w_lora_b": (None, None),
        "u": (None, None), "ln_x": (None,),
    }
    cm = {"mu_k": (None,), "mu_r": (None,),
          "wk": ("data", "model"), "wv": ("model", "data"),
          "wr": ("data", None)}
    block = {"ln1": (None,), "tm": tm, "ln2": (None,), "cm": cm}
    return {"embed": ("model", "data"), "layers": TF.stack_specs(block),
            "final_norm": (None,), "unembed": ("data", "model")}


# ---------------------------------------------------------------------------
# time mix
# ---------------------------------------------------------------------------

def _token_shift(x, prev):
    """[B,S,D] shifted right by one; position 0 takes ``prev`` [B,D]."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(p, x, xs):
    """Finch data-dependent lerp for the five mix streams -> dict of [B,S,D]."""
    delta = xs - x
    base = x + delta * p["mu"][:, None, None, :]                     # [5,B,S,D]
    lora = torch.tanh(x @ p["mix_lora_a"])                           # [B,S,5*32]
    B_, S_, _ = x.shape
    lora = lora.reshape(B_, S_, len(_MIX), _MIX_LORA).permute(2, 0, 1, 3)
    adj = torch.einsum("nbsr,nrd->nbsd", lora, p["mix_lora_b"])
    mixed = base + delta * adj
    return {name: mixed[i] for i, name in enumerate(_MIX)}


def time_mix(p, cfg, x, prev_x, state):
    """x: [B,S,D]; prev_x: [B,D]; state: float32 [B,H,hd,hd]
    -> (y, last_x, state)."""
    B, S, D = x.shape
    hd = cfg.rwkv.head_dim
    H = D // hd
    m = _ddlerp(p, x, _token_shift(x, prev_x))
    r = (m["r"] @ p["wr"]).reshape(B, S, H, hd).float()
    k = (m["k"] @ p["wk"]).reshape(B, S, H, hd).float()
    v = (m["v"] @ p["wv"]).reshape(B, S, H, hd).float()
    g = F.silu(m["g"] @ p["wg"])
    w_log = p["w_base"].float() + \
        torch.tanh(m["w"] @ p["w_lora_a"]).float() @ p["w_lora_b"].float()
    # the log decay: w = exp(lw) in [0, 1)
    lw = -torch.exp(w_log).reshape(B, S, H, hd)
    # the WKV recurrence: one scan op (the card's kernels, their chunked
    # algorithm on the CPU, shapes only on the meta device)
    y, state = wkv_ops.wkv6_scan(r, k, v, lw, p["u"].float(), state)
    y = y.reshape(B, S, D).to(x.dtype)
    y = L.rms_norm(y, p["ln_x"], cfg.norm_eps)                       # per channel
    return (y * g) @ p["wo"], x[:, -1, :], state


def channel_mix(p, x, prev_x):
    xs = _token_shift(x, prev_x)
    xk = x + (xs - x) * p["mu_k"]
    xr = x + (xs - x) * p["mu_r"]
    k = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1, :]


def _block(lp, cfg, x, states):
    """states: dict(wkv [B,H,hd,hd], tm_x [B,D], cm_x [B,D])."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, tm_x, wkv = time_mix(lp["tm"], cfg, h, states["tm_x"], states["wkv"])
    x = x + y
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y2, cm_x = channel_mix(lp["cm"], h2, states["cm_x"])
    return x + y2, {"wkv": wkv, "tm_x": tm_x, "cm_x": cm_x}


_STATE_FIELDS = ("wkv", "tm_x", "cm_x")


def init_state(cfg, batch: int, n_layers: int | None = None, device="cuda"):
    nl = n_layers if n_layers is not None else cfg.n_layers
    hd = cfg.rwkv.head_dim
    H = cfg.d_model // hd
    device = resolve_device(device)
    return {
        "wkv": torch.zeros((nl, batch, H, hd, hd), dtype=torch.float32,
                           device=device),
        "tm_x": torch.zeros((nl, batch, cfg.d_model), dtype=cfg.act_dtype,
                            device=device),
        "cm_x": torch.zeros((nl, batch, cfg.d_model), dtype=cfg.act_dtype,
                            device=device),
        "pos": 0,
    }


def init_state_sealed(cfg, batch: int, n_layers: int | None = None,
                      device="cuda"):
    """Sealed-state structure (ciphertext dtypes), zeros: the real values
    come from prefill's ``_seal_state``."""
    st = init_state(cfg, batch, n_layers, device)
    udt = cipher.uint_dtype_for(cfg.act_dtype)
    return {"wkv": torch.zeros_like(st["wkv"], dtype=torch.int32),
            "tm_x": torch.zeros_like(st["tm_x"], dtype=udt),
            "cm_x": torch.zeros_like(st["cm_x"], dtype=udt),
            "pos": 0, "nonce": 0}


def state_specs(cfg, sealed: bool = False):
    s = {"wkv": (None, "data", "model", None, None),
         "tm_x": (None, "data", None), "cm_x": (None, "data", None),
         "pos": "r"}
    if sealed:
        s["nonce"] = "r"
    return s


def _forward(params, cfg, x, states):
    """The layer loop, each block under ``cfg.remat``; states: stacked
    [n_layers, ...] fields.  Returns (x, new stacked states)."""
    block = TF._maybe_remat(lambda xx, lp, st: _block(lp, cfg, xx, st), cfg)
    outs = {f: [] for f in _STATE_FIELDS}
    for l, lp in enumerate(TF.layer_stack(params)):
        x, st = block(x, lp, {f: states[f][l] for f in _STATE_FIELDS})
        for f in _STATE_FIELDS:
            outs[f].append(st[f])
    return x, {f: torch.stack(v) for f, v in outs.items()}


def _embed(params, cfg, tokens):
    return params["embed"][tokens].to(cfg.act_dtype)


def loss(params, cfg, batch):
    """Next-token CE. batch: tokens [B,S], labels [B,S] (-1 = masked)."""
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    x, _ = _forward(params, cfg, x,
                    init_state(cfg, tokens.shape[0], device=x.device))
    logits = TF.logits_of(params, cfg, x)
    labels = batch["labels"]
    return L.softmax_xent(logits, torch.clamp(labels, min=0),
                          mask=labels >= 0)


def prefill(params, cfg, batch, max_len: int, seal_ctx=None, blocks=None):
    """For an RNN the 'cache' is the state; ``max_len`` is irrelevant.
    blocks: only these blocks of the state (``transformer.prefill``)."""
    del max_len
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    x, new_states = _forward(params, cfg, x,
                             init_state(cfg, tokens.shape[0],
                                        device=x.device))
    new_states["pos"] = tokens.shape[1]
    logits = TF.logits_of(params, cfg, x[:, -1:, :])[:, 0]
    if seal_ctx is not None:
        new_states = _seal_state(new_states, seal_ctx, blocks)
    elif blocks is not None:
        new_states.update(TF.plain_blocks(
            {f: new_states[f] for f in _STATE_FIELDS}, blocks))
    return logits, new_states


def _seal_state(states, seal_ctx, regions=None):
    """CTR-seal the three state fields under nonces 4n, 4n + 1, 4n + 2
    (each field one item); ``regions``: only a rank's block of each."""
    key, nonce = seal_ctx
    n = int(nonce) & common.M32
    regions = regions or {}
    out = dict(states)
    for i, f in enumerate(_STATE_FIELDS):
        out[f] = sealed_lib.seal_items(states[f], key,
                                       (n * 4 + i) & common.M32,
                                       regions.get(f), lead=0)
    out["nonce"] = n
    return out


def _unseal_state_t(states, key, cfg):
    n = int(states["nonce"])
    dts = {"wkv": torch.float32, "tm_x": cfg.act_dtype, "cm_x": cfg.act_dtype}
    out = {f: cipher.unseal_bits(states[f], key, (n * 4 + i) & common.M32,
                                 dts[f])
           for i, f in enumerate(_STATE_FIELDS)}
    out["pos"] = states["pos"]
    return out


def decode_step(params, cfg, states, tokens, seal_ctx=None):
    """One token for the whole stack. tokens: int [B].  Returns (logits
    [B, V], new states); a sealed state comes back under nonce n + 1."""
    sealed = seal_ctx is not None
    if sealed:
        key = seal_ctx[0]
        nonce = int(states["nonce"])
        states = _unseal_state_t(states, key, cfg)
    x = _embed(params, cfg, tokens[:, None])
    x, new_states = _forward(params, cfg, x, states)
    new_states["pos"] = int(states["pos"]) + 1
    logits = TF.logits_of(params, cfg, x)[:, 0]
    if sealed:
        new_states = _seal_state(new_states, (key, nonce + 1))
    return logits, new_states
