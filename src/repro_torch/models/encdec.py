"""Encoder-decoder transformer (torch port of ``repro.models.encdec``): the
seamless-m4t family, its audio frontend a stub.

Encoder: non-causal self-attention with RoPE over precomputed frame
embeddings [B, T_src, D].  Decoder: causal self-attention with RoPE, then
cross-attention to the encoder output (no RoPE: ``hx @ wq`` against
``enc_out @ wk / wv``), then the SwiGLU MLP.  Serving caches: the decoder's
self KV [n_dec, B, max_len, K, hd], which grows, and the cross KV
[n_dec, B, src_len, K, hd], computed once at prefill.  Sealed, layer l's
k, v, xk and xv take nonces 4 sub + 0 ... 3 of its ``_layer_nonce`` (mod
2^32); only the self KV is padded to ``max_len`` and masked at decode.

Port specifics (as ``transformer``): the layer scans are Python loops;
``pos`` and ``nonce`` are host ints; ``decode_step`` writes the new slot
into the self KV in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import cipher
from ..core import sealed as sealed_lib
from ..core.channel import resolve_device
from ..kernels import common
from . import layers as L
from . import transformer as TF

_CACHE_FIELDS = ("k", "v", "xk", "xv")


def init(generator: torch.Generator, cfg, device="cuda"):
    """Random weights for ``cfg`` on ``device`` (generator on that device)."""
    device = resolve_device(device)
    dt, D = cfg.p_dtype, cfg.d_model
    ne = (cfg.encdec.n_enc_layers,)
    nd = (cfg.encdec.n_dec_layers,)
    return {
        "embed": L.embed_init(generator, cfg.vocab, D, dt, device),
        "enc_layers": {
            "ln1": torch.ones(ne + (D,), dtype=dt, device=device),
            "attn": L.attn_params(generator, cfg, device, ne),
            "ln2": torch.ones(ne + (D,), dtype=dt, device=device),
            "mlp": L.swiglu_params(generator, D, cfg.d_ff, dt, device, ne),
        },
        "enc_norm": torch.ones((D,), dtype=dt, device=device),
        "dec_layers": {
            "ln1": torch.ones(nd + (D,), dtype=dt, device=device),
            "self_attn": L.attn_params(generator, cfg, device, nd),
            "ln_x": torch.ones(nd + (D,), dtype=dt, device=device),
            "cross_attn": L.attn_params(generator, cfg, device, nd),
            "ln2": torch.ones(nd + (D,), dtype=dt, device=device),
            "mlp": L.swiglu_params(generator, D, cfg.d_ff, dt, device, nd),
        },
        "final_norm": torch.ones((D,), dtype=dt, device=device),
        "unembed": L.dense_init(generator, D, cfg.vocab, dt, device),
    }


def param_specs(cfg):
    enc = {"ln1": (None,), "attn": TF._fsdp(L.attn_specs(cfg)),
           "ln2": (None,), "mlp": TF._fsdp(L.swiglu_specs())}
    dec = {"ln1": (None,), "self_attn": TF._fsdp(L.attn_specs(cfg)),
           "ln_x": (None,), "cross_attn": TF._fsdp(L.attn_specs(cfg)),
           "ln2": (None,), "mlp": TF._fsdp(L.swiglu_specs())}
    return {"embed": ("model", "data"), "enc_layers": TF.stack_specs(enc),
            "enc_norm": (None,), "dec_layers": TF.stack_specs(dec),
            "final_norm": (None,), "unembed": ("data", "model")}


def encode(params, cfg, frames):
    """frames: [B, T_src, D] precomputed embeddings (frontend stub); each
    block under ``cfg.remat``."""
    x = frames.to(cfg.act_dtype)
    positions = torch.arange(x.shape[1], device=x.device)

    def full(q, k, v):
        return L.gqa_attention(q, k, v, causal=False,
                               q_block=cfg.q_block), None

    f = TF._maybe_remat(
        lambda xx, lp: TF._block(lp, cfg, xx, positions, full)[0], cfg)
    for lp in TF.unbind_tree(params["enc_layers"]):
        x = f(x, lp)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(lp, cfg, x, positions, enc_kv, attend):
    """enc_kv: the layer's cross (k, v); ``attend(q, k, v)`` is the
    self-attention, returning its output and the (k, v) to keep.
    Returns (x, kept)."""
    B, S, _ = x.shape
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L.project_qkv(lp["self_attn"], cfg, h, positions)
    a, kept = attend(q, k, v)
    x = x + L.attn_out(lp["self_attn"], a, B, S)
    hx = L.rms_norm(x, lp["ln_x"], cfg.norm_eps)
    qx = (hx @ lp["cross_attn"]["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    ax = L.gqa_attention(qx, enc_kv[0], enc_kv[1], causal=False,
                         q_block=cfg.q_block)
    x = x + L.attn_out(lp["cross_attn"], ax, B, S)
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.swiglu(lp["mlp"], h2), kept


def _cross_kv(lp, cfg, enc_out):
    B, T, _ = enc_out.shape
    k = (enc_out @ lp["cross_attn"]["wk"]).reshape(B, T, cfg.n_kv_heads,
                                                   cfg.hd)
    v = (enc_out @ lp["cross_attn"]["wv"]).reshape(B, T, cfg.n_kv_heads,
                                                   cfg.hd)
    return k, v


def _decoder(params, cfg, enc_out, tokens, keep: bool = True):
    """Causal decoder pass over ``tokens``, each block (its cross KV
    included) under ``cfg.remat``.  Returns (x, (k, v, xk, xv)) stacked
    [n_dec, B, ...], or (x, None) when ``keep`` is off (training)."""
    x = params["embed"][tokens].to(cfg.act_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def causal(q, k, v):
        return L.gqa_attention(q, k, v, causal=True,
                               q_block=cfg.q_block), (k, v)

    def block(xx, lp):
        enc_kv = _cross_kv(lp, cfg, enc_out)
        xx, (k, v) = _dec_block(lp, cfg, xx, positions, enc_kv, causal)
        return xx, ((k, v, *enc_kv) if keep else None)

    f = TF._maybe_remat(block, cfg)
    kept = []
    for lp in TF.unbind_tree(params["dec_layers"]):
        x, kv = f(x, lp)
        kept.append(kv)
    if not keep:
        return x, None
    return x, tuple(torch.stack(t) for t in zip(*kept))


def loss(params, cfg, batch):
    """Next-token CE. batch: frame_embeds [B,T,D], tokens [B,S], labels [B,S]
    (-1 = masked)."""
    enc_out = encode(params, cfg, batch["frame_embeds"])
    x, _ = _decoder(params, cfg, enc_out, batch["tokens"], keep=False)
    logits = TF.logits_of(params, cfg, x)
    labels = batch["labels"]
    return L.softmax_xent(logits, torch.clamp(labels, min=0),
                          mask=labels >= 0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, src_len: int,
               sealed: bool = False, device="cuda"):
    K, hd = cfg.n_kv_heads, cfg.hd
    nd = cfg.encdec.n_dec_layers
    device = resolve_device(device)
    dt = cipher.uint_dtype_for(cfg.act_dtype) if sealed else cfg.act_dtype
    sfx = "_ct" if sealed else ""
    c = {"pos": 0}
    for name, T in zip(_CACHE_FIELDS, (max_len, max_len, src_len, src_len)):
        c[name + sfx] = torch.zeros((nd, batch, T, K, hd), dtype=dt,
                                    device=device)
    if sealed:
        c["nonce"] = 0
    return c


def cache_specs(cfg, sealed: bool = False):
    kv = (None, "data", "model", None, None)
    names = (("k_ct", "v_ct", "xk_ct", "xv_ct") if sealed
             else _CACHE_FIELDS)
    out = {n: kv for n in names}
    out["pos"] = "r"
    if sealed:
        out["nonce"] = "r"
    return out


def _nonces(nonce: int, layer_idx: int) -> tuple[int, int, int, int]:
    """Layer l's nonces of k, v, xk and xv: 4 sub + 0 ... 3 mod 2^32."""
    sub = TF._layer_nonce(nonce, layer_idx)
    return tuple((sub * 4 + i) & common.M32 for i in range(4))


def seal_caches(caches, key: torch.Tensor, nonce: int, regions=None):
    """Seal (k, v, xk, xv), each [n_dec, B, T, K, hd], layer by layer
    under each layer's four nonces; one CTR launch per field (the layers
    are the items of one batch).  ``regions`` ({field + "_ct": Region})
    seals only a rank's block of each."""
    n = caches[0].shape[0]
    nonces = [_nonces(nonce, l) for l in range(n)]
    keys = key.reshape(1, 2).expand(n, 2)
    regions = regions or {}
    return tuple(
        sealed_lib.seal_items(c, keys, torch.tensor([ns[i] for ns in nonces],
                                                    device=c.device),
                              regions.get(f + "_ct"))
        for i, (c, f) in enumerate(zip(caches, _CACHE_FIELDS)))


def prefill(params, cfg, batch, max_len: int, seal_ctx=None, blocks=None):
    """Encode the source, prefill the decoder over the prompt tokens;
    return (last-token logits, cache).  batch: frame_embeds [B, T_src, D]
    and tokens [B, S]; the self KV is padded to ``max_len`` (the padding
    rows sealed too, as the reference does), the cross KV is T_src long.
    blocks: only these blocks of the cache (``transformer.prefill``)."""
    enc_out = encode(params, cfg, batch["frame_embeds"])
    tokens = batch["tokens"]
    S = tokens.shape[1]
    pad = max_len - S
    if pad < 0:
        raise ValueError(f"a prompt of {S} positions exceeds the "
                         f"{max_len}-slot cache")
    x, (ks, vs, xks, xvs) = _decoder(params, cfg, enc_out, tokens)
    ks = F.pad(ks, (0, 0, 0, 0, 0, pad))
    vs = F.pad(vs, (0, 0, 0, 0, 0, pad))
    cache = {"pos": S}
    if seal_ctx is not None:
        key, nonce = seal_ctx
        sealed = seal_caches((ks, vs, xks, xvs), key, nonce, blocks)
        cache.update({f + "_ct": c for f, c in zip(_CACHE_FIELDS, sealed)})
        cache["nonce"] = int(nonce) & common.M32
    else:
        cache.update(TF.plain_blocks(
            dict(zip(_CACHE_FIELDS, (ks, vs, xks, xvs))), blocks))
    logits = TF.logits_of(params, cfg, x[:, -1:, :])[:, 0]
    return logits, cache


def decode_step(params, cfg, cache, tokens, seal_ctx=None):
    """One decode step. tokens: int [B].  Returns (logits [B, V], cache):
    the new slot is written into the self KV's tensors in place."""
    B = tokens.shape[0]
    pos = int(cache["pos"])
    sealed = seal_ctx is not None
    sfx = "_ct" if sealed else ""
    T, K = cache["k" + sfx].shape[2:4]
    if pos >= T:
        raise ValueError(f"decode position {pos} is past the {T}-slot cache")
    dev = tokens.device
    dt = cfg.act_dtype
    x = params["embed"][tokens[:, None]].to(dt)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=dev)
    key = seal_ctx[0] if sealed else None
    rows = TF._slot_rows(B, T, K, pos, dev) if sealed else None
    for l, lp in enumerate(TF.unbind_tree(params["dec_layers"])):
        kc, vc, xkc, xvc = (cache[f + sfx][l] for f in _CACHE_FIELDS)
        if sealed:
            nk, nv, nxk, nxv = _nonces(cache["nonce"], l)
            kcache = cipher.unseal_bits(kc, key, nk, dt)
            vcache = cipher.unseal_bits(vc, key, nv, dt)
            xk = cipher.unseal_bits(xkc, key, nxk, dt)
            xv = cipher.unseal_bits(xvc, key, nxv, dt)
            # self-KV slots at or past pos hold keystream noise: zero them
            tmask = (torch.arange(T, device=dev) < pos)[None, :, None, None]
            zero = torch.zeros((), dtype=dt, device=dev)
            kcache = torch.where(tmask, kcache, zero)
            vcache = torch.where(tmask, vcache, zero)
        else:
            kcache, vcache, xk, xv = kc, vc, xkc, xvc     # updated in place

        def attend(q, k, v):
            kcache[:, pos] = k[:, 0]
            vcache[:, pos] = v[:, 0]
            a = L.gqa_attention(q, kcache, vcache, causal=False,
                                t_valid=pos + 1)
            if sealed:
                kc[:, pos:pos + 1] = cipher.seal_bits_slice(k, key, nk, rows)
                vc[:, pos:pos + 1] = cipher.seal_bits_slice(v, key, nv, rows)
            return a, None

        x, _ = _dec_block(lp, cfg, x, positions, (xk, xv), attend)
    logits = TF.logits_of(params, cfg, x)[:, 0]
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits, new_cache
