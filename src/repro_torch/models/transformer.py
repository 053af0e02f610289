"""Dense GQA transformer LM (torch port of ``repro.models.transformer``),
also the backbone of the VLM family (a ``patch_proj`` of precomputed patch
embeddings placed before the tokens) and the source of the attention and
logits the recurrent families reuse.

Parameters are nested dicts with the reference's keys; layer leaves are
stacked [n_layers, ...].  ``init`` makes full-width random weights straight
on the device, ``params_from_numpy`` carries the reference's ``init`` tree
across so both packages compute on the same weights.

Training (token inputs): ``loss`` — embed, ``backbone`` with each block
under ``cfg.remat`` (``_maybe_remat``, which every family applies where
the reference does), final norm, logits and the masked cross-entropy.
Serving over a fixed-slot KV cache: ``init_cache``, ``prefill`` and
``decode_step``, with the reference's three
decode branches — plain cache, sealed cache unsealed per layer, and sealed
cache read by the sealed flash-decode kernel
(``cfg.fused_sealed_attention``).  The paged engine (``serve/engine.py``)
runs its own layer loop over the same blocks.

Port specifics: the layer scan is a Python loop; ``pos`` and ``nonce`` of a
cache are host ints; ``decode_step`` writes the new slot into the cache's
tensors IN PLACE and returns the cache dict with ``pos`` advanced.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..core import cipher
from ..core import sealed as sealed_lib
from ..core.channel import resolve_device
from ..kernels import common
from ..kernels.sealed_attention.ops import sealed_decode_attention
from . import layers as L


def init(generator: torch.Generator, cfg, device="cuda"):
    """Random weights for ``cfg`` on ``device`` (generator on that device)."""
    device = resolve_device(device)
    lead = (cfg.n_layers,)
    dt = cfg.p_dtype
    params = {
        "embed": L.embed_init(generator, cfg.vocab, cfg.d_model, dt, device),
        "layers": {
            "ln1": torch.ones(lead + (cfg.d_model,), dtype=dt, device=device),
            "attn": L.attn_params(generator, cfg, device, lead),
            "ln2": torch.ones(lead + (cfg.d_model,), dtype=dt, device=device),
            "mlp": L.swiglu_params(generator, cfg.d_model, cfg.d_ff, dt,
                                   device, lead),
        },
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(generator, cfg.d_model, cfg.vocab,
                                         dt, device)
    if cfg.frontend == "patch":
        params["patch_proj"] = L.dense_init(generator, cfg.d_model,
                                            cfg.d_model, dt, device)
    return params


# ---------------------------------------------------------------------------
# logical sharding specs (parallel/sharding.py): a tuple of logical axes per
# leaf dimension, "r" for a replicated scalar
# ---------------------------------------------------------------------------

def map_specs(fn, spec_tree):
    """``fn`` applied to every spec tuple of a nested dict of specs."""
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v) for k, v in spec_tree.items()}
    return fn(spec_tree)


def stack_specs(spec_tree):
    """The specs of the leaves stacked along a new leading (layer) dim."""
    return map_specs(lambda s: (None, *s), spec_tree)


def _fsdp(spec_tree):
    """Add FSDP (data-axis) sharding on the first non-model dim of 2D+
    params."""
    def f(s):
        if len(s) < 2:
            return s
        out = list(s)
        for i, ax in enumerate(out):
            if ax is None:
                out[i] = "data"
                break
        return tuple(out)
    return map_specs(f, spec_tree)


def _block_specs(cfg):
    return {"ln1": (None,), "attn": L.attn_specs(cfg),
            "ln2": (None,), "mlp": L.swiglu_specs()}


def param_specs(cfg):
    block = _fsdp(_block_specs(cfg))
    specs = {
        "embed": ("model", "data"),
        "layers": stack_specs(block),
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ("data", "model")
    if cfg.frontend == "patch":
        specs["patch_proj"] = (None, "model")
    return specs


def cache_specs(cfg, sealed: bool = False):
    """Logical shardings for the cache: batch over data, seq over model."""
    kv = (None, "data", "model", None, None)
    out = {"pos": "r"}
    if sealed:
        out.update({"k_ct": kv, "v_ct": kv, "nonce": "r"})
    else:
        out.update({"k": kv, "v": kv})
    return out


def logits_of(params, cfg, x):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w


def _tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes: no numpy bridge
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree, device="cuda"):
    """The reference's parameter tree (numpy leaves) as the port's tree."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor_from_numpy(tree, device)


def unbind_tree(tree) -> list:
    """Every index of a stacked [n, ...] tree along its leading axis: one
    ``torch.unbind`` per leaf.  (Selecting ``leaf[i]`` per index would make
    each select's backward write a zero-filled gradient the size of the
    whole stack.)"""
    if isinstance(tree, dict):
        subs = {k: unbind_tree(v) for k, v in tree.items()}
        n = len(next(iter(subs.values())))
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return list(tree.unbind(0))


def layer_stack(params) -> list[dict]:
    """Every layer's parameters out of the stacked ``params["layers"]``."""
    return unbind_tree(params["layers"])


def _block(lp, cfg, x, positions, attend):
    """One pre-norm block; ``attend(q, k, v)`` returns the attention output
    and the KV to keep.  Returns (x, kept)."""
    B, S, _ = x.shape
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L.project_qkv(lp["attn"], cfg, h, positions)
    a, kept = attend(q, k, v)
    x = x + L.attn_out(lp["attn"], a, B, S)
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.swiglu(lp["mlp"], h2), kept


def _save_matmuls(ctx, op, *args, **kwargs):
    """remat "dots": keep the outputs of products without batch dims (the
    reference's ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg):
    """``fn`` under the config's ``remat`` when autograd records: "none"
    keeps every activation, "full" keeps only the inputs and runs ``fn``
    again in the backward pass (``jax.checkpoint``), "dots" keeps the
    matmul outputs as well (as ``_save_matmuls`` says)."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots, not "
                         f"{cfg.remat!r}")
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            _save_matmuls)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False, **kw)

    return run


def backbone(params, cfg, x, positions):
    """Causal forward through the layer stack (training / prefill, no cache
    read), each block under ``cfg.remat``.  Returns (x, (k, v)) with k, v
    stacked [n_layers, B, S, K, hd]."""
    def causal(q, k, v):
        return L.gqa_attention(q, k, v, causal=True,
                               q_block=cfg.q_block), (k, v)

    f = _maybe_remat(lambda xx, lp: _block(lp, cfg, xx, positions, causal),
                     cfg)
    ks, vs = [], []
    for lp in layer_stack(params):
        x, (k, v) = f(x, lp)
        ks.append(k)
        vs.append(v)
    return x, (torch.stack(ks), torch.stack(vs))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg, batch):
    """(x [B, n_front + S, D], n_front): the token embeddings, after the
    projected patch embeddings [B, n_front, D] when the config has the
    patch frontend and the batch carries ``patch_embeds``."""
    x = params["embed"][batch["tokens"]].to(cfg.act_dtype)
    if cfg.frontend == "patch" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(cfg.act_dtype) @ params["patch_proj"]
        return torch.cat([pe, x], dim=1), pe.shape[1]
    return x, 0


def loss(params, cfg, batch):
    """Next-token CE. batch: tokens [B,S], labels [B,S] (-1 = masked),
    and ``patch_embeds`` [B, n_front, D] for the VLM."""
    x, n_front = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = backbone(params, cfg, x, positions)
    logits = logits_of(params, cfg, x[:, n_front:])
    labels = batch["labels"]
    return L.softmax_xent(logits, torch.clamp(labels, min=0),
                          mask=labels >= 0)


# ---------------------------------------------------------------------------
# serving: KV cache (plain or sealed), prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, sealed: bool = False,
               n_layers: int | None = None, device="cuda"):
    nl = n_layers if n_layers is not None else cfg.n_layers
    shape = (nl, batch, max_len, cfg.n_kv_heads, cfg.hd)
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


def _layer_nonce(nonce: int, layer_idx: int) -> int:
    """Per-(cache epoch, layer) nonce mod 2^32; k uses 2*sub, v 2*sub+1."""
    return (int(nonce) * 2 * 65536 + int(layer_idx)) & common.M32


def _kv_nonces(nonce: int, layer_idx: int) -> tuple[int, int]:
    sub = _layer_nonce(nonce, layer_idx)
    return (sub * 2) & common.M32, (sub * 2 + 1) & common.M32


def _slot_rows(B: int, T: int, K: int, pos: int, device) -> torch.Tensor:
    """Counter rows (b*T + pos)*K + k of one token slot, int64 [B, 1, K]."""
    b = torch.arange(B, dtype=torch.int64, device=device)[:, None, None]
    k = torch.arange(K, dtype=torch.int64, device=device)[None, None, :]
    return ((b * T + pos) * K + k) & common.M32


def seal_layers(ks: torch.Tensor, vs: torch.Tensor, key: torch.Tensor,
                nonce: int, regions=None):
    """Seal a plaintext cache [L, B, T, K, hd] (the MoE's
    [units, lpu, B, T, K, hd]) layer by layer under the per-(epoch, layer)
    nonces; one CTR launch per cache (the layers are the items of one
    batch).  ``regions`` ({"k_ct": Region, "v_ct": Region}) seals only a
    rank's block of each, against the whole cache's counter rows."""
    n = ks.shape[0]
    nk, nv = zip(*(_kv_nonces(nonce, l) for l in range(n)))
    keys = key.reshape(1, 2).expand(n, 2)
    regions = regions or {}
    return tuple(sealed_lib.seal_items(x, keys, torch.tensor(ns,
                                                             device=x.device),
                                       regions.get(f))
                 for x, ns, f in ((ks, nk, "k_ct"), (vs, nv, "v_ct")))


def prefill(params, cfg, batch, max_len: int, seal_ctx=None, blocks=None):
    """Run the full prompt; return (last-token logits, cache at ``max_len``).

    batch: {"tokens": int [B, S]} (and ``patch_embeds`` for the VLM, which
    take the cache's first slots).  seal_ctx: (key int32 [2], nonce int)
    seals the cache — the padding rows too, as the reference does.
    blocks: {field: ``core.sealed.Region``}: the cache holds only these
    blocks of its fields (a rank of a mesh), sealed against the whole
    cache's counters."""
    x, _ = _embed_inputs(params, cfg, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    pad = max_len - S
    if pad < 0:
        raise ValueError(f"a prompt of {S} positions exceeds the "
                         f"{max_len}-slot cache")
    x, (ks, vs) = backbone(params, cfg, x, positions)
    ks = F.pad(ks, (0, 0, 0, 0, 0, pad))
    vs = F.pad(vs, (0, 0, 0, 0, 0, pad))
    cache = {"pos": S}
    if seal_ctx is not None:
        key, nonce = seal_ctx
        k_ct, v_ct = seal_layers(ks, vs, key, nonce, blocks)
        cache.update({"k_ct": k_ct, "v_ct": v_ct,
                      "nonce": int(nonce) & common.M32})
    else:
        cache.update(plain_blocks({"k": ks, "v": vs}, blocks))
    logits = logits_of(params, cfg, x[:, -1:, :])
    return logits[:, 0], cache


def plain_blocks(fields: dict, blocks=None) -> dict:
    """Plaintext cache fields, or only their ``blocks`` (copies)."""
    if blocks is None:
        return fields
    return {f: blocks[f].take(x).clone() for f, x in fields.items()}


def decode_step(params, cfg, cache, tokens, seal_ctx=None):
    """One decode step. tokens: int [B].  Returns (logits [B, V], cache):
    the new slot is written into the cache's tensors in place."""
    B = tokens.shape[0]
    pos = int(cache["pos"])
    T = (cache["k_ct"] if seal_ctx is not None else cache["k"]).shape[2]
    if pos >= T:
        raise ValueError(f"decode position {pos} is past the {T}-slot cache")
    dev = tokens.device
    x = params["embed"][tokens[:, None]].to(cfg.act_dtype)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=dev)
    sealed = seal_ctx is not None
    fused = sealed and cfg.fused_sealed_attention
    if fused and cfg.act_dtype != torch.bfloat16:
        raise ValueError("fused_sealed_attention requires bf16 activations")
    key = seal_ctx[0] if sealed else None
    dt = cfg.act_dtype
    for l, lp in enumerate(layer_stack(params)):
        if sealed:
            kc, vc = cache["k_ct"][l], cache["v_ct"][l]       # [B, T, K, hd]
            T, K = kc.shape[1], kc.shape[2]
            nk, nv = _kv_nonces(cache["nonce"], l)
            rows = _slot_rows(B, T, K, pos, dev)
        else:
            kc, vc = cache["k"][l], cache["v"][l]

        def attend(q, k, v):
            if fused:
                # seal ONLY the new slot, then flash-decode straight from the
                # sealed cache: the plaintext cache never reaches memory.
                # Like the reference, this branch authenticates nothing
                # (verify off, no tags, no MAC keys).
                kc[:, pos:pos + 1] = cipher.seal_bits_slice(k, key, nk, rows)
                vc[:, pos:pos + 1] = cipher.seal_bits_slice(v, key, nv, rows)
                G = cfg.n_heads // K
                qk = q.reshape(B, K, G, cfg.hd).to(torch.bfloat16)
                a4, _ = sealed_decode_attention(
                    qk, kc, vc, None, None,
                    cipher.derive_tensor_key(key, nk),
                    cipher.derive_tensor_key(key, nv), None, pos + 1,
                    verify=False)
                return a4.reshape(B, 1, K * G, cfg.hd).to(dt), None
            if sealed:
                kcache = cipher.unseal_bits(kc, key, nk, dt)
                vcache = cipher.unseal_bits(vc, key, nv, dt)
                # slots at or past pos hold keystream noise (possibly NaN
                # bits): zero them, or 0 * NaN poisons the softmax-V product
                tmask = (torch.arange(T, device=dev) < pos)[None, :, None, None]
                zero = torch.zeros((), dtype=dt, device=dev)
                kcache = torch.where(tmask, kcache, zero)
                vcache = torch.where(tmask, vcache, zero)
            else:
                kcache, vcache = kc, vc                      # updated in place
            kcache[:, pos] = k[:, 0]
            vcache[:, pos] = v[:, 0]
            a = L.gqa_attention(q, kcache, vcache, causal=False,
                                t_valid=pos + 1)
            if sealed:
                # write back only the new slot's ciphertext (cost ~ bytes
                # written, paper 3.4); the other slots keep theirs
                kc[:, pos:pos + 1] = cipher.seal_bits_slice(k, key, nk, rows)
                vc[:, pos:pos + 1] = cipher.seal_bits_slice(v, key, nv, rows)
            return a, None

        x, _ = _block(lp, cfg, x, positions, attend)
    logits = logits_of(params, cfg, x)[:, 0]
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits, new_cache
