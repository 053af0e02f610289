"""Family registry — a uniform API over the model families (torch port of
``repro.models.registry``).

Every family module exposes:
    init(generator, cfg, device) -> params
    param_specs(cfg) -> logical sharding tree (parallel/sharding.py)
    loss(params, cfg, batch) -> scalar
    prefill(params, cfg, batch, max_len, seal_ctx=None) -> (logits, state)
    decode_step(params, cfg, state, tokens, seal_ctx=None) -> (logits, state)
plus cache/state constructors, unified here as ``make_decode_state``.
``params_from_numpy`` carries any family's reference tree across.
"""
from __future__ import annotations

import types

from . import encdec, moe, rwkv, ssm, transformer

_FAMILY = {
    "dense": transformer,
    "vlm": transformer,      # patch frontend handled by _embed_inputs
    "moe": moe,
    "rwkv": rwkv,
    "hybrid": ssm,
    "encdec": encdec,
}

params_from_numpy = transformer.params_from_numpy


def get_model(cfg) -> types.ModuleType:
    if cfg.family not in _FAMILY:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return _FAMILY[cfg.family]


def make_decode_state(cfg, batch: int, max_len: int, src_len: int = 0,
                      sealed: bool = False, device="cuda"):
    """Uniform decode-state/cache constructor across families; ``src_len``
    is the encoder-decoder's source length (its cross KV)."""
    get_model(cfg)
    if cfg.family in ("dense", "vlm"):
        return transformer.init_cache(cfg, batch, max_len, sealed,
                                      device=device)
    if cfg.family == "moe":
        return moe.init_cache(cfg, batch, max_len, sealed, device=device)
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_len, src_len, sealed,
                                 device=device)
    if cfg.family == "rwkv":
        return (rwkv.init_state_sealed(cfg, batch, device=device) if sealed
                else rwkv.init_state(cfg, batch, device=device))
    return (ssm.init_state_sealed(cfg, batch, max_len, device=device)
            if sealed else ssm.init_state(cfg, batch, max_len, device=device))


def decode_state_specs(cfg, sealed: bool = False):
    """Uniform logical shardings for the decode state."""
    get_model(cfg)
    if cfg.family in ("dense", "vlm"):
        return transformer.cache_specs(cfg, sealed)
    if cfg.family == "moe":
        return moe.cache_specs(cfg, sealed)
    if cfg.family == "encdec":
        return encdec.cache_specs(cfg, sealed)
    if cfg.family == "rwkv":
        return rwkv.state_specs(cfg, sealed)
    return ssm.state_specs(cfg, sealed)
