"""Family registry — a uniform API over the ported model families (torch
port of ``repro.models.registry``).

Every family module exposes:
    init(generator, cfg, device) -> params
    loss(params, cfg, batch) -> scalar
    prefill(params, cfg, batch, max_len, seal_ctx=None) -> (logits, state)
    decode_step(params, cfg, state, tokens, seal_ctx=None) -> (logits, state)
plus cache/state constructors, unified here as ``make_decode_state``.
``params_from_numpy`` carries any family's reference tree across.
"""
from __future__ import annotations

import types

from . import rwkv, ssm, transformer

_FAMILY = {
    "dense": transformer,
    "vlm": transformer,      # patch frontend handled by _embed_inputs
    "rwkv": rwkv,
    "hybrid": ssm,
}

_NOT_PORTED = ("moe", "encdec")

params_from_numpy = transformer.params_from_numpy


def _check(cfg) -> None:
    if cfg.family in _NOT_PORTED:
        raise ValueError(f"the {cfg.family} family is not yet ported "
                         f"(ported: {', '.join(sorted(_FAMILY))})")
    if cfg.family not in _FAMILY:
        raise ValueError(f"unknown model family {cfg.family!r}")


def get_model(cfg) -> types.ModuleType:
    _check(cfg)
    return _FAMILY[cfg.family]


def make_decode_state(cfg, batch: int, max_len: int, sealed: bool = False,
                      device="cuda"):
    """Uniform decode-state/cache constructor across families."""
    _check(cfg)
    if cfg.family in ("dense", "vlm"):
        return transformer.init_cache(cfg, batch, max_len, sealed,
                                      device=device)
    if cfg.family == "rwkv":
        return (rwkv.init_state_sealed(cfg, batch, device=device) if sealed
                else rwkv.init_state(cfg, batch, device=device))
    return (ssm.init_state_sealed(cfg, batch, max_len, device=device)
            if sealed else ssm.init_state(cfg, batch, max_len, device=device))
