"""Dense GQA transformer LM: parameters and the LM head (torch port).

The paged engine (``serve/engine.py``) runs the layer stack itself; this
module holds what it shares with the reference: ``init`` (full-width random
weights straight on the device), ``logits_of`` and ``params_from_numpy``,
which carries the reference's ``init`` tree across so both packages compute
on the same weights.  Parameters are nested dicts with the reference's keys;
layer leaves are stacked [n_layers, ...].
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.channel import resolve_device
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
    return params


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
