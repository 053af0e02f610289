"""Architecture registry of the port (every family, served and trained)
and ``input_specs``: the batch inputs of one (arch x shape) cell as
``(shape, torch dtype)`` pairs, allocating nothing, with the shape
semantics of the reference's:
  * train_*   -> train_step   (tokens + labels, global_batch x seq)
  * prefill_* -> serve_prefill (prompt tokens)
  * decode_* / long_* -> serve_step (ONE new token against a seq_len cache)
"""
from __future__ import annotations

import importlib

import torch

from ..models.config import (ALL_SHAPES,
                             SHAPES_BY_NAME,  # noqa: F401 (re-exported)
                             ModelConfig, ShapeConfig)

ARCH_IDS = (
    "rwkv6-3b", "qwen3-4b", "minitron-8b", "granite-3-2b", "llama3-405b",
    "internvl2-2b", "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
    "zamba2-1.2b", "seamless-m4t-large-v2",
)

_MODULES = {
    "rwkv6-3b": "rwkv6_3b",
    "qwen3-4b": "qwen3_4b",
    "minitron-8b": "minitron_8b",
    "granite-3-2b": "granite_3_2b",
    "llama3-405b": "llama3_405b",
    "internvl2-2b": "internvl2_2b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "zamba2-1.2b": "zamba2_1_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def arch_module(arch_id: str):
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    m = arch_module(arch_id)
    return m.SMOKE if smoke else m.CONFIG


def train_microbatch(arch_id: str) -> int:
    return getattr(arch_module(arch_id), "TRAIN_MICROBATCH", 16)


def opt_state_dtype(arch_id: str) -> str:
    return getattr(arch_module(arch_id), "OPT_STATE_DTYPE", "float32")


def acc_dtype(arch_id: str) -> str:
    """Gradient-accumulation dtype of the train step."""
    return getattr(arch_module(arch_id), "ACC_DTYPE", "float32")


def skip_reason(arch_id: str, shape_name: str) -> str | None:
    return getattr(arch_module(arch_id), "SKIP_SHAPES", {}).get(shape_name)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, microbatch: int = 0):
    """Batch inputs of one (arch x shape) cell: {name: (shape, dtype)}.

    For 'train', ``microbatch`` (if nonzero) gives the per-accumulation-step
    batch; the trainer runs global_batch // microbatch of them.
    """
    GB, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        B = (microbatch or GB) if shape.kind == "train" else GB
        names = ("tokens", "labels") if shape.kind == "train" else ("tokens",)
        n_tok = S - cfg.n_frontend_tokens if cfg.frontend == "patch" else S
        specs = {k: ((B, n_tok), i32) for k in names}
        if cfg.frontend == "patch":
            specs["patch_embeds"] = ((B, cfg.n_frontend_tokens, cfg.d_model),
                                     bf16)
        elif cfg.frontend == "frame":
            specs["frame_embeds"] = ((B, S, cfg.d_model), bf16)
        return specs
    if shape.kind == "decode":
        return {"tokens": ((GB,), i32)}
    raise ValueError(shape.kind)


def all_cells():
    """Yield every (arch_id, ShapeConfig, skip_reason|None) — 40 cells."""
    for a in ARCH_IDS:
        for s in ALL_SHAPES:
            yield a, s, skip_reason(a, s.name)
