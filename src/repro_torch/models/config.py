"""ModelConfig — the dense-transformer fields that serving reads.

A subset of ``repro.models.config.ModelConfig`` with the same field names
and defaults; dtypes are names mapped to torch dtypes.
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense (the only family served here)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 => d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    q_block: int = 512            # blocked-attention query block

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def act_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def p_dtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
