"""ModelConfig — the fields of the ported families (dense, vlm, moe, rwkv,
hybrid, encdec) that serving and training read, and the input-shape
cells.

A subset of ``repro.models.config`` with the same field names and
defaults; dtypes are names mapped to torch dtypes.
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    shared_expert: bool = False
    d_ff_shared: int = 0          # shared-expert hidden (0 => same as d_ff)
    moe_every: int = 1            # 2 => alternate dense/MoE layers (llama4)
    d_ff_dense: int = 0           # dense-layer hidden when interleaved


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    n_heads: int = 0              # SSD heads (0 => d_model // head_dim)
    head_dim: int = 64
    conv_width: int = 4
    expand: int = 2               # inner dim = expand * d_model


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    attn_every: int = 6           # shared attention block period (zamba2)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64          # LoRA rank for data-dependent decay (Finch)
    gate_lora: int = 64


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 24
    n_dec_layers: int = 24


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | rwkv | hybrid | encdec | vlm
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
    # family sub-configs
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    hybrid: HybridConfig = HybridConfig()
    rwkv: RWKVConfig = RWKVConfig()
    encdec: EncDecConfig = EncDecConfig()
    # modality frontend: 'none' | 'patch' (vlm) | 'frame' (audio, encdec);
    # the caller passes the precomputed patch or frame embeddings
    frontend: str = "none"
    n_frontend_tokens: int = 256  # patches per image / context frames
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "full"           # none | full | dots: what a block keeps
                                  # for the backward pass (models/
                                  # transformer.py::_maybe_remat)
    q_block: int = 512            # blocked-attention query block
    scan_layers: bool = True      # the reference's layer scan (a Python
                                  # loop here either way)
    moe_dispatch_shards: int = 0  # >1: shard-local MoE dispatch (each of
                                  # that many token segments packs its own
                                  # slice of the capacity axis; changes
                                  # which tokens are dropped)
    moe_ep: bool = False          # expert-parallel dispatch under an active
                                  # sharding context with a model axis
                                  # (models/moe_ep.py)
    fused_sealed_attention: bool = False  # fixed-slot decode: the sealed
                                  # flash-decode kernel reads the sealed
                                  # cache directly (bf16 activations only)
    sub_quadratic: bool = False   # True for rwkv / pure-ssm paths

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


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str  # train_4k, prefill_32k, decode_32k, long_500k
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode
    microbatch: int = 0           # sequences per gradient-accumulation step
                                  # (0 => no accumulation; train only)


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train", microbatch=16)
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}
