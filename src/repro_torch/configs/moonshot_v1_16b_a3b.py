"""moonshot-v1-16b-a3b — Moonlight MoE 64e top-6 [hf:moonshotai/Moonlight-16B-A3B; hf]."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=163840, rope_theta=5e4,
    moe=MoEConfig(n_experts=64, top_k=6, capacity_factor=1.25,
                  shared_expert=True, d_ff_shared=2816),
)
SMOKE = CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                     head_dim=32, d_ff=64, vocab=512,
                     moe=MoEConfig(n_experts=8, top_k=2, shared_expert=True,
                                   d_ff_shared=128),
                     dtype="float32", param_dtype="float32", q_block=16)
TRAIN_MICROBATCH = 16
SKIP_SHAPES = {"long_500k": "full attention (quadratic prefill; 0.5M KV)"}
