"""qwen3-4b — dense GQA + qk_norm [hf:Qwen/Qwen3-8B family; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1e6,
)
SMOKE = CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                     head_dim=32, d_ff=256, vocab=512,
                     dtype="float32", param_dtype="float32", q_block=16)
TRAIN_MICROBATCH = 16
SKIP_SHAPES = {"long_500k": "pure full attention (quadratic prefill; 0.5M KV)"}
