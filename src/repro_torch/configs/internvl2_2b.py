"""internvl2-2b — InternViT patch stub + InternLM2 backbone [arXiv:2404.16821; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=92553, rope_theta=1e6,
    frontend="patch", n_frontend_tokens=256,
)
SMOKE = CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                     head_dim=32, d_ff=256, vocab=512, n_frontend_tokens=8,
                     dtype="float32", param_dtype="float32", q_block=16)
TRAIN_MICROBATCH = 16
SKIP_SHAPES = {"long_500k": "pure full attention (quadratic prefill; 0.5M KV)"}
