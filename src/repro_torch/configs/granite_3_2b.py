"""granite-3-2b — dense GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=49155, rope_theta=1e4,
)
SMOKE = CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                     head_dim=32, d_ff=256, vocab=512,
                     dtype="float32", param_dtype="float32", q_block=16)
TRAIN_MICROBATCH = 16
SKIP_SHAPES = {"long_500k": "pure full attention (quadratic prefill; 0.5M KV)"}
