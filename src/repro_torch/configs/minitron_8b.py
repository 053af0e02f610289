"""minitron-8b — width-pruned nemotron, dense GQA [arXiv:2407.14679; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=256000, rope_theta=5e5,
)
SMOKE = CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                     head_dim=32, d_ff=512, vocab=512,
                     dtype="float32", param_dtype="float32", q_block=16)
TRAIN_MICROBATCH = 16
SKIP_SHAPES = {"long_500k": "pure full attention (quadratic prefill; 0.5M KV)"}
