"""llama3-405b — dense GQA, 128k vocab [arXiv:2407.21783; unverified].
The reference also sets ``seq_parallel`` (residuals sharded over its mesh),
which one card has no use for."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=53248, vocab=128256, rope_theta=5e5,
)
SMOKE = CONFIG.with_(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                     head_dim=32, d_ff=768, vocab=512,
                     dtype="float32", param_dtype="float32", q_block=16)
TRAIN_MICROBATCH = 16
OPT_STATE_DTYPE = "bfloat16"  # bf16 Adam moments (HBM budget)
ACC_DTYPE = "bfloat16"        # grad accumulation dtype (HBM budget)
SKIP_SHAPES = {"long_500k": "pure full attention; 0.5M-token KV cache ~270 GB"}
