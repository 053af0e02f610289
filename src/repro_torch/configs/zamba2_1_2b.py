"""zamba2-1.2b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf]."""
from ..models.config import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, conv_width=4, expand=2),
    hybrid=HybridConfig(attn_every=6),
    scan_layers=False,   # heterogeneous stack (shared attn interleave)
    sub_quadratic=True,  # SSM backbone; shared attn uses KV only at hybrid points
)
SMOKE = CONFIG.with_(n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                     head_dim=32, d_ff=256, vocab=512,
                     ssm=SSMConfig(d_state=8, head_dim=16),
                     hybrid=HybridConfig(attn_every=2),
                     dtype="float32", param_dtype="float32", q_block=16)
TRAIN_MICROBATCH = 16
SKIP_SHAPES: dict = {}   # hybrid => long_500k runs
