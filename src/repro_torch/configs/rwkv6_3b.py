"""rwkv6-3b — Finch, attention-free, data-dependent decay [arXiv:2404.05892; hf]."""
from ..models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b", family="rwkv",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    sub_quadratic=True,
)
SMOKE = CONFIG.with_(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
                     d_ff=448, vocab=512, rwkv=RWKVConfig(head_dim=64, decay_lora=8),
                     dtype="float32", param_dtype="float32", q_block=16)
TRAIN_MICROBATCH = 16
SKIP_SHAPES: dict = {}   # O(1) state => long_500k runs
