"""seamless-m4t-large-v2 — enc-dec, audio frontend stubbed [arXiv:2308.11596; hf]."""
from ..models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2", family="encdec",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206,
    encdec=EncDecConfig(n_enc_layers=24, n_dec_layers=24),
    frontend="frame",
)
SMOKE = CONFIG.with_(n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                     head_dim=32, d_ff=256, vocab=512,
                     encdec=EncDecConfig(n_enc_layers=2, n_dec_layers=2),
                     dtype="float32", param_dtype="float32", q_block=16)
TRAIN_MICROBATCH = 16
SKIP_SHAPES = {"long_500k": "full enc-dec attention (quadratic; 0.5M KV)"}
