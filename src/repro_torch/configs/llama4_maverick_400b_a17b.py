"""llama4-maverick-400b-a17b — MoE 128e top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified].
The early-fusion multimodal frontend is out of the assigned backbone scope
(text LM backbone only, per assignment)."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048, rope_theta=5e5,
    moe=MoEConfig(n_experts=128, top_k=1, capacity_factor=1.25,
                  shared_expert=True, d_ff_shared=8192,
                  moe_every=2, d_ff_dense=16384),
)
SMOKE = CONFIG.with_(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                     head_dim=32, d_ff=128, vocab=512,
                     moe=MoEConfig(n_experts=8, top_k=1, shared_expert=True,
                                   d_ff_shared=128, moe_every=2, d_ff_dense=256),
                     dtype="float32", param_dtype="float32", q_block=16)
TRAIN_MICROBATCH = 16
OPT_STATE_DTYPE = "bfloat16"
ACC_DTYPE = "bfloat16"
SKIP_SHAPES = {"long_500k": "full attention (quadratic prefill; 0.5M KV)"}
