"""arctic-480b [hf:Snowflake/snowflake-arctic-base] — dense residual + MoE
128 experts top-2.  bf16 params + adafactor so optimizer state fits the pod
(DESIGN.md §7 / EXPERIMENTS.md memory notes)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    n_experts=128, top_k=2, moe_dense_residual=True,
    params_dtype="bfloat16", optimizer="adafactor",
)
