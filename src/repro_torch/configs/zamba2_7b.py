"""zamba2-7b [arXiv:2411.15242] — 81 Mamba2 layers + ONE shared attention
block applied every 6 layers (weights shared across its 13 applications)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    block_pattern="zamba_hybrid", ssm_state=64, shared_attn_every=6,
)
