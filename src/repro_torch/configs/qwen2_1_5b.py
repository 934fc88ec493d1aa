"""qwen2-1.5b [arXiv:2407.10671] — dense GQA with QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    mlp_type="swiglu", qkv_bias=True, tie_embeddings=True,
)
