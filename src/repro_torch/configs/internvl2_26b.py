"""internvl2-26b [arXiv:2404.16821] — InternViT (STUB) + InternLM2 backbone.

The vision frontend is a stub per the assignment: input_specs() provides
precomputed patch embeddings (B, 1024, d_model) prepended to the text tokens.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    modality="vision_stub", n_prefix_tokens=1024,
)
