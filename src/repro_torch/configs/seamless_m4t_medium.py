"""seamless-m4t-medium [arXiv:2308.11596] — enc-dec; audio frontend STUB:
input_specs() provides precomputed frame embeddings (B, S, d_model)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    encoder_decoder=True, n_encoder_layers=12,
    modality="audio_stub",
)
