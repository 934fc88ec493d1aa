"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B] — 64e top-6
fine-grained MoE (per-expert d_ff=1408)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    n_experts=64, top_k=6,
)
