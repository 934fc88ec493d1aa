"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

A copy of ``repro.configs`` (pure Python), the same ten architectures."""
from typing import Dict

from .base import ModelConfig, ShapeConfig, SHAPES, applicable_shapes

_MODULES = {
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen2-1.5b": "qwen2_1_5b",
    "yi-9b": "yi_9b",
    "gemma-2b": "gemma_2b",
    "arctic-480b": "arctic_480b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "xlstm-125m": "xlstm_125m",
    "internvl2-26b": "internvl2_26b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "zamba2-7b": "zamba2_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    import importlib

    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests: same block structure,
    shrunken dimensions.  Full configs are exercised only via the dry run."""
    import dataclasses

    small = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.block_pattern != "zamba_hybrid" else 8),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        n_prefix_tokens=16 if cfg.n_prefix_tokens else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16,
        ssm_chunk=16,
        shared_attn_every=3,
        slstm_every=cfg.slstm_every,
        remat="none",
        params_dtype="float32",
        dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


__all__ = [
    "ARCH_IDS",
    "ModelConfig",
    "SHAPES",
    "ShapeConfig",
    "applicable_shapes",
    "get_config",
    "reduced",
]
