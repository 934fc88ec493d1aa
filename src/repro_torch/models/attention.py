"""GQA/MQA attention with RoPE, a KV cache and the flash-kernel path (port of
``repro.models.attention``, self-attention only).

The reference math is plain PyTorch; ``attention`` with
``cfg.attention_impl == "flash"`` runs the flash-attention kernel on a CUDA
tensor and its plain version on a CPU tensor.  Cross-attention waits for the
encoder-decoder family, and the blocked jnp attention (``"blocked"``) for
its own item (ROADMAP §1 item 11).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.torch_scheduler import resolve_device
from ..kernels.flash_attention import flash_attention
from .layers import ParamDef, apply_rope

NEG_INF = -1e30


class KVCache(NamedTuple):
    """Per-layer-stack decode cache.  k/v: (L, B, S_max, G, hd)."""

    k: torch.Tensor
    v: torch.Tensor
    #: tokens already written
    length: int


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    defs = {
        "wq": ParamDef((d, nq)),
        "wk": ParamDef((d, nkv)),
        "wv": ParamDef((d, nkv)),
        "wo": ParamDef((nq, d)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((nq,), init="zeros")
        defs["bk"] = ParamDef((nkv,), init="zeros")
        defs["bv"] = ParamDef((nkv,), init="zeros")
    return defs


def _project_qkv(x, p, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa_reference(q, k, v, causal: bool, q_offset: int = 0, kv_len: Optional[int] = None):
    """Grouped scaled-dot-product attention, f32 softmax.

    q: (B, Sq, H, hd); k/v: (B, Skv, G, hd).  ``q_offset`` places queries at
    absolute positions offset..offset+Sq (decode); ``kv_len`` masks the valid
    cache prefix.  As in the JAX package, the scores are formed in the
    inputs' type, and the softmax weights are cast to v's type before the PV
    product."""
    b, sq, h, hd = q.shape
    g = k.shape[2]
    rep = h // g
    qg = q.reshape(b, sq, g, rep, hd)
    scores = torch.einsum("bsgrh,btgh->bgrst", qg, k).to(torch.float32)
    scores = scores / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    skv = k.shape[1]
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        scores = torch.where((kpos <= qpos)[None, None, None], scores, NEG_INF)
    if kv_len is not None:
        valid = torch.arange(skv, device=q.device) < kv_len
        scores = torch.where(valid[None, None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrst,btgh->bsgrh", w, v)
    return out.reshape(b, sq, h, hd)


def attention(x: torch.Tensor, p, cfg: ModelConfig, positions: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    if cfg.attention_impl == "flash" and causal:
        out, _ = flash_attention(q, k, v, causal=True)
    elif cfg.attention_impl == "blocked":
        raise NotImplementedError(
            "attention_impl='blocked' (the jnp _sdpa_blocked) is not ported yet "
            "(ROADMAP §1 item 11); use 'flash' or 'reference'")
    else:
        out = _sdpa_reference(q, k, v, causal=causal)
    return out.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim) @ p.wo


def attention_decode(x: torch.Tensor, p, cfg: ModelConfig, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: write K/V at ``length`` into the caches (in place,
    where the JAX package returns updated copies) and attend over the
    prefix.  k_cache/v_cache: (B, S_max, G, hd)."""
    b = x.shape[0]
    positions = torch.full((b, 1), length, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(x, p, cfg, positions)
    k_cache[:, length:length + 1] = k.to(k_cache.dtype)
    v_cache[:, length:length + 1] = v.to(v_cache.dtype)
    out = _sdpa_reference(q, k_cache, v_cache, causal=False, kv_len=length + 1)
    return out.reshape(b, 1, -1) @ p.wo, k_cache, v_cache


def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    device = resolve_device(device)
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)
