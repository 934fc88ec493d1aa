"""GQA/MQA attention with RoPE, a KV cache, cross-attention and the
flash-kernel path (port of ``repro.models.attention``).

The reference math is plain PyTorch and differentiable as it stands;
``attention`` with ``cfg.attention_impl == "flash"`` runs flash attention
through its ``torch.autograd.Function`` (the forward and backward kernels on
a CUDA tensor, their plain versions on a CPU tensor); ``"blocked"`` runs
``_sdpa_blocked``, the flash algorithm in plain PyTorch on both devices, as
the JAX package has it in jnp.  Flash runs only causal attention, as in
the JAX package: the encoder-decoder's encoder (non-causal) takes the
reference attention under ``"flash"``.  Cross-attention (``cross_attention``
over the keys and values ``encode_cross_kv`` projects from the encoder's
output) has no RoPE and no mask and always runs the reference attention.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

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


def attn_defs(cfg: ModelConfig, cross: bool = False) -> Dict[str, ParamDef]:
    """The projections' shapes; ``cross`` (a decoder layer's cross-attention)
    has no q/k/v biases."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    defs = {
        "wq": ParamDef((d, nq)),
        "wk": ParamDef((d, nkv)),
        "wv": ParamDef((d, nkv)),
        "wo": ParamDef((nq, d)),
    }
    if cfg.qkv_bias and not cross:
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


def _sdpa_blocked(q, k, v, causal: bool, block_q: int = 512, block_k: int = 1024):
    """Flash-algorithm attention in plain PyTorch: an online softmax in f32
    over KV blocks, O(bq·bk) live scores instead of O(S²), in the forward
    and the backward (each KV step is checkpointed, so the backward
    recomputes its scores, as ``jax.checkpoint(kv_step)`` does).  Block
    sizes are halved until they divide the lengths.  q: (B, Sq, H, hd);
    k/v: (B, Skv, G, hd) → (B, Sq, H, hd) in q's type."""
    b, sq, h, hd = q.shape
    skv, g = k.shape[1], k.shape[2]
    rep = h // g
    bq = min(block_q, sq)
    while sq % bq:
        bq //= 2
    bk = min(block_k, skv)
    while skv % bk:
        bk //= 2
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    dev = q.device

    def kv_step(m, l, acc, q_blk, k_blk, v_blk, qi: int, kj: int):
        kf = torch.repeat_interleave(k_blk, rep, dim=2)              # (B,bk,H,hd)
        vf = torch.repeat_interleave(v_blk, rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q_blk.to(torch.float32),
                         kf.to(torch.float32)) * scale
        if causal:
            qpos = qi * bq + torch.arange(bq, device=dev)
            kpos = kj * bk + torch.arange(bk, device=dev)
            s = torch.where((kpos[None, :] <= qpos[:, None])[None, None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + torch.sum(p, dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                        vf.to(torch.float32))
        return m_new, l_new, acc_new

    step = (functools.partial(checkpoint, kv_step, use_reentrant=False)
            if torch.is_grad_enabled() else kv_step)
    outs = []
    for qi in range(sq // bq):
        q_blk = q[:, qi * bq:(qi + 1) * bq]
        m = torch.full((b, h, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, bq, hd), dtype=torch.float32, device=dev)
        for kj in range(skv // bk):
            m, l, acc = step(m, l, acc, q_blk, k[:, kj * bk:(kj + 1) * bk],
                             v[:, kj * bk:(kj + 1) * bk], qi, kj)
        out = acc / torch.clamp(l, min=1e-30)[..., None]               # (B,H,bq,hd)
        outs.append(out.transpose(1, 2).to(q.dtype))                    # (B,bq,H,hd)
    return torch.cat(outs, dim=1)


def attention(x: torch.Tensor, p, cfg: ModelConfig, positions: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    if cfg.attention_impl == "flash" and causal:
        out, _ = flash_attention(q, k, v, causal=True)
    elif cfg.attention_impl == "blocked":
        out = _sdpa_blocked(q, k, v, causal=causal)
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


def cross_attention(x: torch.Tensor, p, cfg: ModelConfig, enc_k: torch.Tensor,
                    enc_v: torch.Tensor) -> torch.Tensor:
    """Attention of the decoder's positions over the encoder's, all of them:
    q without RoPE, no mask.  enc_k/enc_v: (B, S_enc, G, hd), from
    ``encode_cross_kv``."""
    b, s, _ = x.shape
    q = (x @ p.wq).reshape(b, s, cfg.n_heads, cfg.resolved_head_dim)
    out = _sdpa_reference(q, enc_k, enc_v, causal=False)
    return out.reshape(b, s, -1) @ p.wo


def encode_cross_kv(enc_out: torch.Tensor, p, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross-attention keys and values from the encoder's
    output (B, S_enc, d) → two (B, S_enc, G, hd)."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = (enc_out @ p.wk).reshape(b, s, cfg.n_kv_heads, hd)
    v = (enc_out @ p.wv).reshape(b, s, cfg.n_kv_heads, hd)
    return k, v


def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    device = resolve_device(device)
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)
