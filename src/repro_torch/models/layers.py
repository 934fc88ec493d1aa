"""Shared layer machinery: parameter shapes, norms, RoPE, gated MLPs and the
training loss (port of ``repro.models.layers``).

Parameters keep the JAX orientation (``x @ w`` with w of shape (in, out)),
so every product reads as it does in the JAX package.  ``ParamDef`` keeps
the shape and init of a parameter (the JAX package's logical sharding axes
have no counterpart on one card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.rmsnorm import rmsnorm


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | embed | ssm_dt | ssm_alog
    scale: float = 1.0            # fan-in style divisor applied to normal init


def init_leaf(d: ParamDef, generator: torch.Generator, device, dtype=torch.float32,
              fan_in: Optional[int] = None) -> torch.Tensor:
    """The distribution of ``repro.models.layers._init_leaf``: zeros; ones;
    the SSM's dt bias (the inverse softplus of U[1e-3, 1e-1]) and A (the log
    of U[1, 16]); normal with std ``scale`` (embed); else normal with std
    ``scale/sqrt(fan_in)``, where the JAX package takes ``fan_in`` as the
    leading dimension of the definition it materializes (for a scanned
    layer stack that is its outer count, which callers pass as ``fan_in``)."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init in ("ssm_dt", "ssm_alog"):
        lo, hi = (1e-3, 1e-1) if d.init == "ssm_dt" else (1.0, 16.0)
        u = torch.rand(d.shape, generator=generator, dtype=torch.float32,
                       device=generator.device) * (hi - lo) + lo
        u = u + torch.log(-torch.expm1(-u)) if d.init == "ssm_dt" else torch.log(u)
        return u.to(device=device, dtype=dtype)
    if d.init == "embed":
        std = d.scale
    else:
        std = d.scale / math.sqrt(max(1, d.shape[0] if fan_in is None else fan_in))
    out = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                      device=generator.device)
    return out.mul_(std).to(device=device, dtype=dtype)    # in place: one f32 copy at a time


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32, cast back: the RMSNorm
    kernel on the card, its plain version on the CPU."""
    return rmsnorm(x, weight, eps)


def rope_frequencies(head_dim: int, theta: float) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta).to(x.device)                   # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs         # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def glu_mlp(x: torch.Tensor, p, kind: str) -> torch.Tensor:
    """SwiGLU / GeGLU feed-forward; GeGLU uses the tanh GELU, as
    ``jax.nn.gelu`` does by default."""
    gate = x @ p.w_gate
    up = x @ p.w_up
    act = F.silu(gate) if kind == "swiglu" else F.gelu(gate, approximate="tanh")
    return (act * up) @ p.w_down


def mlp_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "w_gate": ParamDef((d_model, d_ff)),
        "w_up": ParamDef((d_model, d_ff)),
        "w_down": ParamDef((d_ff, d_model)),
    }


def norm_defs(d_model: int) -> ParamDef:
    return ParamDef((d_model,), init="zeros")


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 1e-4) -> torch.Tensor:
    """Token-mean cross-entropy in f32 with the z-loss ``z * lse^2`` (the JAX
    package's ``cross_entropy_loss``)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - true
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return torch.mean(loss)
