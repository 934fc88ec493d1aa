"""Mamba2 (SSD) block: the chunked form for train / prefill and the O(1)
recurrent step for decode (port of ``repro.models.ssm``).

The JAX package scans over chunks with ``lax.scan``; here a Python loop
over the ``S / ssm_chunk`` chunks carries the (B, H, P, N) state, so only
(B, Q, Q, H)-sized intermediates are live at once, as there.  Type
promotions follow the JAX package's: the chunk math in f32 (f64 for an
f64 evaluation), the decode window in the conv state's type (f32), each
result cast back to x's type.

Shapes: x (B, S, D) → y (B, S, D).  H = d_inner / ssm_head_dim heads of P =
ssm_head_dim, state N = ssm_state.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import ParamDef, rms_norm

F32 = torch.float32


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The recurrences' type: f32, or f64 for an f64 evaluation."""
    return torch.promote_types(dtype, F32)


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, W-1, d_conv_in)  rolling conv window
    ssd: torch.Tensor    # (B, H, P, N)         SSM state


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    d_inner, h, p, n = mamba_dims(cfg)
    d_conv_in = d_inner + 2 * n           # x-path + B + C go through the conv
    return {
        "norm": ParamDef((d,), init="zeros"),
        "in_proj": ParamDef((d, 2 * d_inner + 2 * n + h)),
        "conv_w": ParamDef((cfg.ssm_conv_width, d_conv_in)),
        "conv_b": ParamDef((d_conv_in,), init="zeros"),
        "a_log": ParamDef((h,), init="ssm_alog"),
        "dt_bias": ParamDef((h,), init="ssm_dt"),
        "d_skip": ParamDef((h,), init="ones"),
        "gate_norm": ParamDef((d_inner,), init="zeros"),
        "out_proj": ParamDef((d_inner, d)),
    }


def _split_proj(xz: torch.Tensor, cfg: ModelConfig):
    """→ z (..., d_inner), xbc (..., d_inner + 2N), dt (..., H)."""
    d_inner, h, p, n = mamba_dims(cfg)
    return torch.split(xz, [d_inner, d_inner + 2 * n, h], dim=-1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (``F.softplus``
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width W over (B, S, C), as the JAX package's
    shift-and-add (W is 4), then SiLU."""
    width, s = w.shape[0], xbc.shape[1]
    out = xbc * w[-1]
    for i in range(1, width):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :s, :]
        out = out + shifted * w[-1 - i]
    return F.silu(out + b)


def mamba_forward(x: torch.Tensor, prm, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence chunked SSD (train / prefill)."""
    bsz, s, d = x.shape
    d_inner, h, p, n = mamba_dims(cfg)
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"mamba_forward: seq {s} must divide into chunks of {q}")

    hx = rms_norm(x, prm.norm, cfg.norm_eps)
    z, xbc, dt_raw = _split_proj(hx @ prm.in_proj, cfg)
    xbc = _causal_conv(xbc, prm.conv_w, prm.conv_b)
    xs, bmat, cmat = torch.split(xbc, [d_inner, n, n], dim=-1)

    acc = _acc(x.dtype)
    xh = xs.reshape(bsz, s, h, p).to(acc)
    bm, cm = bmat.to(acc), cmat.to(acc)
    dt = _softplus(dt_raw.to(acc) + prm.dt_bias)                       # (B,S,H)
    a = -torch.exp(prm.a_log.to(acc))                                  # (H,)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))

    state = torch.zeros((bsz, h, p, n), dtype=acc, device=x.device)
    ys = []
    for c in range(s // q):
        sl = slice(c * q, (c + 1) * q)
        xh_c, bm_c, cm_c, dt_c = xh[:, sl], bm[:, sl], cm[:, sl], dt[:, sl]
        da = dt_c * a                                                  # (B,Q,H)
        cum = torch.cumsum(da, dim=1)
        # the carried state's contribution
        y_inter = torch.einsum("btn,bhpn->bthp", cm_c, state) * torch.exp(cum)[..., None]
        # intra-chunk: masked decay attention, masked BEFORE exp (the masked
        # differences are positive and overflow)
        diff = cum[:, :, None, :] - cum[:, None, :, :]                 # (B,Q,Q,H)
        lmat = torch.exp(torch.where(mask[None, :, :, None], diff, -1e9))
        cb = torch.einsum("btn,bsn->bts", cm_c, bm_c)                  # (B,Q,Q)
        w = cb[..., None] * lmat * dt_c[:, None, :, :]                 # (B,Q,Q,H)
        y_intra = torch.einsum("btsh,bshp->bthp", w, xh_c)
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)                 # (B,Q,H)
        contrib = torch.einsum("bqh,bqhp,bqn->bhpn", dt_c * decay_to_end, xh_c, bm_c)
        state = torch.exp(torch.sum(da, dim=1))[..., None, None] * state + contrib
        ys.append(y_inter + y_intra)
    y = torch.cat(ys, dim=1)                                           # (B,S,H,P)
    y = y + prm.d_skip[None, None, :, None] * xh
    y = y.reshape(bsz, s, d_inner).to(x.dtype)

    y = rms_norm(y * F.silu(z), prm.gate_norm, cfg.norm_eps)
    return y @ prm.out_proj


def mamba_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> MambaState:
    d_inner, h, p, n = mamba_dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, d_inner + 2 * n), dtype=dtype,
                         device=device),
        ssd=torch.zeros((batch, h, p, n), dtype=F32, device=device),
    )


def mamba_decode_step(x: torch.Tensor, prm, cfg: ModelConfig,
                      state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """One token: x (B, 1, D) → (y (B, 1, D), the next state)."""
    bsz = x.shape[0]
    d_inner, h, p, n = mamba_dims(cfg)
    hx = rms_norm(x, prm.norm, cfg.norm_eps)
    z, xbc, dt_raw = _split_proj((hx @ prm.in_proj)[:, 0], cfg)        # (B, ·)

    wt = torch.promote_types(state.conv.dtype, xbc.dtype)
    window = torch.cat([state.conv.to(wt), xbc[:, None, :].to(wt)], dim=1)  # (B, W, C)
    ct = torch.promote_types(wt, prm.conv_w.dtype)
    conv_out = torch.einsum("bwc,wc->bc", window.to(ct), prm.conv_w.to(ct)) + prm.conv_b
    xbc = F.silu(conv_out)
    new_conv = window[:, 1:, :]

    xs, bm, cm = torch.split(xbc, [d_inner, n, n], dim=-1)
    acc = _acc(x.dtype)
    xh = xs.reshape(bsz, h, p).to(acc)
    dt = _softplus(dt_raw.to(acc) + prm.dt_bias)                       # (B,H)
    a = -torch.exp(prm.a_log.to(acc))
    decay = torch.exp(dt * a)                                          # (B,H)
    upd = (dt[..., None, None] * xh[..., :, None]) * bm.to(acc)[:, None, None, :]
    new_ssd = decay[..., None, None] * state.ssd + upd                 # (B,H,P,N)
    y = torch.einsum("bn,bhpn->bhp", cm.to(new_ssd.dtype), new_ssd)
    y = y + prm.d_skip[None, :, None] * xh
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z)[:, None, :], prm.gate_norm, cfg.norm_eps)
    return y @ prm.out_proj, MambaState(conv=new_conv, ssd=new_ssd)
