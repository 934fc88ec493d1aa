"""xLSTM blocks: mLSTM (matrix memory; chunked-parallel train / prefill,
O(1) decode) and sLSTM (scalar memory, strictly recurrent), after
arXiv:2405.04517 (port of ``repro.models.xlstm``).

Stabilized exponential gating throughout (a running max ``m``, starting at
-inf).  The mLSTM's chunk form carries (C, n, m) from chunk to chunk in a
Python loop where the JAX package scans; the sLSTM steps through time in a
Python loop.  Products promote their operands as JAX does (``_mm``), the
recurrences run in f32 (f64 for an f64 evaluation), and the decode states
are f32, so a bf16 model's decode continues in f32 after its
first sLSTM block, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import ParamDef, rms_norm

F32 = torch.float32
GATES = ("z", "i", "f", "o")


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The recurrences' type: f32, or f64 for an f64 evaluation."""
    return torch.promote_types(dtype, F32)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted type of the two, as JAX promotes."""
    t = torch.promote_types(x.dtype, w.dtype)
    return x.to(t) @ w.to(t)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, P, P) matrix memory
    n: torch.Tensor   # (B, H, P)    normalizer
    m: torch.Tensor   # (B, H)       stabilizer


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.n_heads
    return d_inner, heads, d_inner // heads


def mlstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    d_inner, h, p = mlstm_dims(cfg)
    return {
        "norm": ParamDef((d,), init="zeros"),
        "w_up": ParamDef((d, d_inner)),
        "w_z": ParamDef((d, d_inner)),
        "wq": ParamDef((d_inner, d_inner)),
        "wk": ParamDef((d_inner, d_inner)),
        "wv": ParamDef((d_inner, d_inner)),
        "w_i": ParamDef((d_inner, h), init="zeros"),
        "w_f": ParamDef((d_inner, h), init="zeros"),
        "b_i": ParamDef((h,), init="zeros"),
        "b_f": ParamDef((h,), init="ones", scale=3.0),
        "head_norm": ParamDef((d_inner,), init="zeros"),
        "w_down": ParamDef((d_inner, d)),
    }


def _mlstm_qkvif(x_up, prm, cfg: ModelConfig):
    d_inner, h, p = mlstm_dims(cfg)
    lead = x_up.shape[:-1]
    root = math.sqrt(p)
    q = _mm(x_up, prm.wq).reshape(*lead, h, p) / root
    k = _mm(x_up, prm.wk).reshape(*lead, h, p) / root
    v = _mm(x_up, prm.wv).reshape(*lead, h, p)
    i_raw = (_mm(x_up, prm.w_i) + prm.b_i).to(_acc(x_up.dtype))
    f_raw = (_mm(x_up, prm.w_f) + 3.0 * prm.b_f).to(_acc(x_up.dtype))
    return q, k, v, i_raw, f_raw


def mlstm_forward(x: torch.Tensor, prm, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence chunked mLSTM (train / prefill)."""
    bsz, s, d = x.shape
    d_inner, h, p = mlstm_dims(cfg)
    q_len = min(cfg.ssm_chunk, s)
    if s % q_len:
        raise ValueError(f"mlstm_forward: seq {s} must divide into chunks of {q_len}")

    hx = rms_norm(x, prm.norm, cfg.norm_eps)
    x_up = _mm(hx, prm.w_up)
    z = _mm(hx, prm.w_z)
    q, k, v, i_raw, f_raw = _mlstm_qkvif(x_up, prm, cfg)
    logf = F.logsigmoid(f_raw)                                         # (B,S,H)
    acc = logf.dtype
    q, k, v = q.to(acc), k.to(acc), v.to(acc)
    mask = torch.tril(torch.ones((q_len, q_len), dtype=torch.bool, device=x.device))

    c_prev = torch.zeros((bsz, h, p, p), dtype=acc, device=x.device)
    n_prev = torch.zeros((bsz, h, p), dtype=acc, device=x.device)
    m_prev = torch.full((bsz, h), -math.inf, dtype=acc, device=x.device)
    hs = []
    for c in range(s // q_len):
        sl = slice(c * q_len, (c + 1) * q_len)
        qq, kk, vv, ii, lf = q[:, sl], k[:, sl], v[:, sl], i_raw[:, sl], logf[:, sl]
        fcum = torch.cumsum(lf, dim=1)                                 # (B,Q,H)
        g = fcum + m_prev[:, None, :]                                  # total decay incl. carry
        # intra-chunk log weights: F_t - F_s + i_s (s <= t)
        logw = fcum[:, :, None, :] - fcum[:, None, :, :] + ii[:, None, :, :]
        logw = torch.where(mask[None, :, :, None], logw, -math.inf)    # (B,Q,Q,H)
        m_loc = torch.maximum(torch.amax(logw, dim=2), g)              # (B,Q,H)
        w = torch.exp(logw - m_loc[:, :, None, :])                     # (B,Q,Q,H)
        scores = torch.einsum("bthp,bshp->btsh", qq, kk) * w
        carry = torch.exp(g - m_loc)[..., None]
        num = torch.einsum("btsh,bshp->bthp", scores, vv)
        num = num + carry * torch.einsum("bthp,bhpr->bthr", qq, c_prev)
        n_eff = torch.einsum("btsh,bshp->bthp", w, kk) + carry * n_prev[:, None]
        den = torch.maximum(torch.abs(torch.einsum("bthp,bthp->bth", qq, n_eff)),
                            torch.exp(-m_loc))
        hs.append(num / den[..., None])                                # (B,Q,H,P)
        # the carry at the chunk's end
        f_tot = fcum[:, -1, :]                                         # (B,H)
        m_new = torch.maximum(f_tot + m_prev,
                              torch.amax(f_tot[:, None, :] - fcum + ii, dim=1))
        decay_s = torch.exp(f_tot[:, None, :] - fcum + ii - m_new[:, None, :])  # (B,Q,H)
        keep = torch.exp(f_tot + m_prev - m_new)
        c_prev = keep[..., None, None] * c_prev + torch.einsum("bqh,bqhp,bqhr->bhpr",
                                                               decay_s, kk, vv)
        n_prev = keep[..., None] * n_prev + torch.einsum("bqh,bqhp->bhp", decay_s, kk)
        m_prev = m_new
    hs = torch.cat(hs, dim=1).reshape(bsz, s, d_inner).to(x.dtype)
    hs = rms_norm(hs, prm.head_norm, cfg.norm_eps)
    return _mm(hs * F.silu(z), prm.w_down)


def mlstm_init_state(cfg: ModelConfig, batch: int, device=None) -> MLSTMState:
    _, h, p = mlstm_dims(cfg)
    return MLSTMState(
        c=torch.zeros((batch, h, p, p), dtype=F32, device=device),
        n=torch.zeros((batch, h, p), dtype=F32, device=device),
        m=torch.full((batch, h), -math.inf, dtype=F32, device=device),
    )


def mlstm_decode_step(x: torch.Tensor, prm, cfg: ModelConfig,
                      state: MLSTMState) -> Tuple[torch.Tensor, MLSTMState]:
    """One token: x (B, 1, D) → (y (B, 1, D), the next state)."""
    bsz = x.shape[0]
    d_inner, h, p = mlstm_dims(cfg)
    hx = rms_norm(x, prm.norm, cfg.norm_eps)
    x_up = _mm(hx, prm.w_up)[:, 0]
    z = _mm(hx, prm.w_z)[:, 0]
    q, k, v, i_raw, f_raw = _mlstm_qkvif(x_up, prm, cfg)               # (B,H,P)/(B,H)
    logf = F.logsigmoid(f_raw)
    acc = torch.promote_types(logf.dtype, state.c.dtype)
    q, k, v = q.to(acc), k.to(acc), v.to(acc)

    m_new = torch.maximum(logf + state.m, i_raw)                       # (B,H)
    f_eff = torch.exp(logf + state.m - m_new)
    i_eff = torch.exp(i_raw - m_new)
    c_new = f_eff[..., None, None] * state.c + i_eff[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = f_eff[..., None] * state.n + i_eff[..., None] * k
    num = torch.einsum("bhp,bhpr->bhr", q, c_new)
    den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", q, n_new)), torch.exp(-m_new))
    h_out = (num / den[..., None]).reshape(bsz, 1, d_inner).to(x.dtype)
    h_out = rms_norm(h_out, prm.head_norm, cfg.norm_eps)
    return _mm(h_out * F.silu(z)[:, None], prm.w_down), MLSTMState(c=c_new, n=n_new, m=m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, P)
    n: torch.Tensor   # (B, H, P)
    m: torch.Tensor   # (B, H, P)
    h: torch.Tensor   # (B, H, P)


def slstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    h = cfg.n_heads
    return h, cfg.d_model // h


def slstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    h, p = slstm_dims(cfg)
    d_up = (d * 4) // 3
    defs = {"norm": ParamDef((d,), init="zeros")}
    for g in GATES:
        defs[f"w_{g}"] = ParamDef((d, d))
        defs[f"r_{g}"] = ParamDef((h, p, p), scale=0.3)
        defs[f"b_{g}"] = ParamDef((d,), init="zeros")
    defs["head_norm"] = ParamDef((d,), init="zeros")
    # post-up/down GeGLU (factor 4/3, per the xLSTM paper's sLSTM block)
    defs["mlp_norm"] = ParamDef((d,), init="zeros")
    defs["w_gate"] = ParamDef((d, d_up))
    defs["w_upp"] = ParamDef((d, d_up))
    defs["w_down"] = ParamDef((d_up, d))
    return defs


def _slstm_step(prm, cfg: ModelConfig, carry: SLSTMState, gate_x) -> SLSTMState:
    """One recurrent step.  gate_x: dict of the precomputed W·x_t (B,H,P)."""
    c, n, m, h_prev = carry

    def gate(g):
        r = getattr(prm, f"r_{g}")
        t = torch.promote_types(h_prev.dtype, r.dtype)
        return gate_x[g] + torch.einsum("bhp,hpq->bhq", h_prev.to(t), r.to(t))

    z = torch.tanh(gate("z"))
    acc = torch.promote_types(_acc(z.dtype), c.dtype)
    i_raw = gate("i").to(acc)
    f_raw = gate("f").to(acc)
    o = torch.sigmoid(gate("o"))
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i_eff = torch.exp(i_raw - m_new)
    f_eff = torch.exp(logf + m - m_new)
    c_new = f_eff * c + i_eff * z.to(acc)
    n_new = f_eff * n + i_eff
    h_new = (o.to(acc) * c_new / torch.clamp(n_new, min=1e-6)).to(z.dtype)
    return SLSTMState(c_new, n_new, m_new, h_new)


def _slstm_gates_x(hx, prm, cfg: ModelConfig):
    h, p = slstm_dims(cfg)
    lead = hx.shape[:-1]
    return {g: (_mm(hx, getattr(prm, f"w_{g}")) + getattr(prm, f"b_{g}")).reshape(*lead, h, p)
            for g in GATES}


def _slstm_out(x, hs, prm, cfg: ModelConfig):
    """The block's output from its hidden states: head norm, then the GeGLU
    post-MLP on the normed ``x + y`` (the caller adds the residual)."""
    y = rms_norm(hs, prm.head_norm, cfg.norm_eps)
    hm = rms_norm(x + y, prm.mlp_norm, cfg.norm_eps)
    mlp = _mm(F.gelu(_mm(hm, prm.w_gate), approximate="tanh") * _mm(hm, prm.w_upp), prm.w_down)
    return y + mlp


def slstm_forward(x: torch.Tensor, prm, cfg: ModelConfig) -> torch.Tensor:
    bsz, s, d = x.shape
    hx = rms_norm(x, prm.norm, cfg.norm_eps)
    gates = _slstm_gates_x(hx, prm, cfg)                               # (B,S,H,P) each
    carry = slstm_init_state(cfg, bsz, x.dtype, device=x.device)
    hs = []
    for t in range(s):
        carry = _slstm_step(prm, cfg, carry, {g: v[:, t] for g, v in gates.items()})
        hs.append(carry.h)
    return _slstm_out(x, torch.stack(hs, dim=1).reshape(bsz, s, d), prm, cfg)


def slstm_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> SLSTMState:
    h, p = slstm_dims(cfg)
    zero = torch.zeros((batch, h, p), dtype=_acc(dtype), device=device)
    return SLSTMState(c=zero, n=zero.clone(), m=zero - math.inf,
                      h=torch.zeros((batch, h, p), dtype=dtype, device=device))


def slstm_decode_step(x: torch.Tensor, prm, cfg: ModelConfig,
                      state: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    """One token: x (B, 1, D) → (y (B, 1, D), the next state)."""
    bsz = x.shape[0]
    hx = rms_norm(x, prm.norm, cfg.norm_eps)
    gates = {g: v[:, 0] for g, v in _slstm_gates_x(hx, prm, cfg).items()}
    new = _slstm_step(prm, cfg, state, gates)
    return _slstm_out(x, new.h.reshape(bsz, 1, -1), prm, cfg), new
