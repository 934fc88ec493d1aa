"""Flash attention (causal or full, grouped-query), forward and backward:
CUDA kernels and plain PyTorch versions.

Port of ``repro.kernels.flash_attention``: the forward of the Pallas TPU
kernel ``_fwd_kernel`` (through ``_flash_fwd``) and its backward
``_dq_kernel`` / ``_dkv_kernel`` (through ``_flash_bwd``), joined by a
``torch.autograd.Function`` where the JAX package has a custom VJP.
``flash_attention`` returns ``(o, lse)``: ``o`` (B, S, H, hd) in q's type,
differentiable, and the row log-sum-exp ``lse`` (B*H, S) in f32, which the
backward reads and which carries no gradient.  The kernels are
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(dq, dk/dv); the plain versions compute the same functions with whole-row
softmax.

The tensor's device picks the version: a CPU tensor runs the plain version,
a CUDA tensor launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build

#: launches of the CUDA kernels: the forward, dq and dk/dv.
LAUNCHES = {"flash_attention": 0, "flash_attention_dq": 0, "flash_attention_dkv": 0}

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
#: ``flash_attention_fwd_launch``: q, k, v, o, lse, bh, bg, sq, skv, hd,
#: causal, scale, is_bf16, stream
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float] \
    + [ctypes.c_int] + [ctypes.c_void_p]
#: ``flash_attention_dq_launch``: q, k, v, do, lse, delta, dq, bh, bg, sq, skv,
#: hd, causal, scale, is_bf16, stream
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float] \
    + [ctypes.c_int] + [ctypes.c_void_p]
#: ``flash_attention_dkv_launch``: q, k, v, do, lse, delta, dk, dv, bh, bg, sq,
#: skv, hd, causal, scale, is_bf16, stream
_DKV_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] \
    + [ctypes.c_int] + [ctypes.c_void_p]


def _flatten(q, k, v):
    """(B, S, H, hd) → (B*H, S, hd) contiguous, as ``flash_attention`` feeds
    ``_flash_fwd``."""
    b, sq, h, hd = q.shape
    g, skv = k.shape[2], k.shape[1]
    qf = q.transpose(1, 2).reshape(b * h, sq, hd)
    kf = k.transpose(1, 2).reshape(b * g, skv, hd)
    vf = v.transpose(1, 2).reshape(b * g, skv, hd)
    return qf.contiguous(), kf.contiguous(), vf.contiguous()


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: expected q (B,S,H,hd), k = v (B,S,G,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head size, or H is not a multiple of G")


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o (B,S,H,hd) in q's type, lse (B*H,S) f32)`` with f32 math."""
    _check_shapes(q, k, v)
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    qf, kf, vf = _flatten(q, k, v)
    rep = h // k.shape[2]
    kx = kf.to(torch.float32).repeat_interleave(rep, dim=0)
    vx = vf.to(torch.float32).repeat_interleave(rep, dim=0)
    s = torch.matmul(qf.to(torch.float32), kx.transpose(1, 2)) * (1.0 / math.sqrt(hd))
    if causal:
        keep = (torch.arange(skv, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(keep, s, NEG_INF)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    lc = torch.clamp(torch.sum(p, dim=-1), min=1e-30)
    o = torch.matmul(p, vx) / lc[..., None]
    lse = m + torch.log(lc)
    return o.reshape(b, h, sq, hd).transpose(1, 2).to(q.dtype), lse


def _check_cuda(q, k, v):
    """What the CUDA kernels take: shapes, head dims, one float type and one
    device for q, k and v."""
    _check_shapes(q, k, v)
    hd = q.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash_attention: q, k, v must share float32 or bfloat16; "
                             f"{name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")


def _flash_cuda(q, k, v, causal):
    _check_cuda(q, k, v)
    b, sq, h, hd = q.shape
    g, skv = k.shape[2], k.shape[1]
    qf, kf, vf = _flatten(q, k, v)
    o = torch.empty_like(qf)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    if qf.numel() and skv:
        fn = _build.entry("flash_attention", "flash_attention_fwd_launch", _LAUNCH_ARGTYPES)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.check(fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), o.data_ptr(),
                            lse.data_ptr(), b * h, b * g, sq, skv, hd, int(causal),
                            1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16), stream),
                         "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return o.reshape(b, h, sq, hd).transpose(1, 2), lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward alone, no autograd: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _delta(of: torch.Tensor, dof: torch.Tensor) -> torch.Tensor:
    """``rowsum(do * o)`` in f32, (B*H, S): ``_flash_bwd``'s delta."""
    return torch.sum(dof.to(torch.float32) * of.to(torch.float32), dim=-1)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of the flash forward (the plain version of
    ``_dq_kernel`` and ``_dkv_kernel``): p recomputed from the saved ``lse``,
    ``ds = p * (do.v^T - delta) * scale`` with ``delta = rowsum(do*o)``, f32
    math; dq in q's type, dk and dv in k's type.  q, o, do (B,S,H,hd); k, v
    (B,S,G,hd); lse (B*H,S)."""
    _check_shapes(q, k, v)
    b, sq, h, hd = q.shape
    g, skv = k.shape[2], k.shape[1]
    rep = h // g
    f32 = torch.float32
    qf, kf, vf = (t.to(f32) for t in _flatten(q, k, v))
    of, dof = (t.transpose(1, 2).reshape(b * h, sq, hd).to(f32) for t in (o, do))
    scale = 1.0 / math.sqrt(hd)
    kx = kf.repeat_interleave(rep, dim=0)
    vx = vf.repeat_interleave(rep, dim=0)
    s = torch.matmul(qf, kx.transpose(1, 2)) * scale
    if causal:
        keep = (torch.arange(skv, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(keep, s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dof, vx.transpose(1, 2))
    ds = p * (dp - _delta(of, dof)[..., None]) * scale
    dq = torch.matmul(ds, kx)
    dk = torch.matmul(ds.transpose(1, 2), qf).reshape(b * g, rep, skv, hd).sum(1)
    dv = torch.matmul(p.transpose(1, 2), dof).reshape(b * g, rep, skv, hd).sum(1)
    return (dq.reshape(b, h, sq, hd).transpose(1, 2).to(q.dtype),
            dk.reshape(b, g, skv, hd).transpose(1, 2).to(k.dtype),
            dv.reshape(b, g, skv, hd).transpose(1, 2).to(k.dtype))


def _flash_bwd_cuda(q, k, v, o, lse, do, causal):
    _check_cuda(q, k, v)
    b, sq, h, hd = q.shape
    g, skv = k.shape[2], k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b * h, sq):
        raise ValueError(f"flash_attention backward: o {tuple(o.shape)}, do {tuple(do.shape)} "
                         f"and lse {tuple(lse.shape)} do not match q {tuple(q.shape)}")
    qf, kf, vf = _flatten(q, k, v)
    of = o.transpose(1, 2).reshape(b * h, sq, hd)
    dof = do.to(q.dtype).transpose(1, 2).reshape(b * h, sq, hd).contiguous()
    lse = lse.to(torch.float32).contiguous()
    delta = _delta(of, dof).contiguous()
    dq, dk, dv = torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vf)
    if qf.numel() and skv:
        common = (qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(),
                  lse.data_ptr(), delta.data_ptr())
        shape = (b * h, b * g, sq, skv, hd, int(causal), 1.0 / math.sqrt(hd),
                 int(q.dtype == torch.bfloat16))
        fn_dq = _build.entry("flash_attention_bwd", "flash_attention_dq_launch", _DQ_ARGTYPES)
        fn_dkv = _build.entry("flash_attention_bwd", "flash_attention_dkv_launch", _DKV_ARGTYPES)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.check(fn_dq(*common, dq.data_ptr(), *shape, stream), "flash_attention_dq")
            LAUNCHES["flash_attention_dq"] += 1
            _build.check(fn_dkv(*common, dk.data_ptr(), dv.data_ptr(), *shape, stream),
                         "flash_attention_dkv")
            LAUNCHES["flash_attention_dkv"] += 1
    else:
        for t in (dq, dk, dv):
            t.zero_()
    return (dq.reshape(b, h, sq, hd).transpose(1, 2),
            dk.reshape(b, g, skv, hd).transpose(1, 2),
            dv.reshape(b, g, skv, hd).transpose(1, 2))


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: the dq and dk/dv kernels on CUDA tensors (delta
    formed in PyTorch first), the plain version on CPU tensors."""
    if q.device.type == "cuda":
        return _flash_bwd_cuda(q, k, v, o, lse, do, causal)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of ``repro.kernels.flash_attention._flash``: the
    forward saves ``(q, k, v, o, lse)``, the backward runs dq and dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention, GQA by head grouping: q (B,S,H,hd), k/v (B,S,G,hd) →
    ``(o (B,S,H,hd), lse (B*H,S))``; ``o`` is differentiable in q, k and v
    (through the backward kernels on the card), ``lse`` is not."""
    return _FlashAttention.apply(q, k, v, causal)
