"""Flash-attention forward (causal or full, grouped-query): CUDA kernel and
plain PyTorch version.

Port of the forward of ``repro.kernels.flash_attention`` (the Pallas TPU
kernel ``_fwd_kernel`` through ``_flash_fwd``).  Both versions return
``(o, lse)``: ``o`` (B, S, H, hd) in q's type and the row log-sum-exp
``lse`` (B*H, S) in f32, which the backward of the training slice needs.
The kernel is ``csrc/flash_attention.cu``; the plain version below computes
the same function with whole-row softmax.

The tensor's device picks the version: a CPU tensor runs the plain version,
a CUDA tensor launches the kernel or raises; nothing falls back.  The
kernel has no backward yet: a CUDA call whose inputs require grad raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build

#: launches of the CUDA kernel.
LAUNCHES = {"flash_attention": 0}

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
#: ``flash_attention_fwd_launch``: q, k, v, o, lse, bh, bg, sq, skv, hd,
#: causal, scale, is_bf16, stream
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float] \
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


def _flash_cuda(q, k, v, causal):
    _check_shapes(q, k, v)
    b, sq, h, hd = q.shape
    g, skv = k.shape[2], k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash_attention: q, k, v must share float32 or bfloat16; "
                             f"{name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "flash_attention: the CUDA kernel is forward only; its backward "
                "(_dq_kernel, _dkv_kernel) comes with the training slice (ROADMAP §2 item 5)")
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


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward, GQA by head grouping: q (B,S,H,hd), k/v
    (B,S,G,hd) → ``(o (B,S,H,hd), lse (B*H,S))``."""
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
