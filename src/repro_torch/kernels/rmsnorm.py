"""Fused RMSNorm: CUDA kernel and plain PyTorch version.

Port of ``repro.kernels.rmsnorm`` (the Pallas TPU kernel ``_kernel``), which
computes the formula of ``repro.models.layers.rms_norm``:
``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32 over the last axis, cast
back to x's type.  The kernel is ``csrc/rmsnorm.cu`` (CUDA C++, one block
per row).  CUDA C++ and not Triton: the job is a row reduction and an
elementwise pass, which either route writes in a few lines, and CUDA keeps
one build path for every kernel of the port (``_build``: one ``nvcc`` per
source, a plain C interface through ``ctypes``, the launch error checked by
the wrapper), where Triton would add a second compiler and cache.

The tensor's device picks the version: a CPU tensor runs the plain version,
a CUDA tensor launches the kernel or raises; nothing falls back.  On the
card the kernel sits in a ``torch.autograd.Function`` whose backward is the
plain version's autograd gradient, recomputed from x and w: the JAX package
has no RMSNorm backward kernel either (XLA differentiates the jnp
``rms_norm``), so this is the reference's own route.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel.
LAUNCHES = {"rmsnorm": 0}

_DTYPES = (torch.float32, torch.bfloat16)
#: ``rmsnorm_launch``: x, w, out, rows, d, eps, x_bf16, w_bf16, stream
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis, any leading shape (the plain version)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.to(torch.float32))
    return out.to(x.dtype)


def _rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    if x.dim() < 1 or weight.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} does not match the last "
                         f"axis of x {tuple(x.shape)}")
    for name, t in (("x", x), ("weight", weight)):
        if t.dtype not in _DTYPES:
            raise ValueError(f"rmsnorm: {name} must be float32 or bfloat16, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"rmsnorm: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm: {name} must be contiguous")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows == 0:
        return out
    fn = _build.entry("rmsnorm", "rmsnorm_launch", _LAUNCH_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d, eps,
                        int(x.dtype == torch.bfloat16), int(weight.dtype == torch.bfloat16),
                        stream), "rmsnorm")
    LAUNCHES["rmsnorm"] += 1
    return out


class _RMSNorm(torch.autograd.Function):
    """The kernel forward; the backward differentiates ``rmsnorm_plain``
    again from the saved x and w."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight)
        return _rmsnorm_cuda(x, weight, eps)

    @staticmethod
    def backward(ctx, dout):
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            xg, wg = x.detach().requires_grad_(), weight.detach().requires_grad_()
            dx, dw = torch.autograd.grad(rmsnorm_plain(xg, wg, ctx.eps), (xg, wg), dout)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Fused RMSNorm over the last axis; any leading shape (the contract of
    ``repro.kernels.rmsnorm.rmsnorm``), differentiable in x and w."""
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
            return _RMSNorm.apply(x, weight, eps)
        return _rmsnorm_cuda(x, weight, eps)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    raise ValueError(f"rmsnorm: unsupported device {x.device}")
