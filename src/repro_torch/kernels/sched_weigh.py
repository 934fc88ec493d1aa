"""Alg. 5 subset enumeration per host: CUDA kernel and plain PyTorch version.

Port of ``repro.kernels.sched_weigh`` (the Pallas TPU kernel ``_kernel``).
For every host, all 2^K termination subsets of its K preemptible slots are
scored (feasibility against the request on every dim, additive cost) and
reduced to the host's best plan.  The kernel is ``csrc/sched_weigh.cu``; the
plain version below (the port of ``jax_scheduler.host_plan_terms``) is what
CPU tensors run and what the kernel is held against on the card.

The tensor's device picks the version: CPU tensors run the plain version,
CUDA tensors launch the kernel (or raise); nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..core.screen_math import EPS, POS_INF, TIE_EPS
from . import _build

#: launches of the CUDA kernel: ``sched_weigh`` counts every launch (both
#: entry points run the same kernel), ``sched_weigh_gathered`` the launches
#: of the stage-2 entry on a gathered shortlist.
LAUNCHES = {"sched_weigh": 0, "sched_weigh_gathered": 0}

MAX_K = 12
MAX_D = 8
#: ``sched_weigh_launch``: 5 input pointers, n/k/d, tie_eps, 3 outputs, stream
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] \
    + [ctypes.c_void_p] * 4


def subset_masks(k: int) -> np.ndarray:
    """(2^k, k) 0/1 matrix enumerating all subsets (row m = the bits of m)."""
    m = np.arange(1 << k, dtype=np.uint32)
    return ((m[:, None] >> np.arange(k)[None, :]) & 1).astype(np.float32)


def _subset_sums(vals: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(N, K) slot values -> (N, 2^K) sums over each mask's slots (an exact
    zero for a slot outside the mask), in the order of XLA's CPU dot
    ``(N, K) @ (K, 2^K)`` against the 0/1 masks, which the reference's
    ``host_plan_terms`` runs: on two or more hosts (c0 + c1) + (c2 + c3)
    at K = 4 and ((c0 + c2) + (c1 + c3)) + c4 at K = 5; slot order at every
    other K, and at every K on one host."""
    n, k = vals.shape

    def c(s):
        return torch.where(bits[:, s][None, :], vals[:, s][:, None], 0.0)

    if n >= 2 and k == 4:
        return (c(0) + c(1)) + (c(2) + c(3))
    if n >= 2 and k == 5:
        return ((c(0) + c(2)) + (c(1) + c(3))) + c(4)
    acc = torch.zeros((n, bits.shape[0]), dtype=vals.dtype, device=vals.device)
    for s in range(k):
        acc = acc + c(s)
    return acc


def sched_weigh_plain(
    free_f: torch.Tensor,
    inst_res: torch.Tensor,
    inst_cost: torch.Tensor,
    inst_valid: torch.Tensor,
    req_res: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-host Alg. 5 terms ``(best_cost, best_mask, feasible)``, each (N,).

    Subset sums run in XLA's order (``_subset_sums``), the order the kernel
    uses."""
    n, k, d = inst_res.shape
    bits = torch.from_numpy(subset_masks(k) > 0.5).to(free_f.device)  # (M, K)
    valid = inst_valid.to(torch.bool)
    res = torch.where(valid[..., None], inst_res, 0.0)
    cost = torch.where(valid, inst_cost, POS_INF)
    ok = None
    for j in range(d):
        cond = free_f[:, j][:, None] + _subset_sums(res[:, :, j], bits) >= req_res[j] - EPS
        ok = cond if ok is None else ok & cond
    sub = torch.where(ok, _subset_sums(cost, bits), POS_INF)
    best_cost = torch.amin(sub, dim=1)
    size = bits.sum(dim=1)
    is_tie = sub <= best_cost[:, None] + TIE_EPS
    size_key = torch.where(is_tie, size[None, :], k + 1)
    best_mask = torch.argmin(size_key, dim=1).to(torch.int32)
    return best_cost, best_mask, torch.any(ok, dim=1)


def _check_cuda(free_f, inst_res, inst_cost, inst_valid, req_res):
    if not (free_f.dim() == 2 and inst_res.dim() == 3 and inst_cost.dim() == 2
            and inst_valid.dim() == 2 and req_res.dim() == 1):
        raise ValueError("sched_weigh: expected free_f (N,D), inst_res (N,K,D), "
                         "inst_cost (N,K), inst_valid (N,K), req_res (D,)")
    n, k, d = inst_res.shape
    if free_f.shape != (n, d) or inst_cost.shape != (n, k) \
            or inst_valid.shape != (n, k) or req_res.shape != (d,):
        raise ValueError(
            f"sched_weigh: inconsistent shapes free_f {tuple(free_f.shape)}, "
            f"inst_res {tuple(inst_res.shape)}, inst_cost {tuple(inst_cost.shape)}, "
            f"inst_valid {tuple(inst_valid.shape)}, req_res {tuple(req_res.shape)}"
        )
    if not 1 <= k <= MAX_K or not 1 <= d <= MAX_D:
        raise ValueError(f"sched_weigh: kernel takes K <= {MAX_K}, D <= {MAX_D}; "
                         f"got K={k}, D={d}")
    for name, t, dt in (("free_f", free_f, (torch.float32,)),
                        ("inst_res", inst_res, (torch.float32,)),
                        ("inst_cost", inst_cost, (torch.float32,)),
                        ("inst_valid", inst_valid, (torch.bool, torch.uint8)),
                        ("req_res", req_res, (torch.float32,))):
        if t.device != free_f.device:
            raise ValueError(f"sched_weigh: {name} on {t.device}, free_f on {free_f.device}")
        if t.dtype not in dt:
            raise ValueError(f"sched_weigh: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sched_weigh: {name} must be contiguous")
    return n, k, d


def _sched_weigh_cuda(free_f, inst_res, inst_cost, inst_valid, req_res,
                      counts=("sched_weigh",)):
    n, k, d = _check_cuda(free_f, inst_res, inst_cost, inst_valid, req_res)
    fn = _build.entry("sched_weigh", "sched_weigh_launch", _LAUNCH_ARGTYPES)
    best_cost = torch.empty((n,), dtype=torch.float32, device=free_f.device)
    best_mask = torch.empty((n,), dtype=torch.int32, device=free_f.device)
    feasible = torch.empty((n,), dtype=torch.bool, device=free_f.device)
    with torch.cuda.device(free_f.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(
            free_f.data_ptr(), inst_res.data_ptr(), inst_cost.data_ptr(),
            inst_valid.data_ptr(), req_res.data_ptr(), n, k, d, TIE_EPS,
            best_cost.data_ptr(), best_mask.data_ptr(), feasible.data_ptr(),
            stream,
        ), "sched_weigh")
    for name in counts:
        LAUNCHES[name] += 1
    return best_cost, best_mask, feasible


def sched_weigh(free_f, inst_res, inst_cost, inst_valid, req_res):
    """Per-host best plan over all 2^K subsets: ``(best_cost (N,) f32,
    best_mask (N,) i32, feasible (N,) bool)``; the contract of
    ``repro.kernels.sched_weigh.sched_weigh`` with the mask matrix implied
    by K (mask index m = the subset whose bit k is slot k)."""
    if free_f.device.type == "cuda":
        return _sched_weigh_cuda(free_f, inst_res, inst_cost, inst_valid, req_res)
    if free_f.device.type == "cpu":
        return sched_weigh_plain(free_f, inst_res, inst_cost, inst_valid, req_res)
    raise ValueError(f"sched_weigh: unsupported device {free_f.device}")


def sched_weigh_gathered(free_f, inst_res, inst_cost, inst_valid, req_res):
    """Stage-2 entry: the same enumeration on the gathered (M, K, D) rows of
    the shortlisted hosts, its launches counted under ``sched_weigh`` and
    ``sched_weigh_gathered``."""
    if free_f.device.type == "cuda":
        return _sched_weigh_cuda(free_f, inst_res, inst_cost, inst_valid, req_res,
                                 ("sched_weigh", "sched_weigh_gathered"))
    return sched_weigh(free_f, inst_res, inst_cost, inst_valid, req_res)
