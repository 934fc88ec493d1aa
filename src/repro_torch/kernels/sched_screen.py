"""Stage-1 screen: CUDA kernels and plain PyTorch versions.

Port of ``repro.kernels.sched_screen`` (the Pallas TPU kernels ``_kernel``,
``_consts_kernel`` and ``_topm_kernel``).  ``sched_screen_consts`` folds the
10 normalization constants over the fleet; ``sched_screen_topm`` scores
``omega_ub`` against given constants and keeps the top ``m_keep`` hosts,
ties at the lowest index; ``sched_screen`` runs the two in a row and returns
``(top_scores, top_idx, consts)`` with the contract of the JAX function
(callers pass ``m_keep = M + 1`` and read entry M as the admissibility
witness).  The kernels are in ``csrc/sched_screen.cu``: one launch a pass,
any number of hosts, ``m_keep`` up to ``MAX_KEEP``.

The plain versions are the JAX package's jnp screen (``_stage1_rows`` +
``consts_of`` + ``base_from_consts`` + ``omega_of``) with the top-M taken by
a stable descending sort (``torch.topk`` does not keep ``lax.top_k``'s tie
order).  CPU tensors run them; CUDA tensors launch the kernels or raise.

The request fields ``req_preemptible``, ``req_domain`` and ``exclude_zone``
are python scalars (a CUDA kernel takes them as launch arguments).

``gates`` (the policy's own multipliers) selects the traced-multiplier
program of the JAX package's ensemble: ``weigher_multipliers`` are then the
row's values, the gates say which terms exist and the bound's side, and the
weigher sum rounds as ``screen_math._traced_chain`` says.  The kernels take
it as a gate mask and a mode flag.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ..core.screen_math import (
    ScreenConsts,
    base_terms,
    consts_of,
    inv_span,
    omega_of,
    stage1_rows,
)
from . import _build

#: launches, counted where each happens; ``sched_screen`` counts both of the
#: launches it makes (two per call).
LAUNCHES = {"sched_screen_consts": 0, "sched_screen_topm": 0, "sched_screen": 0}

MAX_K = 12
MAX_D = 8
#: the most hosts the top-M pass keeps (its lists hold m_keep rounded up to a
#: power of two)
MAX_KEEP = 1024
#: threads a block (one host each per tile), the largest whose tile fits
THREADS = (512, 256, 128)
#: dynamic shared memory a block may use: two tiles (the next is copied while
#: the current one is scored), or in the top-M pass the larger of those and
#: MERGE_GROUP lists, plus its own list and buffer
SMEM_BUDGET = 200 * 1024
#: lists one merge takes: the last block of each group of this many blocks
#: merges the group's, the last group's the groups' (so at most its square)
MERGE_GROUP = 16


class Geometry(NamedTuple):
    """Launch geometry of the two passes over ``n`` hosts."""

    threads: int        # a block, one host each per tile
    consts_blocks: int
    topm_blocks: int    # = the lists merged, in groups of MERGE_GROUP
    keep_pow2: int      # a list's length: m_keep rounded up to a power of two


def _stage_bytes(threads: int, k: int, d: int) -> int:
    """Bytes of a tile in shared memory (``stage_bytes`` in the kernel)."""
    a16 = lambda x: -(-x // 16) * 16
    rows = ((k * d) | 1) + (k | 1) + 2 * (d | 1)      # floats a host, odd strides
    return a16(threads * 4 * rows) + a16(threads * k)


def _geometry(n: int, k: int, d: int, m_keep: int, sms: int) -> Geometry:
    """Threads and blocks of each pass on a card with ``sms`` SMs: one block
    an SM scores (a block holds up to two tiles, so no second fits), with as
    many threads as leave room for MERGE_GROUP lists of ``keep_pow2`` keys.
    Any ``n`` is taken; raises on an ``m_keep`` out of range."""
    if not 1 <= m_keep <= min(n, MAX_KEEP):
        raise ValueError(f"sched_screen: m_keep={m_keep} out of range for "
                         f"{n} hosts (kernel keeps at most {MAX_KEEP})")
    p = 1 << (m_keep - 1).bit_length()
    threads = next(t for t in THREADS if max(2 * _stage_bytes(t, k, d), MERGE_GROUP * 8 * p)
                   + 8 * (p + t) <= SMEM_BUDGET)
    tiles = -(-n // threads)
    return Geometry(threads, min(tiles, sms), min(tiles, sms, MERGE_GROUP ** 2), p)


class _ScreenArgs(ctypes.Structure):
    """Mirror of ``struct ScreenArgs`` in csrc/sched_screen.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "free_f", "free_n", "sched", "domain", "slow", "inst_res", "inst_cost",
        "inst_valid", "req", "churn", "host_zone")] + [
        (name, ctypes.c_int) for name in (
            "n", "k", "d", "pre", "rdom", "excl", "require_free_slot",
            "has_thr")] + [
        (name, ctypes.c_float) for name in (
            "thr", "m_over", "m_term", "m_pack", "m_strag", "m_churn")] + [
        (name, ctypes.c_int) for name in ("gates", "term_ub", "traced")]


def _m_churn(mult: Sequence[float]) -> float:
    return mult[4] if len(mult) > 4 else 0.0


def _gate_bits(gates: Sequence[float]) -> int:
    """The weighers that are on, as bits in the order over, term, pack,
    straggler, churn."""
    g = tuple(gates[:4]) + (_m_churn(gates),)
    return sum(1 << i for i, m in enumerate(g) if m)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _stage1(fleet, req_preemptible, req_domain, require_free_slot, churn,
            churn_threshold, host_zone, exclude_zone):
    return stage1_rows(
        *fleet, bool(req_preemptible), int(req_domain), require_free_slot,
        churn=churn, churn_threshold=churn_threshold,
        host_zone=host_zone, exclude_zone=exclude_zone,
    )


def sched_screen_consts_plain(
    free_f, free_n, schedulable, domain, slow, inst_res, inst_cost, inst_valid,
    req_res, req_preemptible, req_domain, weigher_multipliers,
    require_free_slot: bool, churn=None, churn_threshold=None,
    host_zone=None, exclude_zone=None, gates=None,
) -> torch.Tensor:
    """The packed (10,) ``ScreenConsts`` of the jnp screen."""
    fleet = (free_f, free_n, schedulable, domain, slow, inst_res, inst_cost,
             inst_valid, req_res)
    valid, lb, ub, raw = _stage1(fleet, req_preemptible, req_domain,
                                 require_free_slot, churn, churn_threshold,
                                 host_zone, exclude_zone)
    return consts_of(tuple(weigher_multipliers), valid, lb, ub, *raw,
                     gates=gates).pack()


def sched_screen_topm_plain(
    free_f, free_n, schedulable, domain, slow, inst_res, inst_cost, inst_valid,
    req_res, req_preemptible, req_domain, consts, weigher_multipliers,
    require_free_slot: bool, m_keep: int, churn=None, churn_threshold=None,
    host_zone=None, exclude_zone=None, gates=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``omega_ub`` against ``consts`` → the ``m_keep`` best, descending,
    ties at the lowest host index."""
    mult = tuple(weigher_multipliers)
    side = mult[1] if gates is None else gates[1]
    fleet = (free_f, free_n, schedulable, domain, slow, inst_res, inst_cost,
             inst_valid, req_res)
    valid, lb, ub, raw = _stage1(fleet, req_preemptible, req_domain,
                                 require_free_slot, churn, churn_threshold,
                                 host_zone, exclude_zone)
    c = ScreenConsts.unpack(consts)
    base, pending = base_terms(mult, raw[0], raw[1], raw[2], c,
                               raw[3] if len(raw) > 3 else None, gates=gates)
    ispan = inv_span(c.c_lo, c.c_hi)
    opt = lb if side >= 0 else ub
    omega = omega_of(opt, base, valid, c, ispan, mult[1], pending=pending,
                     gate=None if gates is None else gates[1])
    order = torch.sort(omega, descending=True, stable=True).indices[:m_keep]
    return omega[order], order.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _screen_args(free_f, free_n, schedulable, domain, slow, inst_res,
                 inst_cost, inst_valid, req_res, req_preemptible, req_domain,
                 weigher_multipliers, require_free_slot, churn,
                 churn_threshold, host_zone, exclude_zone, gates=None) -> _ScreenArgs:
    """Validate the fleet tensors for the kernels and pack the launch
    arguments.  Raises on anything the kernels do not take."""
    if inst_res.dim() != 3:
        raise ValueError("sched_screen: inst_res must be (N, K, D)")
    n, k, d = inst_res.shape
    if not 1 <= k <= MAX_K or not 1 <= d <= MAX_D or n < 1:
        raise ValueError(f"sched_screen: kernel takes N >= 1, K <= {MAX_K}, "
                         f"D <= {MAX_D}; got N={n}, K={k}, D={d}")
    f32, i32, flag = (torch.float32,), (torch.int32,), (torch.bool, torch.uint8)
    spec = [("free_f", free_f, (n, d), f32), ("free_n", free_n, (n, d), f32),
            ("schedulable", schedulable, (n,), flag), ("domain", domain, (n,), i32),
            ("slow", slow, (n,), f32), ("inst_res", inst_res, (n, k, d), f32),
            ("inst_cost", inst_cost, (n, k), f32),
            ("inst_valid", inst_valid, (n, k), flag), ("req_res", req_res, (d,), f32)]
    if churn is not None:
        spec.append(("churn", churn, (n,), f32))
    if host_zone is not None:
        spec.append(("host_zone", host_zone, (n,), i32))
    for name, t, shape, dtypes in spec:
        if t.device != free_f.device:
            raise ValueError(f"sched_screen: {name} on {t.device}, "
                             f"free_f on {free_f.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"sched_screen: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype not in dtypes:
            raise ValueError(f"sched_screen: {name} must be {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sched_screen: {name} must be contiguous")
    mult = tuple(float(m) for m in weigher_multipliers)
    if len(mult) not in (4, 5):
        raise ValueError("sched_screen: weigher_multipliers needs 4 or 5 entries")
    gate = mult if gates is None else tuple(float(g) for g in gates)
    if len(gate) != len(mult):
        raise ValueError("sched_screen: gates and weigher_multipliers differ in length")
    zone_on = host_zone is not None and exclude_zone is not None
    return _ScreenArgs(
        free_f.data_ptr(), free_n.data_ptr(), schedulable.data_ptr(),
        domain.data_ptr(), slow.data_ptr(), inst_res.data_ptr(),
        inst_cost.data_ptr(), inst_valid.data_ptr(), req_res.data_ptr(),
        churn.data_ptr() if churn is not None else None,
        host_zone.data_ptr() if zone_on else None,
        n, k, d, int(bool(req_preemptible)), int(req_domain),
        int(exclude_zone) if zone_on else -1, int(bool(require_free_slot)),
        int(churn_threshold is not None),
        float(churn_threshold) if churn_threshold is not None else 0.0,
        mult[0], mult[1], mult[2], mult[3], _m_churn(mult),
        _gate_bits(gate), int(gate[1] < 0), int(gates is not None),
    )


def _count(counts: Sequence[str]) -> None:
    for name in counts:
        LAUNCHES[name] += 1


_SMS: Dict[int, int] = {}
#: per (device, stream): the 32-bit counters that the kernels leave at 0
#: (zeroed once: the constants pass's, the top-M pass's, one a merge group),
#: then the partials and lists of the last launch.  Launches on one stream
#: run in order, so they share it.
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}
_COUNTER_WORDS = 1 + MERGE_GROUP // 2


def _launch_setup(args: _ScreenArgs, device, m_keep: int):
    """(geometry, stream, workspace of at least the words both passes use)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    geo = _geometry(args.n, args.k, args.d, m_keep, _SMS[index])
    stream = torch.cuda.current_stream(index).cuda_stream
    lists = (geo.topm_blocks + MERGE_GROUP) * geo.keep_pow2     # block and group lists
    words = _COUNTER_WORDS + 5 * geo.consts_blocks + lists
    ws = _WORKSPACE.get((index, stream))
    if ws is None or ws.numel() < words:
        ws = torch.zeros((words,), dtype=torch.int64, device=device)
        _WORKSPACE[(index, stream)] = ws
    return geo, stream, ws


def _consts_cuda(args: _ScreenArgs, geo: Geometry, stream: int, ws: torch.Tensor,
                 consts: torch.Tensor, counts: Sequence[str]) -> None:
    """Launch the constants pass into ``consts``; adds one to each of
    ``counts``."""
    fn = _build.entry("sched_screen", "sched_screen_consts_launch",
                      [_ScreenArgs, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4)
    base = ws.data_ptr()
    with torch.cuda.device(consts.device):      # the stream's device current
        _build.check(fn(args, geo.threads, geo.consts_blocks, base + 8 * _COUNTER_WORDS, base,
                        consts.data_ptr(), stream), "sched_screen_consts")
    _count(counts)


def _topm_cuda(args: _ScreenArgs, geo: Geometry, stream: int, ws: torch.Tensor, consts,
               m_keep: int, scores: torch.Tensor, idx: torch.Tensor,
               counts: Sequence[str]) -> None:
    """Launch the top-M pass (block tops, then the two levels of merges)
    into ``scores`` and ``idx``; adds one to each of ``counts``."""
    if tuple(consts.shape) != (10,) or consts.dtype != torch.float32 \
            or consts.device != scores.device or not consts.is_contiguous():
        raise ValueError("sched_screen_topm: consts must be a contiguous "
                         f"(10,) float32 tensor on {scores.device}")
    fn = _build.entry("sched_screen", "sched_screen_topm_launch",
                      [_ScreenArgs, ctypes.c_void_p] + [ctypes.c_int] * 4
                      + [ctypes.c_void_p] * 7)
    base = ws.data_ptr()
    lists = base + 8 * (_COUNTER_WORDS + 5 * geo.consts_blocks)
    group_lists = lists + 8 * geo.topm_blocks * geo.keep_pow2
    with torch.cuda.device(scores.device):
        _build.check(fn(args, consts.data_ptr(), m_keep, geo.keep_pow2, geo.threads,
                        geo.topm_blocks, lists, group_lists, base + 4, base + 8,
                        scores.data_ptr(), idx.data_ptr(), stream), "sched_screen_topm")
    _count(counts)


def _outputs(m_keep: int, with_consts: bool, device):
    """``(consts or None, scores, idx)`` as views of one allocation."""
    head = 10 if with_consts else 0
    out = torch.empty((head + 2 * m_keep,), dtype=torch.int32, device=device)
    consts = out[:head].view(torch.float32) if with_consts else None
    return consts, out[head:head + m_keep].view(torch.float32), out[head + m_keep:]


# ---------------------------------------------------------------------------
# Public entries (the device picks the version)
# ---------------------------------------------------------------------------


def _device_of(free_f: torch.Tensor) -> str:
    if free_f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sched_screen: unsupported device {free_f.device}")
    return free_f.device.type


def sched_screen_consts(
    free_f, free_n, schedulable, domain, slow, inst_res, inst_cost, inst_valid,
    req_res, req_preemptible, req_domain, weigher_multipliers,
    require_free_slot: bool, churn=None, churn_threshold=None,
    host_zone=None, exclude_zone=None, gates=None,
) -> torch.Tensor:
    """Fold only the 10 normalization constants; returns them packed (10,)."""
    fleet = (free_f, free_n, schedulable, domain, slow, inst_res, inst_cost,
             inst_valid, req_res, req_preemptible, req_domain,
             weigher_multipliers, require_free_slot)
    extra = dict(churn=churn, churn_threshold=churn_threshold,
                 host_zone=host_zone, exclude_zone=exclude_zone, gates=gates)
    if _device_of(free_f) == "cpu":
        return sched_screen_consts_plain(*fleet, **extra)
    args = _screen_args(*fleet, **extra)
    geo, stream, ws = _launch_setup(args, free_f.device, 1)
    consts = torch.empty((10,), dtype=torch.float32, device=free_f.device)
    _consts_cuda(args, geo, stream, ws, consts, ("sched_screen_consts",))
    return consts


def _check_m_keep(m_keep: int, n: int) -> None:
    if not 1 <= m_keep <= n:
        raise ValueError(f"m_keep={m_keep} out of range for {n} hosts")


def sched_screen_topm(
    free_f, free_n, schedulable, domain, slow, inst_res, inst_cost, inst_valid,
    req_res, req_preemptible, req_domain, consts, weigher_multipliers,
    require_free_slot: bool, m_keep: int, churn=None, churn_threshold=None,
    host_zone=None, exclude_zone=None, gates=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score ``omega_ub`` against ``consts`` and return the top ``m_keep``
    ``(scores, host indices)``."""
    head = (free_f, free_n, schedulable, domain, slow, inst_res, inst_cost,
            inst_valid, req_res, req_preemptible, req_domain)
    extra = dict(churn=churn, churn_threshold=churn_threshold,
                 host_zone=host_zone, exclude_zone=exclude_zone, gates=gates)
    if _device_of(free_f) == "cpu":
        _check_m_keep(m_keep, free_f.shape[0])
        return sched_screen_topm_plain(*head, consts, weigher_multipliers,
                                       require_free_slot, m_keep, **extra)
    args = _screen_args(*head, weigher_multipliers, require_free_slot, **extra)
    geo, stream, ws = _launch_setup(args, free_f.device, m_keep)
    _, scores, idx = _outputs(m_keep, False, free_f.device)
    _topm_cuda(args, geo, stream, ws, consts, m_keep, scores, idx, ("sched_screen_topm",))
    return scores, idx


def sched_screen(
    free_f, free_n, schedulable, domain, slow, inst_res, inst_cost, inst_valid,
    req_res, req_preemptible, req_domain, weigher_multipliers,
    require_free_slot: bool, m_keep: int, churn=None, churn_threshold=None,
    host_zone=None, exclude_zone=None, gates=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage-1 screen: ``(top_scores (m_keep,), top_idx (m_keep,), consts
    (10,))`` — the constants pass, then the top-M pass against them.

    On the card that is two launches (the launch arguments are packed once,
    the outputs are one allocation), each counted under its own kernel's name
    and under ``sched_screen``."""
    fleet = (free_f, free_n, schedulable, domain, slow, inst_res, inst_cost,
             inst_valid, req_res, req_preemptible, req_domain,
             weigher_multipliers, require_free_slot)
    extra = dict(churn=churn, churn_threshold=churn_threshold,
                 host_zone=host_zone, exclude_zone=exclude_zone, gates=gates)
    if _device_of(free_f) == "cpu":
        _check_m_keep(m_keep, free_f.shape[0])
        consts = sched_screen_consts_plain(*fleet, **extra)
        scores, idx = sched_screen_topm_plain(
            *fleet[:11], consts, *fleet[11:], m_keep, **extra)
        return scores, idx, consts
    args = _screen_args(*fleet, **extra)
    geo, stream, ws = _launch_setup(args, free_f.device, m_keep)
    consts, scores, idx = _outputs(m_keep, True, free_f.device)
    _consts_cuda(args, geo, stream, ws, consts, ("sched_screen_consts", "sched_screen"))
    _topm_cuda(args, geo, stream, ws, consts, m_keep, scores, idx,
               ("sched_screen_topm", "sched_screen"))
    return scores, idx, consts
