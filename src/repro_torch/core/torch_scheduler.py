"""The two-stage scheduling decision in PyTorch, on persistent fleet state
and on state rebuilt from python hosts per call.

Port of ``repro.core.jax_scheduler``:

    stage 1 (O(N·K))  ``sched_screen``: dual-view fit mask, exact
                      feasibility, termination-cost bounds, the 10
                      normalization constants and the top-(M+1) shortlist
                      by the optimistic score ``omega_ub``;
    stage 2 (O(M·2^K)) ``sched_weigh_gathered``: exact Alg. 5 enumeration on
                      the M shortlisted hosts, then the admissibility check
                      against the best non-shortlisted bound, falling back to
                      the full enumeration (``sched_weigh`` on every host)
                      when the shortlist cannot certify its winner.

Two state flavors, as in the JAX module:

* ``SoAFleetState`` + ``build_fleet_state`` — built once, then updated in
  place by the transitions (``schedule_step``, ``schedule_many``,
  ``apply_*``): the fleet-scale path that ``SoAFleet`` drives;
* ``SoAHostState`` + ``build_soa_state`` — rebuilt from python ``Host``
  objects on every call, with each slot's termination cost frozen at build
  time (``schedule_decision``, ``TorchPreemptibleScheduler``): the
  rebuild-per-call scheduler with the python schedulers' interface.

The state's device picks the kernels: on a CUDA state every stage-1 screen
and every enumeration launches the hand-written kernels; on a CPU state the
same calls run their plain PyTorch versions, which reproduce the JAX
package's default (jnp) path bit for bit on integer-valued inputs.

A policy's ``mesh`` (``fleet_sharding.FleetMesh``) or a state sharded by
``fleet_sharding.shard_fleet_state`` runs stage 1 per host-major shard
(``_sharded_screen``: the constants pass on every shard, the constants
merged, the top-M pass on every shard) and merges the shortlists on the
lead device (``fleet_sharding.merge_shortlists``); the transitions touch
only the block that holds the host.

Differences from the JAX module, all deliberate:

* ``lax.scan`` is a Python loop and ``lax.cond`` a Python ``if``: each
  decision reads one small tensor back to the host (the admissibility flag
  and the winner), so a decision costs one host synchronisation.
* The transitions update the state's tensors **in place** (the JAX package
  donates the buffers instead).  ``schedule_step`` / ``schedule_many`` and
  ``apply_*`` return the same ``SoAFleetState`` object they were given.
* Request fields are python scalars (``req_preemptible``, ``req_domain``,
  ...); ``req_res`` is a (D,) tensor on the state's device.
* The ports of ``host_plan_terms`` (``kernels.sched_weigh_plain``) and of
  ``screen_terms`` / ``_stage1_rows`` (``screen_math``) live beside the
  kernels and the bounds math they share.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import (
    sched_screen,
    sched_screen_consts,
    sched_screen_topm,
    sched_weigh,
    sched_weigh_gathered,
)
from ..kernels.sched_weigh import subset_masks
from .policy import COST_KIND_IDS, DEFAULT_SHORTLIST, SchedulerPolicy, ensure_policy
from .screen_math import (
    NEG_INF,
    POS_INF,
    ScreenConsts,
    base_terms,
    churn_of,
    consts_of,
    floor_mod,
    fma,
    inv_span,
    omega_of,
    slot_cost_by_kind,
    stage1_rows,
)
from .cost import CostFunction, PeriodCost
from .types import (
    EMPTY_PLAN,
    Host,
    Instance,
    Request,
    ScheduleResult,
    TerminationPlan,
)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for and absent:
    an entry point never drops quietly to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_BITS: Dict[Tuple[int, str], torch.Tensor] = {}


def _mask_bits(k: int, device: torch.device) -> torch.Tensor:
    """(2^k, k) bool table on ``device``: row m holds the bits of mask m."""
    key = (k, str(device))
    if key not in _BITS:
        _BITS[key] = torch.from_numpy(subset_masks(k) > 0.5).to(device)
    return _BITS[key]


def _base_of(mult, raw, consts: ScreenConsts, gates=None):
    """``base_terms`` over a 3- or 4-entry ``raw`` tuple: the base weigher
    sum and the product ``omega_of`` fuses into the termination term."""
    churn_raw = raw[3] if len(raw) > 3 else None
    return base_terms(mult, raw[0], raw[1], raw[2], consts, churn_raw, gates=gates)


# ---------------------------------------------------------------------------
# The decision core
# ---------------------------------------------------------------------------


class _Knobs(NamedTuple):
    """What one decision reads off the policy (the static part of
    ``jax_scheduler._decision_core``)."""

    m_cand: int                  # shortlist size M (0 = full enumeration)
    churn_on: bool               # the churn column is read
    zone_on: bool                # the zone-exclusion operand is live
    mult: Tuple[float, ...]      # the multipliers that do the arithmetic
    gates: Optional[Tuple[float, ...]]   # the policy's, under traced values
    thr: Optional[float]         # the hot-zone steering threshold
    m_term: float
    gate: Optional[float]        # omega_of's traced program
    m_term_gate: float


def _knobs(policy: SchedulerPolicy, n_hosts: int, has_churn: bool, has_zone: bool,
           exclude_zone, mult_val) -> _Knobs:
    shortlist = policy.shortlist
    if shortlist is None:
        shortlist = DEFAULT_SHORTLIST if n_hosts > 4 * DEFAULT_SHORTLIST else 0
    churn_on = has_churn and policy.churn_aware
    mult = policy.all_multipliers if churn_on else policy.weigher_multipliers
    gates = None
    if mult_val is not None:
        gates = mult
        mult = tuple(float(mult_val[i]) for i in range(len(gates)))
    gate = None if gates is None else gates[1]
    return _Knobs(
        m_cand=min(int(shortlist), n_hosts), churn_on=churn_on,
        zone_on=has_zone and exclude_zone is not None and policy.relocation_on,
        mult=mult, gates=gates,
        thr=policy.churn_threshold if churn_on else None,
        m_term=mult[1], gate=gate, m_term_gate=mult[1] if gates is None else gate,
    )


def _use_mesh(mesh, n_hosts: int, m_cand: int) -> bool:
    """The JAX package's rule for running the screen per shard: a shortlist,
    and every shard at least M + 1 hosts."""
    return (mesh is not None and m_cand > 0 and n_hosts % mesh.size == 0
            and n_hosts // mesh.size >= m_cand + 1)


_TRACED_ON_MESH = (
    "traced multiplier values (ensemble axis) are not supported on the mesh "
    "stage-1 path, which closes the static multipliers over the per-shard "
    "screen; run the ensemble with mesh=None"
)


def _stage2(rows_c, req_res, pre: bool, cand, u, j_u, consts: ScreenConsts,
            valid_c, base_c, pending_c, n_hosts: int, k: int, kn: _Knobs):
    """Stage 2 on the gathered shortlist rows ``(free_f, inst_res,
    inst_cost, inst_valid)`` and the admissibility check.  Returns
    ``([admissible, w_star, mask, ok], margin)``, the list read back in the
    decision's one host sync."""
    ispan = inv_span(consts.c_lo, consts.c_hi)
    bc_s, bm_s, _ = sched_weigh_gathered(*rows_c, req_res)
    if pre:
        bc_s = torch.zeros_like(bc_s)
        bm_s = torch.zeros_like(bm_s)
    omega_s = omega_of(bc_s, base_c, valid_c, consts, ispan, kn.m_term,
                       pending=pending_c, gate=kn.gate)
    best_val = torch.amax(omega_s)
    # Winner = lowest original index among exact-score ties.
    tie_idx = torch.where(omega_s == best_val, cand, n_hosts)
    winner_pos = torch.argmin(tie_idx)
    w_star = tie_idx[winner_pos]
    ok_s = best_val > NEG_INF / 2

    # ---- admissibility: can any non-shortlisted host still win? -------------
    if kn.m_term_gate:
        scale = abs(kn.m_term) * ispan * (3.0 * k * 1.2e-7)
        bound = fma(-scale, torch.maximum(torch.abs(consts.c_hi),
                                          torch.abs(consts.c_lo)), best_val)
    else:
        bound = best_val
    admissible = (u < bound) | ((u == best_val) & (j_u > w_star)) | ~ok_s
    margin = torch.where(ok_s, best_val - u, POS_INF)
    out = torch.stack([
        admissible.to(torch.float64), w_star.to(torch.float64),
        bm_s[winner_pos].to(torch.float64), ok_s.to(torch.float64),
    ]).tolist()
    return out, margin


def _full_rows(cols, req_res, pre: bool, dom: int, require_free_slot: bool,
               exclude_zone, kn: _Knobs):
    """The full enumeration's stage-1 rows on one block of the ten host
    columns (churn and zone ignored when off): ``(valid, raw, consts)``,
    the constants folded over this block alone."""
    valid, cost_lb, cost_ub, raw = stage1_rows(
        *cols[:8], req_res, pre, dom, require_free_slot,
        churn=cols[8] if kn.churn_on else None, churn_threshold=kn.thr,
        host_zone=cols[9] if kn.zone_on else None, exclude_zone=exclude_zone)
    return valid, raw, consts_of(kn.mult, valid, cost_lb, cost_ub, *raw, gates=kn.gates)


def _full_omega(cols, req_res, pre: bool, valid, raw, consts: ScreenConsts, kn: _Knobs):
    """Every host's exact score on one block under the fleet's ``consts``,
    ``sched_weigh`` enumerating its kill subsets: ``(omega, best_mask)``."""
    base, pending = _base_of(kn.mult, raw, consts, kn.gates)
    ispan = inv_span(consts.c_lo, consts.c_hi)
    best_cost, best_mask, _ = sched_weigh(cols[0], cols[5], cols[6], cols[7], req_res)
    if pre:
        best_cost = torch.zeros_like(best_cost)
        best_mask = torch.zeros_like(best_mask)
    omega = omega_of(best_cost, base, valid, consts, ispan, kn.m_term,
                     pending=pending, gate=kn.gate)
    return omega, best_mask


def _decision_core(
    free_f: torch.Tensor,
    free_n: torch.Tensor,
    schedulable: torch.Tensor,
    domain: torch.Tensor,
    slow: torch.Tensor,
    inst_res: torch.Tensor,
    inst_cost: torch.Tensor,
    inst_valid: torch.Tensor,
    req_res: torch.Tensor,
    req_preemptible: bool,
    req_domain: int,
    policy: SchedulerPolicy,
    require_free_slot: bool,
    churn: Optional[torch.Tensor] = None,
    host_zone: Optional[torch.Tensor] = None,
    exclude_zone: Optional[int] = None,
    mult_val: Optional[Sequence[float]] = None,
) -> Tuple[int, int, bool, bool, torch.Tensor]:
    """The two-stage pipeline on raw fleet tensors (port of
    ``jax_scheduler._decision_core``).

    ``mult_val`` (the ensemble's multiplier axis) is a row of weigher
    multiplier values, as f32 numbers, taking the place of the policy's:
    the policy's own stay the gates (which terms exist, which constants
    fold, the bound's side) and the row's values do the arithmetic, rounded
    as the JAX package's program with traced multipliers rounds
    (``screen_math._traced_chain``).  ``None`` is the static program.

    With ``policy.mesh`` set and every shard of at least M + 1 hosts, the
    tensors are split host-major into one block a shard for this call (as
    ``shard_map`` splits unplaced arrays) and ``_sharded_decision_core``
    decides; a ``mult_val`` there raises ``NotImplementedError``.

    Returns ``(host_idx, term_mask_idx, ok, fell_back, margin)``: the first
    four as python values (read back in the decision's one host sync),
    ``margin`` as a 0-d tensor on the fleet's device (``POS_INF`` when no
    valid host exists or pruning was off)."""
    n_hosts, k = inst_res.shape[0], inst_res.shape[1]
    dev = free_f.device
    kn = _knobs(policy, n_hosts, churn is not None, host_zone is not None,
                exclude_zone, mult_val)
    if policy.mesh is not None and _use_mesh(policy.mesh, n_hosts, kn.m_cand):
        if mult_val is not None:
            raise NotImplementedError(_TRACED_ON_MESH)
        shards = _split_shards(policy.mesh, (free_f, free_n, schedulable, domain, slow,
                                             inst_res, inst_cost, inst_valid, churn,
                                             host_zone), req_res)
        h, bm, ok, fell_back, margin = _sharded_decision_core(
            shards, policy.mesh.lead, req_res.to(policy.mesh.lead), req_preemptible,
            req_domain, policy, require_free_slot, exclude_zone)
        return h, bm, ok, fell_back, margin.to(dev)
    m_cand = kn.m_cand
    churn_on, zone_on = kn.churn_on, kn.zone_on
    if not churn_on:
        churn = None
    if not zone_on:
        host_zone = exclude_zone = None
    mult, gates, thr = kn.mult, kn.gates, kn.thr
    pre = bool(req_preemptible)
    dom = int(req_domain)

    def stage1_of(free_f, free_n, schedulable, domain, slow, inst_res,
                  inst_cost, inst_valid, churn=None, host_zone=None):
        return stage1_rows(
            free_f, free_n, schedulable, domain, slow,
            inst_res, inst_cost, inst_valid, req_res, pre, dom,
            require_free_slot, churn=churn, churn_threshold=thr,
            host_zone=host_zone, exclude_zone=exclude_zone,
        )

    def full_decision() -> Tuple[int, int, bool]:
        """Single-stage path: exact enumeration over every host."""
        cols = (free_f, free_n, schedulable, domain, slow,
                inst_res, inst_cost, inst_valid, churn, host_zone)
        valid, raw, consts = _full_rows(cols, req_res, pre, dom, require_free_slot,
                                        exclude_zone, kn)
        omega, best_mask = _full_omega(cols, req_res, pre, valid, raw, consts, kn)
        host_idx = torch.argmax(omega)
        out = torch.stack([
            host_idx.to(torch.float64), best_mask[host_idx].to(torch.float64),
            (omega[host_idx] > NEG_INF / 2).to(torch.float64),
        ]).tolist()
        return int(out[0]), int(out[1]), bool(out[2])

    no_margin = torch.tensor(POS_INF, dtype=torch.float32, device=dev)
    if m_cand <= 0 or m_cand >= n_hosts:
        h, bm, ok = full_decision()
        return h, bm, ok, False, no_margin

    # ---- stage 1: O(N·K) screen → top-M candidates + (u, j_u) witness -------
    top_s, top_i, consts_arr = sched_screen(
        free_f, free_n, schedulable, domain, slow,
        inst_res, inst_cost, inst_valid,
        req_res, pre, dom,
        weigher_multipliers=mult,
        require_free_slot=require_free_slot,
        m_keep=m_cand + 1,
        churn=churn, churn_threshold=thr,
        host_zone=host_zone, exclude_zone=exclude_zone, gates=gates,
    )
    consts = ScreenConsts.unpack(consts_arr)
    cand = top_i[:m_cand].long()
    u, j_u = top_s[m_cand], top_i[m_cand]
    valid_c, _, _, raw_c = stage1_of(
        free_f[cand], free_n[cand], schedulable[cand], domain[cand],
        slow[cand], inst_res[cand], inst_cost[cand], inst_valid[cand],
        churn[cand] if churn_on else None,
        host_zone[cand] if zone_on else None,
    )
    base_c, pending_c = _base_of(mult, raw_c, consts, gates)

    # ---- stage 2: exact enumeration on the gathered shortlist ---------------
    out, margin = _stage2(
        (free_f[cand], inst_res[cand], inst_cost[cand], inst_valid[cand]), req_res, pre,
        cand, u, j_u, consts, valid_c, base_c, pending_c, n_hosts, k, kn)
    if out[0]:
        return int(out[1]), int(out[2]), bool(out[3]), False, margin
    h, bm, ok = full_decision()
    return h, bm, ok, True, margin


# ---------------------------------------------------------------------------
# The decision on a fleet split across a mesh
# ---------------------------------------------------------------------------


class _Shard(NamedTuple):
    """One shard's operands of a decision, every tensor on its device."""

    free_f: torch.Tensor
    free_n: torch.Tensor
    schedulable: torch.Tensor
    domain: torch.Tensor
    slow: torch.Tensor
    inst_res: torch.Tensor
    inst_cost: torch.Tensor
    inst_valid: torch.Tensor
    churn: Optional[torch.Tensor]
    host_zone: Optional[torch.Tensor]
    req_res: torch.Tensor


def _split_shards(mesh, columns, req_res) -> List[_Shard]:
    """Host-major blocks of unsharded columns (None stays None), one a
    shard, each on its device: views where the device is the same."""
    t = columns[0].shape[0] // mesh.size
    return [_Shard(*(None if x is None else x[s * t:(s + 1) * t].to(dev) for x in columns),
                   req_res.to(dev))
            for s, dev in enumerate(mesh.devices)]


def _merge_consts(local: Sequence[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """The shards' packed (10,) constants folded on ``lead``: the ``*_lo``
    entries (even) by min, the ``*_hi`` entries (odd) by max, which is the
    fleet-wide fold bit for bit."""
    stacked = torch.stack([c.to(lead) for c in local])
    return torch.stack([stacked[:, 0::2].amin(0), stacked[:, 1::2].amax(0)], dim=1).reshape(-1)


def _shard_extra(sh: _Shard, kn: _Knobs, exclude_zone):
    return dict(churn=sh.churn if kn.churn_on else None, churn_threshold=kn.thr,
                host_zone=sh.host_zone if kn.zone_on else None, exclude_zone=exclude_zone)


def _sharded_screen(shards: Sequence[_Shard], lead: torch.device, pre: bool, dom: int,
                    kn: _Knobs, require_free_slot: bool, exclude_zone, m_keep: int):
    """Stage 1 per shard, split at the constants barrier (port of
    ``jax_scheduler._sharded_screen``, its kernel route): each shard's
    ``sched_screen_consts``, the 10 constants merged, each shard's
    ``sched_screen_topm`` against the merged ones keeping ``m_keep``
    hosts, the indices shifted to global ones and gathered on ``lead``.
    Every launch is queued before anything is read.  Returns ``(scores
    (S·m_keep,), idxs (S·m_keep,) int32, consts (10,))`` on ``lead``."""
    t = shards[0].free_f.shape[0]
    local = [sched_screen_consts(*sh[:8], sh.req_res, pre, dom, kn.mult, require_free_slot,
                                 gates=kn.gates, **_shard_extra(sh, kn, exclude_zone))
             for sh in shards]
    merged = _merge_consts(local, lead)
    scores, idxs = [], []
    for s, sh in enumerate(shards):
        sc, ix = sched_screen_topm(
            *sh[:8], sh.req_res, pre, dom, merged.to(sh.free_f.device), kn.mult,
            require_free_slot, m_keep, gates=kn.gates, **_shard_extra(sh, kn, exclude_zone))
        scores.append(sc.to(lead))
        idxs.append(ix.to(lead) + s * t)
    return torch.cat(scores), torch.cat(idxs), merged


def _gather_rows(shards: Sequence[_Shard], cand: torch.Tensor, lead: torch.device,
                 kn: _Knobs) -> List[Optional[torch.Tensor]]:
    """The candidates' rows of the ten host columns (churn and zone None
    when off), each gathered from its owning shard onto ``lead``."""
    t = shards[0].free_f.shape[0]
    owner = torch.div(cand, t, rounding_mode="floor")
    local = [(cand - owner * t).to(sh.free_f.device) for sh in shards]
    pick = (owner, torch.arange(cand.shape[0], device=lead))
    rows = []
    for col in range(10):
        if (col == 8 and not kn.churn_on) or (col == 9 and not kn.zone_on):
            rows.append(None)
            continue
        rows.append(torch.stack([sh[col][loc].to(lead) for sh, loc in zip(shards, local)])[pick])
    return rows


def _sharded_decision_core(
    shards: Sequence[_Shard],
    lead: torch.device,
    req_res: torch.Tensor,
    req_preemptible: bool,
    req_domain: int,
    policy: SchedulerPolicy,
    require_free_slot: bool,
    exclude_zone: Optional[int] = None,
    mult_val: Optional[Sequence[float]] = None,
) -> Tuple[int, int, bool, bool, torch.Tensor]:
    """``_decision_core`` on a fleet split into equal host-major blocks
    (``shards``, global host ``s·T + i`` is row ``i`` of block ``s``);
    ``req_res`` on ``lead``, where the merge, stage 2 and the one host sync
    run.  Returns what ``_decision_core`` returns, bit for bit.

    With a shortlist, stage 1 is ``_sharded_screen``; the merged top-M's
    rows come to ``lead`` for stage 2.  A shard of fewer than M + 1 hosts
    forwards all of them, so the merge is still the fleet-wide ``lax.top_k``
    and the fallback flag and margin are the unsharded screen's.  The full
    enumeration (no shortlist, or the admissibility fallback) runs per
    shard: the screen's rows and ``sched_weigh`` on each block, the
    constants merged as above, the winner the largest score with ties to
    the lowest global index."""
    t = shards[0].free_f.shape[0]
    n_hosts, k = t * len(shards), shards[0].inst_res.shape[1]
    kn = _knobs(policy, n_hosts, shards[0].churn is not None,
                shards[0].host_zone is not None, exclude_zone, mult_val)
    if mult_val is not None and kn.m_cand > 0 and t >= kn.m_cand + 1:
        raise NotImplementedError(_TRACED_ON_MESH)
    excl = exclude_zone if kn.zone_on else None
    pre, dom = bool(req_preemptible), int(req_domain)

    def full_decision() -> Tuple[int, int, bool]:
        stage = [_full_rows(sh[:10], sh.req_res, pre, dom, require_free_slot, excl, kn)
                 for sh in shards]
        merged = _merge_consts([consts.pack() for _, _, consts in stage], lead)
        best, where, masks = [], [], []
        for s, (sh, (valid, raw, _)) in enumerate(zip(shards, stage)):
            consts = ScreenConsts.unpack(merged.to(sh.free_f.device))
            omega, best_mask = _full_omega(sh[:10], sh.req_res, pre, valid, raw, consts, kn)
            i = torch.argmax(omega)
            best.append(omega[i].to(lead))
            where.append((i + s * t).to(lead))
            masks.append(best_mask[i].to(lead))
        best = torch.stack(best)
        w = torch.argmax(best)          # the first shard of the largest score
        out = torch.stack([
            torch.stack(where)[w].to(torch.float64), torch.stack(masks)[w].to(torch.float64),
            (best[w] > NEG_INF / 2).to(torch.float64),
        ]).tolist()
        return int(out[0]), int(out[1]), bool(out[2])

    if kn.m_cand <= 0 or kn.m_cand >= n_hosts:
        h, bm, ok = full_decision()
        return h, bm, ok, False, torch.tensor(POS_INF, dtype=torch.float32, device=lead)

    from .fleet_sharding import merge_shortlists

    all_s, all_i, consts_arr = _sharded_screen(
        shards, lead, pre, dom, kn, require_free_slot, excl, min(kn.m_cand + 1, t))
    consts = ScreenConsts.unpack(consts_arr)
    cand, u, j_u = merge_shortlists(all_s, all_i, kn.m_cand)
    cand = cand.long()
    rows = _gather_rows(shards, cand, lead, kn)
    valid_c, _, _, raw_c = stage1_rows(
        *rows[:8], req_res, pre, dom, require_free_slot, churn=rows[8],
        churn_threshold=kn.thr, host_zone=rows[9], exclude_zone=excl)
    base_c, pending_c = _base_of(kn.mult, raw_c, consts, kn.gates)
    out, margin = _stage2((rows[0], rows[5], rows[6], rows[7]), req_res, pre, cand, u, j_u,
                          consts, valid_c, base_c, pending_c, n_hosts, k, kn)
    if out[0]:
        return int(out[1]), int(out[2]), bool(out[3]), False, margin
    h, bm, ok = full_decision()
    return h, bm, ok, True, margin


# ---------------------------------------------------------------------------
# Persistent fleet state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SoAFleetState:
    """Persistent struct-of-arrays fleet view (port of
    ``jax_scheduler.SoAFleetState``; same fields, names and dtypes, bool
    columns as ``torch.bool``).  The dataclass is frozen but its tensors are
    updated in place by the transitions below."""

    free_f: torch.Tensor          # (N, D) h_f free resources
    free_n: torch.Tensor          # (N, D) h_n free resources
    schedulable: torch.Tensor     # (N,)   bool
    domain: torch.Tensor          # (N,)   int32
    slow: torch.Tensor            # (N,)   float32 straggler factor
    inst_res: torch.Tensor        # (N, K, D) preemptible slot resources
    inst_start: torch.Tensor      # (N, K) slot start times
    inst_price: torch.Tensor      # (N, K) slot price rates
    inst_ckpt: torch.Tensor       # (N, K) last durable-checkpoint times
    inst_cost_kind: torch.Tensor  # (N, K) int32 kind id; -1 = policy default
    inst_period: torch.Tensor     # (N, K) billing period (s); -1 = default
    inst_valid: torch.Tensor      # (N, K) bool
    host_zone: torch.Tensor       # (N,)   int32 zone id
    zone_term: torch.Tensor       # (Z,)   float32 involuntary terminations
    zone_up: torch.Tensor         # (Z,)   float32 accumulated uptime seconds

    #: an unsharded state; ``fleet_sharding.ShardedState`` carries its mesh
    mesh = None

    @property
    def n_hosts(self) -> int:
        return self.free_f.shape[0]

    @property
    def k_slots(self) -> int:
        return self.inst_res.shape[1]

    @property
    def n_zones(self) -> int:
        return self.zone_term.shape[0]

    @property
    def device(self) -> torch.device:
        return self.free_f.device


#: field order and dtypes of ``SoAFleetState`` (the JAX package's names).
STATE_DTYPES = {
    "free_f": torch.float32, "free_n": torch.float32,
    "schedulable": torch.bool, "domain": torch.int32, "slow": torch.float32,
    "inst_res": torch.float32, "inst_start": torch.float32,
    "inst_price": torch.float32, "inst_ckpt": torch.float32,
    "inst_cost_kind": torch.int32, "inst_period": torch.float32,
    "inst_valid": torch.bool, "host_zone": torch.int32,
    "zone_term": torch.float32, "zone_up": torch.float32,
}


def slot_costs(
    cost_kind: str,
    inst_start: torch.Tensor,
    inst_price: torch.Tensor,
    now,
    period,
    inst_ckpt: Optional[torch.Tensor] = None,
    inst_res: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-slot termination cost at time ``now`` (invalid slots are masked
    downstream)."""
    if cost_kind == "period":
        return floor_mod(now - inst_start, period)
    if cost_kind == "count":
        return torch.ones_like(inst_start)
    if cost_kind == "revenue":
        return floor_mod(now - inst_start, period) / period * inst_price
    if cost_kind == "recompute":
        lost = torch.clamp(now - inst_ckpt, min=0.0)
        return lost * torch.clamp(inst_res[..., 0], min=1.0)
    raise ValueError(f"unknown cost kind {cost_kind!r}")


def mixed_slot_costs(
    policy: SchedulerPolicy,
    inst_cost_kind: torch.Tensor,
    inst_start: torch.Tensor,
    inst_price: torch.Tensor,
    inst_ckpt: torch.Tensor,
    inst_res: torch.Tensor,
    now,
    inst_period: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Each slot billed by its own kind (``inst_cost_kind``; -1 = the
    policy default) through ``slot_cost_by_kind``."""
    eff = torch.where(inst_cost_kind >= 0, inst_cost_kind,
                      policy.default_kind_id)
    period = torch.tensor(policy.period, dtype=torch.float32,
                          device=inst_start.device)
    if inst_period is not None:
        period = torch.where(inst_period > 0, inst_period, period)
    return slot_cost_by_kind(eff, inst_start, inst_price, inst_ckpt,
                             inst_res[..., 0], now, period)


def fleet_slot_costs(
    state: SoAFleetState, now, policy: SchedulerPolicy
) -> torch.Tensor:
    """Per-slot termination costs of a fleet state under ``policy``'s cost
    table; the ``inst_period`` column overrides the shared period per slot."""
    now = _f32(now)
    period = torch.where(
        state.inst_period > 0, state.inst_period,
        torch.tensor(policy.period, dtype=torch.float32, device=state.device),
    )
    if not policy.mixed:
        return slot_costs(policy.cost_kind, state.inst_start, state.inst_price,
                          now, period, inst_ckpt=state.inst_ckpt,
                          inst_res=state.inst_res)
    return mixed_slot_costs(policy, state.inst_cost_kind, state.inst_start,
                            state.inst_price, state.inst_ckpt, state.inst_res,
                            now, inst_period=state.inst_period)


def _f32(x) -> float:
    """A python float holding an exact float32 value (the JAX entry points
    cast their scalar operands to f32)."""
    return float(np.float32(x))


def _hosts_to_arrays(hosts: Sequence[Host], k_slots: int,
                     domain_ids: Optional[Dict[str, int]]):
    """Shared host→array conversion: per-host columns plus the per-host
    preemptible lists (sorted by id), with the ``k_slots`` overflow check."""
    n = len(hosts)
    d = len(hosts[0].capacity.spec.dims) if hosts else 0
    if domain_ids is None:
        domain_ids = {}
        for h in hosts:
            domain_ids.setdefault(h.domain, len(domain_ids))
    free_f = np.zeros((n, d), np.float32)
    free_n = np.zeros((n, d), np.float32)
    schedulable = np.zeros((n,), bool)
    domain = np.zeros((n,), np.int32)
    slow = np.ones((n,), np.float32)
    pre_lists: List[List[Instance]] = []
    for i, h in enumerate(hosts):
        free_f[i] = h.free_full.vec
        free_n[i] = h.free_normal.vec
        schedulable[i] = h.schedulable
        domain[i] = domain_ids[h.domain]
        slow[i] = h.slow_factor
        pre = sorted(h.preemptible_instances(), key=lambda x: x.id)
        if len(pre) > k_slots:
            raise ValueError(
                f"host {h.name} has {len(pre)} preemptible instances > k_slots={k_slots}"
            )
        pre_lists.append(pre)
    return d, free_f, free_n, schedulable, domain, slow, pre_lists


def build_fleet_state(
    hosts: Sequence[Host],
    k_slots: int = 8,
    domain_ids: Optional[Dict[str, int]] = None,
    slot_assignment: Optional[Sequence[Dict[str, int]]] = None,
    zone_ids: Optional[Dict[str, int]] = None,
    n_zones: Optional[int] = None,
    zone_term: Optional[np.ndarray] = None,
    zone_up: Optional[np.ndarray] = None,
    device=None,
) -> Tuple[SoAFleetState, List[List[Optional[Instance]]]]:
    """Convert python ``Host`` objects to a ``SoAFleetState`` on ``device``
    (``None`` = the card); see ``jax_scheduler.build_fleet_state`` for the
    arguments.  Returns the state and the per-host slot rows."""
    from .convert import fleet_state_from_numpy

    n = len(hosts)
    d, free_f, free_n, schedulable, domain, slow, pre_lists = _hosts_to_arrays(
        hosts, k_slots, domain_ids
    )
    if zone_ids is None:
        zone_ids = {}
        for h in hosts:
            zone_ids.setdefault(h.zone, len(zone_ids))
    host_zone = np.zeros((n,), np.int32)
    for i, h in enumerate(hosts):
        if h.zone not in zone_ids:
            raise ValueError(
                f"host {h.name} is in unknown zone {h.zone!r}; "
                f"known: {sorted(zone_ids)}"
            )
        host_zone[i] = zone_ids[h.zone]
    z = int(n_zones) if n_zones is not None else max(len(zone_ids), 1)
    if zone_ids and max(zone_ids.values()) >= z:
        raise ValueError(
            f"zone id {max(zone_ids.values())} out of range for n_zones={z}"
        )
    arrays = dict(
        free_f=free_f, free_n=free_n, schedulable=schedulable, domain=domain,
        slow=slow,
        inst_res=np.zeros((n, k_slots, d), np.float32),
        inst_start=np.zeros((n, k_slots), np.float32),
        inst_price=np.ones((n, k_slots), np.float32),
        inst_ckpt=np.zeros((n, k_slots), np.float32),
        inst_cost_kind=np.full((n, k_slots), -1, np.int32),
        inst_period=np.full((n, k_slots), -1.0, np.float32),
        inst_valid=np.zeros((n, k_slots), bool),
        host_zone=host_zone,
        zone_term=(np.zeros((z,), np.float32) if zone_term is None
                   else np.array(zone_term, np.float32)),
        zone_up=(np.zeros((z,), np.float32) if zone_up is None
                 else np.array(zone_up, np.float32)),
    )
    slots: List[List[Optional[Instance]]] = []
    for i, pre in enumerate(pre_lists):
        row: List[Optional[Instance]] = [None] * k_slots
        for k, inst in enumerate(pre):
            if slot_assignment is not None:
                k = slot_assignment[i][inst.id]
            if row[k] is not None:
                raise ValueError(f"slot collision on host {hosts[i].name} slot {k}")
            row[k] = inst
            arrays["inst_res"][i, k] = inst.resources.vec
            arrays["inst_start"][i, k] = inst.start_time
            arrays["inst_price"][i, k] = inst.price_rate
            arrays["inst_ckpt"][i, k] = (
                inst.last_checkpoint if inst.last_checkpoint is not None
                else inst.start_time
            )
            if inst.cost_kind is not None:
                if inst.cost_kind not in COST_KIND_IDS:
                    raise ValueError(
                        f"instance {inst.id} bills by unknown cost kind "
                        f"{inst.cost_kind!r}"
                    )
                arrays["inst_cost_kind"][i, k] = COST_KIND_IDS[inst.cost_kind]
            if inst.period is not None:
                arrays["inst_period"][i, k] = float(inst.period)
            arrays["inst_valid"][i, k] = True
        slots.append(row)
    return fleet_state_from_numpy(arrays, device=device), slots


# ---------------------------------------------------------------------------
# Rebuild-per-call state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SoAHostState:
    """Struct-of-arrays mirror of a host fleet, rebuilt per call (port of
    ``jax_scheduler.SoAHostState``; same fields, names and dtypes).  Unlike
    ``SoAFleetState`` its ``inst_cost`` is frozen at build time and its
    valid slots are a prefix of each row."""

    free_f: torch.Tensor       # (N, D) h_f free resources
    free_n: torch.Tensor       # (N, D) h_n free resources
    schedulable: torch.Tensor  # (N,)   bool
    domain: torch.Tensor       # (N,)   int32
    slow: torch.Tensor         # (N,)   float32 straggler factor
    inst_res: torch.Tensor     # (N, K, D) preemptible instance resources
    inst_cost: torch.Tensor    # (N, K)    per-instance termination cost
    inst_valid: torch.Tensor   # (N, K)    bool
    #: optional per-host zone-churn rate (None = churn-blind), frozen at
    #: build from ``zone_rates``.
    churn: Optional[torch.Tensor] = None      # (N,) float32
    #: optional per-host zone id (None = zone-blind).
    host_zone: Optional[torch.Tensor] = None  # (N,) int32

    #: an unsharded state; ``fleet_sharding.ShardedState`` carries its mesh
    mesh = None

    @property
    def n_hosts(self) -> int:
        return self.free_f.shape[0]

    @property
    def k_slots(self) -> int:
        return self.inst_res.shape[1]

    @property
    def device(self) -> torch.device:
        return self.free_f.device


#: field order and dtypes of ``SoAHostState``; the last two may be None.
HOST_STATE_DTYPES = {
    "free_f": torch.float32, "free_n": torch.float32,
    "schedulable": torch.bool, "domain": torch.int32, "slow": torch.float32,
    "inst_res": torch.float32, "inst_cost": torch.float32,
    "inst_valid": torch.bool, "churn": torch.float32, "host_zone": torch.int32,
}
HOST_STATE_OPTIONAL = ("churn", "host_zone")


def build_soa_state(
    hosts: Sequence[Host],
    now: float,
    cost_fn: Optional[CostFunction] = None,
    k_slots: int = 8,
    domain_ids: Optional[Dict[str, int]] = None,
    zone_rates: Optional[Dict[str, float]] = None,
    zone_ids: Optional[Dict[str, int]] = None,
    device=None,
) -> Tuple[SoAHostState, List[List[Instance]]]:
    """Convert python ``Host`` objects to a ``SoAHostState`` on ``device``
    (``None`` = the card); see ``jax_scheduler.build_soa_state`` for the
    arguments.  Each slot's cost is ``cost_fn.cost([inst], now)``, computed
    in float64 on the host and stored as float32.  Returns the state and the
    per-host preemptible lists (slot order)."""
    from .convert import host_state_from_numpy

    cost_fn = cost_fn or PeriodCost()
    n = len(hosts)
    d, free_f, free_n, schedulable, domain, slow, pre_lists = _hosts_to_arrays(
        hosts, k_slots, domain_ids
    )
    inst_res = np.zeros((n, k_slots, d), np.float32)
    inst_cost = np.zeros((n, k_slots), np.float32)
    inst_valid = np.zeros((n, k_slots), bool)
    for i, pre in enumerate(pre_lists):
        for k, inst in enumerate(pre):
            inst_res[i, k] = inst.resources.vec
            inst_cost[i, k] = cost_fn.cost([inst], now)
            inst_valid[i, k] = True
    arrays = dict(free_f=free_f, free_n=free_n, schedulable=schedulable,
                  domain=domain, slow=slow, inst_res=inst_res,
                  inst_cost=inst_cost, inst_valid=inst_valid)
    if zone_rates is not None:
        arrays["churn"] = np.asarray(
            [float(zone_rates.get(h.zone, 0.0)) for h in hosts], np.float32)
    if zone_ids is not None:
        # an unknown zone is -2, which no exclusion operand matches
        arrays["host_zone"] = np.asarray(
            [int(zone_ids.get(h.zone, -2)) for h in hosts], np.int32)
    return host_state_from_numpy(arrays, device=device), pre_lists


def _rebuild_decision(
    state: SoAHostState,
    req_res,
    req_preemptible: bool,
    req_domain: int,
    policy: SchedulerPolicy,
    req_exclude_zone: int,
) -> Tuple[int, int, bool, bool]:
    """``schedule_decision`` plus the fallback flag: ``(host_idx,
    term_mask_idx, ok, fell_back)``."""
    if not isinstance(req_res, torch.Tensor):
        req_res = torch.from_numpy(np.asarray(req_res, np.float32)).to(state.device)
    if state.mesh is not None:
        shards = []
        for b in state.blocks:
            churn = b.churn
            if churn is None and policy.churn_aware:
                churn = torch.zeros_like(b.slow)
            host_zone = b.host_zone
            if host_zone is None and policy.relocation_on:
                host_zone = torch.zeros_like(b.domain)
            shards.append(_Shard(b.free_f, b.free_n, b.schedulable, b.domain, b.slow,
                                 b.inst_res, b.inst_cost, b.inst_valid, churn, host_zone,
                                 req_res.to(b.device)))
        return _sharded_decision_core(
            shards, state.device, req_res.to(state.device), bool(req_preemptible),
            int(req_domain), policy, require_free_slot=False,
            exclude_zone=int(req_exclude_zone))[:4]
    churn = state.churn
    if churn is None and policy.churn_aware:
        # a churn-aware policy over a state built without rates: every host
        # equally calm (the weigher term normalizes away)
        churn = torch.zeros_like(state.slow)
    host_zone = state.host_zone
    if host_zone is None and policy.relocation_on:
        # every host in zone 0: an exclusion id of 0 excludes the whole
        # fleet, anything else nothing (and -1 = none)
        host_zone = torch.zeros_like(state.domain)
    h, bm, ok, fell_back, _ = _decision_core(
        state.free_f, state.free_n, state.schedulable, state.domain,
        state.slow, state.inst_res, state.inst_cost, state.inst_valid,
        req_res, bool(req_preemptible), int(req_domain), policy,
        require_free_slot=False, churn=churn, host_zone=host_zone,
        exclude_zone=int(req_exclude_zone),
    )
    return h, bm, ok, fell_back


def schedule_decision(
    state,
    req_res,
    req_preemptible: bool,
    req_domain: int,
    policy: Optional[SchedulerPolicy] = None,
    req_exclude_zone: int = -1,
) -> Tuple[int, int, bool]:
    """One scheduling decision on a rebuilt state: ``(host_idx,
    term_mask_idx, ok)`` as python values (port of
    ``jax_scheduler.schedule_decision``).  ``req_res`` is a (D,) tensor on
    the state's device or an array; ``req_domain`` and ``req_exclude_zone``
    are ids, -1 for none.  Unlike the persistent path, a preemptible
    request needs no free slot: the rebuilt rows hold only live instances.
    ``state`` may be sharded (``fleet_sharding.shard_fleet_state``): the
    screen then runs per shard whatever ``policy.mesh`` says."""
    policy = ensure_policy(policy, "schedule_decision")
    return _rebuild_decision(state, req_res, req_preemptible, req_domain,
                             policy, req_exclude_zone)[:3]


# ---------------------------------------------------------------------------
# Transitions (in place)
# ---------------------------------------------------------------------------


def _seq_sum(vec: torch.Tensor, idx: Sequence[int]) -> Optional[torch.Tensor]:
    """``vec[idx[0]] + vec[idx[1]] + ...`` in that order (XLA's reduce adds
    left to right; ``torch.sum`` may reassociate).  None when ``idx`` is
    empty."""
    acc = None
    for i in idx:
        acc = vec[i] if acc is None else acc + vec[i]
    return acc


def _zone_add(col: torch.Tensor, zone: torch.Tensor, value: torch.Tensor) -> None:
    """Add ``value`` to ``col[zone]`` (a sharded fleet's zone pair lives on
    its lead device, the host's row on its shard's)."""
    col.index_put_((zone.reshape(1).long().to(col.device),), value.reshape(1).to(col.device),
                   accumulate=True)


def _apply_decision(
    state: SoAFleetState,
    host_idx: int,
    mask_idx: int,
    ok: bool,
    req_res: torch.Tensor,
    preemptible: bool,
    now: float,
    price: float,
    cost_kind: int,
    period: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one decision in place: evacuate the winning subset, place the
    request.  Returns ``(slot, kill)`` tensors: the slot a preemptible
    placement landed in (undefined for normal/failed requests) and the (K,)
    bool mask of terminated slots.  The winner's zone T/U accumulators
    absorb the kills and the victims' accrued uptime."""
    k = state.k_slots
    h = int(host_idx)
    row_valid = state.inst_valid[h]
    may_kill = ok and not preemptible and mask_idx != 0
    if may_kill:
        kill = _mask_bits(k, state.device)[mask_idx] & row_valid
        freed = torch.sum(torch.where(kill[:, None], state.inst_res[h], 0.0), dim=0)
        valid_after = row_valid & ~kill
    else:
        kill = torch.zeros((k,), dtype=torch.bool, device=state.device)
        valid_after = row_valid.clone()
    if ok:
        if may_kill:
            state.free_f[h] += freed - req_res
        else:
            state.free_f[h] -= req_res
        if not preemptible:
            state.free_n[h] += -req_res
    slot = torch.argmin(valid_after.to(torch.uint8)).to(torch.int32)
    if ok and preemptible:
        onehot = torch.arange(k, device=state.device) == slot
        state.inst_valid[h] = valid_after | onehot
        state.inst_res[h] = torch.where(onehot[:, None], req_res[None, :],
                                        state.inst_res[h])
        for col, value in ((state.inst_start, now), (state.inst_price, price),
                           (state.inst_ckpt, now),
                           (state.inst_cost_kind, cost_kind),
                           (state.inst_period, period)):
            col[h] = torch.where(onehot, value, col[h])
    elif may_kill:
        state.inst_valid[h] = valid_after
        z = state.host_zone[h]
        lost = torch.where(kill, now - state.inst_start[h], 0.0)
        bits = [s for s in range(k) if (mask_idx >> s) & 1]
        _zone_add(state.zone_term, z, kill.to(torch.float32).sum())
        _zone_add(state.zone_up, z, _seq_sum(lost, bits))
    return slot, kill


def _req_inputs(state: SoAFleetState, now, policy: SchedulerPolicy):
    inst_cost = fleet_slot_costs(state, now, policy)
    churn = (churn_of(state.zone_term, state.zone_up, state.host_zone)
             if policy.churn_aware else None)
    return inst_cost, churn


def _step_core(state, req_res, req_preemptible, req_domain, now, price,
               req_cost_kind, req_period, policy, req_exclude=None,
               mult_val=None):
    if state.mesh is not None:
        return _sharded_step_core(state, req_res, req_preemptible, req_domain, now, price,
                                  req_cost_kind, req_period, policy, req_exclude, mult_val)
    now = _f32(now)
    inst_cost, churn = _req_inputs(state, now, policy)
    host_idx, mask_idx, ok, fell_back, margin = _decision_core(
        state.free_f, state.free_n, state.schedulable, state.domain,
        state.slow, state.inst_res, inst_cost, state.inst_valid,
        req_res, bool(req_preemptible), int(req_domain),
        policy, require_free_slot=True, churn=churn,
        host_zone=state.host_zone if req_exclude is not None else None,
        exclude_zone=req_exclude, mult_val=mult_val,
    )
    slot, kill = _apply_decision(
        state, host_idx, mask_idx, ok, req_res, bool(req_preemptible), now,
        _f32(price), int(req_cost_kind), _f32(req_period),
    )
    return host_idx, slot, ok, kill, fell_back, margin


def _sharded_step_core(state, req_res, req_preemptible, req_domain, now, price,
                       req_cost_kind, req_period, policy, req_exclude, mult_val):
    """``_step_core`` on a sharded fleet: each shard's slot costs and churn
    column (the zone pair copied to the shard's device), the sharded
    decision, then the decision applied to the winner's block only.  The
    outputs are on the lead device."""
    now = _f32(now)
    lead = state.device
    shards = []
    for b in state.blocks:
        dev = b.device
        churn = (churn_of(state.zone_term.to(dev), state.zone_up.to(dev), b.host_zone)
                 if policy.churn_aware else None)
        shards.append(_Shard(
            b.free_f, b.free_n, b.schedulable, b.domain, b.slow, b.inst_res,
            fleet_slot_costs(b, now, policy), b.inst_valid, churn,
            b.host_zone if req_exclude is not None else None, req_res.to(dev)))
    host_idx, mask_idx, ok, fell_back, margin = _sharded_decision_core(
        shards, lead, req_res, bool(req_preemptible), int(req_domain), policy,
        require_free_slot=True, exclude_zone=req_exclude, mult_val=mult_val)
    block, row = state.locate(host_idx)
    slot, kill = _apply_decision(
        block, row, mask_idx, ok, req_res.to(block.device), bool(req_preemptible), now,
        _f32(price), int(req_cost_kind), _f32(req_period),
    )
    return host_idx, slot.to(lead), ok, kill.to(lead), fell_back, margin


def _as_req(state: SoAFleetState, req_res) -> torch.Tensor:
    return torch.as_tensor(np.asarray(req_res, np.float32)).to(state.device)


def schedule_step(
    state: SoAFleetState,
    req_res,
    req_preemptible: bool,
    req_domain: int,
    now: float,
    price: float,
    policy: Optional[SchedulerPolicy] = None,
    req_cost_kind: int = -1,
    req_period: float = -1.0,
    req_exclude_zone: int = -1,
) -> Tuple[SoAFleetState, Tuple[torch.Tensor, ...]]:
    """Decide and apply one request on ``state`` (updated in place).

    Returns ``(state, (host_idx, slot, ok, kill, fell_back, margin))`` as in
    ``jax_scheduler.schedule_step``; the outputs are CPU tensors (int32,
    int32, bool, (K,) bool, bool, float32)."""
    policy = ensure_policy(policy, "schedule_step")
    req = req_res if isinstance(req_res, torch.Tensor) else _as_req(state, req_res)
    h, slot, ok, kill, fb, margin = _step_core(
        state, req, req_preemptible, req_domain, now, price, req_cost_kind,
        req_period, policy, req_exclude=int(req_exclude_zone),
    )
    slot, kill, margin = (t.cpu() for t in (slot, kill, margin))
    return state, (
        torch.tensor(h, dtype=torch.int32), slot, torch.tensor(ok),
        kill, torch.tensor(fb), margin,
    )


def schedule_many(
    state: SoAFleetState,
    req_res,
    req_preemptible,
    req_domain,
    req_now,
    req_price,
    policy: Optional[SchedulerPolicy] = None,
    req_cost_kind=None,
    req_period=None,
    req_exclude_zone=None,
) -> Tuple[SoAFleetState, Tuple[torch.Tensor, ...]]:
    """Run a request batch in order on ``state`` (updated in place), each
    decision seeing every earlier one: ``schedule_step`` in a loop, the
    port of ``jax_scheduler.schedule_many``'s ``lax.scan``.

    Request columns are host arrays (numpy or CPU tensors) of length B.
    Returns ``(state, (host_idx (B,), slot (B,), ok (B,), kill (B, K),
    fell_back (B,), margin (B,)))`` as CPU tensors, copied back once."""
    policy = ensure_policy(policy, "schedule_many")
    res = np.asarray(req_res, np.float32)
    b = res.shape[0]
    pre = np.asarray(req_preemptible, bool).reshape(b)
    dom = np.asarray(req_domain, np.int32).reshape(b)
    now = np.asarray(req_now, np.float32).reshape(b)
    price = np.asarray(req_price, np.float32).reshape(b)
    kind = (np.full((b,), -1, np.int32) if req_cost_kind is None
            else np.asarray(req_cost_kind, np.int32).reshape(b))
    period = (np.full((b,), -1.0, np.float32) if req_period is None
              else np.asarray(req_period, np.float32).reshape(b))
    excl = (np.full((b,), -1, np.int32) if req_exclude_zone is None
            else np.asarray(req_exclude_zone, np.int32).reshape(b))
    res_dev = torch.from_numpy(res).to(state.device)
    hosts, oks, fbs, slots, kills, margins = [], [], [], [], [], []
    for i in range(b):
        h, slot, ok, kill, fb, margin = _step_core(
            state, res_dev[i], pre[i], dom[i], now[i], price[i], kind[i],
            period[i], policy, req_exclude=int(excl[i]),
        )
        hosts.append(h)
        oks.append(ok)
        fbs.append(fb)
        slots.append(slot)
        kills.append(kill)
        margins.append(margin)
    slot_t = torch.stack(slots).cpu()
    kill_t = torch.stack(kills).cpu()
    margin_t = torch.stack(margins).cpu()
    return state, (
        torch.tensor(hosts, dtype=torch.int32), slot_t,
        torch.tensor(oks, dtype=torch.bool), kill_t,
        torch.tensor(fbs, dtype=torch.bool), margin_t,
    )


def relocate_many(
    state: SoAFleetState,
    v_host,            # (B,) victim host index
    v_slot,            # (B,) victim slot on that host
    v_on,              # (B,) bool; False = padding row, a full no-op
    req_res,           # (B, D) replacement request sizes
    req_domain,        # (B,) domain id; -1 = any
    req_cost_kind,     # (B,) kind id; -1 = policy default
    req_period,        # (B,) billing period; -1 = policy default
    req_price,         # (B,) the victim's price rate
    req_exclude_zone,  # (B,) the source zone, hard-excluded
    now: float,        # one relocation pass instant
    policy: Optional[SchedulerPolicy] = None,
) -> Tuple[SoAFleetState, Tuple[torch.Tensor, ...]]:
    """One evacuation batch on ``state`` (updated in place), the port of
    ``jax_scheduler.relocate_many``'s ``lax.scan``.  Per victim row, in
    order: checkpoint the victim's slot at ``now`` (gated on ``v_on``),
    re-place it through ``_step_core`` as a preemptible request with its
    source zone excluded, then terminate the victim (voluntarily: the zone's
    U accrues, its T does not) only if the replacement landed.

    Padding rows run the same decision with their sentinel sizes, which fit
    no host, so they leave every state tensor as it was and report what the
    reference reports.  Columns are host arrays of length B.  Returns
    ``(state, (host_idx (B,), slot (B,), ok (B,), fell_back (B,),
    margin (B,)))`` as CPU tensors, copied back once."""
    policy = ensure_policy(policy, "relocate_many")
    res = np.asarray(req_res, np.float32)
    b = res.shape[0]
    vh = np.asarray(v_host, np.int32).reshape(b)
    vs = np.asarray(v_slot, np.int32).reshape(b)
    von = np.asarray(v_on, bool).reshape(b)
    dom = np.asarray(req_domain, np.int32).reshape(b)
    kind = np.asarray(req_cost_kind, np.int32).reshape(b)
    period = np.asarray(req_period, np.float32).reshape(b)
    price = np.asarray(req_price, np.float32).reshape(b)
    excl = np.asarray(req_exclude_zone, np.int32).reshape(b)
    now = _f32(now)
    k = state.k_slots
    res_dev = torch.from_numpy(res).to(state.device)
    hosts, oks, fbs, slots, margins = [], [], [], [], []
    for i in range(b):
        on = bool(von[i])
        if on:
            apply_checkpoint(state, vh[i], vs[i], now)
        h, slot, ok, _, fb, margin = _step_core(
            state, res_dev[i], True, dom[i], now, price[i], kind[i],
            period[i], policy, req_exclude=int(excl[i]),
        )
        if on and ok:
            apply_termination(state, vh[i], np.arange(k) == vs[i], now=now,
                              involuntary=False)
        hosts.append(h)
        oks.append(ok)
        fbs.append(fb)
        slots.append(slot)
        margins.append(margin)
    return state, (
        torch.tensor(hosts, dtype=torch.int32), torch.stack(slots).cpu(),
        torch.tensor(oks, dtype=torch.bool), torch.tensor(fbs, dtype=torch.bool),
        torch.stack(margins).cpu(),
    )


def _on_owner(transition):
    """Run a one-host transition on a sharded state's block that holds the
    host (its tensor arguments moved to that block's device); an unsharded
    state goes straight through.  Returns what the transition returns, with
    the state itself in place of the block and tensors on the lead
    device."""
    @functools.wraps(transition)
    def routed(state, host_idx, *args, **kw):
        if state.mesh is None:
            return transition(state, host_idx, *args, **kw)
        block, row = state.locate(host_idx)
        move = lambda a: a.to(block.device) if isinstance(a, torch.Tensor) else a
        out = transition(block, row, *map(move, args), **{k: move(v) for k, v in kw.items()})
        if isinstance(out, tuple):
            return (state,) + tuple(x.to(state.device) for x in out[1:])
        return state
    return routed


@_on_owner
def apply_placement(
    state: SoAFleetState,
    host_idx: int,
    req_res: torch.Tensor,
    preemptible: bool,
    now: float,
    price: float = 1.0,
    cost_kind: int = -1,
    period: float = -1.0,
) -> Tuple[SoAFleetState, torch.Tensor]:
    """Unconditionally place a request on ``host_idx`` (in place).  A
    preemptible placement needs a free slot on the host."""
    h = int(host_idx)
    state.free_f[h] -= req_res
    if not preemptible:
        state.free_n[h] -= req_res
    k = state.k_slots
    slot = torch.argmin(state.inst_valid[h].to(torch.uint8)).to(torch.int32)
    if preemptible:
        onehot = torch.arange(k, device=state.device) == slot
        state.inst_valid[h] |= onehot
        state.inst_res[h] = torch.where(onehot[:, None], req_res[None, :],
                                        state.inst_res[h])
        for col, value in ((state.inst_start, _f32(now)),
                           (state.inst_price, _f32(price)),
                           (state.inst_ckpt, _f32(now)),
                           (state.inst_cost_kind, int(cost_kind)),
                           (state.inst_period, _f32(period))):
            col[h] = torch.where(onehot, value, col[h])
    return state, slot


@_on_owner
def apply_termination(
    state: SoAFleetState,
    host_idx: int,
    slot_mask,
    now: Optional[float] = None,
    involuntary: bool = False,
) -> SoAFleetState:
    """Free the given preemptible slots on ``host_idx`` (in place; h_n is
    untouched).  ``slot_mask`` is a (K,) host bool array.  With ``now`` the
    evacuated slots' accrued uptime feeds the zone's U, and
    ``involuntary=True`` also counts the kills into T."""
    h = int(host_idx)
    k = state.k_slots
    bits = [s for s in range(k) if bool(np.asarray(slot_mask)[s])]
    mask_idx = sum(1 << s for s in bits)
    row_valid = state.inst_valid[h]
    kill = _mask_bits(k, state.device)[mask_idx] & row_valid
    freed = torch.sum(torch.where(kill[:, None], state.inst_res[h], 0.0), dim=0)
    state.free_f[h] += freed
    state.inst_valid[h] = row_valid & ~kill
    if now is not None and bits:
        z = state.host_zone[h]
        up = torch.where(kill, _f32(now) - state.inst_start[h], 0.0)
        _zone_add(state.zone_up, z, _seq_sum(up, bits))
        if involuntary:
            _zone_add(state.zone_term, z, kill.to(torch.float32).sum())
    return state


@_on_owner
def apply_departure(
    state: SoAFleetState, host_idx: int, res: torch.Tensor
) -> SoAFleetState:
    """Voluntary departure of a normal instance (both views regain ``res``)."""
    h = int(host_idx)
    state.free_f[h] += res
    state.free_n[h] += res
    return state


@_on_owner
def apply_checkpoint(
    state: SoAFleetState, host_idx: int, slot: int, now: float
) -> SoAFleetState:
    """Record a durable checkpoint for the instance in ``slot``."""
    state.inst_ckpt[int(host_idx), int(slot)] = _f32(now)
    return state


@_on_owner
def set_schedulable(state: SoAFleetState, host_idx: int, value: bool) -> SoAFleetState:
    state.schedulable[int(host_idx)] = bool(value)
    return state


@_on_owner
def set_slow_factor(state: SoAFleetState, host_idx: int, value: float) -> SoAFleetState:
    state.slow[int(host_idx)] = _f32(value)
    return state


@_on_owner
def apply_host_failure(
    state: SoAFleetState,
    host_idx: int,
    normal_res: torch.Tensor,
    now: Optional[float] = None,
) -> SoAFleetState:
    """Hard host failure (in place): mark unschedulable, evacuate every
    slot, release the normal aggregate.  With ``now`` every occupied slot's
    kill and accrued uptime feed the zone's T and U."""
    h = int(host_idx)
    k = state.k_slots
    row_valid = state.inst_valid[h].clone()
    freed = torch.sum(torch.where(row_valid[:, None], state.inst_res[h], 0.0), dim=0)
    state.schedulable[h] = False
    state.free_f[h] += freed + normal_res
    state.free_n[h] += normal_res
    state.inst_valid[h] = False
    if now is not None:
        z = state.host_zone[h]
        up = torch.where(row_valid, _f32(now) - state.inst_start[h], 0.0)
        _zone_add(state.zone_up, z, _seq_sum(up, range(k)))
        _zone_add(state.zone_term, z, row_valid.to(torch.float32).sum())
    return state


# ---------------------------------------------------------------------------
# Drop-in scheduler (the python schedulers' .schedule() contract)
# ---------------------------------------------------------------------------


class TorchPreemptibleScheduler:
    """The rebuild-per-call scheduler (port of
    ``jax_scheduler.JaxPreemptibleScheduler``): each ``schedule`` call
    rebuilds a ``SoAHostState`` from the python hosts on ``device`` (``None``
    = the card) and runs the two-stage decision on it, launching the
    decision kernels on a CUDA device.  ``schedule_soa`` decides on a state
    the caller already holds.

    ``last_build_s`` / ``last_decision_s`` hold the wall-clock split of the
    latest ``schedule`` call; ``calls`` and ``fallbacks`` count decisions
    and the shortlist fallbacks among them.

    With ``policy.mesh`` the rebuilt state is not padded, so the screen runs
    per shard only when the host count divides the mesh with at least M + 1
    hosts a shard (``SoAFleet`` pads its state for that); otherwise the
    unsharded screen decides, the same decision."""

    def __init__(
        self,
        cost_fn: Optional[CostFunction] = None,
        k_slots: int = 8,
        policy: Optional[SchedulerPolicy] = None,
        zone_rates: Optional[Dict[str, float]] = None,
        device=None,
    ):
        self.policy = ensure_policy(
            policy, "TorchPreemptibleScheduler", cost_fn=cost_fn
        )
        #: prices a winning mask's victims and freezes slot costs at rebuild;
        #: derived from the policy's cost table when not given.
        self.cost_fn = cost_fn or self.policy.make_cost_fn()
        self.k_slots = k_slots
        #: frozen per-zone churn rates (zone name -> rate) baked into each
        #: rebuild's ``churn`` column.
        self.zone_rates = dict(zone_rates) if zone_rates is not None else None
        self.device = resolve_device(device)
        self.calls = 0
        self.fallbacks = 0
        self.last_build_s = 0.0
        self.last_decision_s = 0.0

    def schedule(
        self, req: Request, hosts: Sequence[Host], now: float
    ) -> ScheduleResult:
        t0 = time.perf_counter()
        # zone ids by first appearance of Host.zone, as build_fleet_state
        zone_ids: Dict[str, int] = {}
        for h in hosts:
            zone_ids.setdefault(h.zone, len(zone_ids))
        state, slots = build_soa_state(
            hosts, now, cost_fn=self.cost_fn, k_slots=self.k_slots,
            zone_rates=self.zone_rates, zone_ids=zone_ids, device=self.device,
        )
        # domain ids by first appearance, as _hosts_to_arrays numbers them
        domains: Dict[str, int] = {}
        for h in hosts:
            domains.setdefault(h.domain, len(domains))
        dom = -1 if req.domain is None else domains.get(req.domain, -1)
        # an unknown zone name excludes nothing
        excl = -1 if req.exclude_zone is None else zone_ids.get(req.exclude_zone, -1)
        req_res = torch.from_numpy(
            np.asarray(req.resources.vec, np.float32)).to(self.device)
        t1 = time.perf_counter()
        host_idx, mask_idx, ok = self.schedule_soa(
            state, req_res, bool(req.preemptible), dom, exclude_zone=excl)
        self.last_build_s, self.last_decision_s = t1 - t0, time.perf_counter() - t1
        if not ok:
            return ScheduleResult(request=req, host=None, passes=1)
        row = slots[host_idx]
        victims = tuple(row[k] for k in range(len(row)) if (mask_idx >> k) & 1)
        plan = (
            EMPTY_PLAN if not victims
            else TerminationPlan(instances=victims,
                                 cost=self.cost_fn.cost(victims, now),
                                 feasible=True)
        )
        return ScheduleResult(request=req, host=hosts[host_idx].name, plan=plan,
                              passes=1)

    def schedule_soa(self, state: SoAHostState, req_res, preemptible: bool,
                     domain: int = -1, exclude_zone: int = -1
                     ) -> Tuple[int, int, bool]:
        """One decision on a rebuilt state: ``(host_idx, mask_idx, ok)``."""
        h, bm, ok, fell_back = _rebuild_decision(
            state, req_res, preemptible, domain, self.policy, exclude_zone)
        self.calls += 1
        self.fallbacks += int(fell_back)
        return h, bm, ok
