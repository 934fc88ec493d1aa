"""Python-side mirror of the persistent fleet state (port of
``repro.core.soa_fleet``).

``SoAFleet`` owns a ``SoAFleetState`` (the tensors the decision path reads
and updates in place) plus the bookkeeping the tensors cannot carry:
instance identities, the slot ↔ instance-id map, and the records needed to
materialize ``Host`` objects again (``sync_hosts``).

With ``policy.queue_capacity > 0`` the fleet carries the streaming
admission plane (``core.admission``): ``submit`` queues an arrival on the
fleet's device, ``drain`` / ``drain_all`` decide the queue in priority
order, and ``admission_stats`` reads its counters.  The churn readers
(``churn_snapshot``, ``zone_rates``, ``fleet_churn_rate``) read the zone
accumulators that the admission plane's storm degradation and the
relocation plane's trigger judge.

With ``policy.relocate_threshold`` set the fleet carries the relocation
plane: ``relocate`` evacuates the highest-loss preemptible instances of
every armed hot zone (two-threshold hysteresis, cooldown, exponential
backoff), each as checkpoint → re-place outside the zone → voluntary
departure.  Direct mode runs a zone's batch through one ``relocate_many``;
with the admission plane on, each re-placement rides the queue and settles
at the drain that decides it.  ``preempt_instance`` is the out-of-band
reclaim that storms use.

Differences from the JAX module, all deliberate:

* The victim ranking (``_relocation_victims``) takes the top ``budget`` of
  the flattened loss with a stable descending ``torch.sort`` (``-0.0``
  canonicalised) instead of ``lax.top_k``: the same order, ties to the
  lowest flat index, on the CPU and on the card.

With ``policy.mesh`` set the fleet pads its state to
``fleet_sharding.padded_hosts_for`` rows and shards it host-major across the
mesh at build, as the JAX package does; every reader and transition takes
the sharded state (the victim ranking in global host order).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .admission import PAD_RES, AdmissionFrontEnd, DrainResult
from .cost import CostFunction
from .fleet_sharding import canonical_device, pad_fleet_state, padded_hosts_for, shard_fleet_state
from .policy import COST_KIND_IDS, DEFAULT_SHORTLIST, SchedulerPolicy, ensure_policy
from .screen_math import NEG_INF, churn_stats, fma, floor_mod
from .torch_scheduler import (
    SoAFleetState,
    _f32,
    apply_checkpoint,
    apply_departure,
    apply_host_failure,
    apply_termination,
    build_fleet_state,
    relocate_many,
    schedule_many,
    schedule_step,
    set_schedulable,
    set_slow_factor,
)
from .types import Host, Instance, Request, Resources


@dataclasses.dataclass
class AdaptiveShortlist:
    """Host-side shortlist-size controller (port of
    ``soa_fleet.AdaptiveShortlist``): grow M (×2 up to ``m_max``) after
    ``grow_after`` consecutive flushes with an admissibility fallback;
    shrink it (÷2 down to ``m_min``) after ``shrink_after`` consecutive
    fallback-free flushes whose smallest margin stayed above
    ``wide_margin``."""

    m: int = DEFAULT_SHORTLIST
    m_min: int = 16
    m_max: int = 256
    grow_after: int = 2
    shrink_after: int = 8
    wide_margin: float = 0.25
    grows: int = 0
    shrinks: int = 0
    _fallback_streak: int = dataclasses.field(default=0, repr=False)
    _calm_streak: int = dataclasses.field(default=0, repr=False)

    def update(self, n_fallbacks: int, min_margin: float) -> None:
        """Fold one flush's signals; possibly step M."""
        if n_fallbacks > 0:
            self._fallback_streak += 1
            self._calm_streak = 0
            if self._fallback_streak >= self.grow_after and self.m < self.m_max:
                self.m = min(self.m * 2, self.m_max)
                self.grows += 1
                self._fallback_streak = 0
        else:
            self._fallback_streak = 0
            self._calm_streak += 1
            if (
                self._calm_streak >= self.shrink_after
                and min_margin > self.wide_margin
                and self.m > self.m_min
            ):
                self.m = max(self.m // 2, self.m_min)
                self.shrinks += 1
                self._calm_streak = 0


@dataclasses.dataclass(frozen=True)
class SoAOutcome:
    """One decision of the fast path, translated back to python identities."""

    request: Request
    host: Optional[str]                  # None = failed
    instance: Optional[Instance]         # the placed record
    victims: Tuple[Instance, ...] = ()   # evacuated preemptible instances

    @property
    def ok(self) -> bool:
        return self.host is not None


def relocation_loss(state: SoAFleetState, zone: int, now: float,
                    default_period: float) -> torch.Tensor:
    """(N, K) loss a reclaim of each slot would cause at ``now``: recompute
    work since the last checkpoint (lost seconds × max(1, dim 0)) plus the
    remaining prepaid billing period (per-slot ``inst_period``; -1 = the
    policy's ``default_period``); ``NEG_INF`` off ``zone`` and on dead
    slots.  The reference's jitted add is contracted into one fused
    multiply-add, and so is this one.  A sharded state's blocks are scored
    on their devices and joined in host order on the lead device."""
    if state.mesh is not None:
        return torch.cat([relocation_loss(b, zone, now, default_period).to(state.device)
                          for b in state.blocks])
    dev = state.device
    now_t = torch.tensor(_f32(now), dtype=torch.float32, device=dev)
    live = state.inst_valid & (state.host_zone[:, None] == int(zone))
    lost = torch.clamp(now_t - state.inst_ckpt, min=0.0)
    chips = torch.clamp(state.inst_res[..., 0], min=1.0)
    period = torch.where(
        state.inst_period > 0, state.inst_period,
        torch.tensor(_f32(default_period), dtype=torch.float32, device=dev))
    remaining = period - floor_mod(now_t - state.inst_start, period)
    return torch.where(live, fma(lost, chips, remaining), NEG_INF)


def _relocation_victims(state: SoAFleetState, zone: int, now: float,
                        default_period: float, budget: int):
    """Checkpoint-aware victim selection: the at-most-``budget`` slots of
    ``zone`` with the highest ``relocation_loss``, ties to the lowest flat
    index (``lax.top_k``'s order, here a stable descending sort with
    ``-0.0`` folded into ``+0.0``).  Returns ``(host (B,), slot (B,),
    valid (B,))`` as numpy arrays, read back in one copy; rows with
    ``valid=False`` gathered a dead or foreign slot and must be skipped."""
    loss = relocation_loss(state, zone, now, default_period).reshape(-1) + 0.0
    top, idx = torch.sort(loss, descending=True, stable=True)
    k = state.k_slots
    idx = idx[:budget]
    out = torch.stack([idx // k, idx % k, (top[:budget] > NEG_INF / 2).long()]).cpu().numpy()
    return out[0], out[1], out[2].astype(bool)


@dataclasses.dataclass
class _ZoneReloc:
    """Per-zone hysteresis and retry record of the relocation plane:
    ``armed`` flips on when ẑ crosses ``policy.relocate_threshold`` outside
    the cooldown and off when ẑ falls below ``relocate_exit_threshold``;
    ``retry_at`` is the exponential-backoff gate that failed re-placements
    push forward."""

    armed: bool = False
    cooldown_until: float = float("-inf")
    fail_streak: int = 0
    retry_at: float = float("-inf")


@dataclasses.dataclass
class RelocationStats:
    """Host-side counters of the relocation plane (one per fleet).

    Conservation: every ``attempted`` victim ends in exactly one of
    ``relocated`` (moved; the victim departed after its replacement
    landed), ``failed`` (re-placement rejected; the victim untouched),
    ``lost_victims`` (reclaimed mid-flight; the replacement stands as its
    restore), ``stale`` (departed on its own mid-flight; the surplus
    replacement departed at once) or ``pending`` (still in the queue)."""

    passes: int = 0
    arms: int = 0
    disarms: int = 0
    attempted: int = 0
    relocated: int = 0
    failed: int = 0
    lost_victims: int = 0
    stale: int = 0
    pending: int = 0

    def summary(self) -> Dict[str, float]:
        return {
            "relocation_passes": float(self.passes),
            "relocation_arms": float(self.arms),
            "relocation_disarms": float(self.disarms),
            "relocation_attempted": float(self.attempted),
            "relocations": float(self.relocated),
            "relocation_failed": float(self.failed),
            "relocation_lost": float(self.lost_victims),
            "relocation_stale": float(self.stale),
            "relocation_pending": float(self.pending),
        }


class SoAFleet:
    """Incremental fleet view: device tensors + id bookkeeping.

    ``device`` (``None`` = the card) holds the state; on a CUDA device every
    decision runs the hand-written kernels, on the CPU their plain versions.
    All decision knobs live on one ``SchedulerPolicy``.
    """

    def __init__(
        self,
        hosts: Sequence[Host],
        cost_fn: Optional[CostFunction] = None,
        k_slots: int = 8,
        policy: Optional[SchedulerPolicy] = None,
        device=None,
    ):
        self.policy = ensure_policy(policy, "SoAFleet", cost_fn=cost_fn)
        self.cost_fn = cost_fn or self.policy.make_cost_fn()
        self.k_slots = k_slots
        self.adaptive: Optional[AdaptiveShortlist] = (
            AdaptiveShortlist(
                m=(DEFAULT_SHORTLIST if self.policy.shortlist is None
                   else self.policy.shortlist),
                m_min=self.policy.adaptive_bounds[0],
                m_max=self.policy.adaptive_bounds[1],
            )
            if self.policy.adaptive_shortlist
            else None
        )
        #: admissibility-fallback totals (every flush, adaptive or not)
        self.decisions = 0
        self.fallbacks = 0

        self.names: List[str] = [h.name for h in hosts]
        self.index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}
        self.capacity: List[Resources] = [h.capacity for h in hosts]
        self.spec = hosts[0].capacity.spec if hosts else None
        self.domains: List[str] = [h.domain for h in hosts]
        self.domain_ids: Dict[str, int] = {}
        for h in hosts:
            self.domain_ids.setdefault(h.domain, len(self.domain_ids))
        self.zones: List[str] = [h.zone for h in hosts]
        self.zone_ids: Dict[str, int] = {}
        for h in hosts:
            self.zone_ids.setdefault(h.zone, len(self.zone_ids))

        table = self.policy.kind_table
        for h in hosts:
            for inst in h.instances.values():
                if inst.cost_kind is not None and inst.cost_kind not in table:
                    raise ValueError(
                        f"instance {inst.id} bills by {inst.cost_kind!r}, "
                        f"not in the policy's cost-kind table {table}"
                    )

        mesh = self.policy.mesh
        if mesh is not None:
            if device is not None and canonical_device(device) != mesh.lead:
                raise ValueError(f"SoAFleet: device {device} is not the mesh's lead "
                                 f"device {mesh.lead}")
            device = mesh.lead
        self.state, slot_rows = build_fleet_state(
            hosts, k_slots=k_slots, domain_ids=self.domain_ids,
            zone_ids=self.zone_ids, device=device,
        )
        if mesh is not None:
            # pad so every shard holds the largest shortlist this fleet can
            # run plus a witness; the padding rows are invalid everywhere
            self.state = shard_fleet_state(
                pad_fleet_state(self.state, padded_hosts_for(len(hosts), self.policy)), mesh)
        #: slot → live preemptible instance id (None = free slot)
        self.slot_ids: List[List[Optional[str]]] = [
            [inst.id if inst is not None else None for inst in row]
            for row in slot_rows
        ]
        #: all live instances, including normal ones
        self.instances: Dict[str, Instance] = {}
        #: id → (host_idx, slot) — slot None for normal instances
        self.locator: Dict[str, Tuple[int, Optional[int]]] = {}
        for i, h in enumerate(hosts):
            for inst in h.instances.values():
                self.instances[inst.id] = inst
                slot = self.slot_ids[i].index(inst.id) if inst.preemptible else None
                self.locator[inst.id] = (i, slot)

        self.preempted: List[Instance] = []
        self._ids = itertools.count()
        #: relocation plane (armed per zone by policy.relocate_threshold)
        self.relocation = RelocationStats()
        self._reloc_zone: Dict[str, _ZoneReloc] = {}
        #: victims whose re-placement is waiting in the admission queue
        self._reloc_inflight: Set[str] = set()
        #: relocated old id → replacement id; the simulator follows this
        #: chain when a departure event names a relocated instance
        self.relocated_ids: Dict[str, str] = {}
        #: resource vectors already copied to the device, by value
        self._vecs: Dict[bytes, torch.Tensor] = {}
        cap = np.stack([c.vec for c in self.capacity]) if hosts else np.zeros((0, 1))
        self._cap0_total = float(cap[:, 0].sum())
        #: streaming admission front end (None = admission plane off)
        self.admission: Optional[AdmissionFrontEnd] = (
            AdmissionFrontEnd(self) if self.policy.queue_capacity else None
        )

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mesh(self):
        return self.policy.mesh

    # -- views of the policy fields ----------------------------------------------
    @property
    def cost_kind(self) -> str:
        return self.policy.cost_kind

    @property
    def period(self) -> float:
        return self.policy.period

    @property
    def weigher_multipliers(self) -> Tuple[float, float, float, float]:
        return self.policy.weigher_multipliers

    @property
    def shortlist(self) -> Optional[int]:
        return self.policy.shortlist

    def _dev(self, vec: np.ndarray) -> torch.Tensor:
        """``vec`` (f32) as a device tensor, copied once per distinct value
        (a fresh host-to-device copy from pageable memory waits for the
        stream)."""
        vec = np.asarray(vec, np.float32)
        key = vec.tobytes()
        t = self._vecs.get(key)
        if t is None:
            t = torch.from_numpy(vec.copy()).to(self.device)
            self._vecs[key] = t
        return t

    # -- derived metrics -------------------------------------------------------
    @property
    def n_hosts(self) -> int:
        return len(self.names)

    def _column(self, name: str) -> torch.Tensor:
        """A per-host state field, whole (a sharded state's gathered on the
        lead device; its padding rows are zero)."""
        st = self.state
        return getattr(st, name) if st.mesh is None else st.field(name)

    def utilization(self) -> float:
        if not self._cap0_total:
            return 0.0
        free0 = float(self._column("free_f")[:, 0].double().sum())
        return (self._cap0_total - free0) / self._cap0_total

    def utilization_normal(self) -> float:
        if not self._cap0_total:
            return 0.0
        free0 = float(self._column("free_n")[:, 0].double().sum())
        return (self._cap0_total - free0) / self._cap0_total

    # -- scheduling ------------------------------------------------------------
    def _req_arrays(self, req: Request):
        dom = -1 if req.domain is None else self.domain_ids.get(req.domain, -1)
        if req.cost_kind is None:
            kind = -1
        else:
            if req.cost_kind not in self.policy.kind_table:
                raise ValueError(
                    f"request {req.id} bills by {req.cost_kind!r}, not in "
                    f"the policy's cost-kind table {self.policy.kind_table}"
                )
            kind = COST_KIND_IDS[req.cost_kind]
        if req.exclude_zone is None:
            excl = -1
        else:
            if req.exclude_zone not in self.zone_ids:
                raise ValueError(
                    f"request {req.id} excludes unknown zone "
                    f"{req.exclude_zone!r}; fleet zones: {sorted(self.zone_ids)}"
                )
            excl = self.zone_ids[req.exclude_zone]
        return (
            req.resources.vec32,
            bool(req.preemptible),
            np.int32(dom),
            np.int32(kind),
            np.float32(-1.0 if req.period is None else req.period),
            np.int32(excl),
        )

    @property
    def effective_shortlist(self) -> Optional[int]:
        """The M the next flush will use (controller-steered when adaptive)."""
        return self.adaptive.m if self.adaptive is not None else self.policy.shortlist

    def _flush_policy(self) -> SchedulerPolicy:
        m = self.effective_shortlist
        if m == self.policy.shortlist:
            return self.policy
        return dataclasses.replace(self.policy, shortlist=m)

    @property
    def shortlist_stats(self) -> Dict[str, int]:
        """Decisions seen, admissibility fallbacks paid, the M decisions run
        with, and the adaptive controller's moves."""
        a = self.adaptive
        m = self.effective_shortlist
        if m is None:
            m = DEFAULT_SHORTLIST if self.state.n_hosts > 4 * DEFAULT_SHORTLIST else 0
        return {
            "decisions": self.decisions,
            "fallbacks": self.fallbacks,
            "shortlist": m,
            "grows": a.grows if a else 0,
            "shrinks": a.shrinks if a else 0,
        }

    def _observe(self, n_fallbacks: int, min_margin: float, n_decisions: int):
        self.decisions += n_decisions
        self.fallbacks += n_fallbacks
        if self.adaptive is not None:
            self.adaptive.update(n_fallbacks, min_margin)

    def schedule_request(self, req: Request, now: float, price: float = 1.0) -> SoAOutcome:
        """One decide-and-apply step on the persistent state."""
        res, pre, dom, kind, period, excl = self._req_arrays(req)
        self.state, (host_idx, slot, ok, kill, fell_back, margin) = schedule_step(
            self.state, self._dev(res), pre, dom, now, price,
            policy=self._flush_policy(), req_cost_kind=kind, req_period=period,
            req_exclude_zone=excl,
        )
        self._observe(int(fell_back), float(margin), 1)
        return self._absorb(req, now, price, int(host_idx), int(slot), bool(ok),
                            kill.numpy())

    def schedule_batch(
        self, items: Sequence[Tuple[Request, float, float]]
    ) -> List[SoAOutcome]:
        """Run ``(request, now, price)`` triples in order through
        ``schedule_many`` (no padding: the loop has no compiled shapes)."""
        if not items:
            return []
        if len(items) == 1:
            req, t, p = items[0]
            return [self.schedule_request(req, t, price=p)]
        b = len(items)
        d = len(self.spec.dims)
        res = np.zeros((b, d), np.float32)
        pre = np.zeros((b,), bool)
        dom = np.full((b,), -1, np.int32)
        now = np.zeros((b,), np.float32)
        price = np.ones((b,), np.float32)
        kind = np.full((b,), -1, np.int32)
        period = np.full((b,), -1.0, np.float32)
        excl = np.full((b,), -1, np.int32)
        for i, (req, t, p) in enumerate(items):
            (res[i], pre[i], dom[i], kind[i], period[i],
             excl[i]) = self._req_arrays(req)
            now[i] = t
            price[i] = p
        self.state, (host_idx, slot, ok, kill, fell_back, margin) = schedule_many(
            self.state, res, pre, dom, now, price,
            policy=self._flush_policy(), req_cost_kind=kind, req_period=period,
            req_exclude_zone=excl,
        )
        host_idx, slot = host_idx.numpy(), slot.numpy()
        ok, kill = ok.numpy(), kill.numpy()
        self._observe(int(fell_back.sum()), float(margin.min()), b)
        return [
            self._absorb(req, t, p, int(host_idx[i]), int(slot[i]), bool(ok[i]), kill[i])
            for i, (req, t, p) in enumerate(items)
        ]

    def _absorb(self, req: Request, now: float, price: float, host_idx: int,
                slot: int, ok: bool, kill_row: np.ndarray) -> SoAOutcome:
        """Fold one decision's outputs back into the python bookkeeping."""
        if not ok:
            return SoAOutcome(request=req, host=None, instance=None)
        name = self.names[host_idx]
        victims: List[Instance] = []
        if not req.preemptible:
            for k in np.flatnonzero(kill_row):
                vid = self.slot_ids[host_idx][k]
                if vid is None:
                    raise RuntimeError(
                        f"decision terminated empty slot {k} on host {name}"
                    )
                victim = self.instances.pop(vid)
                del self.locator[vid]
                self.slot_ids[host_idx][k] = None
                self.preempted.append(victim)
                victims.append(victim)
        inst = Instance(
            id=f"i{next(self._ids)}-{req.id}",
            resources=req.resources,
            preemptible=req.preemptible,
            host=name,
            start_time=now,
            user=req.user,
            price_rate=price,
            cost_kind=req.cost_kind,
            period=req.period,
        )
        self.instances[inst.id] = inst
        if req.preemptible:
            if self.slot_ids[host_idx][slot] is not None:
                raise RuntimeError(f"slot collision on host {name} slot {slot}")
            self.slot_ids[host_idx][slot] = inst.id
            self.locator[inst.id] = (host_idx, slot)
            inst.metadata["slot"] = int(slot)
        else:
            self.locator[inst.id] = (host_idx, None)
        return SoAOutcome(request=req, host=name, instance=inst, victims=tuple(victims))

    # -- streaming admission (policy.queue_capacity > 0) -----------------------
    def _front(self) -> AdmissionFrontEnd:
        if self.admission is None:
            raise RuntimeError(
                "admission plane is off; build the fleet with "
                "SchedulerPolicy(queue_capacity=...) to use submit/drain"
            )
        return self.admission

    def submit(self, req: Request, now: float, price: float = 1.0) -> None:
        """Accept an arrival into the admission plane (decided at the next
        drain, in priority order)."""
        self._front().submit(req, now, price=price)

    def drain(self, now: float, block: bool = True) -> Optional[DrainResult]:
        """Run one admission drain (see ``AdmissionFrontEnd.drain``)."""
        return self._front().drain(now, block=block)

    def drain_all(self, now: float) -> List[DrainResult]:
        """Drain until the queue empties or retries are spent."""
        return self._front().drain_all(now)

    @property
    def admission_stats(self) -> Dict[str, float]:
        """Counters and latency percentiles of the admission plane."""
        front = self._front()
        front.sync()
        return front.stats.summary()

    # -- zone churn readers ------------------------------------------------------
    def churn_snapshot(self) -> Tuple[Dict[str, float], float]:
        """Every churn statistic in one reduction and one copy back
        (``screen_math.churn_stats``): ``(per-zone rate by name, fleet-wide
        rate)``."""
        out = churn_stats(self.state.zone_term, self.state.zone_up).cpu().numpy()
        rates = {z: float(out[i]) for z, i in self.zone_ids.items()}
        return rates, float(out[-1])

    def zone_rates(self) -> Dict[str, float]:
        """Observed per-zone churn rates T / max(U, eps): involuntary
        terminations over accrued preemptible uptime."""
        return self.churn_snapshot()[0]

    def fleet_churn_rate(self) -> float:
        """Fleet-wide churn rate ΣT / max(ΣU, eps): the storm signal the
        admission plane's degradation compares with
        ``policy.storm_threshold``."""
        return self.churn_snapshot()[1]

    # -- lifecycle transitions ---------------------------------------------------
    def depart(self, instance_id: str, now: Optional[float] = None) -> bool:
        """Voluntary departure.  Returns False if the instance is already
        gone.  With ``now`` the slot's accrued uptime feeds its zone's U."""
        inst = self.instances.pop(instance_id, None)
        if inst is None:
            return False
        host_idx, slot = self.locator.pop(instance_id)
        if slot is not None:
            mask = np.zeros((self.k_slots,), bool)
            mask[slot] = True
            self.state = apply_termination(
                self.state, host_idx, mask, now=now, involuntary=False
            )
            self.slot_ids[host_idx][slot] = None
        else:
            self.state = apply_departure(
                self.state, host_idx, self._dev(inst.resources.vec32)
            )
        return True

    def preempt_instance(self, instance_id: str, now: Optional[float] = None) -> bool:
        """Involuntary out-of-band reclaim (a storm, a provider reclaim): the
        instance dies like a scheduler kill, freed on the device, recorded in
        ``preempted`` and, with ``now``, charged to its zone's T and U.
        Returns False when it is already gone (storms and relocations race);
        raises for a live normal instance, which no provider reclaims out of
        band."""
        loc = self.locator.get(instance_id)
        if loc is None:
            return False
        if loc[1] is None:
            raise ValueError(
                f"instance {instance_id} is not preemptible; out-of-band "
                "reclaim only takes preemptible slots (normal instances "
                "leave via depart/fail_host)"
            )
        host_idx, slot = loc
        inst = self.instances.pop(instance_id)
        del self.locator[instance_id]
        mask = np.zeros((self.k_slots,), bool)
        mask[slot] = True
        self.state = apply_termination(
            self.state, host_idx, mask, now=now, involuntary=True
        )
        self.slot_ids[host_idx][slot] = None
        self.preempted.append(inst)
        return True

    def fail_host(self, name: str, now: Optional[float] = None) -> Tuple[int, int]:
        """Hard failure: every instance dies (preemptible ones are recorded
        as preempted).  Returns (n_preempted, n_terminated)."""
        host_idx = self.index[name]
        n_pre = n_norm = 0
        normal_res = np.zeros((len(self.spec.dims),), np.float32)
        for iid in [i for i, (h, _) in self.locator.items() if h == host_idx]:
            inst = self.instances.pop(iid)
            _, slot = self.locator.pop(iid)
            if slot is not None:
                self.slot_ids[host_idx][slot] = None
                self.preempted.append(inst)
                n_pre += 1
            else:
                normal_res += inst.resources.vec32
                n_norm += 1
        self.state = apply_host_failure(
            self.state, host_idx, self._dev(normal_res), now=now
        )
        return n_pre, n_norm

    # -- relocation plane (hot-zone evacuation) --------------------------------
    def relocate(self, now: float) -> int:
        """One relocation pass: evacuate up to ``policy.relocate_budget`` of
        the highest-loss preemptible instances from every armed hot zone,
        checkpoint → place → kill, never the reverse.

        A zone arms when its churn rate ẑ crosses ``relocate_threshold``
        outside its cooldown, and disarms (entering a
        ``relocate_cooldown_s`` cooldown) when ẑ falls below
        ``relocate_exit_threshold``.  A failed re-placement leaves its victim
        running and pushes the zone's ``retry_at`` out exponentially
        (``relocate_backoff_s`` doubling per consecutive failure).  Returns
        the number of evacuations started this pass."""
        pol = self.policy
        if not pol.relocation_on:
            raise RuntimeError(
                "relocation plane is off; build the fleet with "
                "SchedulerPolicy(relocate_threshold=...)"
            )
        st = self.relocation
        st.passes += 1
        rates, _ = self.churn_snapshot()
        started = 0
        for zone in self.zone_ids:
            z = self._reloc_zone.setdefault(zone, _ZoneReloc())
            rate = rates[zone]
            if z.armed and rate < pol.relocate_exit_threshold:
                z.armed = False
                z.cooldown_until = now + pol.relocate_cooldown_s
                st.disarms += 1
            elif not z.armed and rate > pol.relocate_threshold and now >= z.cooldown_until:
                z.armed = True
                z.fail_streak = 0
                z.retry_at = float("-inf")
                st.arms += 1
            if z.armed and now >= z.retry_at:
                started += self._evacuate_zone(zone, now)
        return started

    def _evacuate_zone(self, zone: str, now: float) -> int:
        """Evacuate one armed zone's worst-loss victims (at most the budget):
        in direct mode one ``relocate_many`` batch, with the admission plane
        on one queue entry each, settled at the drain that decides it."""
        pol = self.policy
        st = self.relocation
        budget = min(pol.relocate_budget, self.state.n_hosts * self.k_slots)
        hosts, slots, valid = _relocation_victims(
            self.state, self.zone_ids[zone], now, pol.period, budget)
        started = 0
        batch: List[Tuple[str, int, int, Instance, Request]] = []
        for h, s, v in zip(hosts, slots, valid):
            if not v:
                continue
            iid = self.slot_ids[int(h)][int(s)]
            if iid is None:
                raise RuntimeError(
                    f"relocation victim slot {int(s)} on host {self.names[int(h)]} "
                    "is empty in the mirror")
            if iid in self._reloc_inflight:
                continue  # already mid-flight from an earlier pass
            inst = self.instances[iid]
            st.attempted += 1
            req = Request(
                id=f"reloc-{iid}", resources=inst.resources, preemptible=True,
                user=inst.user, cost_kind=inst.cost_kind, period=inst.period,
                priority=0, exclude_zone=zone, metadata={"relocation": iid},
            )
            if self.admission is not None:
                # checkpoint first: the replacement restarts from here, and a
                # storm racing the move loses only the work since now
                self.checkpoint(iid, now)
                self.admission.submit_relocation(req, iid, zone, now,
                                                 price=inst.price_rate)
                self._reloc_inflight.add(iid)
                st.pending += 1
                started += 1
            else:
                # the mirror's half of the checkpoint; the device's half runs
                # inside relocate_many, row by row
                inst.last_checkpoint = now
                batch.append((iid, int(h), int(s), inst, req))
        if batch:
            started += self._relocate_batch(zone, batch, now)
        return started

    def _relocate_batch(self, zone: str,
                        batch: List[Tuple[str, int, int, Instance, Request]],
                        now: float) -> int:
        """Direct-mode settle of one ``relocate_many`` batch, padded to
        ``max(4, next power of two)`` rows as the reference pads it."""
        b = len(batch)
        padded = max(4, 1 << (b - 1).bit_length())
        d = len(self.spec.dims)
        vh = np.zeros((padded,), np.int32)
        vs = np.zeros((padded,), np.int32)
        von = np.zeros((padded,), bool)
        res = np.full((padded, d), PAD_RES, np.float32)
        dom = np.full((padded,), -1, np.int32)
        kind = np.full((padded,), -1, np.int32)
        period = np.full((padded,), -1.0, np.float32)
        price = np.ones((padded,), np.float32)
        excl = np.full((padded,), -1, np.int32)
        for i, (iid, h, s, inst, req) in enumerate(batch):
            res[i], _, dom[i], kind[i], period[i], excl[i] = self._req_arrays(req)
            vh[i], vs[i], von[i] = h, s, True
            price[i] = inst.price_rate
        self.state, (host_idx, slot, ok, fell_back, margin) = relocate_many(
            self.state, vh, vs, von, res, dom, kind, period, price, excl, now,
            policy=self._flush_policy(),
        )
        host_idx, slot, ok = host_idx.numpy(), slot.numpy(), ok.numpy()
        self._observe(int(fell_back[:b].sum()), float(margin[:b].min()), b)
        st = self.relocation
        z = self._reloc_zone.setdefault(zone, _ZoneReloc())
        no_kill = np.zeros((self.k_slots,), bool)
        started = 0
        for i, (iid, h, s, inst, req) in enumerate(batch):
            if ok[i]:
                out = self._absorb(req, now, inst.price_rate, int(host_idx[i]),
                                   int(slot[i]), True, no_kill)
                # relocate_many already departed the victim on the device
                # (make-before-break, voluntary); fold the mirror here
                self.instances.pop(iid)
                del self.locator[iid]
                self.slot_ids[h][s] = None
                self.relocated_ids[iid] = out.instance.id
                st.relocated += 1
                z.fail_streak = 0
                started += 1
            else:
                self._settle_relocation_rejected(iid, zone, now)
        return started

    def _settle_relocation_placed(self, victim_id: str, zone: str,
                                  out: SoAOutcome, now: float) -> None:
        """Make-before-break settle: the replacement is live, so the victim
        (if still running) departs voluntarily; a move is not churn."""
        st = self.relocation
        if victim_id in self._reloc_inflight:
            self._reloc_inflight.discard(victim_id)
            st.pending -= 1
        z = self._reloc_zone.setdefault(zone, _ZoneReloc())
        if victim_id in self.instances:
            self.depart(victim_id, now=now)
            self.relocated_ids[victim_id] = out.instance.id
            st.relocated += 1
            z.fail_streak = 0
        elif any(i.id == victim_id for i in self.preempted):
            # the storm beat the move: the replacement stands as the restore
            # from the checkpoint taken at evacuation time
            self.relocated_ids[victim_id] = out.instance.id
            st.lost_victims += 1
        else:
            # the victim departed on its own mid-flight: the replacement is
            # surplus and departs at once (no duplicate, no double bill)
            self.depart(out.instance.id, now=now)
            st.stale += 1

    def _settle_relocation_rejected(self, victim_id: str, zone: str, now: float) -> None:
        """Never-worse: a failed re-placement leaves the victim running and
        backs the zone off exponentially."""
        st = self.relocation
        if victim_id in self._reloc_inflight:
            self._reloc_inflight.discard(victim_id)
            st.pending -= 1
        st.failed += 1
        z = self._reloc_zone.setdefault(zone, _ZoneReloc())
        z.fail_streak += 1
        z.retry_at = now + self.policy.relocate_backoff_s * (2.0 ** (z.fail_streak - 1))

    def checkpoint(self, instance_id: str, now: float) -> bool:
        """Record a durable checkpoint for a live preemptible instance."""
        loc = self.locator.get(instance_id)
        if loc is None or loc[1] is None:
            return False
        host_idx, slot = loc
        self.instances[instance_id].last_checkpoint = now
        self.state = apply_checkpoint(self.state, host_idx, slot, now)
        return True

    def heal_host(self, name: str) -> None:
        self.state = set_schedulable(self.state, self.index[name], True)

    def set_slow(self, name: str, slow_factor: float) -> None:
        self.state = set_slow_factor(self.state, self.index[name], slow_factor)

    # -- python-object sync ------------------------------------------------------
    def slot_assignment(self) -> List[Dict[str, int]]:
        """Per-host id → slot map, for bit-exact oracle rebuilds."""
        return [
            {iid: k for k, iid in enumerate(row) if iid is not None}
            for row in self.slot_ids
        ]

    def sync_hosts(self) -> List[Host]:
        """Materialize python ``Host`` objects from the mirror records;
        ``Host.place`` re-validates capacity, so a capacity violation in the
        incremental state raises here."""
        schedulable = self._column("schedulable").cpu().numpy()
        slow = self._column("slow").cpu().numpy()
        hosts = [
            Host(
                name=self.names[i],
                capacity=self.capacity[i],
                domain=self.domains[i],
                zone=self.zones[i],
                schedulable=bool(schedulable[i]),
                slow_factor=float(slow[i]),
            )
            for i in range(self.n_hosts)
        ]
        for inst in self.instances.values():
            host_idx, _ = self.locator[inst.id]
            hosts[host_idx].place(inst)
        return hosts
