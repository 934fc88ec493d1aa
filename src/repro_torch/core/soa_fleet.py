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
accumulators that the admission plane's storm degradation judges.

Not ported yet, and raising ``NotImplementedError``: the relocation plane
(``relocate``) and out-of-band preemption (``preempt_instance``); see
``ROADMAP.md``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .admission import AdmissionFrontEnd, DrainResult
from .cost import CostFunction
from .policy import COST_KIND_IDS, DEFAULT_SHORTLIST, SchedulerPolicy, ensure_policy
from .screen_math import churn_stats
from .torch_scheduler import (
    apply_checkpoint,
    apply_departure,
    apply_host_failure,
    apply_termination,
    build_fleet_state,
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

        self.state, slot_rows = build_fleet_state(
            hosts, k_slots=k_slots, domain_ids=self.domain_ids,
            zone_ids=self.zone_ids, device=device,
        )
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

    def utilization(self) -> float:
        if not self._cap0_total:
            return 0.0
        free0 = float(self.state.free_f[:, 0].double().sum())
        return (self._cap0_total - free0) / self._cap0_total

    def utilization_normal(self) -> float:
        if not self._cap0_total:
            return 0.0
        free0 = float(self.state.free_n[:, 0].double().sum())
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

    # -- planes not ported yet --------------------------------------------------
    def relocate(self, now: float) -> int:
        raise NotImplementedError(
            "relocation plane not ported yet (ROADMAP.md, Open items §1, item 5)")

    def preempt_instance(self, instance_id: str, now: Optional[float] = None) -> bool:
        raise NotImplementedError(
            "out-of-band preemption (storm injection) not ported yet "
            "(ROADMAP.md, Open items §1, item 5)")

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
        schedulable = self.state.schedulable.cpu().numpy()
        slow = self.state.slow.cpu().numpy()
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
