"""Event-driven fleet simulator on the persistent state (port of
``repro.core.simulator``: ``WorkloadSpec``, ``SimMetrics`` and
``SoASimulator.run``'s event loop).

Arrivals (Poisson), truncated-exponential lifetimes, the normal/preemptible
mix, voluntary departures, scheduler-driven preemptions, host failure / heal
and straggler injection, all drawn from ``np.random.default_rng(seed)`` in
the same order as the JAX simulator, so the two event streams are identical.
Runs of consecutive arrivals go through one ``SoAFleet.schedule_batch``.

The python ``Simulator`` (a copy of the JAX package's) runs the same event
stream on a ``Cluster`` of python hosts and asks a scheduler per arrival: one
of the paper's three (``core.scheduler``) or the rebuild-per-call
``TorchPreemptibleScheduler``, whose decisions run on the card.

With ``policy.queue_capacity > 0`` ``SoASimulator.run`` runs in streaming
admission mode (``_run_streaming``): arrivals queue through the fleet's
admission front end and drain on a full batch, on the SLO deadline and after
every capacity-freeing event.

Failure domains: ``inject_zone_storm`` reclaims a seeded fraction of a
zone's preemptible instances at once, and ``inject_churn_regime`` alternates
a zone between calm and stormy phases; with ``policy.relocate_threshold``
set, both loops run a relocation pass every ``relocate_every_s`` and follow
a relocated instance's departure to its replacement.

``SoASimulator.run_trace`` replays a pre-materialised ``core.scan_sim``
``EventTrace`` through the same fleet (direct and streaming): the oracle
that ``scan_sim.simulate_scan`` is held against.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cluster import Cluster
from .cost import CostFunction
from .scheduler import BaseScheduler
from .soa_fleet import SoAFleet
from .types import Request, Resources
from .policy import COST_KINDS


@dataclasses.dataclass(order=True)
class _Event:
    time: float
    seq: int
    # arrival | departure | fail_host | heal_host | drain (streaming SLO tick)
    # | zone_storm | regime_on | relocate
    kind: str = dataclasses.field(compare=False)
    payload: object = dataclasses.field(compare=False, default=None)


@dataclasses.dataclass
class WorkloadSpec:
    """Synthetic workload mirroring §4.4 plus knobs for scale studies."""

    arrival_rate_per_s: float = 1 / 60.0
    lifetime_min_s: float = 600.0        # 10 min
    lifetime_max_s: float = 18000.0      # 300 min
    lifetime_mean_s: float = 5400.0
    preemptible_fraction: float = 0.5
    flavors: Sequence[Tuple[str, Resources]] = ()
    flavor_probs: Optional[Sequence[float]] = None


@dataclasses.dataclass
class SimMetrics:
    t: List[float] = dataclasses.field(default_factory=list)
    utilization: List[float] = dataclasses.field(default_factory=list)
    utilization_normal: List[float] = dataclasses.field(default_factory=list)
    sched_latency_s: List[float] = dataclasses.field(default_factory=list)
    failures_normal: int = 0
    failures_preemptible: int = 0
    placed_normal: int = 0
    placed_preemptible: int = 0
    preemptions: int = 0
    storms: int = 0
    storm_kills: int = 0
    relocation_passes: int = 0
    relocations: int = 0
    relocation_failed: int = 0
    relocation_lost: int = 0

    def summary(self) -> Dict[str, float]:
        return {
            "mean_utilization": float(np.mean(self.utilization)) if self.utilization else 0.0,
            "mean_utilization_normal": float(np.mean(self.utilization_normal)) if self.utilization_normal else 0.0,
            "p50_sched_latency_us": float(np.percentile(self.sched_latency_s, 50) * 1e6) if self.sched_latency_s else 0.0,
            "p99_sched_latency_us": float(np.percentile(self.sched_latency_s, 99) * 1e6) if self.sched_latency_s else 0.0,
            "failures_normal": float(self.failures_normal),
            "failures_preemptible": float(self.failures_preemptible),
            "placed_normal": float(self.placed_normal),
            "placed_preemptible": float(self.placed_preemptible),
            "preemptions": float(self.preemptions),
            "storms": float(self.storms),
            "storm_kills": float(self.storm_kills),
            "relocation_passes": float(self.relocation_passes),
            "relocations": float(self.relocations),
            "relocation_failed": float(self.relocation_failed),
            "relocation_lost": float(self.relocation_lost),
        }


class Simulator:
    """Event loop on a python ``Cluster`` (a copy of
    ``repro.core.simulator.Simulator``): one ``scheduler.schedule`` call per
    arrival, the same draws in the same order.  ``sched_latency_s`` is the
    wall clock of each call."""

    def __init__(
        self,
        cluster: Cluster,
        scheduler: BaseScheduler,
        workload: WorkloadSpec,
        seed: int = 0,
    ):
        self.cluster = cluster
        self.scheduler = scheduler
        self.workload = workload
        self.rng = np.random.default_rng(seed)
        self.metrics = SimMetrics()
        self._heap: List[_Event] = []
        self._seq = itertools.count()
        self._req_ids = itertools.count()
        self.now = 0.0

    # -- event helpers ----------------------------------------------------------
    def _push(self, t: float, kind: str, payload=None) -> None:
        heapq.heappush(self._heap, _Event(t, next(self._seq), kind, payload))

    def _draw_lifetime(self) -> float:
        w = self.workload
        # exponential, truncated to [min,max] (paper §4.4.1 + Knuth ref)
        for _ in range(64):
            x = self.rng.exponential(w.lifetime_mean_s)
            if w.lifetime_min_s <= x <= w.lifetime_max_s:
                return x
        return float(np.clip(x, w.lifetime_min_s, w.lifetime_max_s))

    def _draw_request(self) -> Request:
        w = self.workload
        names = [f[0] for f in w.flavors]
        probs = w.flavor_probs
        idx = self.rng.choice(len(names), p=probs)
        name, res = w.flavors[idx]
        preempt = bool(self.rng.random() < w.preemptible_fraction)
        return Request(
            id=f"r{next(self._req_ids)}", resources=res, preemptible=preempt
        )

    # -- main loop ----------------------------------------------------------------
    def run(
        self,
        duration_s: float,
        stop_on_normal_failure: bool = False,
        sample_every_s: float = 300.0,
    ) -> SimMetrics:
        self._push(self.rng.exponential(1.0 / self.workload.arrival_rate_per_s), "arrival")
        next_sample = 0.0
        while self._heap:
            ev = heapq.heappop(self._heap)
            if ev.time > duration_s:
                break
            self.now = ev.time
            if self.now >= next_sample:
                self._sample()
                next_sample = self.now + sample_every_s
            if ev.kind == "arrival":
                stop = self._handle_arrival()
                self._push(
                    self.now + self.rng.exponential(1.0 / self.workload.arrival_rate_per_s),
                    "arrival",
                )
                if stop and stop_on_normal_failure:
                    break
            elif ev.kind == "departure":
                inst = ev.payload
                host = self.cluster.hosts[inst.host]
                if inst.id in host.instances:  # may have been preempted already
                    self.cluster.terminate(inst)
            elif ev.kind == "fail_host":
                self._fail_host(ev.payload)
            elif ev.kind == "heal_host":
                self.cluster.hosts[ev.payload].schedulable = True
        self._sample()
        return self.metrics

    def _handle_arrival(self) -> bool:
        """Returns True when a NORMAL request failed (paper's stop signal)."""
        req = self._draw_request()
        t0 = _time.perf_counter()
        result = self.scheduler.schedule(req, self.cluster.host_list(), self.now)
        self.metrics.sched_latency_s.append(_time.perf_counter() - t0)
        preempted_before = self.cluster.stats.preemptions
        inst = self.cluster.apply(result, self.now)
        self.metrics.preemptions += self.cluster.stats.preemptions - preempted_before
        if inst is None:
            if req.preemptible:
                self.metrics.failures_preemptible += 1
            else:
                self.metrics.failures_normal += 1
                return True
            return False
        if req.preemptible:
            self.metrics.placed_preemptible += 1
        else:
            self.metrics.placed_normal += 1
        self._push(self.now + self._draw_lifetime(), "departure", inst)
        return False

    # -- fault injection ------------------------------------------------------------
    def inject_host_failure(self, host_name: str, at_s: float, heal_after_s: float = 0.0):
        self._push(at_s, "fail_host", host_name)
        if heal_after_s:
            self._push(at_s + heal_after_s, "heal_host", host_name)

    def inject_stragglers(self, fraction: float, slow_factor: float = 3.0):
        hosts = self.cluster.host_list()
        n = max(1, int(len(hosts) * fraction))
        for h in self.rng.choice(len(hosts), size=n, replace=False):
            hosts[int(h)].slow_factor = slow_factor

    def _fail_host(self, host_name: str) -> None:
        """Hard host failure: all instances die; preemptible ones re-queue."""
        host = self.cluster.hosts[host_name]
        host.schedulable = False
        for inst in list(host.instances.values()):
            if inst.preemptible:
                self.cluster.preempt(inst, self.now)
            else:
                self.cluster.terminate(inst)

    def _sample(self) -> None:
        self.metrics.t.append(self.now)
        self.metrics.utilization.append(self.cluster.utilization())
        self.metrics.utilization_normal.append(self.cluster.utilization_normal())


class SoASimulator:
    """Event loop on the incremental fleet state: each event is an O(K·D)
    in-place transition, and runs of consecutive arrivals are decided in one
    ``schedule_batch`` so consecutive decisions see each other's placements.

    ``device`` (``None`` = the card) is where the fleet state lives when
    ``hosts`` is a host list; a ready ``SoAFleet`` keeps its own device.
    ``policy.mesh`` (``fleet_sharding.fleet_mesh``) shards the fleet state
    host-major across the mesh's devices, the state then on its lead
    device: every decision runs the sharded screen, bit-identical to the
    unsharded run.

    With ``policy.queue_capacity > 0`` the loop runs in **streaming
    admission mode**: arrivals ``submit`` into the fleet's admission front
    end, and drains fire on a full ``admit_batch``, on the ``slo_target_s``
    deadline of the oldest waiting arrival, and after any capacity-freeing
    event (departure, host failure, heal) while requests wait (backfill).
    Drains are dispatched with ``block=False``; a rejected request (queue
    overflow or ``max_retries`` spent) counts as a failure, and
    ``metrics.sched_latency_s`` holds each placement's wall-clock admission
    latency (submit → outcome absorbed).

    Deltas from the JAX package's python ``Simulator`` (the same as the JAX
    ``SoASimulator``'s): lifetimes are drawn at arrival time, and with
    ``stop_on_normal_failure`` the loop stops at the end of the batch (or
    drain).
    """

    def __init__(
        self,
        hosts,
        workload: WorkloadSpec,
        seed: int = 0,
        cost_fn: Optional[CostFunction] = None,
        k_slots: int = 8,
        batch_max: int = 64,
        policy=None,
        device=None,
    ):
        self.fleet = (
            hosts if isinstance(hosts, SoAFleet)
            else SoAFleet(hosts, cost_fn=cost_fn, k_slots=k_slots,
                          policy=policy, device=device)
        )
        self.workload = workload
        self.batch_max = batch_max
        self.rng = np.random.default_rng(seed)
        self.metrics = SimMetrics()
        self._heap: List[_Event] = []
        self._seq = itertools.count()
        self._req_ids = itertools.count()
        self.now = 0.0
        #: buffered (arrival_time, request, lifetime) awaiting one flush
        self._pending: List[Tuple[float, Request, float]] = []
        self._min_dep = float("inf")
        #: request id → lifetime drawn at arrival (streaming mode: the
        #: departure is scheduled once a drain places the request)
        self._lifetimes: Dict[str, float] = {}

    # -- event helpers (the JAX simulator's draws, in its order) --------------
    def _push(self, t: float, kind: str, payload=None) -> None:
        heapq.heappush(self._heap, _Event(t, next(self._seq), kind, payload))

    def _draw_lifetime(self) -> float:
        w = self.workload
        for _ in range(64):
            x = self.rng.exponential(w.lifetime_mean_s)
            if w.lifetime_min_s <= x <= w.lifetime_max_s:
                return x
        return float(np.clip(x, w.lifetime_min_s, w.lifetime_max_s))

    def _draw_request(self) -> Request:
        w = self.workload
        names = [f[0] for f in w.flavors]
        idx = self.rng.choice(len(names), p=w.flavor_probs)
        _, res = w.flavors[idx]
        preempt = bool(self.rng.random() < w.preemptible_fraction)
        return Request(id=f"r{next(self._req_ids)}", resources=res, preemptible=preempt)

    # -- main loop --------------------------------------------------------------
    def run(
        self,
        duration_s: float,
        stop_on_normal_failure: bool = False,
        sample_every_s: float = 300.0,
    ) -> SimMetrics:
        if self.fleet.admission is not None:
            return self._run_streaming(duration_s, stop_on_normal_failure,
                                       sample_every_s)
        self._push(self.rng.exponential(1.0 / self.workload.arrival_rate_per_s), "arrival")
        if self.fleet.policy.relocation_on:
            self._push(self.fleet.policy.relocate_every_s, "relocate")
        next_sample = 0.0
        while self._heap:
            ev = heapq.heappop(self._heap)
            # The buffer must drain before anything that observes or mutates
            # fleet state out of arrival order: a departure/failure event, a
            # departure generated by a buffered arrival (min_dep), a sample
            # point, end-of-run, or a full batch.
            if self._pending and (
                ev.kind != "arrival"
                or ev.time > duration_s
                or ev.time >= self._min_dep
                or ev.time >= next_sample
                or len(self._pending) >= self.batch_max
            ):
                heapq.heappush(self._heap, _Event(ev.time, ev.seq, ev.kind, ev.payload))
                failed_normal = self._flush()
                if failed_normal and stop_on_normal_failure:
                    break
                continue
            if ev.time > duration_s:
                break
            self.now = ev.time
            if self.now >= next_sample:
                self._sample()
                next_sample = self.now + sample_every_s
            if ev.kind == "arrival":
                req = self._draw_request()
                lifetime = self._draw_lifetime()
                self._pending.append((self.now, req, lifetime))
                self._min_dep = min(self._min_dep, self.now + lifetime)
                self._push(
                    self.now + self.rng.exponential(1.0 / self.workload.arrival_rate_per_s),
                    "arrival",
                )
            elif ev.kind == "departure":
                self.fleet.depart(self._depart_id(ev.payload), now=self.now)
            elif ev.kind == "fail_host":
                self.fleet.fail_host(ev.payload, now=self.now)
            elif ev.kind == "heal_host":
                self.fleet.heal_host(ev.payload)
            elif ev.kind == "zone_storm":
                self._zone_storm(*ev.payload)
            elif ev.kind == "regime_on":
                self._regime_on(ev.payload)
            elif ev.kind == "relocate":
                self.fleet.relocate(self.now)
                self._push(self.now + self.fleet.policy.relocate_every_s, "relocate")
        if self._pending:
            self._flush()
        self._sample()
        self._fold_relocation_metrics()
        return self.metrics

    def _depart_id(self, iid: str) -> str:
        """Follow a departure event's id through the relocation chain: a
        relocated instance's departure reaps its replacement (and that one's
        replacement, if it moved again)."""
        relocated = self.fleet.relocated_ids
        while iid in relocated:
            iid = relocated[iid]
        return iid

    def _fold_relocation_metrics(self) -> None:
        rs = self.fleet.relocation
        self.metrics.relocation_passes = rs.passes
        self.metrics.relocations = rs.relocated
        self.metrics.relocation_failed = rs.failed
        self.metrics.relocation_lost = rs.lost_victims

    def _flush(self) -> bool:
        """Decide the buffered arrivals in one batch.  Returns True when a
        normal request failed (the paper's stop signal)."""
        items = [(req, t, 1.0) for t, req, _ in self._pending]
        t0 = _time.perf_counter()
        outcomes = self.fleet.schedule_batch(items)
        per_req = (_time.perf_counter() - t0) / len(items)
        failed_normal = False
        for (t, req, lifetime), out in zip(self._pending, outcomes):
            self.metrics.sched_latency_s.append(per_req)
            self.metrics.preemptions += len(out.victims)
            if not out.ok:
                if req.preemptible:
                    self.metrics.failures_preemptible += 1
                else:
                    self.metrics.failures_normal += 1
                    failed_normal = True
                continue
            if req.preemptible:
                self.metrics.placed_preemptible += 1
            else:
                self.metrics.placed_normal += 1
            self._push(t + lifetime, "departure", out.instance.id)
        self._pending.clear()
        self._min_dep = float("inf")
        return failed_normal

    # -- pre-materialised trace replay (the scan_sim oracle) --------------------
    def run_trace(self, trace, sample_every_s: float = 300.0) -> SimMetrics:
        """Replay an ``EventTrace`` (``core.scan_sim``) through this event
        loop: the oracle ``scan_sim.simulate_scan`` is held against.  The
        flush and sample rules are ``run``'s (a flush before a non-arrival,
        at a sample time and at ``batch_max``), but the events are the trace
        rows in index order instead of the heap and the rng.

        Returns ``SimMetrics``; ``self.trace_outcomes`` holds one
        ``(host_idx, slot, ok, n_victims)`` row per trace row (-1/-1/0/0 for
        non-arrival rows), as ``ScanResult.host/slot/ok/n_kill``.

        With ``policy.queue_capacity > 0`` the replay is in streaming
        admission mode (``_run_trace_streaming``)."""
        from . import scan_sim as ss

        fleet = self.fleet
        if fleet.policy.relocation_on:
            raise NotImplementedError(
                "run_trace: the relocation plane rewrites instance ids "
                "mid-trace; run it via SoASimulator.run"
            )
        if fleet.admission is not None:
            return self._run_trace_streaming(trace, sample_every_s)
        e = trace.n_events
        inv_dom = {i: name for name, i in fleet.domain_ids.items()}
        #: arrival row -> live instance id (None = rejected / never placed)
        iids: List[Optional[str]] = [None] * e
        self.trace_outcomes = np.full((e, 4), -1, np.int64)
        self.trace_outcomes[:, 2:] = 0
        pending: List[int] = []  # buffered arrival row indices
        next_sample = 0.0

        def flush() -> None:
            items = []
            for row in pending:
                req = self._trace_request(trace, row, inv_dom)
                items.append((req, float(trace.time[row]), float(trace.price[row])))
            outcomes = fleet.schedule_batch(items)
            for row, out in zip(pending, outcomes):
                self.metrics.preemptions += len(out.victims)
                pre = bool(trace.preemptible[row])
                if out.ok:
                    iids[row] = out.instance.id
                    h = fleet.index[out.instance.host]
                    s = out.instance.metadata.get("slot", -1)
                    self.trace_outcomes[row] = (h, s, 1, len(out.victims))
                    if pre:
                        self.metrics.placed_preemptible += 1
                    else:
                        self.metrics.placed_normal += 1
                else:
                    self.trace_outcomes[row] = (-1, -1, 0, len(out.victims))
                    if pre:
                        self.metrics.failures_preemptible += 1
                    else:
                        self.metrics.failures_normal += 1
            pending.clear()

        for row in range(e):
            kind = int(trace.kind[row])
            t = float(trace.time[row])
            if pending and (
                kind != ss.ARRIVAL
                or t >= next_sample
                or len(pending) >= self.batch_max
            ):
                flush()
            self.now = t
            if self.now >= next_sample:
                self._sample()
                next_sample = self.now + sample_every_s
            if kind == ss.ARRIVAL:
                pending.append(row)
            else:
                self._trace_event(trace, row, kind, iids)
        if pending:
            flush()
        self._sample()
        return self.metrics

    def _trace_event(self, trace, row: int, kind: int, iids) -> None:
        """A non-arrival trace row on the fleet (both replay modes)."""
        from . import scan_sim as ss

        fleet = self.fleet
        if kind in (ss.DEPARTURE, ss.CHECKPOINT):
            iid = iids[int(trace.inst_id[row])]
            if iid is None:
                return
            if kind == ss.DEPARTURE:
                fleet.depart(self._depart_id(iid), now=self.now)
            else:
                fleet.checkpoint(iid, now=self.now)
        elif kind == ss.FAIL_HOST:
            fleet.fail_host(fleet.names[int(trace.host[row])], now=self.now)
        elif kind == ss.HEAL_HOST:
            fleet.heal_host(fleet.names[int(trace.host[row])])
        elif kind == ss.ZONE_STORM:
            self._trace_storm(int(trace.zone[row]), float(trace.frac[row]))

    def _trace_request(self, trace, row: int, inv_dom) -> Request:
        kind_id = int(trace.cost_kind[row])
        period = float(trace.period[row])
        dom_id = int(trace.domain[row])
        prio = int(trace.priority[row])
        return Request(
            id=f"e{row}",
            resources=Resources(self.fleet.spec, np.asarray(trace.res[row])),
            preemptible=bool(trace.preemptible[row]),
            domain=None if dom_id < 0 else inv_dom[dom_id],
            cost_kind=None if kind_id < 0 else COST_KINDS[kind_id],
            period=None if period <= 0 else period,
            priority=None if prio < 0 else prio,
        )

    def _trace_storm(self, zone_id: int, kill_frac: float) -> int:
        """The trace replay's storm (no rng, unlike ``_zone_storm``): kill
        the ``n`` lowest ``(host, slot)`` live preemptible slots of the
        zone, ``n = min(max(1, round_f32(count * frac)), count)``, the rule
        ``scan_sim``'s storm computes on the device."""
        fleet = self.fleet
        victims = sorted(
            (h, slot, iid)
            for iid, (h, slot) in fleet.locator.items()
            if slot is not None and fleet.zone_ids[fleet.zones[h]] == zone_id
        )
        self.metrics.storms += 1
        if not victims:
            return 0
        n = min(
            max(1, int(np.round(np.float32(len(victims)) * np.float32(kill_frac)))),
            len(victims),
        )
        killed = 0
        for _, _, iid in victims[:n]:
            killed += bool(fleet.preempt_instance(iid, now=self.now))
        self.metrics.storm_kills += killed
        return killed

    # -- pre-materialised trace replay, streaming admission mode ---------------
    def _run_trace_streaming(self, trace, sample_every_s: float) -> SimMetrics:
        """Streaming-mode trace replay: the oracle for ``scan_sim``'s
        admission plane.

        Every drain blocks and fires at an event boundary on the scan's
        triggers, in this order: (1) before the event, when its time reaches
        the oldest waiting arrival's f32 SLO deadline (at most once a
        boundary); (2) after an arrival, when a full ``admit_batch`` waits;
        (3) after a departure, failure, heal or storm while anything waits.
        Placements count under the request's effective (demoted)
        preemptible flag, rejections under the trace's own flag, as the
        scan's counters do."""
        from . import scan_sim as ss

        fleet = self.fleet
        front = fleet.admission
        policy = fleet.policy
        e = trace.n_events
        inv_dom = {i: name for name, i in fleet.domain_ids.items()}
        iids: List[Optional[str]] = [None] * e
        self.trace_outcomes = np.full((e, 4), -1, np.int64)
        self.trace_outcomes[:, 2:] = 0
        next_sample = 0.0
        slo32 = np.float32(policy.slo_target_s)

        def handle(dr) -> None:
            for out in dr.outcomes:
                req = out.request
                row = int(req.id[1:])
                self.metrics.preemptions += len(out.victims)
                iids[row] = out.instance.id
                h = fleet.index[out.instance.host]
                s = out.instance.metadata.get("slot", -1)
                self.trace_outcomes[row] = (h, s, 1, len(out.victims))
                if req.preemptible:  # the effective flag (a storm demotes)
                    self.metrics.placed_preemptible += 1
                else:
                    self.metrics.placed_normal += 1
            for req in dr.rejected:
                if bool(trace.preemptible[int(req.id[1:])]):  # the trace's flag
                    self.metrics.failures_preemptible += 1
                else:
                    self.metrics.failures_normal += 1

        freeing = (ss.DEPARTURE, ss.FAIL_HOST, ss.HEAL_HOST, ss.ZONE_STORM)
        for row in range(e):
            kind = int(trace.kind[row])
            t = float(trace.time[row])
            self.now = t
            if self.now >= next_sample:
                self._sample()
                next_sample = self.now + sample_every_s
            oldest = front.oldest_enq_t()
            if oldest is not None and np.float32(t) >= np.float32(oldest) + slo32:
                handle(front.drain(self.now, block=True))
            if kind == ss.ARRIVAL:
                front.submit(
                    self._trace_request(trace, row, inv_dom), self.now,
                    price=float(trace.price[row]),
                )
                if front.waiting >= policy.admit_batch:
                    handle(front.drain(self.now, block=True))
                continue
            self._trace_event(trace, row, kind, iids)
            if kind in freeing and front.waiting:
                handle(front.drain(self.now, block=True))
        for dr in front.drain_all(self.now):
            handle(dr)
        self._sample()
        return self.metrics

    # -- streaming admission mode (policy.queue_capacity > 0) -------------------
    def _run_streaming(
        self,
        duration_s: float,
        stop_on_normal_failure: bool,
        sample_every_s: float,
    ) -> SimMetrics:
        front = self.fleet.admission
        self._push(self.rng.exponential(1.0 / self.workload.arrival_rate_per_s), "arrival")
        if self.fleet.policy.relocation_on:
            self._push(self.fleet.policy.relocate_every_s, "relocate")
        next_sample = 0.0
        while self._heap:
            ev = heapq.heappop(self._heap)
            if ev.time > duration_s:
                break
            self.now = ev.time
            if self.now >= next_sample:
                front.sync()  # mirror current before observing state
                self._sample()
                next_sample = self.now + sample_every_s
            if ev.kind == "arrival":
                req = self._draw_request()
                self._lifetimes[req.id] = self._draw_lifetime()
                front.submit(req, self.now)
                # SLO tick: by this time the arrival must have been drained
                self._push(self.now + front.policy.slo_target_s, "drain")
                self._push(
                    self.now + self.rng.exponential(1.0 / self.workload.arrival_rate_per_s),
                    "arrival",
                )
                if front.batch_ready():
                    front.drain(self.now, block=False)
            elif ev.kind == "drain":
                deadline = front.next_deadline()
                if deadline is not None and deadline <= self.now + 1e-9:
                    front.drain(self.now, block=False)
            elif ev.kind == "departure":
                front.sync()  # the instance id must exist in the mirror
                self.fleet.depart(self._depart_id(ev.payload), now=self.now)
                if front.waiting:  # backfill the freed capacity
                    front.drain(self.now, block=False)
            elif ev.kind == "fail_host":
                front.sync()
                self.fleet.fail_host(ev.payload, now=self.now)
                if front.waiting:
                    front.drain(self.now, block=False)
            elif ev.kind == "heal_host":
                self.fleet.heal_host(ev.payload)
                if front.waiting:
                    front.drain(self.now, block=False)
            elif ev.kind == "zone_storm":
                front.sync()  # the mirror must be current before the kills
                self._zone_storm(*ev.payload)
                if front.waiting:  # a storm frees capacity: backfill
                    front.drain(self.now, block=False)
            elif ev.kind == "regime_on":
                self._regime_on(ev.payload)
            elif ev.kind == "relocate":
                front.sync()  # the mirror must be current to pick victims
                self.fleet.relocate(self.now)
                self._push(self.now + self.fleet.policy.relocate_every_s, "relocate")
                if front.waiting:  # dispatch the queued re-placements
                    front.drain(self.now, block=False)
            failed_normal = self._handle_drain_results(front.take_results())
            if failed_normal and stop_on_normal_failure:
                break
        # end of run: every waiting request gets its retries; results banked
        # by an earlier sync come first, so the fold stays in time order
        epilogue = front.drain_all(self.now)
        self._handle_drain_results(front.take_results() + epilogue)
        self._sample()
        # the per-request latency here is the wall-clock admission latency
        # (submit → outcome absorbed), not a per-flush mean
        self.metrics.sched_latency_s = list(front.stats.wall_wait_s)
        self._fold_relocation_metrics()
        return self.metrics

    def _handle_drain_results(self, results) -> bool:
        """Fold absorbed drain results into metrics and departure events.
        Returns True when a normal request was rejected (the stop signal)."""
        failed_normal = False
        for dr in results:
            for out in dr.outcomes:
                req = out.request
                if "relocation" in req.metadata:
                    # settled by the relocation plane; the moved instance
                    # keeps its departure event through relocated_ids
                    continue
                self.metrics.preemptions += len(out.victims)
                if req.preemptible:
                    self.metrics.placed_preemptible += 1
                else:
                    self.metrics.placed_normal += 1
                lifetime = self._lifetimes.pop(req.id, None)
                if lifetime is not None:
                    self._push(dr.now + lifetime, "departure", out.instance.id)
            for req in dr.rejected:
                if "relocation" in req.metadata:
                    continue  # never-worse: the victim stays; no failure
                self._lifetimes.pop(req.id, None)
                if req.preemptible:
                    self.metrics.failures_preemptible += 1
                else:
                    self.metrics.failures_normal += 1
                    failed_normal = True
        return failed_normal

    # -- fault injection ----------------------------------------------------------
    def inject_host_failure(self, host_name: str, at_s: float, heal_after_s: float = 0.0):
        self._push(at_s, "fail_host", host_name)
        if heal_after_s:
            self._push(at_s + heal_after_s, "heal_host", host_name)

    def inject_stragglers(self, fraction: float, slow_factor: float = 3.0):
        n = max(1, int(self.fleet.n_hosts * fraction))
        for h in self.rng.choice(self.fleet.n_hosts, size=n, replace=False):
            self.fleet.set_slow(self.fleet.names[int(h)], slow_factor)

    def _check_zone(self, zone: str) -> None:
        if zone not in self.fleet.zone_ids:
            raise ValueError(
                f"unknown zone {zone!r}; fleet zones: {sorted(self.fleet.zone_ids)}")

    def inject_zone_storm(self, zone: str, at_s: float, kill_frac: float = 1.0) -> None:
        """Schedule one correlated preemption storm: at ``at_s`` a seeded
        ``kill_frac`` of the zone's live preemptible instances are reclaimed
        at once (``SoAFleet.preempt_instance``), charged to the zone's churn
        accumulators."""
        self._check_zone(zone)
        if not 0.0 < kill_frac <= 1.0:
            raise ValueError(f"kill_frac must be in (0, 1], got {kill_frac}")
        self._push(at_s, "zone_storm", (zone, float(kill_frac)))

    def inject_churn_regime(
        self,
        zone: str,
        until_s: float,
        mean_on_s: float = 600.0,
        mean_off_s: float = 3600.0,
        storm_every_s: float = 120.0,
        kill_frac: float = 0.25,
        start_s: float = 0.0,
    ) -> None:
        """Markov on/off churn regime for one zone: calm phases
        (exponential, mean ``mean_off_s``) alternate with stormy ones
        (exponential, mean ``mean_on_s``) in which a ``kill_frac`` reclaim
        wave fires every ``storm_every_s``.  Deterministic given the seed."""
        self._check_zone(zone)
        payload = {
            "zone": zone,
            "until_s": float(until_s),
            "mean_on_s": float(mean_on_s),
            "mean_off_s": float(mean_off_s),
            "storm_every_s": float(storm_every_s),
            "kill_frac": float(kill_frac),
        }
        self._push(start_s + self.rng.exponential(payload["mean_off_s"]),
                   "regime_on", payload)

    def _regime_on(self, payload: Dict[str, float]) -> None:
        """Enter one stormy phase: lay down its storm ticks, then schedule
        the next phase after a calm gap."""
        if self.now >= payload["until_s"]:
            return
        end = min(self.now + self.rng.exponential(payload["mean_on_s"]),
                  payload["until_s"])
        t = self.now
        while t < end:
            self._push(t, "zone_storm", (payload["zone"], payload["kill_frac"]))
            t += payload["storm_every_s"]
        nxt = end + self.rng.exponential(payload["mean_off_s"])
        if nxt < payload["until_s"]:
            self._push(nxt, "regime_on", payload)

    def _zone_storm(self, zone: str, kill_frac: float) -> int:
        """Reclaim a seeded ``kill_frac`` of the zone's live preemptible
        instances now (victims by sorted id, then the draw).  Returns the
        kill count."""
        fleet = self.fleet
        victims = sorted(iid for iid, (h, slot) in fleet.locator.items()
                         if slot is not None and fleet.zones[h] == zone)
        self.metrics.storms += 1
        if not victims:
            return 0
        n = max(1, int(round(len(victims) * kill_frac)))
        picks = self.rng.choice(len(victims), size=min(n, len(victims)), replace=False)
        killed = 0
        for i in np.sort(picks):
            killed += bool(fleet.preempt_instance(victims[int(i)], now=self.now))
        self.metrics.storm_kills += killed
        return killed

    def _sample(self) -> None:
        self.metrics.t.append(self.now)
        self.metrics.utilization.append(self.fleet.utilization())
        self.metrics.utilization_normal.append(self.fleet.utilization_normal())
