"""Trace-driven simulator on the fleet's device (port of
``repro.core.scan_sim``).

The JAX module folds a whole event stream into one jitted ``lax.scan``.  This
port keeps its contract and runs a **per-event Python loop** on the fleet's
device instead, not a scan: each event is the port's own transition
(``torch_scheduler._step_core``, ``apply_termination``, ``apply_departure``,
``apply_host_failure``, ``set_schedulable``), the fleet state and the live
normal resources stay on the device, and the per-arrival records, the
slot owners and the counters live on the host, since each decision already
reads its result back once (the admissibility fallback is a Python ``if``).
Folding the loop into one device program is later work and must never change
a result.

* ``EventTrace`` — a struct-of-arrays trace: one i32 ``kind`` column plus
  payload columns (time / size / duration / priority / cost kind / period /
  zone / instance id), numpy throughout (a copy of the JAX module's).
* ``trace_from_workload`` — replays the ``SoASimulator`` rng draw order, so
  a trace is the python simulator's event heap, materialised.
* ``simulate_scan(trace, policy, state)`` — the arrival / departure /
  failure / storm / checkpoint stream, sampled at ``sample_every_s``.
* ``simulate_ensemble`` — many trajectories over one starting state: a
  stacked-trace (seed) axis and optional weigher-multiplier and
  admission-knob axes, run lane after lane, each lane on its padded trace
  and its own clone of the state.

Streaming admission (``policy.queue_capacity > 0``) runs in the loop too:
arrivals ``queue_push`` into a wait queue on the fleet's device, and drains
(``queue_select`` with aging, storm demotion, a ``_step_core`` a taken row,
``queue_pop``) fire on the scan's triggers: the SLO deadline crossed (before
the event), a full batch after an arrival, capacity freed by a departure,
failure, heal or storm (after it); then a ``drain_all`` epilogue at the last
timestamp.  ``knobs`` replaces ``(aging_rate, slo_target_s,
storm_threshold)`` per run (``storm_threshold=inf`` turns demotion off).

``mult`` replaces the weigher multipliers by a row of values, and the
decision then rounds as the JAX package's program with traced multipliers
does (``screen_math._traced_chain``); on the card the screen kernel runs in
its traced mode.

Parity: on integer-time, integer-resource traces every result equals the
JAX module's bit for bit (final state, per-arrival outcomes, counters,
samples and, streaming, the admission counters, queue and waits), and the
port's own ``SoASimulator.run_trace`` too.  Scalars that the reference keeps
in f32 (deadlines, sample times, waits, the storm's kill count) are f32 here.

Storms are deterministic: a ``zone_storm`` row kills the ``n`` lowest
``(host, slot)`` live preemptible slots of its zone, ``n = min(max(1,
round_f32(count * frac)), count)``, and adds their uptime to the zone's U in
one sum (``SoASimulator._trace_storm`` kills them one at a time: equal on
integer traces whose uptime sums stay below 2^24).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .admission import AdmissionQueueState, queue_init, queue_pop, queue_push, queue_select
from .policy import COST_KINDS, SchedulerPolicy, ensure_policy
from .screen_math import churn_stats
from .simulator import SimMetrics, WorkloadSpec
from .torch_scheduler import (
    STATE_DTYPES,
    SoAFleetState,
    _step_core,
    apply_checkpoint,
    apply_departure,
    apply_host_failure,
    apply_termination,
    resolve_device,
    set_schedulable,
)

# -- event kinds --------------------------------------------------------------
ARRIVAL = 0
DEPARTURE = 1
FAIL_HOST = 2
HEAL_HOST = 3
CHECKPOINT = 4
ZONE_STORM = 5
PAD = 6

KIND_NAMES: Tuple[str, ...] = (
    "arrival", "departure", "fail_host", "heal_host", "checkpoint",
    "zone_storm", "pad",
)
KIND_IDS: Dict[str, int] = {name: i for i, name in enumerate(KIND_NAMES)}

#: float payload columns checked for NaN at construction (column, per-row)
_FLOAT_COLS = ("time", "duration", "period", "price", "frac")


@dataclasses.dataclass
class TraceEvent:
    """One decoded trace row (``EventTrace.events`` / ``from_events``)."""

    kind: str
    time: float
    res: Optional[Tuple[float, ...]] = None   # arrival size vector
    preemptible: bool = False
    duration: float = -1.0                    # arrival lifetime (s)
    priority: int = -1
    cost_kind: int = -1                       # COST_KIND_IDS id, -1 = default
    period: float = -1.0
    price: float = 1.0
    domain: int = -1
    zone: int = -1                            # zone_storm target
    frac: float = 0.0                         # zone_storm kill fraction
    inst_id: int = -1                         # departure/checkpoint: arrival row
    host: int = -1                            # fail/heal target host index


@dataclasses.dataclass(frozen=True)
class EventTrace:
    """Struct-of-arrays event trace: ``kind`` i32 + payload columns.

    Rows are time-ordered (non-decreasing).  Non-applicable payloads hold
    sentinel defaults (-1 / 0 / 1.0) so every column is dense.
    """

    kind: np.ndarray          # (E,)   i32  event kind (KIND_NAMES index)
    time: np.ndarray          # (E,)   f32  event time (s)
    res: np.ndarray           # (E,D)  f32  arrival size vector
    preemptible: np.ndarray   # (E,)   bool arrival preemptible flag
    duration: np.ndarray      # (E,)   f32  arrival lifetime (-1 = n/a)
    priority: np.ndarray      # (E,)   i32  arrival priority (-1 = none)
    cost_kind: np.ndarray     # (E,)   i32  COST_KIND_IDS id (-1 = default)
    period: np.ndarray        # (E,)   f32  billing period (-1 = default)
    price: np.ndarray         # (E,)   f32  price rate
    domain: np.ndarray        # (E,)   i32  anti-affinity domain id (-1 = none)
    zone: np.ndarray          # (E,)   i32  storm target zone (-1 = n/a)
    frac: np.ndarray          # (E,)   f32  storm kill fraction
    inst_id: np.ndarray       # (E,)   i32  departure/checkpoint target =
                              #             ARRIVAL ROW INDEX (-1 = n/a)
    host: np.ndarray          # (E,)   i32  fail/heal target host (-1 = n/a)

    def __post_init__(self):
        coerce = {
            "kind": np.int32, "time": np.float32, "res": np.float32,
            "preemptible": np.bool_, "duration": np.float32,
            "priority": np.int32, "cost_kind": np.int32,
            "period": np.float32, "price": np.float32, "domain": np.int32,
            "zone": np.int32, "frac": np.float32, "inst_id": np.int32,
            "host": np.int32,
        }
        for name, dt in coerce.items():
            object.__setattr__(
                self, name, np.ascontiguousarray(getattr(self, name), dt)
            )
        e = self.kind.shape[0]
        for name in coerce:
            col = getattr(self, name)
            want = 2 if name == "res" else 1
            if col.ndim != want or col.shape[0] != e:
                raise ValueError(
                    f"trace column {name!r} has shape {col.shape}, expected "
                    f"{e} rows ({want}-d)"
                )
        bad = np.nonzero((self.kind < 0) | (self.kind > PAD))[0]
        if bad.size:
            i = int(bad[0])
            raise ValueError(
                f"unknown event kind {int(self.kind[i])} at row {i} "
                f"(valid: 0..{PAD} = {KIND_NAMES})"
            )
        if not np.all(np.isfinite(self.time)):
            i = int(np.nonzero(~np.isfinite(self.time))[0][0])
            raise ValueError(f"non-finite time at row {i}")
        if e and float(self.time[0]) < 0.0:
            raise ValueError("negative time at row 0")
        drop = np.nonzero(np.diff(self.time) < 0)[0]
        if drop.size:
            i = int(drop[0])
            raise ValueError(
                f"unsorted times: time[{i + 1}]={float(self.time[i + 1])!r} < "
                f"time[{i}]={float(self.time[i])!r}"
            )
        for name in _FLOAT_COLS[1:] + ("res",):
            col = getattr(self, name)
            nan = np.nonzero(np.isnan(col).reshape(e, -1).any(axis=1))[0]
            if nan.size:
                raise ValueError(
                    f"NaN payload in column {name!r} at row {int(nan[0])}"
                )
        bad = np.nonzero(
            (self.cost_kind < -1) | (self.cost_kind >= len(COST_KINDS))
        )[0]
        if bad.size:
            i = int(bad[0])
            raise ValueError(
                f"unknown cost kind id {int(self.cost_kind[i])} at row {i}"
            )
        arr = self.kind == ARRIVAL
        if np.any(arr & ~np.all(np.isfinite(self.res), axis=1)):
            i = int(np.nonzero(arr & ~np.all(np.isfinite(self.res), axis=1))[0][0])
            raise ValueError(f"non-finite arrival size at row {i}")
        if np.any(arr & (self.res < 0).any(axis=1)):
            i = int(np.nonzero(arr & (self.res < 0).any(axis=1))[0][0])
            raise ValueError(f"negative arrival size at row {i}")
        for k, what in ((DEPARTURE, "departure"), (CHECKPOINT, "checkpoint")):
            rows = np.nonzero(self.kind == k)[0]
            for i in rows:
                tgt = int(self.inst_id[i])
                if not 0 <= tgt < e or int(self.kind[tgt]) != ARRIVAL:
                    raise ValueError(
                        f"{what} at row {int(i)} targets inst_id={tgt}, "
                        f"which is not an arrival row"
                    )
                if float(self.time[tgt]) > float(self.time[i]):
                    raise ValueError(
                        f"{what} at row {int(i)} precedes its arrival "
                        f"(row {tgt})"
                    )
        for k, what in ((FAIL_HOST, "fail_host"), (HEAL_HOST, "heal_host")):
            rows = np.nonzero((self.kind == k) & (self.host < 0))[0]
            if rows.size:
                raise ValueError(
                    f"{what} at row {int(rows[0])} has no host index"
                )
        rows = np.nonzero(self.kind == ZONE_STORM)[0]
        for i in rows:
            if int(self.zone[i]) < 0:
                raise ValueError(f"zone_storm at row {int(i)} has no zone")
            f = float(self.frac[i])
            if not 0.0 < f <= 1.0:
                raise ValueError(
                    f"zone_storm at row {int(i)} has kill fraction {f!r} "
                    f"outside (0, 1]"
                )

    # -- views ----------------------------------------------------------------
    @property
    def n_events(self) -> int:
        return int(self.kind.shape[0])

    @property
    def n_dims(self) -> int:
        return int(self.res.shape[1])

    def events(self) -> List[TraceEvent]:
        """Decode to a python event list (inverse of ``from_events``)."""
        out = []
        for i in range(self.n_events):
            k = int(self.kind[i])
            out.append(TraceEvent(
                kind=KIND_NAMES[k],
                time=float(self.time[i]),
                res=tuple(float(v) for v in self.res[i]) if k == ARRIVAL else None,
                preemptible=bool(self.preemptible[i]),
                duration=float(self.duration[i]),
                priority=int(self.priority[i]),
                cost_kind=int(self.cost_kind[i]),
                period=float(self.period[i]),
                price=float(self.price[i]),
                domain=int(self.domain[i]),
                zone=int(self.zone[i]),
                frac=float(self.frac[i]),
                inst_id=int(self.inst_id[i]),
                host=int(self.host[i]),
            ))
        return out

    @classmethod
    def from_events(cls, events: Sequence[TraceEvent], n_dims: int) -> "EventTrace":
        """Encode a python event list (inverse of ``events``)."""
        e = len(events)
        cols = dict(
            kind=np.zeros(e, np.int32), time=np.zeros(e, np.float32),
            res=np.zeros((e, n_dims), np.float32),
            preemptible=np.zeros(e, bool),
            duration=np.full(e, -1.0, np.float32),
            priority=np.full(e, -1, np.int32),
            cost_kind=np.full(e, -1, np.int32),
            period=np.full(e, -1.0, np.float32),
            price=np.ones(e, np.float32),
            domain=np.full(e, -1, np.int32),
            zone=np.full(e, -1, np.int32),
            frac=np.zeros(e, np.float32),
            inst_id=np.full(e, -1, np.int32),
            host=np.full(e, -1, np.int32),
        )
        for i, ev in enumerate(events):
            if ev.kind not in KIND_IDS:
                raise ValueError(f"unknown event kind {ev.kind!r} at row {i}")
            cols["kind"][i] = KIND_IDS[ev.kind]
            cols["time"][i] = ev.time
            if ev.res is not None:
                cols["res"][i] = np.asarray(ev.res, np.float32)
            cols["preemptible"][i] = ev.preemptible
            cols["duration"][i] = ev.duration
            cols["priority"][i] = ev.priority
            cols["cost_kind"][i] = ev.cost_kind
            cols["period"][i] = ev.period
            cols["price"][i] = ev.price
            cols["domain"][i] = ev.domain
            cols["zone"][i] = ev.zone
            cols["frac"][i] = ev.frac
            cols["inst_id"][i] = ev.inst_id
            cols["host"][i] = ev.host
        return cls(**cols)

    def padded(self, to: int) -> "EventTrace":
        """Right-pad with PAD rows at the trace's final time (no-ops on both
        engines, but each still takes a sample) so unequal-length traces
        share one length on an ensemble axis."""
        e = self.n_events
        if to < e:
            raise ValueError(f"cannot pad {e} events down to {to}")
        if to == e:
            return self
        tail = to - e
        t_last = float(self.time[-1]) if e else 0.0
        base = EventTrace.from_events(
            [TraceEvent(kind="pad", time=t_last)], self.n_dims
        )
        cols = {
            f.name: np.concatenate(
                [getattr(self, f.name),
                 np.repeat(getattr(base, f.name), tail, axis=0)]
            )
            for f in dataclasses.fields(self)
        }
        return EventTrace(**cols)


def stack_traces(traces: Sequence[EventTrace]) -> Dict[str, np.ndarray]:
    """Stack traces on a leading ensemble axis, right-padding with PAD rows."""
    if not traces:
        raise ValueError("stack_traces needs at least one trace")
    d = traces[0].n_dims
    if any(t.n_dims != d for t in traces):
        raise ValueError("traces disagree on resource dimensionality")
    emax = max(t.n_events for t in traces)
    padded = [t.padded(emax) for t in traces]
    return {
        f.name: np.stack([getattr(t, f.name) for t in padded])
        for f in dataclasses.fields(EventTrace)
    }


# -- workload encoder ---------------------------------------------------------
def trace_from_workload(
    workload: WorkloadSpec,
    duration_s: float,
    seed: int = 0,
    *,
    integer_times: bool = True,
    storms: Sequence[Tuple[float, int, float]] = (),
    failures: Sequence[Tuple[float, int, Optional[float]]] = (),
    checkpoint_every: int = 0,
    cost_kinds: Sequence[int] = (),
    priorities: Sequence[int] = (),
) -> EventTrace:
    """Pre-materialise a ``SoASimulator`` workload as an ``EventTrace``.

    Replays the simulator's exact rng draw order (initial inter-arrival
    exponential; per arrival: flavor choice, preemptible uniform, <=64
    truncated lifetime exponentials, next inter-arrival), then lowers the
    event heap into time-sorted rows:

    * arrivals carry size/preemptible/duration (+ optional round-robin
      ``cost_kinds`` / ``priorities`` assignment for mixed-billing traces);
    * each placed lifetime emits a ``departure`` row whose ``inst_id`` is
      the ARRIVAL ROW INDEX (resolved to a live instance at run time);
    * ``storms`` = (time, zone_id, kill_frac), ``failures`` = (time,
      host_idx, heal_after_s|None) inject fault rows;
    * ``checkpoint_every=k`` adds a mid-life checkpoint row for every k-th
      preemptible arrival.

    ``integer_times=True`` floors every event time and rounds lifetimes to
    whole seconds: the regime in which the engines agree bit for bit (f32
    integer sums are exact under any association).
    """
    if not workload.flavors:
        raise ValueError("trace_from_workload needs workload.flavors")
    rng = np.random.default_rng(seed)
    w = workload
    names = [f[0] for f in w.flavors]
    d = len(w.flavors[0][1].vec)

    def draw_lifetime() -> float:
        for _ in range(64):
            x = rng.exponential(w.lifetime_mean_s)
            if w.lifetime_min_s <= x <= w.lifetime_max_s:
                return x
        return float(np.clip(x, w.lifetime_min_s, w.lifetime_max_s))

    def q(t: float) -> float:
        return float(np.floor(t)) if integer_times else float(t)

    events: List[Tuple[float, int, TraceEvent]] = []
    seq = 0

    def emit(t: float, ev: TraceEvent) -> None:
        nonlocal seq
        ev.time = t
        events.append((t, seq, ev))
        seq += 1

    arrivals: List[TraceEvent] = []
    t = rng.exponential(1.0 / w.arrival_rate_per_s)
    n_arr = 0
    while t <= duration_s:
        now = q(t)
        idx = rng.choice(len(names), p=w.flavor_probs)
        _, res = w.flavors[idx]
        preempt = bool(rng.random() < w.preemptible_fraction)
        life = draw_lifetime()
        if integer_times:
            life = max(1.0, float(np.round(life)))
        ev = TraceEvent(
            kind="arrival", time=now,
            res=tuple(float(v) for v in res.vec32),
            preemptible=preempt, duration=life,
            cost_kind=(cost_kinds[n_arr % len(cost_kinds)] if cost_kinds else -1),
            priority=(priorities[n_arr % len(priorities)] if priorities else -1),
        )
        if ev.cost_kind == COST_KINDS.index("period"):
            ev.period = max(60.0, float(np.round(life / 4.0)))
        elif ev.cost_kind == COST_KINDS.index("revenue"):
            ev.period = 3600.0
        emit(now, ev)
        arrivals.append(ev)
        dep_t = now + life
        if dep_t <= duration_s:
            emit(dep_t, TraceEvent(kind="departure", time=dep_t))
            events[-1][2].inst_id = len(arrivals) - 1  # remapped to a row below
        if preempt and checkpoint_every and n_arr % checkpoint_every == 0:
            ck_t = q(now + life / 2.0)
            if ck_t <= min(dep_t, duration_s):
                emit(ck_t, TraceEvent(kind="checkpoint", time=ck_t))
                events[-1][2].inst_id = len(arrivals) - 1
        n_arr += 1
        t += rng.exponential(1.0 / w.arrival_rate_per_s)
    for at, zone, frac in storms:
        emit(q(at), TraceEvent(kind="zone_storm", time=q(at), zone=int(zone),
                               frac=float(frac)))
    for at, host, heal_after in failures:
        emit(q(at), TraceEvent(kind="fail_host", time=q(at), host=int(host)))
        if heal_after is not None:
            ht = q(at + heal_after)
            emit(ht, TraceEvent(kind="heal_host", time=ht, host=int(host)))
    events.sort(key=lambda x: (x[0], x[1]))
    # inst_id currently indexes `arrivals`; remap to sorted row indices
    row_of = {id(ev): i for i, (_, _, ev) in enumerate(events)}
    ordered = [ev for _, _, ev in events]
    for ev in ordered:
        if ev.kind in ("departure", "checkpoint") and ev.inst_id >= 0:
            ev.inst_id = row_of[id(arrivals[ev.inst_id])]
    return EventTrace.from_events(ordered, d)


# -- results --------------------------------------------------------------------
_COUNTER_NAMES = (
    "placed_normal", "placed_preemptible", "failures_normal",
    "failures_preemptible", "preemptions", "storms", "storm_kills",
)
_ADM_NAMES = (
    "arrivals", "admitted", "rejected_overflow", "rejected_retry", "drains",
    "retries", "degraded",
)


@dataclasses.dataclass
class ScanResult:
    """Host-side view of one trajectory.

    Streaming runs (``policy.queue_capacity > 0``) also carry the final
    queue (on the fleet's device), the admission counters (the keys of
    ``AdmissionStats.summary()``'s integer counters) and the per-arrival
    sim-time queue wait (``-1`` = never placed); they are ``None`` on direct
    runs.
    """

    state: SoAFleetState
    host: np.ndarray       # (E,) i32 winning host per arrival row (-1)
    slot: np.ndarray       # (E,) i32 winning slot (-1 = normal / rejected)
    ok: np.ndarray         # (E,) bool placement succeeded
    n_kill: np.ndarray     # (E,) i32 victims evacuated by the placement
    counters: Dict[str, int]
    sample_t: np.ndarray        # (S,) f32 sample times
    sample_free0: np.ndarray    # (S,) f32 sum(free_f[:, 0]) at each sample
    sample_free0_normal: np.ndarray  # (S,) f32 sum(free_n[:, 0])
    #: final wait queue (streaming only)
    queue: Optional[AdmissionQueueState] = None
    #: arrivals / admitted / rejected_overflow / rejected_retry / drains /
    #: retries / degraded / queue_depth
    admission: Optional[Dict[str, int]] = None
    #: (E,) f32 sim-time enqueue→absorb wait per arrival row (-1 = never
    #: placed: rejected, or a non-arrival row)
    wait_s: Optional[np.ndarray] = None
    #: decisions run and, of those, admissibility fallbacks (the full
    #: enumeration): what the run's kernel launches follow from
    decisions: int = 0
    fallbacks: int = 0

    def wait_percentiles(self) -> Dict[str, float]:
        """Sim-time queue-wait p50/p99 over the placed arrivals (the reader
        of ``AdmissionStats.wait_percentiles``, on the same f32 waits)."""
        if self.wait_s is None:
            return {"wait_p50_s": 0.0, "wait_p99_s": 0.0}
        w = np.asarray(self.wait_s)
        w = w[w >= 0.0]
        if not w.size:
            return {"wait_p50_s": 0.0, "wait_p99_s": 0.0}
        return {
            "wait_p50_s": float(np.percentile(w, 50)),
            "wait_p99_s": float(np.percentile(w, 99)),
        }

    def sim_metrics(self, cap0_total: float) -> SimMetrics:
        """``SimMetrics`` as the python loop builds them: the f32 free
        sums turned into utilisation in float64 on the host, as
        ``SoAFleet.utilization`` does.  ``sched_latency_s`` stays empty."""
        m = SimMetrics()
        for t, f, fn in zip(
            self.sample_t, self.sample_free0, self.sample_free0_normal
        ):
            m.t.append(float(t))
            if not cap0_total:
                m.utilization.append(0.0)
                m.utilization_normal.append(0.0)
            else:
                m.utilization.append((cap0_total - float(f)) / cap0_total)
                m.utilization_normal.append((cap0_total - float(fn)) / cap0_total)
        for name, val in self.counters.items():
            setattr(m, name, val)
        return m


# -- input checks ------------------------------------------------------------------
def _check_policy(policy: SchedulerPolicy, where: str) -> None:
    # everything else, the streaming admission plane included, runs in the
    # loop; docs/scan_sim.md#which-planes-scan has the support matrix
    if policy.relocation_on:
        raise NotImplementedError(
            f"{where}: the relocation plane runs host-side passes between "
            f"events (victim identity bookkeeping) and is not folded into "
            f"the trace loop; see docs/scan_sim.md#which-planes-scan"
        )
    if policy.mesh is not None:
        raise NotImplementedError(
            f"{where}: sharded fleet state is not supported under the scan; "
            f"see docs/scan_sim.md#which-planes-scan"
        )
    if policy.adaptive_shortlist:
        raise NotImplementedError(
            f"{where}: adaptive_shortlist mutates the policy between batches "
            f"(host-side controller) and cannot run inside one trajectory; "
            f"see docs/scan_sim.md#which-planes-scan"
        )


def _check_trace(trace: EventTrace, state: SoAFleetState,
                 policy: SchedulerPolicy) -> None:
    if state.mesh is not None:
        raise NotImplementedError(
            "sharded fleet state is not supported under the scan; see "
            "docs/scan_sim.md#which-planes-scan"
        )
    n = state.inst_valid.shape[0]
    n_zones = state.zone_term.shape[0]
    if trace.n_dims != state.free_f.shape[1]:
        raise ValueError(
            f"trace has {trace.n_dims} resource dims, fleet has "
            f"{state.free_f.shape[1]}"
        )
    fail = np.isin(trace.kind, (FAIL_HOST, HEAL_HOST))
    if np.any(fail & (trace.host >= n)):
        raise ValueError(f"fail/heal host index out of range (fleet has {n})")
    if np.any((trace.kind == ZONE_STORM) & (trace.zone >= n_zones)):
        raise ValueError(
            f"zone_storm zone index out of range (fleet has {n_zones} zones)"
        )
    table_ids = {-1} | {COST_KINDS.index(kname) for kname in policy.kind_table}
    arr = trace.kind == ARRIVAL
    bad = np.unique(trace.cost_kind[arr & ~np.isin(trace.cost_kind,
                                                   sorted(table_ids))])
    if bad.size:
        raise ValueError(
            f"trace bills by cost kind ids {bad.tolist()}, not in the "
            f"policy's kind table {policy.kind_table}"
        )
    if policy.queue_capacity:
        if np.any(arr & (trace.priority >= policy.n_classes)):
            i = int(np.nonzero(arr & (trace.priority >= policy.n_classes))[0][0])
            raise ValueError(
                f"arrival at row {i} has priority {int(trace.priority[i])} "
                f"outside the policy's {policy.n_classes} classes"
            )
        headroom = 1 << (32 - int(policy.n_classes).bit_length())
        if trace.n_events >= headroom:
            raise ValueError(
                f"trace has {trace.n_events} rows but the packed "
                f"queue_select key holds only {headroom} seq tickets at "
                f"n_classes={policy.n_classes}"
            )


def _check_mult(mult, policy: SchedulerPolicy) -> np.ndarray:
    gates = policy.all_multipliers
    mult = np.asarray(mult, np.float32)
    if mult.shape[-1] != len(gates):
        raise ValueError(
            f"multiplier rows must have {len(gates)} entries "
            f"(weigher + churn), got shape {mult.shape}"
        )
    flat = mult.reshape(-1, len(gates))
    for i, g in enumerate(gates):
        if g == 0.0 and np.any(flat[:, i] != 0.0):
            raise ValueError(
                f"multiplier column {i} must be 0 everywhere: the policy's "
                f"static multiplier gates that term off"
            )
        if i == 1 and g != 0.0 and np.any(np.sign(flat[:, i]) != np.sign(g)):
            raise ValueError(
                "termination multipliers on the ensemble axis must keep the "
                "static multiplier's sign (the screening bound side is "
                "chosen from it)"
            )
    if np.any(~np.isfinite(mult)):
        raise ValueError("non-finite multiplier on the ensemble axis")
    return mult


def _check_knobs(knobs, policy: SchedulerPolicy) -> np.ndarray:
    """Validate a ``(..., 3)`` array of admission-knob rows ``(aging_rate,
    slo_target_s, storm_threshold)``; ``storm_threshold = np.inf`` turns
    demotion off for that run (``churn > inf`` is never true)."""
    if not policy.queue_capacity:
        raise ValueError(
            "admission knobs need a streaming policy (queue_capacity > 0)"
        )
    knobs = np.asarray(knobs, np.float32)
    if knobs.shape[-1] != 3:
        raise ValueError(
            f"knob rows must be (aging_rate, slo_target_s, storm_threshold), "
            f"got shape {knobs.shape}"
        )
    flat = knobs.reshape(-1, 3)
    if np.any(~np.isfinite(flat[:, 0])) or np.any(flat[:, 0] < 0):
        raise ValueError("aging_rate knob must be finite and >= 0")
    if np.any(~np.isfinite(flat[:, 1])) or np.any(flat[:, 1] <= 0):
        raise ValueError("slo_target_s knob must be finite and > 0")
    if np.any(np.isnan(flat[:, 2])) or np.any(flat[:, 2] <= 0):
        raise ValueError(
            "storm_threshold knob must be > 0 (np.inf = degradation off)"
        )
    return knobs


# -- the event loop --------------------------------------------------------------
_C = {name: i for i, name in enumerate(_COUNTER_NAMES)}
_A = {name: i for i, name in enumerate(_ADM_NAMES)}


def _clone_state(state: SoAFleetState, device: torch.device) -> SoAFleetState:
    return SoAFleetState(**{
        f: getattr(state, f).to(device=device, copy=True) for f in STATE_DTYPES
    })


class _Run:
    """One trajectory: the fleet state and live normal resources on the
    device, every record of the reference's scan carry on the host."""

    def __init__(self, trace: EventTrace, policy: SchedulerPolicy,
                 state: SoAFleetState, normal_res, sample_every: np.float32,
                 mult: Optional[np.ndarray], knobs: Optional[np.ndarray]):
        self.trace, self.policy, self.st = trace, policy, state
        self.dev = dev = state.device
        e = trace.n_events
        n, k = state.inst_valid.shape
        self.e, self.n, self.k = e, n, k
        self.normal_res = normal_res
        self.res_dev = torch.from_numpy(trace.res).to(dev)
        self.sample_every = sample_every
        self.mult_val = None if mult is None else tuple(float(v) for v in mult)
        if knobs is not None:
            self.aging = float(knobs[0])
            self.slo = np.float32(knobs[1])
            self.storm_thr = np.float32(knobs[2])
        else:
            self.aging = policy.aging_rate
            self.slo = np.float32(policy.slo_target_s)
            self.storm_thr = (None if policy.storm_threshold is None
                              else np.float32(policy.storm_threshold))
        self.streaming = policy.queue_capacity > 0
        s1 = e + 1
        self.slot_owner = np.full((n, k), -1, np.int64)
        self.ev_host = np.full((s1,), -1, np.int64)
        self.ev_slot = np.full((s1,), -1, np.int64)
        self.ev_live = np.zeros((s1,), bool)
        self.counters = np.zeros((7,), np.int64)
        self.decisions = self.fallbacks = 0
        self.next_sample = np.float32(0.0)
        self.samples: List[Tuple[np.float32, np.float32, np.float32]] = []
        self.out = np.full((e, 4), -1, np.int64)
        self.out[:, 2:] = 0
        if self.streaming:
            cap = policy.queue_capacity
            self.q = queue_init(cap, state.free_f.shape[1], device=dev)
            self.depth = 0
            self.q_src = np.full((cap,), e, np.int64)
            self.ev_ok = np.zeros((s1,), bool)
            self.ev_kill = np.zeros((s1,), np.int64)
            self.ev_pre = np.zeros((s1,), bool)
            self.ev_wait = np.full((s1,), -1.0, np.float32)
            self.adm = np.zeros((7,), np.int64)
            self.next_deadline = np.float32(np.inf)

    # -- pieces shared by the branches ---------------------------------------
    def _free_sums(self) -> Tuple[np.float32, np.float32]:
        sums = torch.stack([self.st.free_f[:, 0].sum(), self.st.free_n[:, 0].sum()])
        f0, n0 = sums.cpu().numpy()
        return np.float32(f0), np.float32(n0)

    def record_sample(self, t: np.float32) -> None:
        if t >= self.next_sample:
            self.samples.append((t,) + self._free_sums())
            self.next_sample = np.float32(t + self.sample_every)

    def decide(self, src: int, res, pre: bool, dom: int, now: np.float32,
               price: float, kind: int, period: float, req_exclude):
        """One ``_step_core`` decision and the carry's bookkeeping of it.
        Returns ``(host, slot, ok, n_kill)`` as the reference's row."""
        policy = self.policy
        h, slot, ok, kill, fell_back, _ = _step_core(
            self.st, res, pre, dom, float(now), price, kind, period, policy,
            req_exclude=req_exclude, mult_val=self.mult_val,
        )
        self.decisions += 1
        self.fallbacks += int(fell_back)
        s, n_kill = -1, 0
        if ok and pre:
            s = int(slot)
            self.slot_owner[h, s] = src
        elif ok:
            kill_h = kill.cpu().numpy()
            n_kill = int(kill_h.sum())
            if n_kill:
                owners = self.slot_owner[h]
                dead = owners[kill_h & (owners >= 0)]
                self.ev_live[dead] = False
                owners[kill_h] = -1
            self.normal_res[h] += res
        c = self.counters
        if ok:
            c[_C["placed_preemptible" if pre else "placed_normal"]] += 1
        c[_C["preemptions"]] += n_kill
        return (h if ok else -1), s, ok, n_kill

    # -- the seven branches -----------------------------------------------------
    def arrival(self, e: int, t: np.float32) -> None:
        tr = self.trace
        pre = bool(tr.preemptible[e])
        if self.streaming:
            prio = int(tr.priority[e])
            klass = prio if prio >= 0 else (self.policy.n_classes - 1 if pre else 0)
            self.q, slot, okp = queue_push(
                self.q, self.res_dev[e], pre, int(tr.domain[e]),
                int(tr.cost_kind[e]), float(tr.period[e]), -1, klass, float(t),
                float(tr.price[e]),
            )
            slot, okp = (int(v) for v in torch.stack([slot.to(torch.int32),
                                                      okp.to(torch.int32)]).tolist())
            self.adm[_A["arrivals"]] += 1
            if okp:
                self.depth += 1
                self.q_src[slot] = e
                self.next_deadline = min(self.next_deadline, np.float32(t + self.slo))
            else:
                self.adm[_A["rejected_overflow"]] += 1
                self.counters[_C["failures_preemptible" if pre else "failures_normal"]] += 1
            return
        h, s, ok, n_kill = self.decide(
            e, self.res_dev[e], pre, int(tr.domain[e]), t, float(tr.price[e]),
            int(tr.cost_kind[e]), float(tr.period[e]), req_exclude=-1,
        )
        if not ok:
            self.counters[_C["failures_preemptible" if pre else "failures_normal"]] += 1
        self.ev_live[e] = ok
        self.ev_host[e] = h
        self.ev_slot[e] = s
        self.out[e] = (h, s, int(ok), n_kill)

    def _target(self, e: int):
        tg = min(max(int(self.trace.inst_id[e]), 0), self.e)
        live = bool(self.ev_live[tg])
        h = max(int(self.ev_host[tg]), 0)
        s = min(max(int(self.ev_slot[tg]), 0), self.k - 1)
        is_pre = bool(self.ev_pre[tg] if self.streaming else self.trace.preemptible[tg])
        return tg, live, h, s, is_pre

    def departure(self, e: int, t: np.float32) -> None:
        tg, live, h, s, is_pre = self._target(e)
        if live and is_pre:
            apply_termination(self.st, h, np.arange(self.k) == s, now=float(t),
                              involuntary=False)
            self.slot_owner[h, s] = -1
        elif live:
            radd = self.res_dev[tg]
            apply_departure(self.st, h, radd)
            self.normal_res[h] -= radd
        self.ev_live[tg] = False

    def fail_host(self, e: int, t: np.float32) -> None:
        h = min(max(int(self.trace.host[e]), 0), self.n - 1)
        apply_host_failure(self.st, h, self.normal_res[h], now=float(t))
        self.slot_owner[h] = -1
        self.ev_live &= ~(self.ev_host == h)
        self.normal_res[h] = 0.0

    def heal_host(self, e: int, t: np.float32) -> None:
        set_schedulable(self.st, min(max(int(self.trace.host[e]), 0), self.n - 1), True)

    def checkpoint(self, e: int, t: np.float32) -> None:
        tg, live, h, s, is_pre = self._target(e)
        if live and is_pre:
            apply_checkpoint(self.st, h, s, float(t))

    def zone_storm(self, e: int, t: np.float32) -> None:
        st = self.st
        zn = int(self.trace.zone[e])
        live = st.inst_valid & (st.host_zone[:, None] == zn)
        flat = live.reshape(-1)
        csum = torch.cumsum(flat.to(torch.int32), 0)
        cnt = int(csum[-1]) if flat.numel() else 0
        self.counters[_C["storms"]] += 1
        if cnt == 0:
            return
        want = max(1, int(np.round(np.float32(cnt) * self.trace.frac[e])))
        n_kill = min(want, cnt)
        kill = (flat & (csum <= n_kill)).reshape(self.n, self.k)
        freed = torch.sum(torch.where(kill[:, :, None], st.inst_res, 0.0), dim=1)
        up = torch.sum(torch.where(kill, float(t) - st.inst_start, 0.0))
        zc = min(max(zn, 0), st.zone_term.shape[0] - 1)
        st.free_f.add_(freed)
        st.inst_valid.logical_and_(~kill)
        st.zone_term[zc] += float(n_kill)
        st.zone_up[zc] += up
        kill_h = kill.cpu().numpy()
        owners = self.slot_owner[kill_h]
        self.ev_live[owners[owners >= 0]] = False
        self.slot_owner[kill_h] = -1
        self.counters[_C["storm_kills"]] += n_kill

    # -- the streaming admission plane ----------------------------------------
    def drain(self, now: np.float32) -> None:
        """One admission drain: select, demote in a storm, a ``_step_core``
        a taken row, pop; the bookkeeping of the reference's carry."""
        policy = self.policy
        q = self.q
        idx, take = queue_select(q, policy.admit_batch, now=float(now),
                                 aging_rate=self.aging, n_classes=policy.n_classes)
        il = idx.long()
        cols = torch.stack([c.double() for c in (
            take, q.preemptible[il], q.domain[il], q.cost_kind[il], q.period[il],
            q.price[il], q.enq_t[il], idx)]).cpu().numpy()
        take_h = cols[0] > 0
        orig_pre = take_h & (cols[1] > 0)
        pre = orig_pre
        degraded = np.zeros_like(orig_pre)
        if self.storm_thr is not None:
            churn = churn_stats(self.st.zone_term, self.st.zone_up)[-1]
            if bool(churn > float(self.storm_thr)):
                degraded = orig_pre
                pre = np.zeros_like(orig_pre)
        placed = np.zeros_like(take_h)
        for j in np.nonzero(take_h)[0]:
            src = int(self.q_src[int(cols[7, j])])
            p = bool(pre[j])
            h, s, ok, n_kill = self.decide(
                src, q.res[il[j]], p, int(cols[2, j]), now, float(cols[5, j]),
                int(cols[3, j]), float(cols[4, j]), req_exclude=None,
            )
            placed[j] = ok
            self.ev_kill[src] += n_kill
            if ok:
                self.ev_live[src] = True
                self.ev_ok[src] = True
                self.ev_host[src] = h
                self.ev_pre[src] = p
                if p:
                    self.ev_slot[src] = s
                self.ev_wait[src] = np.float32(now - np.float32(cols[6, j]))
        self.q, dropped = queue_pop(q, idx, take, torch.from_numpy(placed).to(self.dev),
                                    policy.max_retries)
        dropped = dropped.cpu().numpy()
        c, a = self.counters, self.adm
        c[_C["failures_normal"]] += int((dropped & ~orig_pre).sum())
        c[_C["failures_preemptible"]] += int((dropped & orig_pre).sum())
        a[_A["admitted"]] += int(placed.sum())
        a[_A["rejected_retry"]] += int(dropped.sum())
        a[_A["retries"]] += int((take_h & ~placed & ~dropped).sum())
        a[_A["degraded"]] += int(degraded.sum())
        a[_A["drains"]] += 1
        self.depth -= int(placed.sum()) + int(dropped.sum())
        oldest = torch.amin(torch.where(self.q.valid, self.q.enq_t, float("inf")))
        self.next_deadline = np.float32(np.float32(oldest.item()) + self.slo)

    # -- the loop -------------------------------------------------------------
    def run(self) -> ScanResult:
        tr, policy = self.trace, self.policy
        branches = (self.arrival, self.departure, self.fail_host, self.heal_host,
                    self.checkpoint, self.zone_storm, None)
        freeing = (DEPARTURE, FAIL_HOST, HEAL_HOST, ZONE_STORM)
        for e in range(self.e):
            kd = int(tr.kind[e])
            t = tr.time[e]
            self.record_sample(t)
            if self.streaming and t >= self.next_deadline:
                self.drain(t)
            if branches[kd] is not None:
                branches[kd](e, t)
            if self.streaming and (
                    (kd == ARRIVAL and self.depth >= policy.admit_batch)
                    or (kd in freeing and self.depth > 0)):
                self.drain(t)
        t_last = tr.time[self.e - 1] if self.e else np.float32(0.0)
        stream = None
        if self.streaming:
            # drain_all at the last timestamp: each failing entry spends one
            # retry a drain, so ceil(Q/B) * max_retries + 2 rounds suffice
            limit = (-(-policy.queue_capacity // policy.admit_batch)
                     * policy.max_retries + 2)
            for _ in range(limit):
                if self.depth > 0:
                    self.drain(t_last)
            e = self.e
            self.out = np.stack([self.ev_host[:e], self.ev_slot[:e],
                                 self.ev_ok[:e].astype(np.int64), self.ev_kill[:e]], axis=1)
            adm = {name: int(self.adm[i]) for i, name in enumerate(_ADM_NAMES)}
            adm["queue_depth"] = self.depth
            stream = (self.q, adm, self.ev_wait[:e].copy())
        # the closing sample, as the python loop's final _sample()
        self.samples.append((np.float32(t_last),) + self._free_sums())
        samp = np.asarray(self.samples, np.float32).reshape(-1, 3)
        return ScanResult(
            state=self.st,
            host=self.out[:, 0].astype(np.int32), slot=self.out[:, 1].astype(np.int32),
            ok=self.out[:, 2].astype(bool), n_kill=self.out[:, 3].astype(np.int32),
            counters={name: int(self.counters[i]) for i, name in enumerate(_COUNTER_NAMES)},
            sample_t=samp[:, 0], sample_free0=samp[:, 1], sample_free0_normal=samp[:, 2],
            queue=None if stream is None else stream[0],
            admission=None if stream is None else stream[1],
            wait_s=None if stream is None else stream[2],
            decisions=self.decisions, fallbacks=self.fallbacks,
        )


def _one_run(trace, policy, state, normal_res, sample_every_s, mult, knobs,
             device) -> ScanResult:
    st = _clone_state(state, device)
    n, d = st.free_f.shape
    nres = (torch.zeros((n, d), dtype=torch.float32, device=device) if normal_res is None
            else torch.tensor(np.asarray(normal_res, np.float32), device=device))
    return _Run(trace, policy, st, nres, np.float32(sample_every_s), mult, knobs).run()


def _device_of(state: SoAFleetState, device):
    return state.device if device is None else resolve_device(device)


def simulate_scan(
    trace: EventTrace,
    policy: Optional[SchedulerPolicy],
    state: SoAFleetState,
    *,
    normal_res=None,
    sample_every_s: float = 300.0,
    mult=None,
    knobs=None,
    device=None,
) -> ScanResult:
    """Run ``trace`` against a clone of ``state`` (left as it was).

    The run is on ``state``'s device unless ``device`` names another (a CUDA
    state launches the decision kernels; a CPU one runs their plain
    versions).  ``normal_res`` seeds the per-host live normal resources
    (needed only when the starting state already hosts normal instances
    that a ``fail_host`` row may evacuate); zeros by default.  ``mult``
    replaces the policy's weigher/churn multiplier values by one row (the
    same zero pattern and termination sign; see ``simulate_ensemble``).

    With ``policy.queue_capacity > 0`` the run is in **streaming admission
    mode**, equal to ``SoASimulator.run_trace``'s streaming replay; ``knobs``
    then replaces ``(aging_rate, slo_target_s, storm_threshold)`` by one row
    (``np.inf`` threshold = demotion off).

    Returns a ``ScanResult``: the final fleet state, the per-arrival
    placement/rejection sequence, the counters and the sample series
    (``.sim_metrics(cap0_total)`` builds ``SimMetrics``).
    """
    policy = ensure_policy(policy, "simulate_scan")
    _check_policy(policy, "simulate_scan")
    _check_trace(trace, state, policy)
    if mult is not None:
        mult = _check_mult(mult, policy)
        if mult.ndim != 1:
            raise ValueError("simulate_scan takes one multiplier row; use "
                             "simulate_ensemble for a stacked axis")
    if knobs is not None:
        knobs = _check_knobs(knobs, policy)
        if knobs.ndim != 1:
            raise ValueError("simulate_scan takes one knob row; use "
                             "simulate_ensemble for a stacked axis")
    return _one_run(trace, policy, state, normal_res, sample_every_s, mult, knobs,
                    _device_of(state, device))


def simulate_ensemble(
    traces: Sequence[EventTrace],
    policy: Optional[SchedulerPolicy],
    state: SoAFleetState,
    *,
    mults=None,
    knobs=None,
    normal_res=None,
    sample_every_s: float = 300.0,
    device=None,
) -> List[ScanResult]:
    """Monte-Carlo harness: many trajectories from one starting state, over
    a trace (seed) axis and, optionally, weigher-multiplier and
    admission-knob axes.

    ``traces`` are right-padded with PAD rows to one length; ``mults`` is a
    ``(P, len(policy.all_multipliers))`` array of multiplier rows zipped
    lane for lane with the traces; ``knobs`` (streaming policies only) a
    ``(P, 3)`` array of ``(aging_rate, slo_target_s, storm_threshold)``
    rows.  An axis of length 1 broadcasts against the others.  Lanes run one
    after another, each on its padded trace and its own clone of ``state``,
    so each lane equals ``simulate_scan`` of its padded trace; the outcomes
    and waits come back trimmed to the lane's own rows.

    Multiplier rows keep the policy's zero pattern and termination sign: the
    policy's multipliers gate which terms exist and the screening bound's
    side, and the rows only change magnitudes.  Knob rows have no such
    constraint.
    """
    policy = ensure_policy(policy, "simulate_ensemble")
    _check_policy(policy, "simulate_ensemble")
    traces = list(traces)
    if not traces:
        raise ValueError("simulate_ensemble needs at least one trace")
    with_mult = mults is not None
    if with_mult:
        mults = _check_mult(mults, policy)
        if mults.ndim != 2:
            raise ValueError("mults must be (P, n_multipliers)")
    with_knobs = knobs is not None
    if with_knobs:
        knobs = _check_knobs(knobs, policy)
        if knobs.ndim != 2:
            raise ValueError(
                "knobs must be (P, 3) rows of (aging_rate, slo_target_s, "
                "storm_threshold)"
            )
    n_lanes = max(
        len(traces),
        mults.shape[0] if with_mult else 1,
        knobs.shape[0] if with_knobs else 1,
    )
    if len(traces) == 1 and n_lanes > 1:
        traces = traces * n_lanes
    if with_mult and mults.shape[0] == 1 and n_lanes > 1:
        mults = np.repeat(mults, n_lanes, axis=0)
    if with_knobs and knobs.shape[0] == 1 and n_lanes > 1:
        knobs = np.repeat(knobs, n_lanes, axis=0)
    if with_mult and mults.shape[0] != len(traces):
        raise ValueError(
            f"{len(traces)} traces vs {mults.shape[0]} multiplier rows"
        )
    if with_knobs and knobs.shape[0] != len(traces):
        raise ValueError(
            f"{len(traces)} traces vs {knobs.shape[0]} knob rows"
        )
    if len({t.n_dims for t in traces}) > 1:
        raise ValueError("traces disagree on resource dimensionality")
    for t in traces:
        _check_trace(t, state, policy)
    dev = _device_of(state, device)
    emax = max(t.n_events for t in traces)
    lanes = []
    for i, t in enumerate(traces):
        res = _one_run(t.padded(emax), policy, state, normal_res, sample_every_s,
                       mults[i] if with_mult else None,
                       knobs[i] if with_knobs else None, dev)
        e = t.n_events
        res.host, res.slot, res.ok, res.n_kill = (
            res.host[:e], res.slot[:e], res.ok[:e], res.n_kill[:e])
        if res.wait_s is not None:
            res.wait_s = res.wait_s[:e]
        lanes.append(res)
    return lanes
