"""Streaming admission front end: a wait queue on the fleet's device and the
drain that feeds it to the decision path (port of ``repro.core.admission``).

A request no longer vanishes when the fleet cannot place it at once:

* **Wait queue** (``AdmissionQueueState``): a fixed-capacity
  struct-of-arrays queue on the fleet's device, beside ``SoAFleetState``.
  Each row carries a request's resource vector and flags, a **priority
  class** (0 = interactive, highest; ``n_classes - 1`` = batch, lowest), a
  FIFO ticket (``seq``), its enqueue time and a retry counter.  The
  transitions (``queue_push`` / ``queue_push_many`` / ``queue_select`` /
  ``queue_pop``) are tensor operations that return a new queue state; the
  queue never leaves the device between drains.
* **Drains** (``_drain_entry``): push the newly accumulated arrivals,
  select the top ``admit_batch`` waiting rows by ``(class, seq)`` (strict
  priority between classes, FIFO within one), decide each selected row with
  ``torch_scheduler._step_core`` at the drain's common ``now``, and fold the
  outcomes back: placed rows leave, failed rows stay for **backfill retry**
  until ``max_retries`` attempts are spent.  The drain feeds each request's
  columns through the same decision step as ``schedule_many``, so a drained
  queue's decisions equal the unqueued path's on the same sequence.
* **Interactive preempts batch** through the decision path's own
  predicate: normal (interactive) requests may evacuate preemptible
  instances, and the queue drains them first.
* **Front end** (``AdmissionFrontEnd``): arrivals accumulate on the host
  until a drain; ``drain(block=False)`` banks the outcome for
  ``take_results`` and gives the same results as blocking drains.

Differences from the JAX module, all deliberate:

* The reference pushes arrivals through a ``lax.scan`` of ``queue_push``;
  ``queue_push_many`` pushes a whole buffer at once (the k-th live arrival
  takes the k-th free row) and returns the scan's outputs exactly.
* The drain order is one stable sort of a packed **int64** key (PyTorch has
  no uint32 comparisons); every key lies in ``[0, 2**32)``, so the order is
  the reference's uint32 order bit for bit.
* Rows a drain selects past the end of the queue (``take=False``) are not
  decided at all: the reference runs them with the ``PAD_RES`` sentinel,
  which fits no host and leaves the state as it was.
* The decision loop reads one tensor back per decision (the admissibility
  fallback is a Python ``if``), so a drain is synchronous even when the
  front end is asked not to block: ``block=False`` keeps the reference's
  contract (absorb later, bank for ``take_results``), not its overlap.

Relocation re-placements (``submit_relocation``) ride the queue as class-0
preemptible entries with their source zone excluded; ``flush`` settles each
one through the owning fleet when it is placed, dropped or overflows.  The
zone-exclusion operand reaches the decision only when
``policy.relocation_on``: a relocation-off drain runs the same program as
before the plane existed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .policy import SchedulerPolicy
from .screen_math import POS_INF, churn_stats
from .torch_scheduler import SoAFleetState, _f32, _step_core, resolve_device
from .types import Request

#: The reference's resource vector for untaken drain rows: a request no host
#: can fit, so deciding it changes nothing (the port does not decide them).
PAD_RES = 1e30

#: Sort key of an invalid row: above every valid key (those are < 2**32 - 1).
_INVALID_KEY = 0xFFFFFFFF

#: field → dtype of ``AdmissionQueueState`` (the JAX package's names).
QUEUE_DTYPES = {
    "res": torch.float32, "preemptible": torch.bool, "domain": torch.int32,
    "cost_kind": torch.int32, "period": torch.float32,
    "exclude_zone": torch.int32, "klass": torch.int32, "price": torch.float32,
    "enq_t": torch.float32, "seq": torch.int32, "tries": torch.int32,
    "valid": torch.bool, "next_seq": torch.int32,
}


# ---------------------------------------------------------------------------
# Queue state + transitions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdmissionQueueState:
    """Fixed-capacity wait queue (struct-of-arrays) on one device.

    ``Q = policy.queue_capacity`` rows; a row is live iff ``valid``.  The
    ``(klass, seq)`` pair is the drain order.  ``tries`` counts placement
    attempts already spent (backfill retries).
    """

    res: torch.Tensor          # (Q, D) f32 request resource vectors
    preemptible: torch.Tensor  # (Q,)   bool
    domain: torch.Tensor       # (Q,)   i32; -1 = any
    cost_kind: torch.Tensor    # (Q,)   i32 kind id; -1 = policy default
    period: torch.Tensor       # (Q,)   f32 contract period; -1 = default
    exclude_zone: torch.Tensor  # (Q,)  i32 hard-excluded zone id; -1 = none
    klass: torch.Tensor        # (Q,)   i32 priority class; 0 = highest
    price: torch.Tensor        # (Q,)   f32
    enq_t: torch.Tensor        # (Q,)   f32 enqueue (arrival) time
    seq: torch.Tensor          # (Q,)   i32 FIFO ticket
    tries: torch.Tensor        # (Q,)   i32 failed placement attempts so far
    valid: torch.Tensor        # (Q,)   bool
    next_seq: torch.Tensor     # ()     i32 ticket counter

    @property
    def capacity(self) -> int:
        return self.res.shape[0]

    @property
    def device(self) -> torch.device:
        return self.res.device

    @property
    def depth(self) -> torch.Tensor:
        """Live rows, as a 0-d int32 tensor on the queue's device."""
        return self.valid.sum().to(torch.int32)


def queue_init(capacity: int, n_dims: int, device=None) -> AdmissionQueueState:
    """Empty queue of ``capacity`` rows over ``n_dims`` resource dims on
    ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    q = int(capacity)

    def full(value, dtype, shape=(q,)):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return AdmissionQueueState(
        res=full(0.0, torch.float32, (q, n_dims)),
        preemptible=full(False, torch.bool),
        domain=full(-1, torch.int32),
        cost_kind=full(-1, torch.int32),
        period=full(-1.0, torch.float32),
        exclude_zone=full(-1, torch.int32),
        klass=full(0, torch.int32),
        price=full(1.0, torch.float32),
        enq_t=full(0.0, torch.float32),
        seq=full(0, torch.int32),
        tries=full(0, torch.int32),
        valid=full(False, torch.bool),
        next_seq=full(0, torch.int32, ()),
    )


def _col(x, dtype: torch.dtype, dev: torch.device, shape=None) -> torch.Tensor:
    """``x`` (a tensor, numpy array or python scalar) as a ``dtype`` tensor on
    ``dev``; values convert as numpy's ``astype`` would."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    t = x.to(device=dev, dtype=dtype)
    return t if shape is None else t.reshape(shape)


def queue_push_many(
    q: AdmissionQueueState,
    res,           # (A, D)
    preemptible,   # (A,) bool
    domain,        # (A,) i32
    cost_kind,     # (A,) i32
    period,        # (A,) f32; -1 = policy default
    exclude_zone,  # (A,) i32; -1 = none
    klass,         # (A,) i32
    enq_t,         # (A,) f32
    price,         # (A,) f32
    live=None,     # (A,) bool; False = padding row, no-op; None = all live
) -> Tuple[AdmissionQueueState, torch.Tensor, torch.Tensor]:
    """Enqueue A arrivals in order, each into the first free row.

    The batched form of the reference's ``lax.scan`` of ``queue_push``: the
    k-th live arrival takes the k-th free row (by index) while rows remain.
    Returns ``(q', slot (A,) i32, ok (A,) bool)`` equal to the scan's: the
    slot each arrival saw as first free (0 when none was), ``ok=False`` for
    a padding row or a full queue, which rejects and never displaces."""
    dev = q.device
    cap = q.capacity
    res = _col(res, torch.float32, dev)
    a = res.shape[0]
    if a == 0:
        return q, torch.zeros((0,), dtype=torch.int32, device=dev), \
            torch.zeros((0,), dtype=torch.bool, device=dev)
    live = (torch.ones((a,), dtype=torch.bool, device=dev) if live is None
            else _col(live, torch.bool, dev, (a,)))
    free = ~q.valid
    n_free = free.sum()
    # free rows first, in index order
    free_rows = torch.sort(q.valid.to(torch.uint8), stable=True).indices
    before = torch.cumsum(live.to(torch.int64), 0) - live.to(torch.int64)
    pushes_before = torch.minimum(before, n_free)
    room = pushes_before < n_free
    ok = live & room
    slot = torch.where(room, free_rows[torch.clamp(pushes_before, max=cap - 1)],
                       0).to(torch.int32)
    # row r takes arrival src[r] when any pushed arrival chose it
    sel = ok[:, None] & (slot[:, None] == torch.arange(cap, device=dev)[None, :])
    hit = sel.any(0)
    src = torch.argmax(sel.to(torch.uint8), 0)

    def put(old, new):
        new = new[src]
        mask = hit if old.dim() == 1 else hit[:, None]
        return torch.where(mask, new, old)

    seq_new = (q.next_seq.to(torch.int64) + pushes_before).to(torch.int32)
    q = dataclasses.replace(
        q,
        res=put(q.res, res),
        preemptible=put(q.preemptible, _col(preemptible, torch.bool, dev, (a,))),
        domain=put(q.domain, _col(domain, torch.int32, dev, (a,))),
        cost_kind=put(q.cost_kind, _col(cost_kind, torch.int32, dev, (a,))),
        period=put(q.period, _col(period, torch.float32, dev, (a,))),
        exclude_zone=put(q.exclude_zone, _col(exclude_zone, torch.int32, dev, (a,))),
        klass=put(q.klass, _col(klass, torch.int32, dev, (a,))),
        price=put(q.price, _col(price, torch.float32, dev, (a,))),
        enq_t=put(q.enq_t, _col(enq_t, torch.float32, dev, (a,))),
        seq=put(q.seq, seq_new),
        tries=torch.where(hit, 0, q.tries),
        valid=q.valid | hit,
        next_seq=q.next_seq + ok.sum().to(torch.int32),
    )
    return q, slot, ok


def queue_push(
    q: AdmissionQueueState,
    res,           # (D,)
    preemptible,   # () bool
    domain,        # () i32
    cost_kind,     # () i32
    period,        # () f32; -1 = policy default
    exclude_zone,  # () i32; -1 = none
    klass,         # () i32
    enq_t,         # () f32
    price,         # () f32
    live=True,     # () bool; False = padding row, no-op
) -> Tuple[AdmissionQueueState, torch.Tensor, torch.Tensor]:
    """Enqueue one arrival into the first free row.

    Returns ``(q', slot, ok)`` as 0-d tensors; ``ok=False`` (queue full, or
    ``live=False``) leaves the queue untouched: a full queue rejects at
    arrival, it never displaces a waiting row."""
    dev = q.device
    q, slot, ok = queue_push_many(
        q, _col(res, torch.float32, dev, (1, -1)),
        *(_col(v, dt, dev, (1,)) for v, dt in (
            (preemptible, torch.bool), (domain, torch.int32),
            (cost_kind, torch.int32), (period, torch.float32),
            (exclude_zone, torch.int32), (klass, torch.int32),
            (enq_t, torch.float32), (price, torch.float32),
            (live, torch.bool))),
    )
    return q, slot[0], ok[0]


def queue_select(
    q: AdmissionQueueState,
    batch: int,
    now=None,
    aging_rate=0.0,
    n_classes: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick the next ``batch`` rows in drain order.

    Order is ``(klass asc, seq asc)``: strict priority between classes,
    FIFO within a class; a retried row keeps its ticket, so it drains ahead
    of everything that arrived after it.  Returns ``(idx (B,) i32, take (B,)
    bool)``; rows with ``take=False`` gathered an invalid row (the queue
    holds fewer than ``batch``) and are padding.

    One stable sort of a packed key orders both columns: the effective class
    in the high ``cb = n_classes.bit_length()`` bits of 32 (8 when
    ``n_classes`` is None), clipped to ``2**cb - 2``, ``seq`` below it, an
    invalid row at the sentinel ``0xFFFFFFFF``.  The key is int64, and every
    key lies in ``[0, 2**32)``, so the order is the reference's uint32 order
    bit for bit; ``seq`` must stay below ``2**(32 - cb)``.

    With ``aging_rate > 0`` a row's effective class decays with its wait:
    ``max(0, klass - floor(f32(aging_rate) * max(now - enq_t, 0)))``, in
    f32 as the reference computes it; ``seq`` stays the second key."""
    klass = q.klass
    if now is not None and aging_rate:
        now_t = torch.tensor(_f32(now), dtype=torch.float32, device=q.device)
        waited = torch.clamp(now_t - q.enq_t, min=0.0)
        rate = torch.tensor(_f32(aging_rate), dtype=torch.float32, device=q.device)
        decay = torch.floor(rate * waited).to(torch.int32)
        klass = torch.clamp(klass - decay, min=0)
    cb = int(n_classes).bit_length() if n_classes else 8
    packed = (torch.clamp(klass, 0, (1 << cb) - 2).to(torch.int64) << (32 - cb)) \
        | q.seq.to(torch.int64)
    key = torch.where(q.valid, packed, _INVALID_KEY)
    order = torch.sort(key, stable=True).indices
    idx = order[: int(batch)]
    return idx.to(torch.int32), q.valid[idx]


def queue_pop(
    q: AdmissionQueueState,
    idx,      # (B,) distinct rows a drain attempted
    take,     # (B,) which of them were real
    placed,   # (B,) which of those the decision path placed
    max_retries: int,
) -> Tuple[AdmissionQueueState, torch.Tensor]:
    """Fold one drain's outcomes back into the queue.

    Placed rows leave; failed rows spend one retry and stay (backfill)
    until ``max_retries`` attempts are spent, when they are dropped.
    Returns ``(q', dropped (B,))``."""
    dev = q.device
    idx = _col(idx, torch.int64, dev)
    take = _col(take, torch.bool, dev)
    placed = _col(placed, torch.bool, dev)
    fail = take & ~placed
    tries_at = q.tries[idx]
    tries_new = tries_at + fail.to(torch.int32)
    dropped = fail & (tries_new >= int(max_retries))
    remove = placed | dropped
    valid_at = q.valid[idx]
    tries = q.tries.clone()
    tries[idx] = torch.where(take, tries_new, tries_at)
    valid = q.valid.clone()
    valid[idx] = torch.where(take, valid_at & ~remove, valid_at)
    return dataclasses.replace(q, tries=tries, valid=valid), dropped


# ---------------------------------------------------------------------------
# The drain: push arrivals → select → decide → pop
# ---------------------------------------------------------------------------


def _drain_entry(
    fleet_state: SoAFleetState,
    q: AdmissionQueueState,
    new_res,     # (A, D) arrival buffer
    new_pre,     # (A,) bool
    new_dom,     # (A,) i32
    new_kind,    # (A,) i32
    new_period,  # (A,) f32; -1 = policy default
    new_excl,    # (A,) i32 excluded zone id; -1 = none
    new_cls,     # (A,) i32
    new_t,       # (A,) f32 arrival times
    new_price,   # (A,) f32
    now,         # drain time (cast to f32)
    *,
    policy: SchedulerPolicy,
):
    """One admission drain.  ``fleet_state`` is updated in place; the queue
    state is returned anew.

    Each taken row is decided by ``_step_core`` at the drain's common
    ``now``, in drain order, so a drained queue equals feeding the same
    requests to ``schedule_many`` in that order.

    Graceful degradation (``policy.storm_threshold``): when the fleet-wide
    churn rate ΣT/max(ΣU, eps) of the state's zone accumulators exceeds the
    threshold, this drain's preemptible rows are demoted to non-preemptible
    for this attempt and reported per row (``degraded``), so the host mirror
    books the placement under the demoted request.

    Returns ``(fleet_state, q', aux)`` with ``aux = (new_slot, pushed, idx,
    take, placed, host_idx, slot, kill, fell_back, margin, wait, dropped,
    degraded, depth)``, as the reference's; rows with ``take=False`` report
    ``ok=False``, host 0, slot 0, no kill, no fallback and margin
    ``POS_INF``."""
    dev = fleet_state.device
    now32 = _f32(now)
    now_t = torch.tensor(now32, dtype=torch.float32, device=dev)
    q, new_slot, pushed = queue_push_many(
        q, new_res, new_pre, new_dom, new_kind, new_period, new_excl,
        new_cls, new_t, new_price,
    )
    idx, take = queue_select(q, policy.admit_batch, now=now32,
                             aging_rate=policy.aging_rate,
                             n_classes=policy.n_classes)
    il = idx.long()
    b = il.shape[0]
    b_res = q.res[il]
    b_pre = take & q.preemptible[il]
    if policy.storm_threshold is not None:
        # fleet-wide rate = last entry of the fused churn reduction
        churn = churn_stats(fleet_state.zone_term, fleet_state.zone_up)[-1]
        storm = churn > _f32(policy.storm_threshold)
        degraded = b_pre & storm
        b_pre = b_pre & ~storm
    else:
        degraded = torch.zeros_like(b_pre)
    # the scalar columns of the batch, read back once for the decision loop;
    # the exclusion column rides only when the relocation plane is on
    cols = [take, b_pre, q.domain[il], q.cost_kind[il], q.period[il], q.price[il]]
    if policy.relocation_on:
        cols.append(q.exclude_zone[il])
    cols = torch.stack([c.double() for c in cols]).cpu().numpy()
    # an untaken row is not decided: host 0, slot 0, not ok, no kill, no
    # fallback, margin POS_INF
    untaken = (0, torch.zeros((), dtype=torch.int32, device=dev), False,
               torch.zeros((fleet_state.k_slots,), dtype=torch.bool, device=dev), False,
               torch.tensor(POS_INF, dtype=torch.float32, device=dev))
    hosts, slots, oks, kills, fbs, margins = zip(*(
        _step_core(fleet_state, b_res[j], bool(cols[1, j]), int(cols[2, j]), now32,
                   float(cols[5, j]), int(cols[3, j]), float(cols[4, j]), policy,
                   req_exclude=int(cols[6, j]) if policy.relocation_on else None)
        if cols[0, j] else untaken for j in range(b)))
    ok_t = torch.tensor(oks, dtype=torch.bool, device=dev)
    placed = ok_t & take
    wait = torch.where(placed, now_t - q.enq_t[il], 0.0)
    q, dropped = queue_pop(q, il, take, placed, policy.max_retries)
    return fleet_state, q, (
        new_slot, pushed, idx, take, placed,
        torch.tensor(hosts, dtype=torch.int32), torch.stack(slots),
        torch.stack(kills), torch.tensor(fbs, dtype=torch.bool),
        torch.stack(margins), wait, dropped, degraded, q.depth,
    )


# ---------------------------------------------------------------------------
# Host side: stats, identity bookkeeping, the front end
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdmissionStats:
    """Counters and latency samples of one front end (host side).

    Conservation: every arrival is in exactly one bucket,
    ``arrivals == admitted + rejected_overflow + rejected_retry
    + queue_depth + pending``.
    """

    arrivals: int = 0
    admitted: int = 0
    rejected_overflow: int = 0
    rejected_retry: int = 0
    drains: int = 0
    retries: int = 0
    #: preemptible attempts demoted to non-preemptible by storm degradation
    degraded: int = 0
    queue_depth: int = 0
    #: sim-time admission latency (drain time - arrival time) per placement
    wait_s: List[float] = dataclasses.field(default_factory=list)
    #: wall-clock submit → outcome-absorbed latency per placement (seconds)
    wall_wait_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def rejected(self) -> int:
        return self.rejected_overflow + self.rejected_retry

    @staticmethod
    def _pct(samples: Sequence[float], pct: float) -> float:
        if not samples:
            return 0.0
        # f32 on purpose: the waits are f32 differences from the drain, and
        # interpolating in f32 keeps this reader bit-identical to the
        # reference's
        return float(np.percentile(np.asarray(samples, np.float32), pct))

    def wait_percentiles(self) -> Dict[str, float]:
        """Sim-time queue-wait p50/p99 (drain time − arrival time per
        admitted placement, f32 differences computed by the drain)."""
        return {
            "wait_p50_s": self._pct(self.wait_s, 50),
            "wait_p99_s": self._pct(self.wait_s, 99),
        }

    def summary(self) -> Dict[str, float]:
        return {
            "arrivals": self.arrivals,
            "admitted": self.admitted,
            "rejected_overflow": self.rejected_overflow,
            "rejected_retry": self.rejected_retry,
            "drains": self.drains,
            "retries": self.retries,
            "degraded": self.degraded,
            "queue_depth": self.queue_depth,
            "wait_p50_s": self._pct(self.wait_s, 50),
            "wait_p99_s": self._pct(self.wait_s, 99),
            "wall_p50_us": self._pct(self.wall_wait_s, 50) * 1e6,
            "wall_p99_us": self._pct(self.wall_wait_s, 99) * 1e6,
        }


@dataclasses.dataclass(frozen=True)
class DrainResult:
    """Host-side view of one absorbed drain."""

    now: float
    #: every attempted (request, placed) pair in service (drain) order: the
    #: exact decision sequence, for oracle replays
    attempts: Tuple[Tuple[Request, bool], ...]
    #: placed requests' outcomes, in service order
    outcomes: Tuple[object, ...]          # Tuple[SoAOutcome, ...]
    #: requests rejected by this drain (queue overflow or retries spent)
    rejected: Tuple[Request, ...]
    #: requests that failed placement but stay queued for backfill retry
    retried: Tuple[Request, ...]
    #: live queue rows after the drain
    queue_depth: int


@dataclasses.dataclass
class _Waiting:
    """One not-yet-admitted request (host mirror of a queue row)."""

    request: Request
    price: float
    klass: int
    enq_t: float
    submit_wall: float  # time.perf_counter() at submit


class AdmissionFrontEnd:
    """Admission layer over one ``SoAFleet``; the queue lives on the fleet's
    device.

    ``submit()`` puts arrivals into a host-side buffer; ``drain()`` pushes
    the buffer and decides one ``admit_batch`` selection.  With
    ``block=False`` the outcome is absorbed later (the next drain,
    ``flush()``, ``sync()`` or a stats read) and banked for
    ``take_results``; the results are those of blocking drains.  The
    decision loop reads one tensor back per decision (its admissibility
    fallback is a Python ``if``), so the drain itself runs before
    ``drain`` returns either way.  The fleet's python mirror is updated
    through the same ``_absorb`` as the direct entry points.
    """

    def __init__(self, fleet):
        policy = fleet.policy
        if policy.queue_capacity <= 0:
            raise ValueError("AdmissionFrontEnd needs policy.queue_capacity > 0")
        if policy.mesh is not None:
            raise NotImplementedError(
                "admission queue + sharded fleet state is future work; "
                "drop policy.mesh or policy.queue_capacity"
            )
        self.fleet = fleet
        self.policy = policy
        self.qstate = queue_init(policy.queue_capacity, len(fleet.spec.dims),
                                 device=fleet.device)
        #: queue row → waiting record (mirrors ``AdmissionQueueState.valid``)
        self.slots: List[Optional[_Waiting]] = [None] * policy.queue_capacity
        self._pending: List[_Waiting] = []
        #: relocation re-placements in flight: request id → (victim id,
        #: source zone), settled by the owning fleet at the drain that
        #: decides each (``SoAFleet.relocate``)
        self._reloc: Dict[str, Tuple[str, str]] = {}
        self._inflight = None
        #: results absorbed as a side effect (a drain flushing an earlier
        #: non-blocking one) awaiting ``take_results``
        self._unclaimed: List[DrainResult] = []
        self.stats = AdmissionStats()

    # -- submission -------------------------------------------------------------
    def _klass_of(self, req: Request) -> int:
        nc = self.policy.n_classes
        if req.priority is None:
            return 0 if not req.preemptible else nc - 1
        k = int(req.priority)
        if not 0 <= k < nc:
            raise ValueError(
                f"request {req.id} priority {k} outside the policy's {nc} classes"
            )
        return k

    def submit(self, req: Request, now: float, price: float = 1.0) -> None:
        """Accept one arrival into the buffer (never blocks)."""
        self.fleet._req_arrays(req)  # validate cost kind early, like direct paths
        self._pending.append(_Waiting(
            request=req, price=float(price), klass=self._klass_of(req),
            enq_t=float(now), submit_wall=time.perf_counter(),
        ))
        self.stats.arrivals += 1

    def submit_relocation(self, req: Request, victim_id: str, zone: str,
                          now: float, price: float = 1.0) -> None:
        """Queue one relocation re-placement: a class-0 entry that stays
        preemptible, so it never displaces a user placement.  The victim
        keeps running until the drain that places this entry settles it; a
        rejected entry leaves the victim untouched and backs the zone off."""
        self.submit(req, now, price=price)
        self._reloc[req.id] = (victim_id, zone)

    @property
    def pending(self) -> int:
        """Arrivals buffered but not yet pushed to the queue."""
        return len(self._pending)

    @property
    def waiting(self) -> int:
        """Everything not yet decided: buffer + live queue rows."""
        return len(self._pending) + sum(w is not None for w in self.slots)

    def batch_ready(self) -> bool:
        return len(self._pending) >= self.policy.admit_batch

    def oldest_enq_t(self) -> Optional[float]:
        ts = [w.enq_t for w in self._pending]
        ts += [w.enq_t for w in self.slots if w is not None]
        return min(ts) if ts else None

    def next_deadline(self) -> Optional[float]:
        """Sim time by which the SLO forces the next drain (None = idle)."""
        oldest = self.oldest_enq_t()
        return None if oldest is None else oldest + self.policy.slo_target_s

    # -- drains -------------------------------------------------------------------
    def drain(self, now: float, block: bool = True) -> Optional[DrainResult]:
        """Run one drain at sim time ``now``.

        Absorbs any earlier non-blocking drain first (its result goes to
        ``take_results``), then pushes the buffer and decides one
        ``admit_batch`` selection.  Returns this drain's ``DrainResult``
        when ``block``; with ``block=False`` returns None and the result is
        absorbed later (``flush`` / ``take_results``)."""
        self.sync()
        pend, self._pending = self._pending, []
        if not pend and not any(w is not None for w in self.slots):
            return DrainResult(
                now=float(now), attempts=(), outcomes=(), rejected=(),
                retried=(), queue_depth=0,
            ) if block else None
        a, d = len(pend), len(self.fleet.spec.dims)
        res = np.zeros((a, d), np.float32)
        pre = np.zeros((a,), bool)
        dom = np.full((a,), -1, np.int32)
        kind = np.full((a,), -1, np.int32)
        per = np.full((a,), -1.0, np.float32)
        exc = np.full((a,), -1, np.int32)
        cls = np.zeros((a,), np.int32)
        enq = np.zeros((a,), np.float32)
        price = np.ones((a,), np.float32)
        for i, w in enumerate(pend):
            res[i], pre[i], dom[i], kind[i], per[i], exc[i] = \
                self.fleet._req_arrays(w.request)
            cls[i], enq[i], price[i] = w.klass, w.enq_t, w.price
        self.fleet.state, self.qstate, aux = _drain_entry(
            self.fleet.state, self.qstate, res, pre, dom, kind, per, exc, cls,
            enq, price, now,
            policy=self.fleet._flush_policy(),
        )
        self._inflight = (pend, float(now), aux)
        self.stats.drains += 1
        return self.flush() if block else None

    def flush(self) -> Optional[DrainResult]:
        """Absorb the outstanding drain's outcomes into the mirror."""
        if self._inflight is None:
            return None
        pend, now, aux = self._inflight
        self._inflight = None
        (new_slot, pushed, idx, take, placed, host_idx, slot, kill,
         fell_back, margin, wait, dropped, degraded, depth) = (
            x.cpu().numpy() for x in aux
        )
        wall_now = time.perf_counter()

        rejected: List[Request] = []
        # 1. arrivals → queue rows (or overflow rejection)
        for i, w in enumerate(pend):
            if pushed[i]:
                self.slots[int(new_slot[i])] = w
            else:
                self.stats.rejected_overflow += 1
                rejected.append(w.request)
                reloc = self._reloc.pop(w.request.id, None)
                if reloc is not None:  # overflow: the victim keeps running
                    self.fleet._settle_relocation_rejected(reloc[0], reloc[1], now)
        # 2. attempted rows, in service order
        outcomes, retried, attempts = [], [], []
        for j in range(len(idx)):
            if not take[j]:
                continue
            row = int(idx[j])
            w = self.slots[row]
            if w is None:
                raise RuntimeError(f"drain attempted empty queue row {row}")
            # storm degradation demoted this attempt on the device; mirror it
            req = w.request
            if degraded[j]:
                req = dataclasses.replace(req, preemptible=False)
                self.stats.degraded += 1
            attempts.append((req, bool(placed[j])))
            if placed[j]:
                self.slots[row] = None
                out = self.fleet._absorb(req, now, w.price, int(host_idx[j]),
                                         int(slot[j]), True, kill[j])
                outcomes.append(out)
                self.stats.admitted += 1
                self.stats.wait_s.append(float(wait[j]))
                self.stats.wall_wait_s.append(wall_now - w.submit_wall)
                reloc = self._reloc.pop(req.id, None)
                if reloc is not None:  # make-before-break: the replacement
                    # is live, so now the victim may go
                    self.fleet._settle_relocation_placed(reloc[0], reloc[1], out, now)
            elif dropped[j]:
                self.slots[row] = None
                self.stats.rejected_retry += 1
                rejected.append(w.request)
                reloc = self._reloc.pop(req.id, None)
                if reloc is not None:  # the victim keeps running; back off
                    self.fleet._settle_relocation_rejected(reloc[0], reloc[1], now)
            else:
                self.stats.retries += 1
                retried.append(w.request)
        n_take = int(take.sum())
        if n_take:
            self.fleet._observe(int(fell_back[take].sum()),
                                float(margin[take].min()), n_take)
        self.stats.queue_depth = int(depth)
        return DrainResult(
            now=now, attempts=tuple(attempts), outcomes=tuple(outcomes),
            rejected=tuple(rejected), retried=tuple(retried),
            queue_depth=int(depth),
        )

    def sync(self) -> None:
        """Absorb any outstanding drain, banking its result for
        ``take_results`` (call it wherever the python mirror must be
        current, e.g. before a departure or failure event)."""
        prev = self.flush()
        if prev is not None:
            self._unclaimed.append(prev)

    def wait_percentiles(self) -> Dict[str, float]:
        """Sim-time queue-wait p50/p99 over every absorbed placement."""
        self.sync()
        return self.stats.wait_percentiles()

    def take_results(self) -> List[DrainResult]:
        """Absorb and return every drain result not yet handed to a caller
        (the non-blocking pattern; see ``SoASimulator``)."""
        self.sync()
        out, self._unclaimed = self._unclaimed, []
        return out

    def drain_all(self, now: float) -> List[DrainResult]:
        """Drain until the queue is empty or every waiting row has spent its
        retries (end of a run)."""
        results: List[DrainResult] = []
        # each failing row spends one retry a drain, so this ends within
        # ceil(Q/B) * max_retries + 1 rounds
        cap = self.policy.queue_capacity
        limit = -(-cap // self.policy.admit_batch) * self.policy.max_retries + 2
        for _ in range(limit):
            if self.waiting == 0:
                break
            results.append(self.drain(now, block=True))
        return results
