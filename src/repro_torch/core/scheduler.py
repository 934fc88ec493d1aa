"""The three schedulers evaluated in the paper (§4.5, Fig. 2).

* ``FilterScheduler``      — the unmodified OpenStack-style baseline:
                             filter on ``h_f``, weigh, pick.  Preemption-blind.
* ``RetryScheduler``       — the two-cycle design the paper argues against:
                             pass 1 = FilterScheduler; on failure of a normal
                             request, pass 2 re-filters against ``h_n`` and
                             runs select-and-terminate.
* ``PreemptibleScheduler`` — the paper's contribution (Alg. 2 + 6): ONE pass,
                             filtering view switched per request type
                             (normal → h_n, preemptible → h_f), weighing on
                             h_f, then select-and-terminate on the winner.

Schedulers are *pure deciders*: they return a ``ScheduleResult`` carrying the
winning host and the termination plan; applying the plan (evacuating jobs,
checkpointing) is the cluster runtime's job (core/cluster.py,
core/preemption.py).

A verbatim copy of ``repro.core.scheduler`` (numpy only), kept in the
PyTorch port so that it never imports the JAX package: the same seed draws
the same tie-breaks, so the two packages make the same choices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .cost import CostFunction, PeriodCost
from .filters import DEFAULT_FILTERS, Filter, run_filters
from .select_terminate import plan_for_host
from .types import (
    EMPTY_PLAN,
    Host,
    Request,
    Resources,
    ScheduleError,
    ScheduleResult,
    TerminationPlan,
)
from .weighers import (
    DEFAULT_WEIGHERS,
    PackingRank,
    WeighContext,
    Weigher,
    normalized_weights,
)


class BaseScheduler:
    def __init__(
        self,
        filters: Sequence[Filter] = DEFAULT_FILTERS,
        weighers: Optional[Sequence[Weigher]] = None,
        cost_fn: Optional[CostFunction] = None,
        seed: int = 0,
    ):
        self.filters = list(filters)
        self.weighers = list(weighers) if weighers is not None else list(DEFAULT_WEIGHERS)
        self.cost_fn = cost_fn or PeriodCost()
        self._rng = np.random.default_rng(seed)

    # -- shared machinery ----------------------------------------------------
    def _filter(
        self, req: Request, hosts: Sequence[Host], view: str
    ) -> List[Host]:
        """``view``: 'full' → h_f, 'normal' → h_n."""
        out = []
        for h in hosts:
            free = h.free_full if view == "full" else h.free_normal
            if run_filters(self.filters, h, req, free):
                out.append(h)
        return out

    def _pick(
        self, req: Request, candidates: Sequence[Host], ctx: WeighContext
    ) -> Optional[Host]:
        if not candidates:
            return None
        omega = normalized_weights(self.weighers, req, candidates, ctx)
        best = np.max(omega)
        if not np.isfinite(best):
            return None
        ties = np.flatnonzero(omega >= best - 1e-12)
        idx = int(ties[self._rng.integers(len(ties))]) if len(ties) > 1 else int(ties[0])
        return candidates[idx]

    def schedule(
        self, req: Request, hosts: Sequence[Host], now: float
    ) -> ScheduleResult:
        raise NotImplementedError


class FilterScheduler(BaseScheduler):
    """Unmodified baseline: one pass over ``h_f``; no preemption."""

    def __init__(self, **kw):
        kw.setdefault("weighers", (PackingRank(),))
        super().__init__(**kw)

    def schedule(self, req: Request, hosts: Sequence[Host], now: float) -> ScheduleResult:
        ctx = WeighContext(now=now, cost_fn=self.cost_fn)
        candidates = self._filter(req, hosts, view="full")
        host = self._pick(req, candidates, ctx)
        return ScheduleResult(request=req, host=host.name if host else None, passes=1)


class RetryScheduler(BaseScheduler):
    """Two-cycle comparison baseline (paper §4.5).

    Cycle 1 is the plain filter scheduler.  Only when a *normal* request
    fails does cycle 2 run: re-filter against ``h_n``, weigh on ``h_f``,
    select-and-terminate.  The doubled filter+weigh work on the unhappy path
    is exactly the latency penalty Fig. 2 shows.
    """

    def schedule(self, req: Request, hosts: Sequence[Host], now: float) -> ScheduleResult:
        ctx = WeighContext(now=now, cost_fn=self.cost_fn)
        # ---- cycle 1: preemption-blind
        candidates = self._filter(req, hosts, view="full")
        host = self._pick(req, candidates, ctx)
        if host is not None:
            return ScheduleResult(request=req, host=host.name, passes=1)
        if req.preemptible:
            return ScheduleResult(request=req, host=None, passes=1)
        # ---- cycle 2: evacuation-aware retry
        candidates = self._filter(req, hosts, view="normal")
        host = self._pick(req, candidates, ctx)
        if host is None:
            return ScheduleResult(request=req, host=None, passes=2)
        plan = plan_for_host(host, req, self.cost_fn, now, cache=ctx.plan_cache)
        if not plan.feasible:
            return ScheduleResult(request=req, host=None, passes=2)
        return ScheduleResult(request=req, host=host.name, plan=plan, passes=2)


class PreemptibleScheduler(BaseScheduler):
    """The paper's single-pass preemptible-aware scheduler (Alg. 2 + Alg. 6).

    Normal requests filter against ``h_n`` (seeing through preemptible
    instances); preemptible requests filter against ``h_f``.  Weighing always
    uses ``h_f``.  The Alg. 5 subset computed while weighing
    (TerminationCostRank) is memoized in the per-call plan cache and reused by
    the final select-and-terminate — the single-pass efficiency claim.
    """

    def schedule(self, req: Request, hosts: Sequence[Host], now: float) -> ScheduleResult:
        ctx = WeighContext(now=now, cost_fn=self.cost_fn)
        view = "full" if req.preemptible else "normal"
        candidates = self._filter(req, hosts, view=view)
        host = self._pick(req, candidates, ctx)
        if host is None:
            return ScheduleResult(request=req, host=None, passes=1)
        if req.preemptible or req.resources.fits_in(host.free_full):
            return ScheduleResult(request=req, host=host.name, passes=1)
        # overcommitted → select and terminate (Alg. 6 line 3-4)
        plan = plan_for_host(host, req, self.cost_fn, now, cache=ctx.plan_cache)
        if not plan.feasible:
            return ScheduleResult(request=req, host=None, passes=1)
        return ScheduleResult(request=req, host=host.name, plan=plan, passes=1)


SCHEDULER_REGISTRY = {
    "filter": FilterScheduler,
    "retry": RetryScheduler,
    "preemptible": PreemptibleScheduler,
}
