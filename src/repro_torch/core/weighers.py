"""Modular host weighers (phase 2 of the paper's Alg. 2).

Weighing ALWAYS sees the full host state ``h_f`` — ranking the "costless"
host requires knowing which preemptible instances sit on it (paper §3.1).

Normalization follows OpenStack (paper §4.1):

    Ω(h) = Σ_i  m_i · N(w_i(h)),      N(w) = (w − min W) / (max W − min W)

with N ≡ 0 when all weights are equal.  The best host is the Ω-argmax with
random tie-breaking.

Paper-fidelity note: the paper's prose Alg. 4 (PeriodRank) sums the partial
periods of *all* preemptible instances on a host, but its evaluation
(Table 5: host-A chosen with min-subset cost 55 over host-B's single-instance
cost 58, despite host-A's all-instance sum being 113) shows the implementation
ranked hosts by the *cost of the optimal termination subset* — i.e. Alg. 5's
objective evaluated during weighing.  We provide both: ``PeriodRank`` (the
literal Alg. 4) and ``TerminationCostRank`` (what reproduces Tables 3–6, and
what our PreemptibleScheduler uses by default, sharing its subset computation
with the terminate phase through a plan cache).

A verbatim copy of ``repro.core.weighers`` (numpy only), kept in the
PyTorch port so that it never imports the JAX package.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .cost import BILL_PERIOD_S, CostFunction, PeriodCost
from .select_terminate import plan_for_host
from .types import Host, Request


@dataclasses.dataclass
class WeighContext:
    """Shared state for one scheduling call."""

    now: float
    cost_fn: CostFunction
    #: memoized Alg. 5 plans, shared between weighing and termination.
    plan_cache: Dict[tuple, object] = dataclasses.field(default_factory=dict)


class Weigher(abc.ABC):
    name: str = "weigher"
    multiplier: float = 1.0

    @abc.abstractmethod
    def weight(self, req: Request, host: Host, ctx: WeighContext) -> float:
        ...


class OvercommitRank(Weigher):
    """Paper Alg. 3: −1 when placing the request would overcommit ``h_f``
    (i.e. requires terminating preemptible instances), else 0."""

    name = "overcommit"

    def weight(self, req: Request, host: Host, ctx: WeighContext) -> float:
        return -1.0 if not req.resources.fits_in(host.free_full) else 0.0


class PeriodRank(Weigher):
    """Paper Alg. 4, literal: −Σ (run_time mod period) over ALL preemptible
    instances on the host."""

    name = "period"

    def __init__(self, period_s: float = BILL_PERIOD_S):
        self.period_s = float(period_s)

    def weight(self, req: Request, host: Host, ctx: WeighContext) -> float:
        w = 0.0
        for inst in host.preemptible_instances():
            w += inst.run_time(ctx.now) % self.period_s
        return -w


class TerminationCostRank(Weigher):
    """Rank hosts by −(cost of the optimal Alg. 5 termination subset); 0 when
    no termination is needed.  Reproduces the paper's Tables 3–6.  Infeasible
    hosts get −inf (they should already have been filtered out)."""

    name = "termination_cost"

    def weight(self, req: Request, host: Host, ctx: WeighContext) -> float:
        plan = plan_for_host(host, req, ctx.cost_fn, ctx.now, cache=ctx.plan_cache)
        if not plan.feasible:
            return -float("inf")
        return -plan.cost


class PackingRank(Weigher):
    """Prefer fuller hosts (consolidation → fewer preemptions later).
    Weight = −Σ normalized free capacity of ``h_f``."""

    name = "packing"

    def weight(self, req: Request, host: Host, ctx: WeighContext) -> float:
        cap = np.maximum(host.capacity.vec, 1e-9)
        return -float(np.sum(host.free_full.vec / cap))


class StragglerRank(Weigher):
    """TPU adaptation: penalize historically slow hosts (heartbeat-derived
    ``slow_factor``) so synchronous-SPMD jobs avoid stragglers."""

    name = "straggler"

    def weight(self, req: Request, host: Host, ctx: WeighContext) -> float:
        return -float(host.slow_factor)


def normalized_weights(
    weighers: Sequence[Weigher],
    req: Request,
    hosts: Sequence[Host],
    ctx: WeighContext,
) -> np.ndarray:
    """OpenStack-style Ω for each host: Σ m_i · N(w_i(h))."""
    if not hosts:
        return np.zeros(0)
    omega = np.zeros(len(hosts))
    for wg in weighers:
        raw = np.array([wg.weight(req, h, ctx) for h in hosts], dtype=np.float64)
        finite = np.isfinite(raw)
        if not finite.any():
            continue
        lo = raw[finite].min()
        hi = raw[finite].max()
        if hi - lo < 1e-12:
            norm = np.zeros_like(raw)
        else:
            norm = (raw - lo) / (hi - lo)
        norm[~finite] = -np.inf  # infeasible hosts can never win
        omega = omega + wg.multiplier * norm
    return omega


DEFAULT_WEIGHERS: Sequence[Weigher] = (
    OvercommitRank(),
    TerminationCostRank(),
)

WEIGHER_REGISTRY = {
    "overcommit": OvercommitRank,
    "period": PeriodRank,
    "termination_cost": TerminationCostRank,
    "packing": PackingRank,
    "straggler": StragglerRank,
}
