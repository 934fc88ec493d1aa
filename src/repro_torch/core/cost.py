"""Cost modules for the select-and-terminate phase (paper Alg. 5).

A cost module scores a *set* of preemptible instances: the provider-side
damage of terminating exactly that set.  Alg. 5 picks the feasible subset with
minimal cost.  Modularity is a first-class requirement in the paper ("an
instance selection ... only based on the minimization of instances terminated
... may not work for a provider that wish to terminate the instances that
generate less revenues").

A verbatim copy of ``repro.core.cost`` (pure python), kept in the PyTorch port
so that it never imports the JAX package.
"""
from __future__ import annotations

import abc
from typing import Sequence

from .types import Instance

#: The paper's billing quantum: "commercial providers tend to charge by
#: complete periods of 1 h, so partial hours are not accounted".
BILL_PERIOD_S = 3600.0


class CostFunction(abc.ABC):
    name: str = "cost"

    @abc.abstractmethod
    def cost(self, instances: Sequence[Instance], now: float) -> float:
        ...


class PeriodCost(CostFunction):
    """Paper Alg. 4 / §4.2 cost: sum of *partial-period* run time.

    An instance whose run time is an exact multiple of the period costs 0 to
    terminate (the provider bills every started period, so nothing accrued in
    the current period is lost).  E.g. 120 min → 0; 119 min → 59 min lost.
    """

    name = "period"

    def __init__(self, period_s: float = BILL_PERIOD_S):
        self.period_s = float(period_s)

    def cost(self, instances: Sequence[Instance], now: float) -> float:
        # an instance carrying its own contract period bills by it
        # (``Instance.period``; the device path's ``inst_period`` column)
        return sum(
            i.run_time(now) % (i.period or self.period_s) for i in instances
        )


class CountCost(CostFunction):
    """Minimize the *number* of terminated instances (the naive policy the
    paper argues a provider may NOT want — kept as a baseline)."""

    name = "count"

    def cost(self, instances: Sequence[Instance], now: float) -> float:
        return float(len(instances))


class RevenueCost(CostFunction):
    """Lost revenue: unbilled partial period × the instance's price rate."""

    name = "revenue"

    def __init__(self, period_s: float = BILL_PERIOD_S):
        self.period_s = float(period_s)

    def cost(self, instances: Sequence[Instance], now: float) -> float:
        # per-instance contract periods (``Instance.period``) override the
        # shared billing quantum, exactly like the ``inst_period`` column
        def one(i: Instance) -> float:
            p = i.period or self.period_s
            return (i.run_time(now) % p) / p * i.price_rate

        return sum(one(i) for i in instances)


class RecomputeCost(CostFunction):
    """Beyond-paper, TPU adaptation: preempting a *training* job destroys the
    work done since its last durable checkpoint.  Cost = chip-seconds to
    recompute.  Jobs that just checkpointed are nearly free to evacuate —
    this couples the scheduler to the fault-tolerance layer (core/preemption).
    """

    name = "recompute"

    def cost(self, instances: Sequence[Instance], now: float) -> float:
        total = 0.0
        for i in instances:
            anchor = i.last_checkpoint if i.last_checkpoint is not None else i.start_time
            lost_s = max(0.0, now - anchor)
            chips = i.resources.vec[0]  # first dim is chips/vcpus by convention
            total += lost_s * max(1.0, chips)
        return total


class WeightedSumCost(CostFunction):
    """Combine cost modules with multipliers (provider policy composition)."""

    name = "weighted_sum"

    def __init__(self, parts: Sequence[tuple[float, CostFunction]]):
        self.parts = list(parts)

    def cost(self, instances: Sequence[Instance], now: float) -> float:
        return sum(m * c.cost(instances, now) for m, c in self.parts)


class MixedCost(CostFunction):
    """Heterogeneous per-instance billing: each instance is scored by ITS OWN
    kind (``Instance.cost_kind``; ``None`` falls back to ``default``), and a
    set's cost is the sum of those per-instance terms — still per-instance
    additive, so the whole two-stage device pipeline applies unchanged.

    This is the mixed spot/on-demand economics the paper's §5 payment-model
    discussion (and INDIGO-DataCloud) motivates: one fleet can bill some
    instances by partial period, others by count / lost revenue / recompute
    work.  The python oracle of the device path's kind-table selection
    (``SchedulerPolicy`` + the ``inst_cost_kind`` column); pinned
    decision-for-decision by tests/test_mixed_cost.py.

    ``kinds`` lists the extra kinds instances may carry beyond ``default``
    (the policy's cost-kind table); an instance carrying a kind outside the
    table is a configuration error and raises.
    """

    name = "mixed"

    def __init__(
        self,
        default: str = "period",
        kinds: Sequence[str] = (),
        period_s: float = BILL_PERIOD_S,
    ):
        self.default = str(default)
        self.kinds = tuple(str(k) for k in kinds)
        self.period_s = float(period_s)
        for kind in (self.default,) + self.kinds:
            if kind not in COST_REGISTRY:
                raise ValueError(
                    f"unknown cost kind {kind!r}; known: {sorted(COST_REGISTRY)}"
                )
        self._table = {self.default, *self.kinds}
        period_kw = {"period_s": self.period_s}
        self._fns = {
            kind: COST_REGISTRY[kind](
                **(period_kw if kind in ("period", "revenue") else {})
            )
            for kind in self._table
        }

    def kind_of(self, instance: Instance) -> str:
        kind = instance.cost_kind or self.default
        if kind not in self._table:
            raise ValueError(
                f"instance {instance.id} bills by {kind!r}, which is not in "
                f"this fleet's cost-kind table {sorted(self._table)}"
            )
        return kind

    def cost(self, instances: Sequence[Instance], now: float) -> float:
        return sum(
            self._fns[self.kind_of(i)].cost([i], now) for i in instances
        )


COST_REGISTRY = {
    "period": PeriodCost,
    "count": CountCost,
    "revenue": RevenueCost,
    "recompute": RecomputeCost,
}
