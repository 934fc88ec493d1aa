"""Cluster state machine: the fleet of hosts plus instance lifecycle.

Applies ``ScheduleResult``s produced by a scheduler: evacuates the planned
preemptible instances (through the preemption protocol, which gives training
jobs a checkpoint window) and places the new instance.

A verbatim copy of ``repro.core.cluster`` (pure python), kept in the PyTorch
port so that it never imports the JAX package; ``Cluster.from_fleet`` reads
the port's ``SoAFleet``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from .scheduler import BaseScheduler
from .types import (
    Host,
    Instance,
    Request,
    Resources,
    ScheduleError,
    ScheduleResult,
)

PreemptHook = Callable[[Instance, float], None]


@dataclasses.dataclass
class ClusterStats:
    placed: int = 0
    failed: int = 0
    preemptions: int = 0
    #: provider-side cost paid to preemptions (per the active cost function).
    preemption_cost: float = 0.0


class Cluster:
    """Mutable fleet state + instance lifecycle."""

    def __init__(self, hosts: Iterable[Host]):
        self.hosts: Dict[str, Host] = {h.name: h for h in hosts}
        self.stats = ClusterStats()
        self._ids = itertools.count()
        #: hooks fired on preemption (checkpoint protocol, accounting, ...).
        self.preempt_hooks: List[PreemptHook] = []
        #: ids of preempted instances, for re-queueing (elasticity).
        self.preempted: List[Instance] = []

    # -- views ----------------------------------------------------------------
    def host_list(self) -> List[Host]:
        return list(self.hosts.values())

    def instances(self) -> List[Instance]:
        return [i for h in self.hosts.values() for i in h.instances.values()]

    def utilization(self) -> float:
        """Fraction of total capacity in use (first resource dim)."""
        cap = sum(h.capacity.vec[0] for h in self.hosts.values())
        used = sum(h.used().vec[0] for h in self.hosts.values())
        return used / cap if cap else 0.0

    def utilization_normal(self) -> float:
        cap = sum(h.capacity.vec[0] for h in self.hosts.values())
        used = sum(h.used(include_preemptible=False).vec[0] for h in self.hosts.values())
        return used / cap if cap else 0.0

    # -- lifecycle --------------------------------------------------------------
    def apply(
        self, result: ScheduleResult, now: float, price_rate: float = 1.0
    ) -> Optional[Instance]:
        """Apply a scheduling decision: evacuate the plan, place the instance."""
        if not result.ok:
            self.stats.failed += 1
            return None
        host = self.hosts[result.host]
        for victim in result.plan.instances:
            self.preempt(victim, now)
        inst = Instance(
            id=f"i{next(self._ids)}-{result.request.id}",
            resources=result.request.resources,
            preemptible=result.request.preemptible,
            host=host.name,
            start_time=now,
            user=result.request.user,
            price_rate=price_rate,
        )
        host.place(inst)
        self.stats.placed += 1
        self.stats.preemption_cost += result.plan.cost
        return inst

    def preempt(self, inst: Instance, now: float) -> None:
        """Terminate a preemptible instance (checkpoint hooks fire first)."""
        for hook in self.preempt_hooks:
            hook(inst, now)
        host = self.hosts[inst.host]
        host.remove(inst.id)
        self.stats.preemptions += 1
        self.preempted.append(inst)

    def terminate(self, inst: Instance) -> None:
        """Voluntary termination (end of lifetime) — no preemption hooks."""
        self.hosts[inst.host].remove(inst.id)

    def schedule_and_place(
        self,
        scheduler: BaseScheduler,
        req: Request,
        now: float,
    ) -> Optional[Instance]:
        result = scheduler.schedule(req, self.host_list(), now)
        return self.apply(result, now)

    @classmethod
    def from_fleet(cls, fleet) -> "Cluster":
        """Materialize a python ``Cluster`` from an incremental ``SoAFleet``
        (fast-path → python-tooling bridge; placement re-validates capacity)."""
        cluster = cls(fleet.sync_hosts())
        cluster.preempted = list(fleet.preempted)
        cluster.stats.preemptions = len(fleet.preempted)
        return cluster


def make_uniform_fleet(
    n_hosts: int,
    capacity: Resources,
    domain_size: int = 0,
    name_prefix: str = "host",
) -> List[Host]:
    """Build a uniform fleet; ``domain_size`` groups hosts into ICI domains."""
    hosts = []
    for i in range(n_hosts):
        dom = f"dom{i // domain_size}" if domain_size else "d0"
        hosts.append(Host(name=f"{name_prefix}-{i}", capacity=capacity, domain=dom))
    return hosts
