"""Core control-plane types for the preemptible-aware scheduler.

The paper (López García et al., FGCS 2019) schedules VM requests onto physical
hosts.  In `repro` the same algebra places *jobs* (training / serving shards)
onto TPU hosts; the resource vector is generic so both the paper's testbed
(vCPU / RAM / disk) and the TPU fleet (chips / HBM / host-RAM) are expressible.

A verbatim copy of ``repro.core.types`` (numpy only): importing the JAX
package's module would run ``repro/core/__init__.py``, which loads JAX, so the
PyTorch port keeps its own copy.  The parity tests compare the two.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Resource vectors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    """Names the dimensions of a resource vector."""

    dims: Tuple[str, ...]

    def zeros(self) -> "Resources":
        return Resources(self, np.zeros(len(self.dims)))

    def make(self, **kwargs: float) -> "Resources":
        vec = np.zeros(len(self.dims))
        for key, val in kwargs.items():
            vec[self.dims.index(key)] = float(val)
        return Resources(self, vec)


#: The paper's testbed dimensions (Table 1 / Table 2).
VM_SPEC = ResourceSpec(("vcpus", "ram_mb", "disk_gb"))
#: TPU fleet dimensions used by the `repro` cluster runtime.
TPU_SPEC = ResourceSpec(("chips", "hbm_gb", "host_ram_gb"))


@dataclasses.dataclass(frozen=True)
class Resources:
    """Immutable resource vector with component-wise algebra."""

    spec: ResourceSpec
    vec: np.ndarray

    def __post_init__(self):  # defensive copy + freeze
        v = np.asarray(self.vec, dtype=np.float64).copy()
        v.setflags(write=False)
        object.__setattr__(self, "vec", v)

    # -- algebra ------------------------------------------------------------
    def __add__(self, other: "Resources") -> "Resources":
        self._check(other)
        return Resources(self.spec, self.vec + other.vec)

    def __sub__(self, other: "Resources") -> "Resources":
        self._check(other)
        return Resources(self.spec, self.vec - other.vec)

    def __le__(self, other: "Resources") -> bool:
        self._check(other)
        return bool(np.all(self.vec <= other.vec + 1e-9))

    def fits_in(self, free: "Resources") -> bool:
        """True when this request fits inside ``free`` on every dimension."""
        return self <= free

    @property
    def vec32(self) -> np.ndarray:
        """float32 view for the device-resident SoA paths (resource values
        are small integers in practice, so the cast is exact)."""
        return np.asarray(self.vec, dtype=np.float32)

    def any_negative(self) -> bool:
        return bool(np.any(self.vec < -1e-9))

    def get(self, dim: str) -> float:
        return float(self.vec[self.spec.dims.index(dim)])

    def _check(self, other: "Resources") -> None:
        if self.spec is not other.spec and self.spec != other.spec:
            raise ValueError(f"resource spec mismatch: {self.spec} vs {other.spec}")

    def __repr__(self) -> str:
        parts = ", ".join(f"{d}={v:g}" for d, v in zip(self.spec.dims, self.vec))
        return f"Resources({parts})"


def sum_resources(spec: ResourceSpec, items: Iterable[Resources]) -> Resources:
    total = np.zeros(len(spec.dims))
    for it in items:
        total = total + it.vec
    return Resources(spec, total)


# ---------------------------------------------------------------------------
# Requests and instances
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Flavor:
    """A named instance size (paper Table 2: small / medium / large)."""

    name: str
    resources: Resources


@dataclasses.dataclass(frozen=True)
class Request:
    """A placement request (VM in the paper; job shard in `repro`).

    ``preemptible`` selects the host-state view used during filtering
    (Alg. 2): normal requests filter against ``h_n``, preemptible against
    ``h_f``.
    """

    id: str
    resources: Resources
    preemptible: bool = False
    user: str = "anon"
    #: Optional ICI-domain constraint (TPU adaptation): a job restricted to a
    #: contiguous slice domain.  ``None`` means any domain.
    domain: Optional[str] = None
    #: Billing kind this request's instance will be scored under at
    #: termination time ("period" | "count" | "revenue" | "recompute");
    #: ``None`` = the fleet policy's default kind.  Mixed-payment fleets
    #: (``SchedulerPolicy.cost_kinds`` / ``cost.MixedCost``) set this per
    #: request; homogeneous fleets leave it None.
    cost_kind: Optional[str] = None
    #: Admission-priority class for the streaming front end
    #: (``core.admission``): 0 = highest (interactive), larger = lower.
    #: ``None`` derives the class from ``preemptible`` — normal requests are
    #: interactive (class 0), preemptible requests are batch (the lowest
    #: class).  Ignored by the direct (unqueued) entry points.
    priority: Optional[int] = None
    #: Per-instance billing period in seconds for the period/revenue kinds
    #: (contract terms vary per customer class); ``None`` = the fleet
    #: policy's shared ``period``.
    period: Optional[float] = None
    #: Hard zone exclusion: the decision pipeline filters every host in this
    #: failure zone out of stage 1, regardless of churn state.  Set by the
    #: relocation plane on evacuation re-placements so a victim can never be
    #: re-placed into the zone it is fleeing; ``None`` = no exclusion.
    exclude_zone: Optional[str] = None
    metadata: Mapping[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Instance:
    """A placed instance/job-shard occupying resources on a host."""

    id: str
    resources: Resources
    preemptible: bool
    host: str
    start_time: float
    user: str = "anon"
    #: $/hour equivalent used by revenue-aware cost modules.
    price_rate: float = 1.0
    #: Timestamp of the last durable checkpoint (training jobs).  Used by the
    #: beyond-paper RecomputeCost module: preempting a job that checkpointed
    #: recently is cheap.
    last_checkpoint: Optional[float] = None
    #: Billing kind this instance is scored under (mirrors
    #: ``Request.cost_kind``); ``None`` = the fleet policy's default.
    cost_kind: Optional[str] = None
    #: Per-instance billing period in seconds (mirrors ``Request.period``);
    #: ``None`` = the fleet policy's shared ``period``.
    period: Optional[float] = None
    metadata: Dict[str, object] = dataclasses.field(default_factory=dict)

    def run_time(self, now: float) -> float:
        return max(0.0, now - self.start_time)


# ---------------------------------------------------------------------------
# Dual host state (the paper's central data structure)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Host:
    """A physical host with the paper's dual resource views.

    ``free_full``  — the ``h_f`` view: every running instance counted.
    ``free_normal`` — the ``h_n`` view: preemptible instances *not* counted,
    so a normal request can "see through" them during filtering.
    """

    name: str
    capacity: Resources
    domain: str = "d0"
    #: Failure domain (cloud zone / rack): preemption-storm correlation and
    #: the learned churn rates are tracked per zone, not per host.
    zone: str = "z0"
    #: hosts marked unschedulable (drain / failure) are filtered out.
    schedulable: bool = True
    #: Relative slowness factor learned from heartbeats (1.0 == nominal);
    #: used by the straggler-aware weigher.
    slow_factor: float = 1.0
    instances: Dict[str, Instance] = dataclasses.field(default_factory=dict)

    # -- derived views -------------------------------------------------------
    def used(self, include_preemptible: bool = True) -> Resources:
        return sum_resources(
            self.capacity.spec,
            (
                i.resources
                for i in self.instances.values()
                if include_preemptible or not i.preemptible
            ),
        )

    @property
    def free_full(self) -> Resources:
        """``h_f``: free resources counting ALL instances."""
        return self.capacity - self.used(include_preemptible=True)

    @property
    def free_normal(self) -> Resources:
        """``h_n``: free resources counting only NON-preemptible instances."""
        return self.capacity - self.used(include_preemptible=False)

    def preemptible_instances(self) -> List[Instance]:
        return [i for i in self.instances.values() if i.preemptible]

    def normal_instances(self) -> List[Instance]:
        return [i for i in self.instances.values() if not i.preemptible]

    # -- mutation (used by the cluster state machine) ------------------------
    def place(self, inst: Instance) -> None:
        if inst.id in self.instances:
            raise ValueError(f"duplicate instance id {inst.id} on {self.name}")
        if not inst.resources.fits_in(self.free_full):
            raise ValueError(
                f"instance {inst.id} does not fit on {self.name}: "
                f"need {inst.resources}, free {self.free_full}"
            )
        inst.host = self.name
        self.instances[inst.id] = inst

    def remove(self, instance_id: str) -> Instance:
        return self.instances.pop(instance_id)


# ---------------------------------------------------------------------------
# Scheduling outcomes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TerminationPlan:
    """Alg. 5 output: the cost-minimal feasible set of preemptible instances
    whose evacuation (plus existing free resources) admits the request."""

    instances: Tuple[Instance, ...]
    cost: float
    feasible: bool

    @property
    def ids(self) -> Tuple[str, ...]:
        return tuple(i.id for i in self.instances)


EMPTY_PLAN = TerminationPlan(instances=(), cost=0.0, feasible=True)
INFEASIBLE_PLAN = TerminationPlan(instances=(), cost=float("inf"), feasible=False)


@dataclasses.dataclass(frozen=True)
class ScheduleResult:
    """Outcome of one scheduling call."""

    request: Request
    host: Optional[str]
    plan: TerminationPlan = EMPTY_PLAN
    #: number of filter/weigh passes executed (1 for the paper's design,
    #: 2 for the retry baseline when termination triggers).
    passes: int = 1

    @property
    def ok(self) -> bool:
        return self.host is not None


class ScheduleError(RuntimeError):
    """Raised when a request cannot be scheduled (maps to the paper's
    'failure process defined in the scheduling algorithm')."""
