"""``SchedulerPolicy`` — the one frozen knob bundle of every decision path.

PyTorch-port copy of ``repro.core.policy``.  Two fields are gone:
``use_pallas`` and ``fused_screen`` chose a kernel backend in the JAX package;
here the device of the state's tensors chooses it (CPU tensors run the plain
PyTorch versions, CUDA tensors the hand-written kernels).  ``mesh`` is a
``fleet_sharding.FleetMesh`` (a tuple of devices, one a shard) instead of a
``jax.sharding.Mesh``.  ``donate`` is kept for field parity with the JAX
policy; the port always updates the state tensors in place.

Contracts:

* **Frozen + hashable + value-equal.**  Two policies built from the same
  field values are ``==`` and hash alike, and every field is hashable.
* **Decision-neutral execution knobs.**  ``shortlist`` and ``donate`` select
  how the answer is computed, never the answer itself.
  ``weigher_multipliers`` and the cost table define the answer: they are the
  provider's policy proper.

The **cost-kind table** (``cost_kind`` + ``cost_kinds``) lets one fleet bill
some instances by partial period, others by count / lost revenue / recompute
work, chosen per instance via the ``inst_cost_kind`` column of
``SoAFleetState`` (see ``torch_scheduler.mixed_slot_costs`` and
``cost.MixedCost``, the python oracle).  A single-kind policy never reads the
kind column.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .cost import (
    BILL_PERIOD_S,
    CostFunction,
    CountCost,
    MixedCost,
    PeriodCost,
    RecomputeCost,
    RevenueCost,
)

#: Canonical device-resident cost kinds; position = the kind id stored in
#: ``SoAFleetState.inst_cost_kind`` (-1 there = "use the policy default").
COST_KINDS: Tuple[str, ...] = ("period", "count", "revenue", "recompute")
COST_KIND_IDS = {kind: i for i, kind in enumerate(COST_KINDS)}

#: Default stage-2 shortlist size when ``shortlist=None`` (auto).
DEFAULT_SHORTLIST = 64


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


@dataclasses.dataclass(frozen=True)
class SchedulerPolicy:
    """Frozen, hashable bundle of every static decision knob.

    Fields (see docs/api.md for the full table):

    * ``weigher_multipliers`` — (overcommit, termination_cost, packing,
      straggler); the first two reproduce the paper's evaluation policy.
    * ``cost_kind`` — the DEFAULT billing kind: used for every slot whose
      ``inst_cost_kind`` is -1, and recorded on new placements whose request
      carries no explicit kind.
    * ``cost_kinds`` — extra kinds instances of this fleet may carry
      (the mixed-payment table).  Empty = homogeneous fleet, which compiles
      the exact single-kind program (bit-identical to the pre-policy path).
    * ``period`` — billing quantum (seconds) of the ``period``/``revenue``
      kinds.
    * ``shortlist`` — stage-2 candidate count M (None = auto, 0 = full
      enumeration).
    * ``adaptive_shortlist`` / ``adaptive_bounds`` — host-side controller
      resizing M between flushes within [m_min, m_max] (powers of two).
    * ``mesh`` — a 1-D ``FleetMesh`` (``fleet_sharding.fleet_mesh``): the
      screen runs per host-major shard with a bit-exact cross-shard merge;
      ``SoAFleet`` pads and shards its state at build.
    * ``donate`` — kept for parity with the JAX policy; the port updates
      the state in place whatever its value.
    * ``queue_capacity`` — slots in the device-resident admission queue
      (0 = admission plane off; ``core.admission`` untouched).
    * ``admit_batch`` — decisions per drain (the ``schedule_many`` batch the
      front end accumulates toward).
    * ``slo_target_s`` — admission-latency SLO (sim-time seconds): a drain
      is forced once the oldest waiting arrival has waited this long.
    * ``max_retries`` — placement attempts per queued request before it is
      rejected (1 = no backfill retry).
    * ``n_classes`` — priority classes; class 0 (interactive) drains first,
      class ``n_classes - 1`` (batch) last.
    * ``churn_multiplier`` — weight of the failure-domain churn weigher:
      hosts in zones with a high learned churn rate ẑ = T/max(U, ε) are
      penalized.  0 (default) compiles the exact churn-blind program.
    * ``churn_threshold`` — hard steering: zones whose ẑ exceeds this are
      filtered out for PREEMPTIBLE placements (normal work still lands).
      ``None`` = off.
    * ``storm_threshold`` — graceful degradation in the admission front
      end: when the FLEET-WIDE churn rate exceeds this, pending preemptible
      requests are admitted as non-preemptible instead of being exposed to
      the storm.  ``None`` = off.
    * ``aging_rate`` — anti-starvation aging (classes per second of queue
      wait): a queued entry's effective class decays toward 0 the longer it
      waits, as one more ``queue_select`` lexsort column.  0 = strict
      (class, seq) order, the pre-aging program.
    * ``relocate_threshold`` — the relocation plane's arming threshold: a
      zone whose learned churn rate ẑ exceeds it becomes an evacuation
      target (``SoAFleet.relocate``).  ``None`` (default) = the relocation
      plane is off entirely and no zone-exclusion operand is compiled.
    * ``relocate_exit`` — hysteresis exit: an armed zone disarms only when
      ẑ drops BELOW this (must be < ``relocate_threshold``; ``None`` =
      half the arming threshold), so a zone oscillating around the arming
      threshold never thrashes.
    * ``relocate_cooldown_s`` — per-zone cooldown after a disarm before the
      zone may re-arm.
    * ``relocate_budget`` — max victims evacuated per zone per relocation
      pass (bounds migration storms).
    * ``relocate_backoff_s`` — base of the per-zone exponential backoff
      after a failed relocation (doubles per consecutive failure).
    * ``relocate_every_s`` — period of the simulator's relocation trigger.
    """

    weigher_multipliers: Tuple[float, float, float, float] = (1.0, 1.0, 0.0, 0.0)
    churn_multiplier: float = 0.0
    churn_threshold: Optional[float] = None
    storm_threshold: Optional[float] = None
    cost_kind: str = "period"
    cost_kinds: Tuple[str, ...] = ()
    period: float = BILL_PERIOD_S
    shortlist: Optional[int] = None
    adaptive_shortlist: bool = False
    adaptive_bounds: Tuple[int, int] = (16, 256)
    mesh: object = None
    donate: bool = True
    queue_capacity: int = 0
    admit_batch: int = 32
    slo_target_s: float = 60.0
    max_retries: int = 8
    n_classes: int = 2
    aging_rate: float = 0.0
    relocate_threshold: Optional[float] = None
    relocate_exit: Optional[float] = None
    relocate_cooldown_s: float = 300.0
    relocate_budget: int = 4
    relocate_backoff_s: float = 30.0
    relocate_every_s: float = 60.0

    def __post_init__(self):
        # Tuple-normalize sequence fields so list-passing callers still get a
        # hashable (and value-equal) policy instead of a mid-trace TypeError.
        mult = tuple(float(m) for m in self.weigher_multipliers)
        if len(mult) != 4:
            raise ValueError(
                f"weigher_multipliers needs 4 entries (overcommit, "
                f"termination_cost, packing, straggler); got {len(mult)}"
            )
        object.__setattr__(self, "weigher_multipliers", mult)
        object.__setattr__(self, "churn_multiplier", float(self.churn_multiplier))
        for name in ("churn_threshold", "storm_threshold", "relocate_threshold"):
            val = getattr(self, name)
            if val is not None:
                val = float(val)
                if not val > 0:
                    raise ValueError(f"{name} must be positive or None, got {val}")
                object.__setattr__(self, name, val)
        # -- relocation plane -------------------------------------------------
        if self.relocate_exit is not None:
            exit_val = float(self.relocate_exit)
            if self.relocate_threshold is None:
                raise ValueError(
                    "relocate_exit without relocate_threshold (the plane is "
                    "off); set relocate_threshold to arm evacuation"
                )
            if not 0 < exit_val < self.relocate_threshold:
                raise ValueError(
                    f"relocate_exit must sit in (0, relocate_threshold="
                    f"{self.relocate_threshold}) for hysteresis, got {exit_val}"
                )
            object.__setattr__(self, "relocate_exit", exit_val)
        for name in ("relocate_cooldown_s", "relocate_backoff_s",
                     "relocate_every_s"):
            val = float(getattr(self, name))
            if not val > 0:
                raise ValueError(f"{name} must be positive, got {val}")
            object.__setattr__(self, name, val)
        if int(self.relocate_budget) < 1:
            raise ValueError(
                f"relocate_budget must be >= 1, got {self.relocate_budget}"
            )
        object.__setattr__(self, "relocate_budget", int(self.relocate_budget))
        if float(self.aging_rate) < 0:
            raise ValueError(f"aging_rate must be >= 0, got {self.aging_rate}")
        object.__setattr__(self, "aging_rate", float(self.aging_rate))
        kinds = tuple(str(k) for k in self.cost_kinds)
        object.__setattr__(self, "cost_kinds", kinds)
        for kind in (self.cost_kind,) + kinds:
            if kind not in COST_KIND_IDS:
                raise ValueError(
                    f"unknown cost kind {kind!r}; device-resident kinds are "
                    f"{COST_KINDS} (others must use the rebuild path)"
                )
        if not self.period > 0:
            raise ValueError(f"period must be positive, got {self.period}")
        if self.shortlist is not None and int(self.shortlist) < 0:
            raise ValueError(f"shortlist must be >= 0 or None, got {self.shortlist}")
        if self.shortlist is not None:
            object.__setattr__(self, "shortlist", int(self.shortlist))
        lo, hi = (int(b) for b in self.adaptive_bounds)
        if not (_is_pow2(lo) and _is_pow2(hi)):
            raise ValueError(
                f"adaptive_bounds must be powers of two (M doubles/halves "
                f"between them), got {self.adaptive_bounds}"
            )
        if lo > hi:
            raise ValueError(f"adaptive_bounds m_min > m_max: {self.adaptive_bounds}")
        object.__setattr__(self, "adaptive_bounds", (lo, hi))
        if self.adaptive_shortlist and self.shortlist == 0:
            # The starting M itself may sit outside adaptive_bounds (the
            # pre-policy controller accepted that and clamps as it moves);
            # only the genuinely contradictory setting is rejected.
            raise ValueError(
                "adaptive_shortlist=True contradicts shortlist=0 (explicit "
                "full enumeration); pass shortlist=None or a starting M"
            )
        if self.mesh is not None:
            from .fleet_sharding import FleetMesh

            if not isinstance(self.mesh, FleetMesh):
                raise ValueError(
                    "mesh must be a 1-D FleetMesh (see fleet_sharding.fleet_mesh)"
                )
        # -- admission plane --------------------------------------------------
        qc, ab = int(self.queue_capacity), int(self.admit_batch)
        mr, nc = int(self.max_retries), int(self.n_classes)
        if qc < 0:
            raise ValueError(f"queue_capacity must be >= 0 (0 = off), got {qc}")
        if ab < 1:
            raise ValueError(f"admit_batch must be >= 1, got {ab}")
        if qc and ab > qc:
            raise ValueError(
                f"admit_batch ({ab}) cannot exceed queue_capacity ({qc}); a "
                "drain selects at most the whole queue"
            )
        if not float(self.slo_target_s) > 0:
            raise ValueError(
                f"slo_target_s must be positive, got {self.slo_target_s}"
            )
        if mr < 1:
            raise ValueError(f"max_retries must be >= 1, got {mr}")
        if nc < 1:
            raise ValueError(f"n_classes must be >= 1, got {nc}")
        if nc > 255:
            raise ValueError(
                f"n_classes must be <= 255, got {nc}: drain order sorts one "
                "packed key whose class field is at most 8 of its low 32 "
                "bits (see core/admission.py queue_select)"
            )
        object.__setattr__(self, "queue_capacity", qc)
        object.__setattr__(self, "admit_batch", ab)
        object.__setattr__(self, "slo_target_s", float(self.slo_target_s))
        object.__setattr__(self, "max_retries", mr)
        object.__setattr__(self, "n_classes", nc)

    # -- weigher multipliers ---------------------------------------------------
    @property
    def all_multipliers(self) -> Tuple[float, float, float, float, float]:
        """The public 4-tuple extended with the churn multiplier — the 5-slot
        form every screen backend consumes (``screen_math``)."""
        return self.weigher_multipliers + (self.churn_multiplier,)

    @property
    def churn_aware(self) -> bool:
        """True when decisions read the zone-churn plane at all (weigher or
        hard steering) — gates the extra stage-1 input statically."""
        return bool(self.churn_multiplier) or self.churn_threshold is not None

    # -- relocation plane -----------------------------------------------------
    @property
    def relocation_on(self) -> bool:
        """True when the hot-zone relocation plane is enabled — gates the
        per-request zone-exclusion operand statically, the same way
        ``churn_aware`` gates the churn row: relocation-off policies compile
        the exact pre-relocation program."""
        return self.relocate_threshold is not None

    @property
    def relocate_exit_threshold(self) -> float:
        """The resolved hysteresis exit (``relocate_exit`` or half the
        arming threshold).  Only meaningful when :attr:`relocation_on`."""
        if self.relocate_threshold is None:
            raise ValueError("relocation plane is off (relocate_threshold=None)")
        if self.relocate_exit is not None:
            return self.relocate_exit
        return self.relocate_threshold / 2.0

    # -- cost-kind table ------------------------------------------------------
    @property
    def kind_table(self) -> Tuple[str, ...]:
        """Distinct kinds this fleet may bill, default first."""
        extra = tuple(k for k in dict.fromkeys(self.cost_kinds) if k != self.cost_kind)
        return (self.cost_kind,) + extra

    @property
    def mixed(self) -> bool:
        """True when more than one billing kind is in play (the kind column
        is read; single-kind policies never touch it)."""
        return len(self.kind_table) > 1

    @property
    def default_kind_id(self) -> int:
        return COST_KIND_IDS[self.cost_kind]

    def max_shortlist(self) -> int:
        """Largest M a decision under this policy can run with — the adaptive
        ceiling when the controller is on; what sharded fleets pad for."""
        if self.adaptive_shortlist:
            return self.adaptive_bounds[1]
        return DEFAULT_SHORTLIST if self.shortlist is None else self.shortlist

    # -- python cost-module bridge --------------------------------------------
    @classmethod
    def for_cost(cls, cost_fn: Optional[CostFunction], **overrides) -> "SchedulerPolicy":
        """Build a policy whose cost table mirrors a python cost module
        (the inverse of :meth:`make_cost_fn`).  ``MixedCost`` maps to a
        multi-kind table; the four single-kind modules map to themselves."""
        cost_fn = cost_fn or PeriodCost()
        if isinstance(cost_fn, MixedCost):
            fields = dict(
                cost_kind=cost_fn.default,
                cost_kinds=tuple(cost_fn.kinds),
                period=cost_fn.period_s,
            )
        elif isinstance(cost_fn, PeriodCost):
            fields = dict(cost_kind="period", period=cost_fn.period_s)
        elif isinstance(cost_fn, CountCost):
            fields = dict(cost_kind="count")
        elif isinstance(cost_fn, RevenueCost):
            fields = dict(cost_kind="revenue", period=cost_fn.period_s)
        elif isinstance(cost_fn, RecomputeCost):
            fields = dict(cost_kind="recompute")
        else:
            raise ValueError(
                f"cost function {cost_fn.name!r} has no device-resident "
                "equivalent; use the rebuild path (build_soa_state + "
                "schedule_decision)"
            )
        fields.update(overrides)
        return cls(**fields)

    def make_cost_fn(self) -> CostFunction:
        """The python cost module equivalent to this policy's cost table —
        the oracle the parity tests rebuild states with."""
        if self.mixed:
            return MixedCost(
                default=self.cost_kind, kinds=self.cost_kinds, period_s=self.period
            )
        return {
            "period": lambda: PeriodCost(self.period),
            "count": CountCost,
            "revenue": lambda: RevenueCost(self.period),
            "recompute": RecomputeCost,
        }[self.cost_kind]()


def ensure_policy(
    policy: Optional[SchedulerPolicy],
    where: str,
    cost_fn: Optional[CostFunction] = None,
) -> SchedulerPolicy:
    """Validate/derive the policy an entry point will compile against.

    ``None`` derives a policy from ``cost_fn`` (or the all-defaults policy).
    An explicit policy passes through type-checked — and, when ``cost_fn``
    is ALSO given, checked for billing agreement: billing was historically
    derived from ``cost_fn``, so a policy that bills differently from an
    explicitly-passed cost module would silently reprice decisions — make
    the disagreement loud instead.
    """
    if policy is None:
        return SchedulerPolicy.for_cost(cost_fn)
    if not isinstance(policy, SchedulerPolicy):
        raise TypeError(f"{where}(): policy must be a SchedulerPolicy")
    if cost_fn is not None:
        derived = SchedulerPolicy.for_cost(cost_fn)
        if (
            derived.cost_kind != policy.cost_kind
            or set(derived.kind_table) != set(policy.kind_table)
            or derived.period != policy.period
        ):
            raise ValueError(
                f"{where}(): cost_fn={cost_fn.name!r} bills "
                f"{derived.kind_table} @ period={derived.period} but the "
                f"given policy bills {policy.kind_table} @ "
                f"period={policy.period}; drop cost_fn or build the "
                "policy with SchedulerPolicy.for_cost(cost_fn, ...)"
            )
    return policy
