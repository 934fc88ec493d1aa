"""The port's decision path (``schedule_step`` / ``schedule_many`` and the
transitions, on CPU tensors: the plain versions of the kernels) against the
JAX package's jitted path on 512-host saturated fleets.

Both sides start from the same state (the JAX builder's arrays carried
across with ``convert``) and receive the same integer-regime request stream:
every decision tuple ``(host_idx, slot, ok, kill, fell_back, margin)`` and
every final state array must be bitwise equal.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_scheduler as jref
from repro.core.policy import SchedulerPolicy as JPolicy
from repro.core.types import VM_SPEC as JVM, Host as JHost, Instance as JInst, Resources as JRes
from repro_torch.core import fleets
from repro_torch.core import torch_scheduler as port
from repro_torch.core.convert import fleet_state_from_numpy, fleet_state_to_numpy
from repro_torch.core.policy import SchedulerPolicy as TPolicy

torch.set_num_threads(1)

KINDS = ("period", "count", "revenue", "recompute")


def jax_hosts(hosts):
    """The JAX package's own Host objects for a port-built fleet."""
    out = []
    for h in hosts:
        jh = JHost(name=h.name, capacity=JRes(JVM, h.capacity.vec), domain=h.domain,
                   zone=h.zone, schedulable=h.schedulable, slow_factor=h.slow_factor)
        for inst in h.instances.values():
            jh.place(JInst(id=inst.id, resources=JRes(JVM, inst.resources.vec),
                           preemptible=inst.preemptible, host=jh.name,
                           start_time=inst.start_time, price_rate=inst.price_rate))
        out.append(jh)
    return out


def _states(n, seed, zones=1):
    hosts = fleets.saturated_fleet(n, seed=seed)
    for i, h in enumerate(hosts):
        h.zone = f"z{i % zones}"
    jstate, _ = jref.build_fleet_state(jax_hosts(hosts), k_slots=8)
    arrays = {f: np.asarray(getattr(jstate, f)) for f in port.STATE_DTYPES}
    return jstate, fleet_state_from_numpy(arrays, device="cpu")


def _requests(rng, b, t0, kinds):
    flav = np.stack([s.vec for s in fleets.SIZES.values()]).astype(np.float32)
    res = flav[rng.integers(0, 3, b)]
    pre = rng.random(b) < 0.5
    now = (t0 + np.cumsum(rng.integers(1, 30, b))).astype(np.float32)
    price = rng.integers(1, 5, b).astype(np.float32)
    kind = rng.integers(-1, kinds, b).astype(np.int32) if kinds else np.full(b, -1, np.int32)
    return res, pre, np.full(b, -1, np.int32), now, price, kind


def _assert_states(tstate, jstate):
    got = fleet_state_to_numpy(tstate)
    for f in port.STATE_DTYPES:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jstate, f)), err_msg=f)


def _assert_outs(tout, jout, what):
    names = ("host_idx", "slot", "ok", "kill", "fell_back", "margin")
    for t, j, name in zip(tout, jout, names):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f"{what}: {name}")


def _run_batches(tpol, jpol, n_batches=3, b=40, seed=0, kinds=0, zones=1):
    jstate, tstate = _states(512, seed, zones)
    rng = np.random.default_rng(seed + 1)
    t = float(fleets.NOW)
    fell = 0
    for i in range(n_batches):
        res, pre, dom, now, price, kind = _requests(rng, b, t, kinds)
        t = float(now[-1])
        jstate, jout = jref.schedule_many(jstate, res, pre, dom, now, price,
                                          policy=jpol, req_cost_kind=kind)
        tstate, tout = port.schedule_many(tstate, res, pre, dom, now, price,
                                          policy=tpol, req_cost_kind=kind)
        _assert_outs(tout, jout, f"batch {i}")
        fell += int(tout[4].sum())
    _assert_states(tstate, jstate)
    return fell


@pytest.mark.parametrize("kind", KINDS)
def test_schedule_many_each_cost_kind(kind):
    _run_batches(TPolicy(cost_kind=kind, shortlist=16),
                 JPolicy(cost_kind=kind, shortlist=16), seed=KINDS.index(kind))


def test_schedule_many_mixed_cost_table():
    table = ("count", "revenue", "recompute")
    _run_batches(TPolicy(cost_kinds=table, shortlist=16),
                 JPolicy(cost_kinds=table, shortlist=16), seed=7, kinds=4)


def test_schedule_many_default_policy_and_weighers():
    """shortlist=None resolves to M=64 at 512 hosts; the churn weigher and
    threshold read per-zone accumulators fed by the batch's own kills."""
    _run_batches(TPolicy(), JPolicy(), seed=3)
    mult = (1.0, 1.0, 0.5, 0.25)
    _run_batches(
        TPolicy(weigher_multipliers=mult, churn_multiplier=2.0, churn_threshold=0.001),
        JPolicy(weigher_multipliers=mult, churn_multiplier=2.0, churn_threshold=0.001),
        seed=4, zones=4)


@pytest.mark.parametrize("mult,churn", [((1.0, 1.0, 0.05, 0.0), 2.0),
                                         ((1.0, 0.7, 1.3, 0.9), 0.0),
                                         ((0.3, 0.7, 1.3, 0.0), 0.0)])
def test_schedule_many_fractional_multipliers(mult, churn):
    """Multipliers that are not powers of two round their products, so the
    reference's fused multiply-adds show in every score and margin: the
    port mirrors them bitwise through the whole pipeline."""
    kw = dict(weigher_multipliers=mult, churn_multiplier=churn, shortlist=16)
    if churn:
        kw["churn_threshold"] = 0.5
    _run_batches(TPolicy(**kw), JPolicy(**kw), n_batches=2, seed=4, zones=4)


def _random_arrays(rng, n, k=6):
    """An integer-regime fleet whose slots hold uneven multi-dim resources:
    the stage-1 bounds are loose, so a small shortlist often cannot certify
    its winner."""
    start = (fleets.NOW - rng.integers(10, 500, (n, k)) * 60.0).astype(np.float32)
    return dict(
        free_f=rng.integers(0, 5, (n, 3)).astype(np.float32),
        free_n=rng.integers(4, 12, (n, 3)).astype(np.float32),
        schedulable=rng.random(n) < 0.95,
        domain=np.zeros(n, np.int32),
        slow=rng.integers(1, 4, n).astype(np.float32),
        inst_res=rng.integers(0, 5, (n, k, 3)).astype(np.float32),
        inst_start=start, inst_price=np.ones((n, k), np.float32), inst_ckpt=start,
        inst_cost_kind=np.full((n, k), -1, np.int32),
        inst_period=np.full((n, k), -1.0, np.float32),
        inst_valid=rng.random((n, k)) < 0.8,
        host_zone=np.zeros(n, np.int32),
        zone_term=np.zeros(1, np.float32), zone_up=np.zeros(1, np.float32),
    )


@pytest.mark.parametrize("m", [1, 4])
def test_forced_fallbacks_match(m):
    """Loose bounds and a tiny shortlist: the full enumeration runs, and
    both sides fall back on the same decisions."""
    rng = np.random.default_rng(m)
    arrays = _random_arrays(rng, 256)
    jstate = jref.SoAFleetState(**{f: jnp.asarray(v) for f, v in arrays.items()})
    tstate = fleet_state_from_numpy(arrays, device="cpu")
    b = 64
    res = rng.integers(1, 7, (b, 3)).astype(np.float32)
    pre = np.zeros(b, bool)
    now = (fleets.NOW + np.arange(b) * 60.0).astype(np.float32)
    args = (res, pre, np.full(b, -1, np.int32), now, np.ones(b, np.float32))
    jstate, jout = jref.schedule_many(jstate, *args, policy=JPolicy(shortlist=m))
    tstate, tout = port.schedule_many(tstate, *args, policy=TPolicy(shortlist=m))
    _assert_outs(tout, jout, "fallback batch")
    _assert_states(tstate, jstate)
    assert int(tout[4].sum()) > 0


def test_full_enumeration_path():
    """shortlist=0 (no pruning) and M >= N take the single-stage path."""
    _run_batches(TPolicy(shortlist=0), JPolicy(shortlist=0), n_batches=2, seed=6)


def test_schedule_step_and_transitions_with_now():
    """schedule_step interleaved with host failures (with and without
    ``now``), terminations (voluntary and involuntary), departures,
    checkpoints and the schedulable / slow setters."""
    jstate, tstate = _states(512, 9, zones=3)
    rng = np.random.default_rng(10)
    t = float(fleets.NOW)
    pol_t, pol_j = TPolicy(shortlist=16), JPolicy(shortlist=16)
    for i in range(60):
        res, pre, dom, now, price, _ = _requests(rng, 1, t, 0)
        t = float(now[0]) + 0.25       # quarter seconds: exact, not integer
        jstate, jout = jref.schedule_step(jstate, jnp.asarray(res[0]), bool(pre[0]), -1,
                                          t, float(price[0]), policy=pol_j, donate=False)
        tstate, tout = port.schedule_step(tstate, res[0], bool(pre[0]), -1, t,
                                          float(price[0]), policy=pol_t)
        _assert_outs(tout, jout, f"step {i}")
        h = int(rng.integers(0, 512))
        op = i % 6
        if op == 0:
            normal = np.asarray([2.0, 4000.0, 40.0], np.float32)
            jstate = jref.apply_host_failure(jstate, h, normal, now=t)
            tstate = port.apply_host_failure(tstate, h, torch.from_numpy(normal), now=t)
        elif op == 1:
            mask = rng.random(8) < 0.5
            inv = bool(i % 4 == 1)
            jstate = jref.apply_termination(jstate, h, mask, now=t, involuntary=inv)
            tstate = port.apply_termination(tstate, h, mask, now=t, involuntary=inv)
        elif op == 2:
            mask = rng.random(8) < 0.5
            jstate = jref.apply_termination(jstate, h, mask)
            tstate = port.apply_termination(tstate, h, mask)
        elif op == 3:
            jstate = jref.set_schedulable(jstate, h, True)
            tstate = port.set_schedulable(tstate, h, True)
            jstate = jref.apply_checkpoint(jstate, h, 2, t)
            tstate = port.apply_checkpoint(tstate, h, 2, t)
        elif op == 4:
            jstate = jref.set_slow_factor(jstate, h, 3.0)
            tstate = port.set_slow_factor(tstate, h, 3.0)
        else:
            normal = np.asarray([1.0, 2000.0, 20.0], np.float32)
            jstate = jref.apply_host_failure(jstate, h, normal)
            tstate = port.apply_host_failure(tstate, h, torch.from_numpy(normal))
        _assert_states(tstate, jstate)


def test_apply_placement_matches():
    jstate, tstate = _states(64, 2)
    for h, pre in ((3, True), (5, False), (3, True)):
        req = np.asarray([1.0, 2000.0, 20.0], np.float32)
        jstate, jslot = jref.apply_placement(jstate, h, req, pre, 1234.5, 2.0, 1, 600.0)
        tstate, tslot = port.apply_placement(tstate, h, torch.from_numpy(req), pre,
                                             1234.5, 2.0, 1, 600.0)
        assert int(tslot) == int(jslot)
    _assert_states(tstate, jstate)


def test_unported_planes_raise():
    # the mesh is ported: anything but a 1-D FleetMesh is refused, with the
    # JAX policy's message
    with pytest.raises(ValueError, match="mesh must be a 1-D"):
        TPolicy(mesh=object())
    # the admission and relocation planes are ported: their policies build
    assert TPolicy(queue_capacity=64).queue_capacity == 64
    pol = TPolicy(relocate_threshold=0.5)
    assert pol.relocation_on and pol.relocate_exit_threshold == 0.25


# ---------------------------------------------------------------------------
# Traced multipliers (the ensemble's multiplier axis) through one decision
# ---------------------------------------------------------------------------

_NOW_FRAC = float(np.float32(fleets.NOW + 0.37))


def _fractional_arrays(rng, n, k=8):
    """A fleet off the integer grid: half-unit free resources, fractional
    straggler factors, slot costs at a fractional clock."""
    start = (_NOW_FRAC - rng.random((n, k)) * 3e4).astype(np.float32)
    half = ((rng.random((n, 3)) < 0.3) * 0.5).astype(np.float32)
    return dict(
        free_f=rng.integers(0, 5, (n, 3)).astype(np.float32) + half,
        free_n=rng.integers(4, 12, (n, 3)).astype(np.float32),
        schedulable=rng.random(n) < 0.95, domain=np.zeros(n, np.int32),
        slow=(1 + rng.random(n) * 3).astype(np.float32),
        inst_res=rng.integers(0, 5, (n, k, 3)).astype(np.float32),
        inst_cost=((np.float32(_NOW_FRAC) - start) % 3600).astype(np.float32),
        inst_valid=rng.random((n, k)) < 0.8,
    )


_FIELDS = ("free_f", "free_n", "schedulable", "domain", "slow", "inst_res", "inst_cost",
           "inst_valid")


@functools.lru_cache(maxsize=None)
def _jitted_decision(policy, churn_on):
    def run(a, req, pre, mv, ch):
        return jref._decision_core(*(a[f] for f in _FIELDS), req, pre, jnp.int32(-1),
                                   policy, True, churn=ch if churn_on else None,
                                   mult_val=mv)
    return jax.jit(run)


#: power-of-two rows (the reference's own), rows that are not, the
#: policy's own values, and a zero under a nonzero gate
ROWS4 = [(1.0, 1.0, 0.0, 0.0), (4.0, 0.25, 0.0, 0.0), (0.5, 2.0, 0.0, 0.0),
         (0.7, 1.3, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0)]
ROWS5 = [(1.0, 1.0, 0.0, 0.0, 2.0), (4.0, 0.25, 0.0, 0.0, 0.5), (0.7, 1.3, 0.0, 0.0, 0.0),
         (0.0, 1.0, 0.0, 0.0, 1.7)]
CHURN = dict(churn_multiplier=2.0, churn_threshold=0.005)
TRACED_CASES = [
    (64, dict(shortlist=16), ROWS4), (64, {}, ROWS4), (320, {}, ROWS4),
    (64, dict(shortlist=4), ROWS4),
    (64, dict(shortlist=16, **CHURN), ROWS5), (320, CHURN, ROWS5),
    (320, dict(weigher_multipliers=(1.0, 1.0, 0.5, 0.25)),
     [(1.0, 1.0, 0.5, 0.25), (0.7, 1.3, 0.3, 1.7), (0.0, 1.0, 0.0, 0.0), (2.0, 2.0, 2.0, 2.0)]),
    (320, dict(weigher_multipliers=(0.0, -1.0, 0.5, 0.25)),
     [(0.0, -1.0, 0.5, 0.25), (0.0, -0.3, 1.7, 0.0)]),
]


@pytest.mark.parametrize("n,kw,rows", TRACED_CASES)
def test_decision_core_traced_multipliers(n, kw, rows):
    """``_decision_core(mult_val=row)`` equals the jitted reference's
    ``_decision_core(..., mult_val=jnp.asarray(row))`` bit for bit (host,
    mask, ok, fell_back, margin) on fractional inputs: the full
    enumeration (64 hosts), the shortlist (320, or 64 with M = 16 and a
    fallback-prone M = 4), churn on and off, with normal and preemptible
    requests."""
    churn_on = "churn_multiplier" in kw
    rng = np.random.default_rng(n + len(kw))
    a = _fractional_arrays(rng, n)
    ch = (rng.random(n) * 0.01).astype(np.float32)
    fn = _jitted_decision(JPolicy(**kw), churn_on)
    tpol = TPolicy(**kw)
    ta = {f: torch.from_numpy(v) for f, v in a.items()}
    fell = 0
    for row in rows:
        for i in range(10):
            req = rng.integers(1, 7, 3).astype(np.float32)
            pre = bool(i % 3 == 0)
            want = fn(a, req, pre, np.asarray(row, np.float32), ch)
            got = port._decision_core(*(ta[f] for f in _FIELDS), torch.from_numpy(req), pre,
                                      -1, tpol, True,
                                      churn=torch.from_numpy(ch) if churn_on else None,
                                      mult_val=row)
            for g, w, what in zip(got, want, ("host", "mask", "ok", "fell_back", "margin")):
                g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{row} {i}: {what}")
            fell += int(got[3])
    if kw.get("shortlist") == 4:
        assert fell > 0
