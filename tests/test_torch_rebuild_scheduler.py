"""The port's rebuild-per-call scheduler (``TorchPreemptibleScheduler``,
``build_soa_state``, ``schedule_decision``; CPU tensors, so the plain
versions of the kernels) against the JAX package's
``JaxPreemptibleScheduler``, and against the port's own python
``PreemptibleScheduler`` (the mirror of ``test_jax_scheduler.py``).

Each package builds its own ``Host`` objects from the same drawn tuples.
Decisions must agree bit for bit: ``(host_idx, mask_idx, ok)`` of
``schedule_decision``, and host, plan ids and cost of ``schedule``.  The
sizes straddle the 4 x 64-host edge where the auto shortlist switches on
(256 runs the full-fleet enumeration, 257 the screen and the gathered
enumeration) and include Fig. 2's fleets (24, 240 and 2,400 hosts).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost as jcost
from repro.core import jax_scheduler as jref
from repro.core import types as jtypes
from repro.core.policy import SchedulerPolicy as JPolicy
from repro_torch.core import cost as tcost
from repro_torch.core import fleets
from repro_torch.core import torch_scheduler as port
from repro_torch.core import types as ttypes
from repro_torch.core.convert import host_state_from_numpy, host_state_to_numpy
from repro_torch.core.policy import SchedulerPolicy as TPolicy
from repro_torch.core.scheduler import PreemptibleScheduler
from repro_torch.core.soa_fleet import SoAFleet

torch.set_num_threads(1)

NOW = 500_000.0
CAP = np.array([8.0, 16000.0, 160.0])
SIZE_VECS = [np.array([1.0, 2000.0, 20.0]), np.array([2.0, 4000.0, 40.0]),
             np.array([4.0, 8000.0, 80.0])]
KINDS = ("period", "count", "revenue", "recompute")


# ---------------------------------------------------------------------------
# drawn tuples, and each package's hosts built from them
# ---------------------------------------------------------------------------


def draw_fleet(rng, n, fill=0.8, domains=1, zones=1, mixed=False, cap=CAP):
    """Host tuples ``(name, domain, zone, slow, [instance tuples])`` with
    instance tuples ``(id, res, preemptible, start, price, kind, ckpt)``;
    integer-minute start times (``test_jax_scheduler.random_fleet``'s
    draws), and with ``mixed`` a cost kind, price and checkpoint each."""
    spec, iid = [], 0
    for i in range(n):
        free, insts = cap.copy(), []
        while cap[0] - free[0] < fill * cap[0]:
            res = SIZE_VECS[int(rng.integers(3))]
            if np.any(res > free):
                break
            pre = bool(rng.random() < 0.5)
            start = NOW - float(rng.integers(10, 500)) * 60.0
            price, kind, ckpt = 1.0, None, None
            if mixed and pre:
                price = float(rng.integers(1, 5))
                kind = KINDS[int(rng.integers(4))]
                if rng.random() < 0.5:
                    ckpt = start + float(rng.integers(0, 100)) * 60.0
            insts.append((f"x{iid}", res, pre, start, price, kind, ckpt))
            free = free - res
            iid += 1
        spec.append((f"h{i}", f"d{i % domains}", f"z{i % zones}", 1.0, insts))
    return spec


def spec_of(hosts):
    """The tuples of a port-built fleet (``fleets.saturated_fleet`` ...)."""
    return [(h.name, h.domain, h.zone, h.slow_factor,
             [(i.id, i.resources.vec, i.preemptible, i.start_time, i.price_rate,
               i.cost_kind, i.last_checkpoint) for i in h.instances.values()])
            for h in hosts]


def build(types, spec, cap=CAP):
    hosts = []
    for name, dom, zone, slow, insts in spec:
        h = types.Host(name=name, capacity=types.Resources(types.VM_SPEC, cap),
                       domain=dom, zone=zone, slow_factor=slow)
        for iid, res, pre, start, price, kind, ckpt in insts:
            inst = types.Instance(id=iid, resources=types.Resources(types.VM_SPEC, res),
                                  preemptible=pre, host=name, start_time=start,
                                  price_rate=price, cost_kind=kind)
            inst.last_checkpoint = ckpt
            h.place(inst)
        hosts.append(h)
    return hosts


def both(spec, cap=CAP):
    return build(jtypes, spec, cap), build(ttypes, spec, cap)


def requests(res, pre, domain=None, exclude_zone=None):
    kw = dict(id="q", preemptible=pre, domain=domain, exclude_zone=exclude_zone)
    return (jtypes.Request(resources=jtypes.Resources(jtypes.VM_SPEC, res), **kw),
            ttypes.Request(resources=ttypes.Resources(ttypes.VM_SPEC, res), **kw))


def same_result(a, b, what=""):
    """A JAX-package and a port ``ScheduleResult``: the same choice."""
    assert a.ok == b.ok, what
    assert a.host == b.host, what
    assert a.plan.ids == b.plan.ids, what
    assert a.plan.cost == b.plan.cost, what


def jax_arrays(state):
    return {f: None if getattr(state, f) is None else np.asarray(getattr(state, f))
            for f in port.HOST_STATE_DTYPES}


def same_decision(jstate, tstate, req_vec, pre, dom=-1, jpol=None, tpol=None):
    j = jref.schedule_decision(jstate, jnp.asarray(req_vec, jnp.float32), jnp.asarray(pre),
                               jnp.asarray(dom, jnp.int32), policy=jpol)
    t = port.schedule_decision(tstate, req_vec, pre, dom, policy=tpol)
    assert (int(j[0]), int(j[1]), bool(j[2])) == t
    return t


@pytest.fixture
def stage_calls(monkeypatch):
    """Counts of the screen and the two enumeration entries the decision
    core calls (the plain versions run on the CPU, so the kernels' launch
    counters stay at 0)."""
    calls = {"sched_screen": 0, "sched_weigh": 0, "sched_weigh_gathered": 0}
    for name in calls:
        fn = getattr(port, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(port, name, counted)
    return calls


# ---------------------------------------------------------------------------
# the mirror of test_jax_scheduler.py: the port against its python oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("preemptible", [False, True])
def test_rebuild_matches_python_reference(seed, preemptible):
    rng = np.random.default_rng(seed)
    hosts = build(ttypes, draw_fleet(rng, 13))
    req = ttypes.Request(id="q", resources=ttypes.Resources(ttypes.VM_SPEC, SIZE_VECS[seed % 3]),
                         preemptible=preemptible)
    py = PreemptibleScheduler(cost_fn=tcost.PeriodCost())
    py._rng = np.random.default_rng(0)
    tx = port.TorchPreemptibleScheduler(cost_fn=tcost.PeriodCost(), k_slots=8, device="cpu")
    r_py, r_tx = py.schedule(req, hosts, NOW), tx.schedule(req, hosts, NOW)
    assert r_py.ok == r_tx.ok
    if r_py.ok:
        assert r_tx.plan.cost == pytest.approx(r_py.plan.cost, abs=1e-2)
        if not (abs(r_py.plan.cost - r_tx.plan.cost) < 1e-6 and r_py.host != r_tx.host):
            assert set(r_tx.plan.ids) == set(r_py.plan.ids)


# ---------------------------------------------------------------------------
# the port against the JAX package, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 13, 37, 256, 257, 300])
def test_rebuild_matches_jax_scheduler(n, stage_calls):
    """Across the shortlist edge: the port's ``schedule`` equals
    ``JaxPreemptibleScheduler.schedule`` (host, plan ids, cost) and
    ``schedule_decision`` equals the JAX one on each package's own state,
    for normal and preemptible requests of every size."""
    spec = draw_fleet(np.random.default_rng(n), n)
    jh, th = both(spec)
    jx = jref.JaxPreemptibleScheduler(cost_fn=jcost.PeriodCost(), k_slots=8)
    tx = port.TorchPreemptibleScheduler(cost_fn=tcost.PeriodCost(), k_slots=8, device="cpu")
    jstate, _ = jref.build_soa_state(jh, NOW, jcost.PeriodCost(), k_slots=8)
    tstate, _ = port.build_soa_state(th, NOW, tcost.PeriodCost(), k_slots=8, device="cpu")
    oks = 0
    for res in SIZE_VECS:
        for pre in (False, True):
            jr, tr = requests(res, pre)
            same_result(jx.schedule(jr, jh, NOW), tx.schedule(tr, th, NOW), f"{res} {pre}")
            oks += same_decision(jstate, tstate, res, pre)[2]
    assert oks > 0
    if n > 4 * 64:        # the shortlist: one screen and one gathered weigh a call
        assert stage_calls["sched_screen"] == stage_calls["sched_weigh_gathered"] == 12
        assert stage_calls["sched_weigh"] == tx.fallbacks   # full fleet on fallback only
    else:                 # the full-fleet enumeration, every call
        assert stage_calls["sched_screen"] == stage_calls["sched_weigh_gathered"] == 0
        assert stage_calls["sched_weigh"] == 12


@pytest.mark.parametrize("n", [24, 240, 2400])
def test_fig2_scenarios_match_jax(n):
    """Fig. 2's three scenarios on the paper's Table 1 nodes: a normal and a
    preemptible request on an empty fleet, a normal one on a saturated
    fleet (every call terminates)."""
    sat = both(spec_of(fleets.saturated_fleet(n, seed=0)), fleets.NODE_CAP.vec)
    empty = both(spec_of(fleets.empty_fleet(n)), fleets.NODE_CAP.vec)
    jx = jref.JaxPreemptibleScheduler(cost_fn=jcost.PeriodCost(), k_slots=8)
    tx = port.TorchPreemptibleScheduler(cost_fn=tcost.PeriodCost(), k_slots=8, device="cpu")
    py = PreemptibleScheduler(cost_fn=tcost.PeriodCost())
    medium = fleets.SIZES["medium"].vec
    for what, (jh, th), pre in (("empty", empty, False), ("empty-spot", empty, True),
                                ("saturated", sat, False)):
        jr, tr = requests(medium, pre)
        got = tx.schedule(tr, th, fleets.NOW)
        same_result(jx.schedule(jr, jh, fleets.NOW), got, what)
        ref = py.schedule(tr, th, fleets.NOW)
        assert got.ok and ref.ok and got.plan.cost == ref.plan.cost, what
        assert bool(got.plan.ids) == (what == "saturated"), what


def test_request_domain_matches_jax():
    """Domain ids by first appearance; a request pinned to a domain lands
    only there, and an unknown domain name matches any host (-1); zone
    exclusions as the JAX package reads them."""
    spec = draw_fleet(np.random.default_rng(5), 40, domains=4)
    spec = spec[7:] + spec[:7]            # domain d3 appears first
    jh, th = both(spec)
    jx = jref.JaxPreemptibleScheduler(cost_fn=jcost.PeriodCost(), k_slots=8)
    tx = port.TorchPreemptibleScheduler(cost_fn=tcost.PeriodCost(), k_slots=8, device="cpu")
    for dom in ("d0", "d2", "elsewhere", None):
        for res in SIZE_VECS:
            jr, tr = requests(res, False, domain=dom)
            got = tx.schedule(tr, th, NOW)
            same_result(jx.schedule(jr, jh, NOW), got, f"{dom} {res}")
            if got.ok and dom in ("d0", "d2"):
                assert next(h for h in th if h.name == got.host).domain == dom
    # a zone to flee (a known one, -1 for an unknown one) is read only when
    # the relocation plane is on; under the default policy both ignore it
    for zone in ("z0", "nowhere"):
        jr, tr = requests(SIZE_VECS[1], False, exclude_zone=zone)
        same_result(jx.schedule(jr, jh, NOW), tx.schedule(tr, th, NOW), zone)


@pytest.mark.parametrize("threshold", [None, 0.003])
def test_frozen_zone_rates_match_jax(threshold):
    """A churn-aware policy over rates frozen at rebuild (zone z3 has no
    rate, so it reads 0); and the same policy over a state built without
    rates, which reads all-zero churn."""
    spec = draw_fleet(np.random.default_rng(9), 60, zones=4)
    jh, th = both(spec)
    rates = {"z0": 0.004, "z1": 0.0005, "z2": 0.002}
    kw = dict(cost_kind="period", churn_multiplier=2.0, churn_threshold=threshold)
    jpol, tpol = JPolicy(**kw), TPolicy(**kw)
    jx = jref.JaxPreemptibleScheduler(k_slots=8, policy=jpol, zone_rates=rates)
    tx = port.TorchPreemptibleScheduler(k_slots=8, policy=tpol, zone_rates=rates, device="cpu")
    for res in SIZE_VECS:
        for pre in (False, True):
            jr, tr = requests(res, pre)
            same_result(jx.schedule(jr, jh, NOW), tx.schedule(tr, th, NOW), f"{res} {pre}")
    jstate, _ = jref.build_soa_state(jh, NOW, k_slots=8)
    tstate, _ = port.build_soa_state(th, NOW, k_slots=8, device="cpu")
    assert tstate.churn is None
    for pre in (False, True):
        same_decision(jstate, tstate, SIZE_VECS[1], pre, jpol=jpol, tpol=tpol)


def test_mixed_cost_matches_jax():
    """Four cost kinds, prices and checkpoints on one fleet
    (``test_mixed_cost.py``'s ``MixedCost``): the frozen float64 costs
    rounded to f32 and the decisions, at both sides of the edge."""
    for n in (48, 300):
        spec = draw_fleet(np.random.default_rng(n + 1), n, mixed=True)
        jh, th = both(spec)
        jc = jcost.MixedCost(default="period", kinds=KINDS)
        tc = tcost.MixedCost(default="period", kinds=KINDS)
        jx = jref.JaxPreemptibleScheduler(cost_fn=jc, k_slots=8)
        tx = port.TorchPreemptibleScheduler(cost_fn=tc, k_slots=8, device="cpu")
        for res in SIZE_VECS:
            jr, tr = requests(res, False)
            same_result(jx.schedule(jr, jh, NOW), tx.schedule(tr, th, NOW), f"{n} {res}")
        jarr = jax_arrays(jref.build_soa_state(jh, NOW, jc, k_slots=8)[0])
        tarr = host_state_to_numpy(port.build_soa_state(th, NOW, tc, k_slots=8, device="cpu")[0])
        np.testing.assert_array_equal(tarr["inst_cost"], jarr["inst_cost"])
        assert np.any(tarr["inst_cost"] != np.round(tarr["inst_cost"]))   # off the grid


def test_jax_state_handed_over_decides_alike():
    """The JAX package's ``build_soa_state`` arrays, carried across by
    ``host_state_from_numpy``, equal the port's own build field for field
    (frozen costs, domain and zone ids by first appearance, an unknown zone
    as -2), and decide as the JAX state does."""
    spec = draw_fleet(np.random.default_rng(3), 300, domains=3, zones=3)
    spec = spec[1:] + spec[:1]
    jh, th = both(spec)
    rates, zone_ids = {"z1": 0.25, "z2": 0.5}, {"z2": 0, "z0": 1}      # z1 unknown: -2
    jstate, jslots = jref.build_soa_state(jh, NOW + 30.0, jcost.PeriodCost(), k_slots=8,
                                          zone_rates=rates, zone_ids=zone_ids)
    arrays = jax_arrays(jstate)
    handed = host_state_from_numpy(arrays, device="cpu")
    own, tslots = port.build_soa_state(th, NOW + 30.0, tcost.PeriodCost(), k_slots=8,
                                       zone_rates=rates, zone_ids=zone_ids, device="cpu")
    for f, v in host_state_to_numpy(own).items():
        np.testing.assert_array_equal(v, arrays[f], err_msg=f)
    assert set(np.unique(arrays["host_zone"])) == {-2, 0, 1}
    assert [[i.id for i in row] for row in tslots] == [[i.id for i in row] for row in jslots]
    for res in SIZE_VECS:
        for pre in (False, True):
            for dom in (-1, 1):
                t = same_decision(jstate, handed, res, pre, dom)
                assert port.schedule_decision(own, res, pre, dom) == t


def test_persistent_state_with_holes_decides_as_rebuild():
    """The rebuilt state packs each host's slots as a prefix; the persistent
    state keeps holes where instances left.  On the same live fleet both
    give the JAX rebuild scheduler's decision for normal requests."""
    rng = np.random.default_rng(11)
    th = build(ttypes, draw_fleet(rng, 40))
    fleet = SoAFleet(th, cost_fn=tcost.PeriodCost(), k_slots=8, device="cpu")
    leave = [iid for j, (iid, inst) in enumerate(fleet.instances.items())
             if inst.preemptible and j % 3 == 0]
    for iid in leave:
        fleet.depart(iid)
    valid = fleet.state.inst_valid.numpy()
    assert any(not row[:row.sum()].all() for row in valid)        # holes exist
    live = fleet.sync_hosts()
    jh = build(jtypes, spec_of(live))
    jx = jref.JaxPreemptibleScheduler(cost_fn=jcost.PeriodCost(), k_slots=8)
    tx = port.TorchPreemptibleScheduler(cost_fn=tcost.PeriodCost(), k_slots=8, device="cpu")
    now = NOW + 120.0
    for j, res in enumerate(SIZE_VECS[1:]):
        jr, tr = requests(res, False)
        want = jx.schedule(jr, jh, now)
        same_result(want, tx.schedule(tr, live, now))
        out = fleet.schedule_request(ttypes.Request(id=f"p{j}", resources=tr.resources,
                                                    preemptible=False), now)
        assert out.ok == want.ok and out.host == want.host
        assert tuple(sorted(v.id for v in out.victims)) == tuple(sorted(want.plan.ids))
        if out.ok:   # keep the python mirrors in step for the next request
            live = fleet.sync_hosts()
            jh = build(jtypes, spec_of(live))


def test_host_state_round_trip_is_exact():
    rng = np.random.default_rng(0)
    n, k = 50, 8
    arrays = dict(
        free_f=(rng.random((n, 3)) * 8).astype(np.float32),
        free_n=(rng.random((n, 3)) * 8).astype(np.float32),
        schedulable=rng.random(n) < 0.9, domain=rng.integers(0, 4, n).astype(np.int32),
        slow=rng.random(n).astype(np.float32),
        inst_res=(rng.random((n, k, 3)) * 4).astype(np.float32),
        inst_cost=(rng.random((n, k)) * 3600).astype(np.float32),
        inst_valid=rng.random((n, k)) < 0.5,
    )
    state = host_state_from_numpy(arrays, device="cpu")
    assert state.churn is None and state.host_zone is None
    assert set(host_state_to_numpy(state)) == set(arrays)
    full = dict(arrays, churn=rng.random(n).astype(np.float32),
                host_zone=rng.integers(-2, 3, n).astype(np.int32))
    back = host_state_to_numpy(host_state_from_numpy(full, device="cpu"))
    for f, v in full.items():
        assert back[f].dtype == v.dtype, f
        np.testing.assert_array_equal(back[f], v, err_msg=f)
    with pytest.raises(ValueError, match="domain"):
        host_state_from_numpy(dict(arrays, domain=arrays["domain"] + 0.5), device="cpu")
    with pytest.raises(ValueError, match="inst_cost"):
        host_state_from_numpy({f: v for f, v in arrays.items() if f != "inst_cost"},
                              device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert port.TorchPreemptibleScheduler().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.TorchPreemptibleScheduler()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.build_soa_state(fleets.empty_fleet(2), NOW)
