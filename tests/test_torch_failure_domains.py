"""The port's failure-domain plane (``repro_torch``, on the CPU) against the
JAX package's: §1–4 of ``tests/test_failure_domains.py`` (§5–6, aging and
storm demotion, are mirrored in ``tests/test_torch_admission.py``).

* the zone accumulators (``zone_term`` / ``zone_up``) against a python churn
  oracle under placements, evacuations, out-of-band preemptions, voluntary
  departures and host failures, in lockstep with the JAX fleet;
* churn-aware decisions on the incremental state against the port's own
  rebuild oracle and against the JAX fleet;
* hot-zone steering (threshold gate, churn weigher);
* zone storms and churn regimes: deterministic, conserving, zone-isolated,
  and equal to the JAX simulator's on the same seed; input validation.

Integer event times keep every f32 sum exact, so equality is strict.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import simulator as jsim
from repro.core.cost import PeriodCost as JPeriodCost
from repro.core.types import Host as JHost
from repro_torch.core import simulator as tsim
from repro_torch.core import torch_scheduler as port
from repro_torch.core.cost import PeriodCost
from repro_torch.core.screen_math import CHURN_EPS
from repro_torch.core.types import VM_SPEC, Host, Instance
from test_torch_relocation import CAP, SIZES, Pair, _assert_conserved, _jres, _zoned, \
    check_fleets

torch.set_num_threads(1)

K = 8


# ---------------------------------------------------------------------------
# 1. accumulator parity vs a pure-python churn oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zone_accumulators_match_python_oracle(seed):
    """Every involuntary kill adds 1 to its zone's T and the victim's
    accrued uptime to U; voluntary departures add uptime only; normal
    instances never touch the accumulators.  The JAX fleet runs alongside."""
    rng = np.random.default_rng(seed)
    n_hosts, n_zones = 12, 3
    p = Pair(_zoned(n_hosts, n_zones), cost_kind="period")
    fleet = p.t
    T = np.zeros((n_zones,), np.float64)
    U = np.zeros((n_zones,), np.float64)
    live = {}                      # id -> (zone index, start, preemptible)
    now = 0.0
    for step in range(350):
        now += float(rng.integers(1, 90))
        roll = rng.random()
        if roll < 0.55:
            pre = bool(rng.random() < 0.6)
            out = p.schedule(now, id=f"r{step}", resources=SIZES[int(rng.integers(3))],
                             preemptible=pre)
            if out.ok:
                z = fleet.zone_ids[fleet.zones[fleet.index[out.host]]]
                for v in out.victims:
                    T[z] += 1.0
                    U[z] += now - v.start_time
                    del live[v.id]
                live[out.instance.id] = (z, now, pre)
        elif roll < 0.75 and live:
            iid = sorted(live)[int(rng.integers(len(live)))]
            z, start, pre = live.pop(iid)
            assert p.call("depart", iid, now=now)
            if pre:
                U[z] += now - start
        elif roll < 0.90:
            pre_ids = [i for i, (_, _, pr) in live.items() if pr]
            if pre_ids:
                iid = sorted(pre_ids)[int(rng.integers(len(pre_ids)))]
                z, start, _ = live.pop(iid)
                assert p.call("preempt_instance", iid, now=now)
                T[z] += 1.0
                U[z] += now - start
        else:
            name = f"h{rng.integers(n_hosts)}"
            host_idx = fleet.index[name]
            z = fleet.zone_ids[fleet.zones[host_idx]]
            for iid in [i for i, (h, _) in fleet.locator.items() if h == host_idx]:
                _, start, pre = live.pop(iid)
                if pre:
                    T[z] += 1.0
                    U[z] += now - start
            p.call("fail_host", name, now=now)
            p.call("heal_host", name)
        np.testing.assert_array_equal(fleet.state.zone_term.numpy(), T.astype(np.float32),
                                      err_msg=f"event {step}: zone_term")
        np.testing.assert_array_equal(fleet.state.zone_up.numpy(), U.astype(np.float32),
                                      err_msg=f"event {step}: zone_up")
    assert T.sum() > 0 and U.sum() > 0
    p.check()
    rates = fleet.zone_rates()
    for z, i in fleet.zone_ids.items():
        np.testing.assert_allclose(rates[z], np.float32(T[i]) / max(np.float32(U[i]), CHURN_EPS),
                                   rtol=1e-6)
    np.testing.assert_allclose(fleet.fleet_churn_rate(),
                               np.float32(T.sum()) / max(np.float32(U.sum()), CHURN_EPS),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# 2. churn-aware decision parity: incremental state vs rebuild oracle
# ---------------------------------------------------------------------------


def test_churn_aware_decisions_match_rebuild_oracle():
    """With a churn multiplier and a churn threshold, every decision on the
    incremental state equals one on a state rebuilt from python hosts with
    the live zone accumulators (the port's ``build_fleet_state``), and the
    JAX fleet's."""
    rng = np.random.default_rng(11)
    n_hosts = 16
    kw = dict(weigher_multipliers=(1.0, 1.0, 0.05, 0.0), churn_multiplier=2.0,
              churn_threshold=0.5, cost_kind="period")
    p = Pair(_zoned(n_hosts, 4), **kw)
    fleet = p.t
    hosts = [Host(capacity=CAP, **s) for s in _zoned(n_hosts, 4)]
    by_name = {h.name: h for h in hosts}
    now, live = 0.0, []

    def remove(iid):
        for h in hosts:
            if iid in h.instances:
                h.remove(iid)

    for step in range(300):
        now += float(rng.integers(1, 90))
        roll = rng.random()
        if roll < 0.60:
            res, pre = SIZES[int(rng.integers(3))], bool(rng.random() < 0.6)
            price = float(rng.integers(1, 5))
            oracle, _ = port.build_fleet_state(
                hosts, k_slots=K, domain_ids=fleet.domain_ids,
                slot_assignment=fleet.slot_assignment(), zone_ids=fleet.zone_ids,
                zone_term=fleet.state.zone_term.numpy(), zone_up=fleet.state.zone_up.numpy(),
                device="cpu")
            _, (oh, _, ook, okill, _, _) = port.schedule_step(
                oracle, np.asarray(res.vec, np.float32), pre, -1, now, price,
                policy=fleet.policy)
            expect = set()
            if bool(ook) and not pre:
                expect = {fleet.slot_ids[int(oh)][k] for k in np.flatnonzero(okill.numpy())}
                expect -= {None}
            out = p.schedule(now, price=price, id=f"r{step}", resources=res, preemptible=pre)
            assert bool(ook) == out.ok, f"event {step}"
            if out.ok:
                assert fleet.names[int(oh)] == out.host, f"event {step}"
                assert {v.id for v in out.victims} == expect
                host = by_name[out.host]
                for v in out.victims:
                    host.remove(v.id)
                inst = out.instance
                host.place(Instance(id=inst.id, resources=inst.resources,
                                    preemptible=inst.preemptible, host=host.name,
                                    start_time=inst.start_time, price_rate=inst.price_rate,
                                    cost_kind=inst.cost_kind, period=inst.period))
                live.append(inst.id)
        elif roll < 0.78 and live:
            iid = live.pop(int(rng.integers(len(live))))
            if p.call("depart", iid, now=now):
                remove(iid)
        elif roll < 0.92:
            pre_ids = sorted(i for i, (_, s) in fleet.locator.items() if s is not None)
            if pre_ids:
                iid = pre_ids[int(rng.integers(len(pre_ids)))]
                assert p.call("preempt_instance", iid, now=now)
                remove(iid)
        else:
            name = f"h{rng.integers(n_hosts)}"
            host = by_name[name]
            if host.schedulable:
                p.call("fail_host", name, now=now)
                host.schedulable = False
                host.instances.clear()
            else:
                p.call("heal_host", name)
                host.schedulable = True
    assert float(fleet.state.zone_term.sum()) > 0
    p.check()


# ---------------------------------------------------------------------------
# 3. hot-zone steering: threshold gate + churn weigher
# ---------------------------------------------------------------------------


def _two_zone(hot_term=10.0, **kw):
    """h0 in the hot zone (ẑ = 0.1), h1 cold (ẑ = 0)."""
    p = Pair([dict(name="h0", zone="z_hot"), dict(name="h1", zone="z_cold")], **kw)
    p.seed_churn([hot_term, 0.0], [100.0, 100.0])
    return p


def test_churn_threshold_steers_preemptible_off_hot_zone():
    small = SIZES[0]
    blind = _two_zone(cost_kind="period")
    assert blind.schedule(10.0, id="p", resources=small, preemptible=True).host == "h0"
    gated = _two_zone(cost_kind="period", churn_threshold=0.05)
    assert gated.schedule(10.0, id="p", resources=small, preemptible=True).host == "h1"
    assert gated.schedule(11.0, id="n", resources=small, preemptible=False).host == "h0"
    gated.check()
    all_hot = Pair([dict(name="h0", zone="z_hot")], cost_kind="period", churn_threshold=0.05)
    all_hot.seed_churn([10.0], [100.0])
    assert not all_hot.schedule(10.0, id="p", resources=small, preemptible=True).ok


def test_churn_weigher_penalizes_hot_zone():
    weighed = _two_zone(cost_kind="period", churn_multiplier=2.0)
    for rid, pre in (("p", True), ("n", False)):
        out = weighed.schedule(10.0 + (rid == "n"), id=rid, resources=SIZES[0], preemptible=pre)
        assert out.ok and out.host == "h1", f"{rid} landed {out.host}"
    weighed.check()


# ---------------------------------------------------------------------------
# 4. storm injection: determinism, conservation, zone isolation
# ---------------------------------------------------------------------------


def _storm_sim(package="port", seed=3):
    medium = VM_SPEC.make(vcpus=2, ram_mb=4000, disk_gb=40)
    if package == "port":
        sim = tsim.SoASimulator(
            [Host(capacity=CAP, **s) for s in _zoned(12, 3)],
            tsim.WorkloadSpec(arrival_rate_per_s=1 / 20.0, preemptible_fraction=1.0,
                              flavors=(("medium", medium),)),
            seed=seed, cost_fn=PeriodCost(), k_slots=4, device="cpu")
    else:
        sim = jsim.SoASimulator(
            [JHost(capacity=_jres(CAP), **s) for s in _zoned(12, 3)],
            jsim.WorkloadSpec(arrival_rate_per_s=1 / 20.0, preemptible_fraction=1.0,
                              flavors=(("medium", _jres(medium)),)),
            seed=seed, cost_fn=JPeriodCost(), k_slots=4)
    sim.inject_zone_storm("z1", at_s=1500.0, kill_frac=0.5)
    sim.inject_churn_regime("z2", until_s=4000.0, mean_on_s=300.0, mean_off_s=800.0,
                            storm_every_s=100.0, kill_frac=0.3, start_s=0.0)
    return sim


def _state_keys(m):
    skip = {"p50_sched_latency_us", "p99_sched_latency_us"}
    return {k: v for k, v in m.summary().items() if k not in skip}


def test_zone_storms_deterministic_and_conserving():
    sim = _storm_sim()
    m = sim.run(4000.0)
    jsim_ = _storm_sim("jax")
    jm = jsim_.run(4000.0)
    assert _state_keys(m) == _state_keys(jm)
    check_fleets(sim.fleet, jsim_.fleet)
    assert m.storms >= 1 and m.storm_kills >= 1
    assert len(sim.fleet.preempted) == m.storm_kills
    assert m.preemptions == 0
    term = sim.fleet.state.zone_term.numpy()
    assert term[sim.fleet.zone_ids["z0"]] == 0.0
    assert term.sum() == float(m.storm_kills)
    for inst in sim.fleet.preempted:
        assert sim.fleet.zones[sim.fleet.index[inst.host]] in ("z1", "z2")
    _assert_conserved(sim.fleet)
    sim2 = _storm_sim()
    assert _state_keys(sim2.run(4000.0)) == _state_keys(m)
    np.testing.assert_array_equal(sim2.fleet.state.zone_term.numpy(), term)


def test_zone_storm_validates_inputs():
    sim = _storm_sim()
    with pytest.raises(ValueError, match="unknown zone"):
        sim.inject_zone_storm("z9", at_s=10.0)
    with pytest.raises(ValueError, match="kill_frac"):
        sim.inject_zone_storm("z1", at_s=10.0, kill_frac=0.0)
    with pytest.raises(ValueError, match="unknown zone"):
        sim.inject_churn_regime("z9", until_s=100.0)
