"""The port's relocation plane (``repro_torch``, on the CPU) against the JAX
package's, in lockstep.

Each test of ``tests/test_relocation.py`` runs on a port ``SoAFleet`` /
``SoASimulator`` (``device="cpu"``) and on a JAX one with the same hosts,
policy and events: every decision, every counter of ``RelocationStats``,
the per-zone hysteresis records, ``relocated_ids``, the python mirrors and
the final fleet state must be equal; then the reference test's own property
holds on the port's results.  Beside them:

* ``relocate_many`` against the jitted reference directly, padding rows
  included, on the full enumeration and on the screen;
* the victim loss against the jitted ``_relocation_victims``'s own, bit for
  bit (fault (b): the reference's add is a fused multiply-add), and the
  ranking on heavily tied fleets (fault (a): ``lax.top_k``'s tie order).

Event times, resources and prices are integers, so f32 sums are exact and
equality is strict; the loss test also runs off the integer grid.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.soa_fleet as jsf
from repro.core import jax_scheduler as jref
from repro.core import simulator as jsim
from repro.core.policy import SchedulerPolicy as JPolicy
from repro.core.types import VM_SPEC as JVM, Host as JHost, Request as JReq, Resources as JRes
import repro_torch.core.soa_fleet as tsf
from repro_torch.core import fleets
from repro_torch.core import simulator as tsim
from repro_torch.core import torch_scheduler as port
from repro_torch.core.admission import PAD_RES, QUEUE_DTYPES
from repro_torch.core.convert import fleet_state_from_numpy, fleet_state_to_numpy, queue_state_to_numpy
from repro_torch.core.policy import SchedulerPolicy as TPolicy
from repro_torch.core.screen_math import CHURN_EPS
from repro_torch.core.soa_fleet import SoAFleet as TFleet
from repro_torch.core.torch_scheduler import STATE_DTYPES
from repro_torch.core.types import VM_SPEC, Host, Instance, Request
from test_torch_scheduler import jax_hosts
from test_torch_sched_screen import _case

torch.set_num_threads(1)

NOW = 500_000.0
CAP = VM_SPEC.make(vcpus=8, ram_mb=16000, disk_gb=160)
SIZES = [
    VM_SPEC.make(vcpus=1, ram_mb=2000, disk_gb=20),
    VM_SPEC.make(vcpus=2, ram_mb=4000, disk_gb=40),
    VM_SPEC.make(vcpus=4, ram_mb=8000, disk_gb=80),
]
K = 8
N_ZONES = 3


def _jres(res):
    return JRes(JVM, res.vec)


def _zoned(n, n_zones=N_ZONES):
    return [dict(name=f"h{i}", domain=f"dom{i % 2}", zone=f"z{i % n_zones}")
            for i in range(n)]


def _hot_cold(n_hot=2, n_cold=2):
    """n_hot hosts in z0 (hot), n_cold in z1 (cold, empty)."""
    return ([dict(name=f"hot{i}", zone="z0") for i in range(n_hot)]
            + [dict(name=f"cold{i}", zone="z1") for i in range(n_cold)])


def _reloc_policy(**kw):
    kw.setdefault("cost_kind", "period")
    kw.setdefault("relocate_threshold", 0.05)
    return kw


def _req_pair(**kw):
    res = kw.pop("resources")
    return Request(resources=res, **kw), JReq(resources=_jres(res), **kw)


def _out_key(o):
    return (o.ok, o.host, o.instance.id if o.ok else None,
            o.instance.metadata.get("slot") if o.ok else None,
            tuple(v.id for v in o.victims))


def _assert_states(tstate, jstate, what=""):
    got = fleet_state_to_numpy(tstate)
    for f in STATE_DTYPES:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jstate, f)),
                                      err_msg=f"{what} {f}")


class Pair:
    """A port ``SoAFleet`` (CPU) and a JAX one driven in lockstep; every
    call's result is compared as it comes, ``check`` compares the rest."""

    def __init__(self, specs, k=K, **policy_kw):
        self.t = TFleet([Host(capacity=CAP, **s) for s in specs], k_slots=k,
                        policy=TPolicy(**policy_kw), device="cpu")
        self.j = jsf.SoAFleet([JHost(capacity=_jres(CAP), **s) for s in specs], k_slots=k,
                              policy=JPolicy(**policy_kw))

    def schedule(self, now, price=1.0, **req_kw):
        tr, jr = _req_pair(**req_kw)
        to = self.t.schedule_request(tr, now, price=price)
        jo = self.j.schedule_request(jr, now, price=price)
        assert _out_key(to) == _out_key(jo)
        return to

    def call(self, method, *args, **kw):
        got = getattr(self.t, method)(*args, **kw)
        assert got == getattr(self.j, method)(*args, **kw), method
        return got

    def seed_churn(self, term, up):
        """Overwrite the zone accumulators (ẑ = T / max(U, eps))."""
        self.t.state = dataclasses.replace(
            self.t.state, zone_term=torch.tensor(term, dtype=torch.float32),
            zone_up=torch.tensor(up, dtype=torch.float32))
        self.j.state = dataclasses.replace(
            self.j.state, zone_term=jnp.asarray(term, jnp.float32),
            zone_up=jnp.asarray(up, jnp.float32))

    def check(self):
        check_fleets(self.t, self.j)


def check_fleets(tf, jf):
    """Mirrors, relocation records and the fleet state equal."""
    assert [(i.id, i.host, i.start_time, i.last_checkpoint) for i in tf.instances.values()] == \
        [(i.id, i.host, i.start_time, i.last_checkpoint) for i in jf.instances.values()]
    assert tf.locator == jf.locator and tf.slot_ids == jf.slot_ids
    assert [i.id for i in tf.preempted] == [i.id for i in jf.preempted]
    assert dataclasses.asdict(tf.relocation) == dataclasses.asdict(jf.relocation)
    assert tf.relocation.summary() == jf.relocation.summary()
    assert {z: dataclasses.asdict(r) for z, r in tf._reloc_zone.items()} == \
        {z: dataclasses.asdict(r) for z, r in jf._reloc_zone.items()}
    assert tf.relocated_ids == jf.relocated_ids
    assert tf._reloc_inflight == jf._reloc_inflight
    assert tf.shortlist_stats == jf.shortlist_stats
    _assert_states(tf.state, jf.state)
    if tf.admission is not None:
        ts, js = (dataclasses.asdict(f.admission.stats) for f in (tf, jf))
        del ts["wall_wait_s"], js["wall_wait_s"]
        assert ts == js
        assert tf.admission._reloc == jf.admission._reloc
        got = queue_state_to_numpy(tf.admission.qstate)
        for f in QUEUE_DTYPES:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(jf.admission.qstate, f)),
                                          err_msg=f)


def _assert_conserved(fleet):
    """No instance lost, duplicated or double-billed: the python mirror, the
    locator and the slot map agree, nothing is both live and preempted, and
    materializing hosts re-places every instance (``Host.place`` raises on
    overflow)."""
    assert set(fleet.instances) == set(fleet.locator)
    slot_listed = {}
    for h, row in enumerate(fleet.slot_ids):
        for s, iid in enumerate(row):
            if iid is not None:
                assert iid not in slot_listed, f"{iid} in two slots"
                slot_listed[iid] = (h, s)
    assert slot_listed == {iid: loc for iid, loc in fleet.locator.items() if loc[1] is not None}
    assert not {i.id for i in fleet.preempted} & set(fleet.instances)
    fleet.sync_hosts()


# ---------------------------------------------------------------------------
# 1. the exclusion operand: decisions bit-exact, never into the excluded zone
# ---------------------------------------------------------------------------


def _filled_zoned_hosts(rng, n_hosts, fill=0.8):
    """``tests/test_relocation.py``'s fixture, as (port hosts, JAX hosts)."""
    th = [Host(capacity=CAP, **s) for s in _zoned(n_hosts)]
    iid = 0
    for h in th:
        while h.used().vec[0] < fill * CAP.vec[0]:
            size = SIZES[int(rng.integers(3))]
            if not size.fits_in(h.free_full):
                break
            pre = bool(rng.random() < 0.6) and len(h.preemptible_instances()) < K
            h.place(Instance(id=f"x{iid}", resources=size, preemptible=pre, host=h.name,
                             start_time=NOW - float(rng.integers(10, 500)) * 60.0))
            iid += 1
    return th, jax_hosts(th)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shortlist", [8, 0])
def test_exclusion_decisions_bit_exact(seed, shortlist):
    """For every excluded zone (and the -1 sentinel) the full 6-tuple
    decision equals the JAX package's, on the screen (M=8) and on the full
    enumeration; a placed host is never in the excluded zone; with the
    sentinel the relocation-on program equals the relocation-off one."""
    rng = np.random.default_rng(seed)
    th, jh = _filled_zoned_hosts(rng, 37)
    zone_ids = {f"z{i}": i for i in range(N_ZONES)}
    jstate, _ = jref.build_fleet_state(jh, k_slots=K, zone_ids=zone_ids)
    arrays = {f: np.asarray(getattr(jstate, f)) for f in STATE_DTYPES}
    host_zone = arrays["host_zone"]
    knobs = dict(cost_kind="period", shortlist=shortlist)
    tpol, jpol = TPolicy(relocate_threshold=0.05, **knobs), JPolicy(relocate_threshold=0.05,
                                                                   fused_screen=False, **knobs)
    toff = TPolicy(**knobs)
    step = 0
    for excl in (-1, 0, 1, 2):
        for pre in (True, False):
            req = np.asarray(SIZES[step % 3].vec, np.float32)
            now = NOW + 60.0 * step
            _, jout = jref.schedule_step(jstate, req, pre, np.int32(-1), now, 1.0, policy=jpol,
                                         donate=False, req_exclude_zone=np.int32(excl))
            _, tout = port.schedule_step(fleet_state_from_numpy(arrays, device="cpu"), req, pre,
                                         -1, now, 1.0, policy=tpol, req_exclude_zone=excl)
            for t, j, name in zip(tout, jout, ("host", "slot", "ok", "kill", "fb", "margin")):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                              err_msg=f"excl={excl} pre={pre}: {name}")
            if bool(tout[2]) and excl >= 0:
                assert host_zone[int(tout[0])] != excl
            if excl < 0:
                _, off = port.schedule_step(fleet_state_from_numpy(arrays, device="cpu"), req,
                                            pre, -1, now, 1.0, policy=toff)
                for a, b in zip(tout, off):
                    np.testing.assert_array_equal(a.numpy(), b.numpy())
            step += 1


def test_split_phase_screen_parity_with_exclusion():
    """The split screen (consts, then top-M) with the zone operands gives
    the JAX package's fused kernel's shortlist, scores and constants
    (``tests/test_relocation.py``'s fixture, the plain versions here)."""
    rng = np.random.default_rng(7)
    n, d = 150, 3
    a = dict(
        free_f=rng.integers(0, 9, (n, d)).astype(np.float32),
        free_n=rng.integers(2, 12, (n, d)).astype(np.float32),
        schedulable=rng.random(n) < 0.9,
        domain=rng.integers(0, 3, (n,)).astype(np.int32),
        slow=rng.integers(1, 5, (n,)).astype(np.float32),
        inst_res=rng.integers(0, 5, (n, K, d)).astype(np.float32),
        inst_cost=(rng.integers(0, 60, (n, K)) * 60).astype(np.float32),
        inst_valid=rng.random((n, K)) < 0.7,
    )
    host_zone = rng.integers(0, N_ZONES, (n,)).astype(np.int32)
    for excl in (-1, 0, 2):
        _case(a, np.asarray(SIZES[1].vec, np.float32), True, -1, (1.0, 1.0, 0.0, 0.0), 33,
              zone=host_zone, excl=excl)


# ---------------------------------------------------------------------------
# 2. hysteresis: arm above threshold, disarm below exit, cooldown gates re-arm
# ---------------------------------------------------------------------------


def test_hysteresis_arm_disarm_cooldown():
    p = Pair(_zoned(4, 2), **_reloc_policy(relocate_threshold=0.05, relocate_cooldown_s=300.0))
    assert p.t.policy.relocate_exit_threshold == pytest.approx(0.025)
    for view in ("cost_kind", "period", "weigher_multipliers", "shortlist"):
        assert getattr(p.t, view) == getattr(p.j, view), view
    st = p.t.relocation
    p.seed_churn([10.0, 0.0], [100.0, 100.0])     # hot z0 arms
    p.call("relocate", 10.0)
    assert st.arms == 1 and p.t._reloc_zone["z0"].armed
    p.seed_churn([4.0, 0.0], [100.0, 100.0])      # between exit and threshold
    p.call("relocate", 20.0)
    assert st.disarms == 0 and p.t._reloc_zone["z0"].armed
    p.seed_churn([1.0, 0.0], [100.0, 100.0])      # below exit: disarm, cooldown
    p.call("relocate", 30.0)
    z = p.t._reloc_zone["z0"]
    assert st.disarms == 1 and not z.armed and z.cooldown_until == pytest.approx(330.0)
    p.seed_churn([10.0, 0.0], [100.0, 100.0])     # hot inside the cooldown
    p.call("relocate", 100.0)
    assert st.arms == 1 and not z.armed
    p.call("relocate", 400.0)                     # past it: re-arms
    assert st.arms == 2 and p.t._reloc_zone["z0"].armed
    p.check()

    off = TFleet([Host(capacity=CAP, **s) for s in _zoned(2, 2)], k_slots=K,
                 policy=TPolicy(cost_kind="period"), device="cpu")
    with pytest.raises(RuntimeError, match="relocation plane is off"):
        off.relocate(0.0)


# ---------------------------------------------------------------------------
# 3. checkpoint-aware victim selection + per-pass budget
# ---------------------------------------------------------------------------


def test_victims_ranked_by_expected_loss():
    """Budget 1 takes the victim whose last checkpoint is furthest behind."""
    p = Pair(_hot_cold(), **_reloc_policy(relocate_budget=1))
    ids = []
    for i in range(2):
        out = p.schedule(0.0, id=f"p{i}", resources=SIZES[0], preemptible=True)
        assert out.ok and out.host.startswith("hot")
        ids.append(out.instance.id)
    p.call("checkpoint", ids[0], 1000.0)
    p.seed_churn([10.0, 0.0], [100.0, 100.0])
    p.call("relocate", 2000.0)
    assert p.t.relocation.relocated == 1
    assert ids[1] in p.t.relocated_ids and ids[0] in p.t.instances
    p.check()


def test_budget_bounds_evacuations_per_pass():
    p = Pair(_hot_cold(2, 4), **_reloc_policy(relocate_budget=2))
    for i in range(6):
        assert p.schedule(0.0, id=f"p{i}", resources=SIZES[0], preemptible=True).ok
    in_hot = sum(1 for iid, (h, s) in p.t.locator.items()
                 if s is not None and p.t.zones[h] == "z0")
    assert in_hot >= 4
    p.seed_churn([10.0, 0.0], [100.0, 100.0])
    p.call("relocate", 100.0)
    assert p.t.relocation.attempted == 2 and p.t.relocation.relocated == 2
    p.call("relocate", 200.0)
    assert p.t.relocation.attempted == 4
    p.check()


# ---------------------------------------------------------------------------
# 4. never-worse: failed re-placement leaves the victim, exponential backoff
# ---------------------------------------------------------------------------


def test_failed_replacement_leaves_victim_and_backs_off():
    p = Pair([dict(name=f"h{i}", zone="z0") for i in range(2)],
             **_reloc_policy(relocate_budget=1, relocate_backoff_s=30.0))
    iid = p.schedule(0.0, id="p", resources=SIZES[0], preemptible=True).instance.id
    p.seed_churn([10.0], [100.0])
    st = p.t.relocation
    p.call("relocate", 100.0)
    assert st.attempted == 1 and st.failed == 1 and st.relocated == 0
    assert iid in p.t.instances
    assert p.t._reloc_zone["z0"].retry_at == pytest.approx(130.0)
    p.call("relocate", 110.0)                     # inside the backoff
    assert st.attempted == 1
    p.call("relocate", 130.0)                     # past it: fails again, doubles
    assert st.attempted == 2 and st.failed == 2
    assert p.t._reloc_zone["z0"].retry_at == pytest.approx(190.0)
    assert float(p.t.state.inst_ckpt.max()) == 130.0
    assert set(p.t.instances) == {iid} and not p.t.preempted
    p.check()


def test_preempt_instance_contract():
    """Already-gone ids are benign (False); a live normal instance raises."""
    p = Pair(_zoned(2, 2), cost_kind="period")
    assert p.call("preempt_instance", "never-existed", now=1.0) is False
    out = p.schedule(0.0, id="n", resources=SIZES[0], preemptible=False)
    for fleet in (p.t, p.j):
        with pytest.raises(ValueError, match="not preemptible"):
            fleet.preempt_instance(out.instance.id, now=1.0)
    assert out.instance.id in p.t.instances
    spot = p.schedule(2.0, id="s", resources=SIZES[1], preemptible=True)
    assert p.call("preempt_instance", spot.instance.id, now=50.0) is True
    assert p.call("preempt_instance", spot.instance.id, now=60.0) is False
    assert [i.id for i in p.t.preempted] == [spot.instance.id]
    p.check()


def test_churn_snapshot_single_reader_matches_wrappers():
    p = Pair(_zoned(6, 3), cost_kind="period")
    p.seed_churn([3.0, 0.0, 7.0], [60.0, 0.0, 140.0])
    rates, fleet_rate = p.t.churn_snapshot()
    assert (rates, fleet_rate) == p.j.churn_snapshot()
    assert rates == p.t.zone_rates() and fleet_rate == p.t.fleet_churn_rate()
    np.testing.assert_allclose(rates["z0"], 3.0 / 60.0, rtol=1e-6)
    np.testing.assert_allclose(rates["z1"], np.float32(0.0) / CHURN_EPS, rtol=1e-6)
    np.testing.assert_allclose(fleet_rate, 10.0 / 200.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# 5. chaos: conservation after every event
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_relocation_chaos_conserves_after_every_event(seed):
    """Arrivals (some with their own ``exclude_zone``), departures, storm
    preemptions, host fail/heal and relocation passes, in lockstep: equal
    after every event, conserving, excluded zones honoured, and the
    relocation ledger balanced."""
    rng = np.random.default_rng(seed)
    p = Pair(_zoned(12, 3), k=4, **_reloc_policy(
        relocate_threshold=0.005, relocate_budget=3, relocate_backoff_s=20.0,
        relocate_cooldown_s=100.0))
    fleet = p.t
    now, live = 0.0, []
    for step in range(250):
        now += float(rng.integers(1, 60))
        roll = rng.random()
        if roll < 0.5:
            excl = f"z{rng.integers(N_ZONES)}" if rng.random() < 0.2 else None
            out = p.schedule(now, id=f"r{step}", resources=SIZES[int(rng.integers(3))],
                             preemptible=bool(rng.random() < 0.7), exclude_zone=excl)
            if out.ok:
                if excl is not None:
                    assert fleet.zones[fleet.index[out.host]] != excl
                live.append(out.instance.id)
        elif roll < 0.62 and live:
            p.call("depart", live.pop(int(rng.integers(len(live)))), now=now)
        elif roll < 0.8:
            zone = f"z{rng.integers(N_ZONES)}"
            pre_ids = sorted(i for i, (h, s) in fleet.locator.items()
                             if s is not None and fleet.zones[h] == zone)
            for iid in pre_ids[: int(rng.integers(1, 4))]:
                assert p.call("preempt_instance", iid, now=now)
        elif roll < 0.88:
            name = f"h{rng.integers(12)}"
            if bool(fleet.state.schedulable[fleet.index[name]]):
                p.call("fail_host", name, now=now)
            else:
                p.call("heal_host", name)
        else:
            p.call("relocate", now)
        _assert_conserved(fleet)
        if step % 25 == 0:
            p.check()
    p.check()
    st = fleet.relocation
    assert st.pending == 0
    assert st.attempted == st.relocated + st.failed + st.lost_victims + st.stale
    assert st.passes > 0 and st.attempted > 0
    assert len(fleet.relocated_ids) >= st.relocated > 0


# ---------------------------------------------------------------------------
# 6. the seeded storm regime, direct and streaming
# ---------------------------------------------------------------------------


def _storm_sims(relocate, streaming, seed=11):
    """``tests/test_relocation.py::_storm_sim`` in both packages."""
    knobs = dict(cost_kind="period", churn_multiplier=2.0, churn_threshold=1e-4)
    if streaming:
        knobs.update(queue_capacity=64, admit_batch=8, slo_target_s=30.0)
    if relocate:
        knobs.update(relocate_threshold=1e-4, relocate_every_s=60.0, relocate_budget=8,
                     relocate_cooldown_s=600.0)
    medium = VM_SPEC.make(vcpus=2, ram_mb=4000, disk_gb=40)
    out = []
    for sim_mod, host, res, pol, kw in (
            (tsim, Host, lambda r: r, TPolicy, dict(device="cpu")),
            (jsim, JHost, _jres, JPolicy, {})):
        spec = sim_mod.WorkloadSpec(arrival_rate_per_s=1 / 20.0, preemptible_fraction=1.0,
                                    flavors=(("medium", res(medium)),))
        sim = sim_mod.SoASimulator([host(capacity=res(CAP), **s) for s in _zoned(12, 3)], spec,
                                   seed=seed, k_slots=4, policy=pol(**knobs), **kw)
        sim.inject_churn_regime("z2", until_s=4000.0, mean_on_s=300.0, mean_off_s=800.0,
                                storm_every_s=100.0, kill_frac=0.3, start_s=0.0)
        sim.inject_zone_storm("z2", at_s=3500.0, kill_frac=1.0)
        out.append(sim)
    return out


def _metrics_but_latency(m):
    out = dataclasses.asdict(m)
    del out["sched_latency_s"]
    return out


def _run_pair(relocate, streaming):
    ts, js = _storm_sims(relocate, streaming)
    mt, mj = ts.run(4000.0), js.run(4000.0)
    assert _metrics_but_latency(mt) == _metrics_but_latency(mj)
    assert len(mt.sched_latency_s) == len(mj.sched_latency_s)
    check_fleets(ts.fleet, js.fleet)
    return ts, mt


@pytest.mark.parametrize("streaming", [False, True])
def test_evacuation_under_storm_regime_matches_jax(streaming):
    """The storm regime with and without the plane, each in lockstep with
    the JAX simulator; then the reference test's properties on the port."""
    _, m0 = _run_pair(relocate=False, streaming=streaming)
    evac, m1 = _run_pair(relocate=True, streaming=streaming)
    assert m1.relocations > 0 and m1.relocation_passes > 0
    assert m1.storm_kills <= m0.storm_kills
    assert m1.failures_normal == 0
    assert len(evac.fleet.preempted) == m1.storm_kills
    _assert_conserved(evac.fleet)
    st = evac.fleet.relocation
    assert st.pending == 0
    assert st.attempted == st.relocated + st.failed + st.lost_victims + st.stale
    assert (m1.relocations, m1.relocation_failed, m1.relocation_lost) == \
        (st.relocated, st.failed, st.lost_victims)


# ---------------------------------------------------------------------------
# 7. batched victim re-placement: one relocate_many a zone, bit-exact
# ---------------------------------------------------------------------------


def test_batched_evacuation_one_dispatch_bit_exact(monkeypatch):
    """Direct-mode evacuation runs the zone's victims as one
    ``relocate_many`` call and no per-victim ``schedule_request``, equal to
    the JAX package's, and to the per-victim checkpoint → re-place →
    terminate loop replayed on a clone, state bit for bit."""
    kw = _reloc_policy(relocate_budget=4)

    def build():
        p = Pair(_hot_cold(2, 4), **kw)
        ids = [p.schedule(0.0, id=f"p{i}", resources=SIZES[i % 2], preemptible=True).instance.id
               for i in range(6)]
        p.call("checkpoint", ids[0], 900.0)
        p.call("checkpoint", ids[2], 400.0)
        p.seed_churn([10.0, 0.0], [100.0, 100.0])
        return p

    p = build()
    calls = {"batch": 0, "per_victim": 0}
    real_many, real_sr = tsf.relocate_many, TFleet.schedule_request

    def counting_many(*a, **k):
        calls["batch"] += 1
        return real_many(*a, **k)

    def counting_sr(self, *a, **k):
        calls["per_victim"] += 1
        return real_sr(self, *a, **k)

    monkeypatch.setattr(tsf, "relocate_many", counting_many)
    monkeypatch.setattr(TFleet, "schedule_request", counting_sr)
    now = 2000.0
    p.call("relocate", now)
    monkeypatch.undo()
    assert calls == {"batch": 1, "per_victim": 0}
    assert p.t.relocation.attempted == 4 and p.t.relocation.relocated > 0
    p.check()

    oracle = build().t
    hosts, slots, valid = tsf._relocation_victims(oracle.state, oracle.zone_ids["z0"], now,
                                                  oracle.policy.period, budget=4)
    moved = {}
    for h, s, v in zip(hosts, slots, valid):
        if not v:
            continue
        iid = oracle.slot_ids[int(h)][int(s)]
        inst = oracle.instances[iid]
        assert oracle.checkpoint(iid, now)
        out = oracle.schedule_request(
            Request(id=f"reloc-{iid}", resources=inst.resources, preemptible=True,
                    user=inst.user, cost_kind=inst.cost_kind, period=inst.period,
                    priority=0, exclude_zone="z0"), now, price=inst.price_rate)
        if out.ok:
            assert oracle.depart(iid, now=now)
            moved[iid] = out.instance.metadata.get("slot")
    got, want = fleet_state_to_numpy(p.t.state), fleet_state_to_numpy(oracle.state)
    for f in STATE_DTYPES:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert set(p.t.relocated_ids) == set(moved)
    for iid, new_id in p.t.relocated_ids.items():
        assert p.t.locator[new_id][1] == moved[iid]
    _assert_conserved(p.t)


# ---------------------------------------------------------------------------
# 8. relocate_many against the jitted reference, padding rows included
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_hosts,zones", [(16, 3), (300, 3), (16, 1)])
def test_relocate_many_matches_jitted_reference(n_hosts, zones):
    """Half the hosts saturated, half empty, in ``zones`` zones: 5 victims of
    zone 0 and 3 padding rows (``v_on=False``, ``PAD_RES``), every output and
    the state after bitwise equal; with one zone every replacement fails."""
    hosts = fleets.saturated_fleet(n_hosts, seed=n_hosts)
    for i, h in enumerate(hosts):
        h.zone = f"z{i % zones}"
        if i % 2:
            for iid in list(h.instances):
                h.remove(iid)
    jstate, _ = jref.build_fleet_state(jax_hosts(hosts), k_slots=K)
    arrays = {f: np.asarray(getattr(jstate, f)) for f in STATE_DTYPES}
    tstate = fleet_state_from_numpy(arrays, device="cpu")
    rows = np.argwhere(arrays["inst_valid"] & (arrays["host_zone"][:, None] == 0))[:5]
    assert len(rows) == 5
    b = 8
    vh, vs = np.zeros(b, np.int32), np.zeros(b, np.int32)
    von = np.zeros(b, bool)
    res = np.full((b, 3), PAD_RES, np.float32)
    excl = np.full(b, -1, np.int32)
    price = np.ones(b, np.float32)
    for i, (h, s) in enumerate(rows):
        vh[i], vs[i], von[i], excl[i] = h, s, True, 0
        res[i] = arrays["inst_res"][h, s]
        price[i] = i + 1
    dom, kind, period = np.full(b, -1, np.int32), np.full(b, -1, np.int32), np.full(b, -1.0, np.float32)
    period[1] = 1800.0
    now = float(fleets.NOW) + 100.0
    tpol, jpol = TPolicy(relocate_threshold=1e-4), JPolicy(relocate_threshold=1e-4)
    jstate, jout = jref.relocate_many(jstate, vh, vs, von, res, dom, kind, period, price, excl,
                                      now, policy=jpol, donate=False)
    tstate, tout = port.relocate_many(tstate, vh, vs, von, res, dom, kind, period, price, excl,
                                      now, policy=tpol)
    for t, j, name in zip(tout, jout, ("host", "slot", "ok", "fell_back", "margin")):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    _assert_states(tstate, jstate)
    ok = tout[2].numpy()
    assert not ok[5:].any()
    assert ok[:5].all() if zones > 1 else not ok.any()


# ---------------------------------------------------------------------------
# 9. the victim loss and ranking against the jitted reference
# ---------------------------------------------------------------------------


def _reference_loss(jstate, zone, now, period):
    """The jitted reference's own loss, bit for bit: ``_relocation_victims``
    traced anew with ``lax.top_k`` returning its input and the input's bits
    as indices, so ``host * K + slot`` spells each loss's bits."""
    def bits_top_k(x, k):
        return x, jax.lax.bitcast_convert_type(x, jnp.int32)

    real = jax.lax.top_k
    jax.lax.top_k = bits_top_k
    try:
        # a fresh function, so this trace never enters the reference's cache
        fn = jax.jit(lambda *args, budget: jsf._relocation_victims.__wrapped__(
            *args, budget=budget), static_argnames=("budget",))
        n, k = jstate.inst_valid.shape
        h, s, _ = fn(jstate, jnp.int32(zone), jnp.float32(now), jnp.float32(period),
                     budget=n * k)
    finally:
        jax.lax.top_k = real
    bits = (np.asarray(h).astype(np.int64) * k + np.asarray(s)).astype(np.int32)
    return bits.reshape(n, k)


def _loss_state(kind, n=96, seed=0):
    """Fleet state arrays: ``tied`` (every slot started and checkpointed at
    one instant, one size; a fifth dead), ``fractional`` (off the integer
    grid: fractional clocks, sizes and periods, where the fused multiply-add
    shows)."""
    rng = np.random.default_rng(seed)
    hosts = fleets.empty_fleet(n)
    for i, h in enumerate(hosts):
        h.zone = f"z{i % 3}"
    jstate, _ = jref.build_fleet_state(jax_hosts(hosts), k_slots=K)
    a = {f: np.asarray(getattr(jstate, f)).copy() for f in STATE_DTYPES}
    a["inst_valid"] = rng.random((n, K)) < 0.8
    if kind == "tied":
        a["inst_start"][:] = 1000.0
        a["inst_ckpt"][:] = 1000.0
        a["inst_res"][:] = np.asarray(SIZES[1].vec, np.float32)
    else:
        a["inst_start"] = (rng.random((n, K)) * 5000).astype(np.float32)
        a["inst_ckpt"] = (rng.random((n, K)) * 5000).astype(np.float32)
        a["inst_res"] = (rng.random((n, K, 3)) * 3).astype(np.float32)
        a["inst_period"] = np.where(rng.random((n, K)) < 0.5, -1.0,
                                    rng.random((n, K)) * 3000 + 1).astype(np.float32)
    return a


@pytest.mark.parametrize("kind", ["tied", "fractional"])
def test_victim_loss_and_ranking_match_jitted_reference(kind):
    a = _loss_state(kind)
    jstate = jref.SoAFleetState(**{f: jnp.asarray(v) for f, v in a.items()})
    tstate = fleet_state_from_numpy(a, device="cpu")
    n = a["inst_valid"].shape[0]
    now = 6001.25 if kind == "fractional" else 4600.0
    for zone in (0, 2, 5):
        want = _reference_loss(jstate, zone, now, 3600.0)
        got = tsf.relocation_loss(tstate, zone, now, 3600.0).numpy().view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=f"zone {zone}: loss bits")
        for budget in (1, 7, 64, 65, n * K):
            want = jsf._relocation_victims(jstate, jnp.int32(zone), jnp.float32(now),
                                           jnp.float32(3600.0), budget=budget)
            got = tsf._relocation_victims(tstate, zone, now, 3600.0, budget)
            for g, w, name in zip(got, want, ("host", "slot", "valid")):
                np.testing.assert_array_equal(g, np.asarray(w),
                                              err_msg=f"zone {zone} budget {budget}: {name}")
