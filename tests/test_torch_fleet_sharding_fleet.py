"""Device sharding through the entry points a user calls, on the CPU:
``SoAFleet`` and ``SoASimulator`` with a mesh of CPU shards against the JAX
package's unsharded fleet and simulator (which its own tests hold equal to
its sharded ones), ``TorchPreemptibleScheduler`` with a mesh, the planes
that refuse a mesh with the reference's messages, and one subprocess that
runs the reference's own sharded screen and ``schedule_many`` on four
forced host devices against the port.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import jax_scheduler as jref
from repro.core import fleet_sharding as jfs
from repro.core import simulator as jsim
from repro.core.cost import RevenueCost as JRevenue
from repro.core.policy import SchedulerPolicy as JPolicy
from repro.core.soa_fleet import SoAFleet as JFleet
from repro.core.types import VM_SPEC as JVM, Request as JRequest, Resources as JRes
from repro_torch.core import fleet_sharding as tfs
from repro_torch.core import fleets
from repro_torch.core import scan_sim
from repro_torch.core import simulator as tsim
from repro_torch.core import torch_scheduler as port
from repro_torch.core.admission import AdmissionFrontEnd
from repro_torch.core.cluster import make_uniform_fleet
from repro_torch.core.convert import fleet_state_from_numpy, fleet_state_to_numpy
from repro_torch.core.cost import RevenueCost
from repro_torch.core.policy import SchedulerPolicy as TPolicy
from repro_torch.core.soa_fleet import SoAFleet
from repro_torch.core.types import Request
from test_torch_fleet_sharding import NOW, SIZES, cpu_mesh, jax_hosts_kinds, random_fleet
from test_torch_scheduler import jax_hosts

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def padded_jax_state(jfleet, n_padded):
    return jfs.pad_fleet_state(jfleet.state, n_padded)


def assert_state_equals(tstate, jstate):
    got = fleet_state_to_numpy(tstate)
    for f in port.STATE_DTYPES:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jstate, f)), err_msg=f)


# ---------------------------------------------------------------------------
# SoAFleet with a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [2, 4, 8])
def test_sharded_fleet_end_to_end(s):
    """``test_sharded_parity.py::test_sharded_fleet_end_to_end`` on the port:
    padding and placement at build, sharded decisions, departures, a host
    failure and a batch, under non-integer slot costs (``RevenueCost``,
    where the admissibility tolerance is live): outcome for outcome equal to
    the JAX package's unsharded fleet, and the final state equal to its
    state padded (the padding rows untouched)."""
    hosts = random_fleet(np.random.default_rng(23), 43, zones=1)
    jfleet = JFleet(jax_hosts(hosts), cost_fn=JRevenue(), k_slots=8,
                    policy=JPolicy.for_cost(JRevenue(), shortlist=8))
    mesh = cpu_mesh(s)
    tfleet = SoAFleet(hosts, cost_fn=RevenueCost(), k_slots=8, device="cpu",
                      policy=TPolicy.for_cost(RevenueCost(), shortlist=8, mesh=mesh))
    assert tfleet.mesh is mesh and tfleet.state.mesh is mesh
    assert tfleet.state.n_hosts == tfs.padded_hosts(43, s, m_keep=9)
    assert tfleet.n_hosts == 43

    def drive(fleet, req_cls, spec):
        log = []
        out = fleet.schedule_batch([
            (req_cls(id=f"r{i}", resources=spec(SIZES[i % 3]), preemptible=bool(i % 2)),
             NOW + 60.0 * i, 1.0) for i in range(10)])
        log += [(o.host, o.ok, tuple(v.id for v in o.victims)) for o in out]
        placed = next(o for o in out if o.ok)
        fleet.depart(placed.instance.id)
        fleet.fail_host("h3")
        fleet.set_slow("h5", 2.0)
        o = fleet.schedule_request(req_cls(id="rx", resources=spec(SIZES[2]), preemptible=False),
                                   NOW + 3600.0)
        log.append((o.host, o.ok, tuple(v.id for v in o.victims)))
        log.append(round(fleet.utilization(), 6))
        log.append(round(fleet.utilization_normal(), 6))
        return log

    want = drive(jfleet, JRequest, lambda r: JRes(JVM, r.vec))
    assert drive(tfleet, Request, lambda r: r) == want
    assert tfleet.locator == jfleet.locator and tfleet.slot_ids == jfleet.slot_ids
    assert_state_equals(tfleet.state, padded_jax_state(jfleet, tfleet.state.n_hosts))
    synced = tfleet.sync_hosts()
    assert [sorted(h.instances) for h in synced] == \
        [sorted(h.instances) for h in jfleet.sync_hosts()]


def test_sharded_fleet_relocation_matches_jax():
    """The relocation plane on a sharded fleet: the victim ranking across
    shards in global host order and the direct-mode ``relocate_many``,
    equal to the JAX package's unsharded fleet pass for pass."""
    hosts = fleets.zoned_fleet(60, (2, 2, 4), seed=4)
    pol = dict(relocate_threshold=1e-4, relocate_budget=6, shortlist=8)
    jfleet = JFleet(jax_hosts(hosts), k_slots=8, policy=JPolicy(**pol))
    tfleet = SoAFleet(hosts, k_slots=8, device="cpu", policy=TPolicy(mesh=cpu_mesh(4), **pol))
    storm = [iid for iid, (h, slot) in tfleet.locator.items()
             if slot is not None and tfleet.zones[h] == "z2"][::2]
    for fleet in (jfleet, tfleet):
        for iid in storm:
            fleet.preempt_instance(iid, now=fleets.NOW + 600.0)
    moved = []
    for p in range(3):
        now = fleets.NOW + 660.0 + 60.0 * p
        moved.append((jfleet.relocate(now), tfleet.relocate(now)))
        assert tfleet.relocated_ids == jfleet.relocated_ids
        assert tfleet.locator == jfleet.locator
    assert all(a == b for a, b in moved) and sum(a for a, _ in moved) > 0
    assert_state_equals(tfleet.state, padded_jax_state(jfleet, tfleet.state.n_hosts))


# ---------------------------------------------------------------------------
# SoASimulator with a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_hosts,s", [(44, 4), (45, 4), (45, 2)])
def test_sharded_simulator_matches_jax(n_hosts, s):
    """``test_sharded_parity.py::test_sharded_simulator_smoke`` on the port:
    the event loop on a sharded fleet (45 hosts: a ragged fleet, padded)
    against the JAX package's unsharded simulator, same seed: identical
    summaries (latency aside), placements, preemptions and final state."""
    node = fleets.NODE_CAP
    flav = (("small", SIZES[0]), ("medium", SIZES[1]))
    jflav = tuple((k, JRes(JVM, v.vec)) for k, v in flav)
    kw = dict(arrival_rate_per_s=0.05, preemptible_fraction=0.6, flavor_probs=(0.5, 0.5))
    jhosts = jax_hosts(make_uniform_fleet(n_hosts, node))
    js = jsim.SoASimulator(jhosts, jsim.WorkloadSpec(flavors=jflav, **kw), seed=5, k_slots=8,
                           policy=JPolicy(shortlist=8))
    ts = tsim.SoASimulator(make_uniform_fleet(n_hosts, node),
                           tsim.WorkloadSpec(flavors=flav, **kw), seed=5, k_slots=8,
                           policy=TPolicy(shortlist=8, mesh=cpu_mesh(s)), device="cpu")
    for sim in (js, ts):
        sim.inject_host_failure(jhosts[7].name, at_s=600.0, heal_after_s=600.0)
    mj, mt = js.run(1800.0), ts.run(1800.0)
    strip = lambda m: {k: v for k, v in m.summary().items() if "latency" not in k}
    assert strip(mt) == strip(mj)
    assert mt.utilization == mj.utilization
    assert list(ts.fleet.instances) == list(js.fleet.instances)
    assert [i.id for i in ts.fleet.preempted] == [i.id for i in js.fleet.preempted]
    assert ts.fleet.decisions == js.fleet.decisions > 0
    assert_state_equals(ts.fleet.state, padded_jax_state(js.fleet, ts.fleet.state.n_hosts))


# ---------------------------------------------------------------------------
# The rebuild-per-call scheduler with a mesh
# ---------------------------------------------------------------------------


def test_rebuild_scheduler_with_a_mesh():
    """``TorchPreemptibleScheduler`` with a mesh splits the rebuilt state per
    call when the host count divides the mesh with M + 1 hosts a shard, and
    runs the unsharded screen otherwise: the same choices as without it."""
    from repro_torch.core.torch_scheduler import TorchPreemptibleScheduler

    for n in (40, 38):
        hosts = random_fleet(np.random.default_rng(n), n)
        plain = TorchPreemptibleScheduler(policy=TPolicy(shortlist=8), device="cpu")
        meshed = TorchPreemptibleScheduler(policy=TPolicy(shortlist=8, mesh=cpu_mesh(4)),
                                           device="cpu")
        for i, size in enumerate(SIZES):
            req = Request(id=f"q{i}", resources=size, preemptible=bool(i % 2))
            a, b = plain.schedule(req, hosts, NOW), meshed.schedule(req, hosts, NOW)
            assert (a.host, a.plan.ids, a.plan.cost) == (b.host, b.plan.ids, b.plan.cost)


# ---------------------------------------------------------------------------
# Planes that refuse a mesh, with the reference's messages
# ---------------------------------------------------------------------------


def _message(fn):
    with pytest.raises(NotImplementedError) as err:
        fn()
    return str(err.value)


def test_admission_plane_refuses_a_mesh():
    """A fleet with the admission plane and a mesh is refused at build, with
    the JAX package's message (its one-device mesh reaches the same check)."""
    want = _message(lambda: JFleet(
        jax_hosts(fleets.empty_fleet(40)),
        policy=JPolicy(queue_capacity=16, admit_batch=4, mesh=jfs.fleet_mesh())))
    pol = TPolicy(queue_capacity=16, admit_batch=4, mesh=cpu_mesh(2))
    assert _message(lambda: SoAFleet(fleets.empty_fleet(40), device="cpu", policy=pol)) == want
    fleet = SoAFleet(fleets.empty_fleet(40), device="cpu",
                     policy=TPolicy(queue_capacity=16, admit_batch=4))
    fleet.policy = pol
    assert _message(lambda: AdmissionFrontEnd(fleet)) == want


def test_scan_refuses_a_mesh():
    """``simulate_scan`` and ``simulate_ensemble`` refuse a mesh with the
    reference's ``_check_policy`` message, and a sharded state too."""
    from repro.core import scan_sim as jscan

    mesh = cpu_mesh(2)
    hosts = fleets.empty_fleet(40)
    trace = scan_sim.trace_from_workload(
        tsim.WorkloadSpec(flavors=list(fleets.SIZES.items())), 120.0, seed=1)
    state, _ = port.build_fleet_state(hosts, device="cpu")
    for where, run in (("simulate_scan", lambda p: scan_sim.simulate_scan(trace, p, state)),
                       ("simulate_ensemble",
                        lambda p: scan_sim.simulate_ensemble([trace], p, state))):
        got = _message(lambda: run(TPolicy(mesh=mesh)))
        assert got == _message(lambda: jscan._check_policy(JPolicy(mesh=jfs.fleet_mesh()), where))
    sharded = tfs.shard_fleet_state(state, mesh)
    assert "sharded fleet state" in _message(
        lambda: scan_sim.simulate_scan(trace, TPolicy(), sharded))


# ---------------------------------------------------------------------------
# The reference's own sharded screen and schedule_many, on forced devices
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import functools, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import jax_scheduler as jref
from repro.core import fleet_sharding as jfs
from repro.core.policy import SchedulerPolicy
from repro.core.screen_math import churn_of

assert jax.device_count() == 4, jax.devices()
src, dst = sys.argv[1], sys.argv[2]
a = dict(np.load(src))
mesh = jfs.fleet_mesh()
state = jref.SoAFleetState(**{f: jnp.asarray(a[f]) for f in a if not f.startswith("req_")})
kw = dict(shortlist=8, churn_multiplier=2.0, churn_threshold=0.25, relocate_threshold=0.5,
          cost_kinds=("count", "revenue", "recompute"))
pol = SchedulerPolicy(**kw)
out = {}
now = jnp.float32(a["req_now"][0])
cost = jref.fleet_slot_costs(state, now, pol)
churn = churn_of(state.zone_term, state.zone_up, state.host_zone)
mult = pol.all_multipliers
for i, pre in enumerate((False, True)):
    fn = jax.jit(lambda ff, fn_, sc, dm, sl, ir, ic, iv, rr, ch, hz, ez: jref._sharded_screen(
        mesh, ff, fn_, sc, dm, sl, ir, ic, iv, rr, jnp.asarray(pre), jnp.int32(-1), mult, True, 8,
        use_fused=True, churn=ch, churn_threshold=pol.churn_threshold, host_zone=hz,
        exclude_zone=ez))
    s_, i_, c_ = fn(state.free_f, state.free_n, state.schedulable, state.domain, state.slow,
                    state.inst_res, cost, state.inst_valid, jnp.asarray(a["req_res"][0]), churn,
                    state.host_zone, jnp.int32(1))
    out[f"screen{i}_scores"], out[f"screen{i}_idx"], out[f"screen{i}_consts"] = map(
        np.asarray, (s_, i_, c_))
sharded = jfs.shard_fleet_state(state, mesh)
for fused in (None, True):
    st, res = jref.schedule_many(
        sharded, a["req_res"], a["req_pre"], a["req_dom"], a["req_now"], a["req_price"],
        policy=SchedulerPolicy(mesh=mesh, fused_screen=fused, **kw),
        req_cost_kind=a["req_kind"], req_exclude_zone=a["req_excl"], donate=False)
    tag = "fused" if fused else "jnp"
    for name, v in zip(("host", "slot", "ok", "kill", "fell_back", "margin"), res):
        out[f"{tag}_{name}"] = np.asarray(v)
    for f in a:
        if not f.startswith("req_"):
            out[f"{tag}_state_{f}"] = np.asarray(getattr(st, f))
np.savez(dst, **out)
print("ok")
"""


def test_port_matches_the_reference_sharded_screen_on_forced_devices(tmp_path):
    """The reference's ``_sharded_screen`` (its kernel route, split at the
    constants barrier, in interpret mode) and ``schedule_many(mesh=...)``
    (jnp and kernel routes) under ``--xla_force_host_platform_device_count=4``
    in a subprocess, against the port on four CPU shards: each shard's
    forwarded ``(scores, idx)`` and the merged constants bit for bit, every
    decision and the final state."""
    hosts = random_fleet(np.random.default_rng(31), 37, kinds=True)
    zt, zu = np.asarray([0.0, 8.0, 32.0], np.float32), np.asarray([64.0] * 3, np.float32)
    jstate, _ = jref.build_fleet_state(jax_hosts_kinds(hosts), k_slots=8, zone_term=zt,
                                       zone_up=zu)
    jstate = jfs.pad_fleet_state(jstate, jfs.padded_hosts(37, 4, m_keep=9))
    arrays = {f: np.asarray(getattr(jstate, f)) for f in port.STATE_DTYPES}
    rng = np.random.default_rng(32)
    b = 12
    reqs = dict(
        req_res=np.stack([SIZES[i].vec for i in rng.integers(0, 3, b)]).astype(np.float32),
        req_pre=rng.random(b) < 0.5, req_dom=np.full(b, -1, np.int32),
        req_now=(NOW + np.cumsum(rng.integers(1, 90, b))).astype(np.float32),
        req_price=rng.integers(1, 5, b).astype(np.float32),
        req_kind=rng.integers(-1, 4, b).astype(np.int32),
        req_excl=rng.choice(np.asarray([-1, 0, 2], np.int32), b))
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **arrays, **reqs)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(src), str(dst)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert run.returncode == 0, run.stderr[-4000:]
    ref = dict(np.load(dst))

    mesh = cpu_mesh(4)
    kw = dict(shortlist=8, churn_multiplier=2.0, churn_threshold=0.25, relocate_threshold=0.5,
              cost_kinds=("count", "revenue", "recompute"))
    pol = TPolicy(mesh=mesh, **kw)
    state = fleet_state_from_numpy(arrays, mesh=mesh)
    whole = state.gather()
    now = float(reqs["req_now"][0])
    cost = port.fleet_slot_costs(whole, now, pol)
    churn = port.churn_of(whole.zone_term, whole.zone_up, whole.host_zone)
    req = torch.from_numpy(reqs["req_res"][0].copy())
    cols = (whole.free_f, whole.free_n, whole.schedulable, whole.domain, whole.slow,
            whole.inst_res, cost, whole.inst_valid, churn, whole.host_zone)
    for i, pre in enumerate((False, True)):
        kn = port._knobs(pol, 40, True, True, 1, None)
        shards = port._split_shards(mesh, cols, req)
        scores, idx, consts = port._sharded_screen(shards, mesh.lead, pre, -1, kn, True, 1, 9)
        np.testing.assert_array_equal(scores.numpy().view(np.int32),
                                      ref[f"screen{i}_scores"].view(np.int32))
        np.testing.assert_array_equal(idx.numpy(), ref[f"screen{i}_idx"])
        np.testing.assert_array_equal(consts.numpy().view(np.int32),
                                      ref[f"screen{i}_consts"].view(np.int32))
    state, out = port.schedule_many(state, reqs["req_res"], reqs["req_pre"], reqs["req_dom"],
                                    reqs["req_now"], reqs["req_price"], policy=pol,
                                    req_cost_kind=reqs["req_kind"],
                                    req_exclude_zone=reqs["req_excl"])
    got = fleet_state_to_numpy(state)
    for tag in ("jnp", "fused"):
        for name, v in zip(("host", "slot", "ok", "kill", "fell_back", "margin"), out):
            np.testing.assert_array_equal(v.numpy(), ref[f"{tag}_{name}"], err_msg=f"{tag} {name}")
        for f in port.STATE_DTYPES:
            np.testing.assert_array_equal(got[f], ref[f"{tag}_state_{f}"], err_msg=f"{tag} {f}")
    assert out[2].any()
