"""The port's ``SoASimulator`` in streaming admission mode
(``policy.queue_capacity > 0``, on the CPU) against the JAX package's on the
same seed.

Mirrors the streaming tests of ``tests/test_admission.py`` (conservation and
determinism, the SLO deadline, the f32 wait-percentile reader) over 3
simulated hours, each also held to the JAX simulator: every metric but the
wall-clock ``sched_latency_s``, every admission stat but the wall-clock
ones, the placements, locator and preemptions, the final fleet state and
the final queue must be equal.  Then a saturated fleet with host failures, a heal and
stragglers, under the default policy and under one with the churn weigher,
storm demotion, aging and three classes: equal again.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import simulator as jsim
from repro.core.policy import SchedulerPolicy as JPolicy
from repro.core.types import VM_SPEC as JVM, Host as JHost, Resources as JRes
from repro_torch.core import fleets
from repro_torch.core import simulator as tsim
from repro_torch.core.admission import QUEUE_DTYPES
from repro_torch.core.convert import fleet_state_to_numpy, queue_state_to_numpy
from repro_torch.core.policy import SchedulerPolicy as TPolicy
from repro_torch.core.torch_scheduler import STATE_DTYPES
from repro_torch.core.types import VM_SPEC, Host
from test_torch_scheduler import jax_hosts

torch.set_num_threads(1)

CAP = VM_SPEC.make(vcpus=8, ram_mb=16000, disk_gb=160)
MEDIUM = VM_SPEC.make(vcpus=2, ram_mb=4000, disk_gb=40)


def _metrics_but_latency(m):
    out = dataclasses.asdict(m)
    del out["sched_latency_s"]
    return out


def _assert_same_run(ts, js, mt, mj):
    assert _metrics_but_latency(mt) == _metrics_but_latency(mj)
    assert len(mt.sched_latency_s) == len(mj.sched_latency_s)
    tf, jf = ts.fleet, js.fleet
    tstats, jstats = (dataclasses.asdict(f.admission.stats) for f in (tf, jf))
    del tstats["wall_wait_s"], jstats["wall_wait_s"]
    assert tstats == jstats
    assert tf.admission.wait_percentiles() == jf.admission.wait_percentiles()
    assert list(tf.instances) == list(jf.instances)
    assert tf.locator == jf.locator and tf.slot_ids == jf.slot_ids
    assert [i.id for i in tf.preempted] == [i.id for i in jf.preempted]
    assert tf.shortlist_stats == jf.shortlist_stats
    got = fleet_state_to_numpy(tf.state)
    for f in STATE_DTYPES:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jf.state, f)), err_msg=f)
    got = queue_state_to_numpy(tf.admission.qstate)
    for f in QUEUE_DTYPES:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jf.admission.qstate, f)),
                                      err_msg=f)


def _streaming_sims(seed=11):
    """``tests/test_admission.py``'s streaming simulator, in both packages."""
    kw = dict(arrival_rate_per_s=1 / 20.0, preemptible_fraction=0.5)
    pol = dict(queue_capacity=64, admit_batch=8, slo_target_s=120.0)
    ts = tsim.SoASimulator(
        [Host(name=f"h{i}", capacity=CAP) for i in range(16)],
        tsim.WorkloadSpec(flavors=(("medium", MEDIUM),), **kw), seed=seed,
        policy=TPolicy(**pol), device="cpu")
    js = jsim.SoASimulator(
        [JHost(name=f"h{i}", capacity=JRes(JVM, CAP.vec)) for i in range(16)],
        jsim.WorkloadSpec(flavors=(("medium", JRes(JVM, MEDIUM.vec)),), **kw), seed=seed,
        policy=JPolicy(**pol))
    return ts, js


#: the reference tests run 6 and 12 simulated hours; 3 keep this file's CPU
#: time small (about 3,700 decisions, each with retries, on 16 hosts)
HOURS = 3


@pytest.fixture(scope="module")
def streamed():
    """One streaming run of each package (seed 11)."""
    ts, js = _streaming_sims()
    return (ts, js, ts.run(HOURS * 3600.0, sample_every_s=900.0),
            js.run(HOURS * 3600.0, sample_every_s=900.0))


def test_streaming_simulator_conserves_and_matches_jax(streamed):
    ts, js, mt, mj = streamed
    s = ts.fleet.admission.stats
    assert s.arrivals == s.admitted + s.rejected + s.queue_depth
    assert s.admitted == mt.placed_normal + mt.placed_preemptible
    assert s.rejected == mt.failures_normal + mt.failures_preemptible
    assert s.admitted > 50 and s.retries > 0
    assert mt.sched_latency_s == s.wall_wait_s      # the wall-clock admission latency
    _assert_same_run(ts, js, mt, mj)


def test_streaming_simulator_is_deterministic(streamed):
    ts, _, mt, _ = streamed
    again, _ = _streaming_sims()
    m2 = again.run(HOURS * 3600.0, sample_every_s=900.0)
    assert _metrics_but_latency(m2) == _metrics_but_latency(mt)
    assert list(again.fleet.instances) == list(ts.fleet.instances)


def test_streaming_simulator_respects_slo_deadline(streamed):
    """With a lazy batch size the SLO tick still forces timely drains: the
    median placed request waits no longer than ``slo_target_s``."""
    ts = streamed[0]
    s = ts.fleet.admission.stats
    assert s.wait_s, "nothing was admitted"
    assert float(np.percentile(np.asarray(s.wait_s), 50)) <= ts.fleet.policy.slo_target_s + 1e-6


def test_wait_percentile_readers_agree(streamed):
    """The sim-time p50/p99 interpolate in f32, equal to the JAX reader's
    over the same waits; ``summary`` and ``admission_stats`` expose them."""
    ts, js = streamed[:2]
    front = ts.fleet.admission
    pct = front.wait_percentiles()
    assert set(pct) == {"wait_p50_s", "wait_p99_s"}
    w = np.asarray(front.stats.wait_s, np.float32)
    assert pct["wait_p50_s"] == float(np.percentile(w, 50))
    assert pct["wait_p99_s"] == float(np.percentile(w, 99))
    assert pct["wait_p50_s"] <= pct["wait_p99_s"]
    assert pct == js.fleet.admission.wait_percentiles()
    summ = ts.fleet.admission_stats
    assert summ["wait_p50_s"] == pct["wait_p50_s"] and summ["wait_p99_s"] == pct["wait_p99_s"]


@pytest.mark.parametrize("policy_kw", [
    dict(queue_capacity=64, admit_batch=16, max_retries=3, slo_target_s=60.0, shortlist=16),
    dict(queue_capacity=32, admit_batch=8, max_retries=2, slo_target_s=30.0, n_classes=3,
         aging_rate=0.01, weigher_multipliers=(1.0, 1.0, 0.5, 0.25), churn_multiplier=2.0,
         storm_threshold=1e-4, shortlist=32),
], ids=["default", "churn_storm_aging"])
def test_saturated_streaming_with_failures_matches_jax(policy_kw):
    """Half an hour at 320 saturated hosts (two zones) with host failures,
    a heal and stragglers, streaming: identical metrics, stats, placements,
    preemptions, final state and queue.  Arrival times are not integers, so
    waits, slot costs and the zone sums carry fractions."""
    hosts = fleets.saturated_fleet(320, seed=4)
    for i, h in enumerate(hosts):
        h.zone = f"z{i % 2}"
    jh = jax_hosts(hosts)
    kw = dict(arrival_rate_per_s=1 / 8.0, lifetime_mean_s=1200.0)
    ts = tsim.SoASimulator(hosts, tsim.WorkloadSpec(flavors=list(fleets.SIZES.items()), **kw),
                           seed=9, policy=TPolicy(**policy_kw), device="cpu")
    js = jsim.SoASimulator(
        jh, jsim.WorkloadSpec(flavors=[(k, JRes(JVM, v.vec)) for k, v in fleets.SIZES.items()],
                              **kw), seed=9, policy=JPolicy(**policy_kw))
    for sim in (ts, js):
        sim.inject_stragglers(0.05)
        sim.inject_host_failure("h3", at_s=400.0, heal_after_s=600.0)
        sim.inject_host_failure("h77", at_s=1200.0)
    mt, mj = ts.run(1800.0), js.run(1800.0)
    s = ts.fleet.admission.stats
    assert s.admitted > 100 and s.retries > 0 and mt.preemptions > 0
    assert s.arrivals == s.admitted + s.rejected + s.queue_depth
    if "storm_threshold" in policy_kw:
        assert s.degraded > 0
    _assert_same_run(ts, js, mt, mj)
