"""The port's python ``Simulator`` (a copy of the JAX package's) driving the
paper's schedulers and the rebuild-per-call ``TorchPreemptibleScheduler``.

Mirrors ``test_simulator.py`` (backfill, spare on-demand capacity, host
failure and heal, the straggler weigher, determinism), then holds the port
to the JAX package: the same seed gives the same metrics, every field but
the wall-clock ``sched_latency_s``, with the python schedulers and with the
rebuild scheduler against ``JaxPreemptibleScheduler``.  Last, the check of
``test_soa_incremental.py``: the persistent ``SoASimulator`` and the
rebuild-per-call ``Simulator`` land in the same utilisation regime.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import cluster as jcluster
from repro.core import cost as jcost
from repro.core import scheduler as jsched
from repro.core import simulator as jsim
from repro.core import types as jtypes
from repro.core.jax_scheduler import JaxPreemptibleScheduler
from repro_torch.core import cost as tcost
from repro_torch.core import scheduler as tsched
from repro_torch.core import simulator as tsim
from repro_torch.core import types as ttypes
from repro_torch.core.cluster import Cluster, make_uniform_fleet
from repro_torch.core.torch_scheduler import TorchPreemptibleScheduler
from repro_torch.core.weighers import OvercommitRank, StragglerRank, TerminationCostRank

torch.set_num_threads(1)

NODE = ttypes.VM_SPEC.make(vcpus=8, ram_mb=16000, disk_gb=10_000)


def spec(frac, rate=1 / 20.0, sim=tsim, types=ttypes):
    medium = types.VM_SPEC.make(vcpus=2, ram_mb=4000, disk_gb=40)
    return sim.WorkloadSpec(arrival_rate_per_s=rate, preemptible_fraction=frac,
                            flavors=(("medium", medium),))


def run_sim(sched_cls, frac, n_hosts=16, seed=3, duration=24 * 3600.0, **kw):
    cluster = Cluster(make_uniform_fleet(n_hosts, NODE))
    sim = tsim.Simulator(cluster, sched_cls(cost_fn=tcost.PeriodCost(), **kw), spec(frac),
                         seed=seed)
    return sim, sim.run(duration)


def metrics_but_latency(m):
    out = dataclasses.asdict(m)
    del out["sched_latency_s"]
    return out


def outcome(metrics, cluster):
    """Metrics but latency, final placements and the preempted ids."""
    return (metrics_but_latency(metrics),
            {n: sorted(h.instances) for n, h in cluster.hosts.items()},
            [i.id for i in cluster.preempted])


@pytest.fixture(scope="module")
def rebuild_run():
    """``test_soa_incremental.py``'s workload (16 hosts, 24 simulated hours)
    through ``Simulator`` with the rebuild scheduler on CPU tensors."""
    cluster = Cluster(make_uniform_fleet(16, NODE))
    sched = TorchPreemptibleScheduler(cost_fn=tcost.PeriodCost(), k_slots=4, device="cpu")
    m = tsim.Simulator(cluster, sched, spec(0.5, rate=1 / 40.0), seed=5).run(24 * 3600.0)
    return m, cluster


# ---------------------------------------------------------------------------
# the mirror of test_simulator.py
# ---------------------------------------------------------------------------


def test_backfill_eliminates_normal_failures():
    _, blind = run_sim(tsched.FilterScheduler, 0.5)
    _, aware = run_sim(tsched.PreemptibleScheduler, 0.5)
    assert aware.failures_normal < blind.failures_normal
    assert aware.preemptions > 0


def test_preemptible_keeps_ondemand_capacity():
    cluster = Cluster(make_uniform_fleet(16, NODE))
    sim = tsim.Simulator(cluster, tsched.PreemptibleScheduler(cost_fn=tcost.PeriodCost()),
                         spec(0.7, rate=1 / 80.0), seed=3)
    m = sim.run(24 * 3600.0)
    assert m.failures_normal == 0
    assert np.mean(m.utilization) > 0.4


def test_host_failure_evacuates_and_heals():
    cluster = Cluster(make_uniform_fleet(4, NODE))
    sim = tsim.Simulator(cluster, tsched.PreemptibleScheduler(cost_fn=tcost.PeriodCost()),
                         spec(0.5), seed=0)
    sim.inject_host_failure("host-1", at_s=3600.0, heal_after_s=7200.0)
    sim.run(6 * 3600.0)
    assert cluster.hosts["host-1"].schedulable
    assert cluster.stats.preemptions == len(cluster.preempted)


def test_straggler_weigher_avoids_slow_hosts():
    cluster = Cluster(make_uniform_fleet(8, NODE))
    slow = {"host-0", "host-1"}
    for name in slow:
        cluster.hosts[name].slow_factor = 5.0
    sched = tsched.PreemptibleScheduler(
        cost_fn=tcost.PeriodCost(),
        weighers=(OvercommitRank(), TerminationCostRank(), StragglerRank()),
    )
    tsim.Simulator(cluster, sched, spec(0.3, rate=1 / 600.0), seed=1).run(24 * 3600.0)
    placed_slow = sum(len(cluster.hosts[h].instances) for h in slow)
    placed_fast = sum(len(h.instances) for n, h in cluster.hosts.items() if n not in slow)
    assert placed_slow / 2 < placed_fast / 6


def test_simulation_is_deterministic():
    _, a = run_sim(tsched.PreemptibleScheduler, 0.5, seed=11)
    _, b = run_sim(tsched.PreemptibleScheduler, 0.5, seed=11)
    assert metrics_but_latency(a) == metrics_but_latency(b)


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


def _jax_cluster(n_hosts):
    node = jtypes.VM_SPEC.make(vcpus=8, ram_mb=16000, disk_gb=10_000)
    return jcluster.Cluster(jcluster.make_uniform_fleet(n_hosts, node))


@pytest.mark.parametrize("name", ["filter", "retry", "preemptible"])
def test_simulator_matches_jax(name):
    """The paper's schedulers, the same seed: the same metrics, the same
    final placements, with a host failure and stragglers on the way."""
    runs = []
    for sim_mod, cluster, sched_mod, cost_mod, types in (
            (tsim, Cluster(make_uniform_fleet(12, NODE)), tsched, tcost, ttypes),
            (jsim, _jax_cluster(12), jsched, jcost, jtypes)):
        sim = sim_mod.Simulator(
            cluster, sched_mod.SCHEDULER_REGISTRY[name](cost_fn=cost_mod.PeriodCost(), seed=4),
            spec(0.5, rate=1 / 30.0, sim=sim_mod, types=types), seed=21)
        sim.inject_stragglers(0.25)
        sim.inject_host_failure("host-3", at_s=4 * 3600.0, heal_after_s=3600.0)
        runs.append(outcome(sim.run(10 * 3600.0), cluster))
    assert runs[0] == runs[1]
    assert runs[0][0]["placed_normal"] + runs[0][0]["placed_preemptible"] > 300


def test_rebuild_simulator_matches_jax(rebuild_run):
    """``Simulator`` with the rebuild scheduler (CPU tensors) against the
    JAX package's ``Simulator`` with ``JaxPreemptibleScheduler``."""
    cluster = _jax_cluster(16)
    m = jsim.Simulator(cluster, JaxPreemptibleScheduler(cost_fn=jcost.PeriodCost(), k_slots=4),
                       spec(0.5, rate=1 / 40.0, sim=jsim, types=jtypes), seed=5).run(24 * 3600.0)
    got = outcome(*rebuild_run)
    assert got == outcome(m, cluster)
    assert got[0]["preemptions"] > 0


def test_soa_simulator_matches_rebuild_simulator_metrics(rebuild_run):
    """The persistent-state simulator and the rebuild-per-call simulator
    under the same workload land in the same utilisation regime."""
    fast = tsim.SoASimulator(make_uniform_fleet(16, NODE), spec(0.5, rate=1 / 40.0), seed=5,
                             cost_fn=tcost.PeriodCost(), k_slots=4, device="cpu")
    m_fast = fast.run(24 * 3600.0)
    m_slow = rebuild_run[0]
    assert m_fast.placed_normal + m_fast.placed_preemptible > 100
    assert np.isclose(np.mean(m_fast.utilization), np.mean(m_slow.utilization), atol=0.1)
    hosts = fast.fleet.sync_hosts()
    assert sum(len(h.instances) for h in hosts) == len(fast.fleet.instances)
