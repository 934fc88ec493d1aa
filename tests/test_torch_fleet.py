"""The port's ``SoAFleet`` and ``SoASimulator.run`` (on the CPU) against the
JAX package's, seed for seed; the ``convert`` round trip; the default device;
and the rule that the port never imports JAX or the JAX package.
"""
from __future__ import annotations

import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import simulator as jsim
from repro.core.policy import SchedulerPolicy as JPolicy
from repro.core.types import VM_SPEC as JVM, Resources as JRes
from repro_torch.core import fleets
from repro_torch.core import simulator as tsim
from repro_torch.core.convert import fleet_state_from_numpy, fleet_state_to_numpy
from repro_torch.core.policy import SchedulerPolicy as TPolicy
from repro_torch.core.soa_fleet import SoAFleet
from repro_torch.core.torch_scheduler import STATE_DTYPES, resolve_device
from test_torch_scheduler import jax_hosts

torch.set_num_threads(1)

COUNTERS = ("failures_normal", "failures_preemptible", "placed_normal",
            "placed_preemptible", "preemptions", "storms", "storm_kills")


def _sims(n, seed, policy_kw, zones=2):
    hosts = fleets.saturated_fleet(n, seed=seed)
    for i, h in enumerate(hosts):
        h.zone = f"z{i % zones}"
    jh = jax_hosts(hosts)
    tflav = list(fleets.SIZES.items())
    jflav = [(k, JRes(JVM, v.vec)) for k, v in fleets.SIZES.items()]
    kw = dict(arrival_rate_per_s=1 / 10.0, lifetime_mean_s=1800.0)
    ts = tsim.SoASimulator(hosts, tsim.WorkloadSpec(flavors=tflav, **kw), seed=seed,
                           policy=TPolicy(**policy_kw), device="cpu")
    js = jsim.SoASimulator(jh, jsim.WorkloadSpec(flavors=jflav, **kw), seed=seed,
                           policy=JPolicy(**policy_kw))
    return ts, js


def _assert_same_run(ts, js, mt, mj):
    for key in COUNTERS:
        assert getattr(mt, key) == getattr(mj, key), key
    assert mt.t == mj.t
    assert mt.utilization == mj.utilization
    assert mt.utilization_normal == mj.utilization_normal
    assert len(mt.sched_latency_s) == len(mj.sched_latency_s)
    tf, jf = ts.fleet, js.fleet
    assert list(tf.instances) == list(jf.instances)          # placement sequence
    assert tf.locator == jf.locator
    assert tf.slot_ids == jf.slot_ids
    assert [i.id for i in tf.preempted] == [i.id for i in jf.preempted]
    assert tf.shortlist_stats == jf.shortlist_stats
    got = fleet_state_to_numpy(tf.state)
    for f in STATE_DTYPES:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jf.state, f)), err_msg=f)


@pytest.mark.parametrize("policy_kw", [
    dict(shortlist=16),
    dict(weigher_multipliers=(1.0, 1.0, 0.5, 0.25), churn_multiplier=2.0,
         churn_threshold=0.0005, shortlist=32),
])
def test_simulator_matches_jax(policy_kw):
    """A simulated hour at 256 hosts with host failures, a heal and
    stragglers: identical counters, samples, placements, preemptions and
    final state.  Arrival times are not integers, so slot costs, the zone
    uptime sums and the normalization constants carry real fractions."""
    ts, js = _sims(256, 4, policy_kw)
    for sim in (ts, js):
        sim.inject_stragglers(0.05)
        sim.inject_host_failure("h3", at_s=900.0, heal_after_s=1200.0)
        sim.inject_host_failure("h77", at_s=2400.0)
    mt, mj = ts.run(3600.0), js.run(3600.0)
    assert mt.placed_normal > 0 and mt.preemptions > 0
    _assert_same_run(ts, js, mt, mj)


def test_sync_hosts_replaces_every_instance():
    ts, js = _sims(128, 8, dict(shortlist=8))
    ts.run(1200.0)
    js.run(1200.0)
    hosts = ts.fleet.sync_hosts()
    jhosts = js.fleet.sync_hosts()
    assert [sorted(h.instances) for h in hosts] == [sorted(h.instances) for h in jhosts]
    for h, jh in zip(hosts, jhosts):
        np.testing.assert_array_equal(h.free_full.vec, jh.free_full.vec)
    # a rebuilt fleet from the synced hosts decides like the live one
    rebuilt = SoAFleet(hosts, policy=ts.fleet.policy, device="cpu")
    np.testing.assert_array_equal(rebuilt.state.free_f.numpy(), ts.fleet.state.free_f.numpy())


def test_convert_round_trip_is_exact():
    rng = np.random.default_rng(0)
    arrays, _ = fleets.packed_arrays(50, 8, seed=1)
    arrays["inst_start"] = (rng.random((50, 8)) * 1e6).astype(np.float32)
    arrays["inst_valid"] = rng.random((50, 8)) < 0.5
    state = fleet_state_from_numpy(arrays, device="cpu")
    back = fleet_state_to_numpy(state)
    for f, v in arrays.items():
        assert back[f].dtype == np.asarray(v).dtype, f
        np.testing.assert_array_equal(back[f], v, err_msg=f)
    assert state.schedulable.dtype == torch.bool and state.domain.dtype == torch.int32
    bad = dict(arrays, domain=arrays["domain"] + 0.5)
    with pytest.raises(ValueError, match="domain"):
        fleet_state_from_numpy(bad, device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SoAFleet(fleets.empty_fleet(4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet_state_from_numpy(fleets.packed_arrays(4, 2)[0])


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    for name in ("repro_torch.core.torch_scheduler", "repro_torch.core.preemption",
                 "repro_torch.core.scan_sim", "repro_torch.core.fleet_sharding",
                 "repro_torch.configs", "repro_torch.configs.qwen2_1_5b",
                 "repro_torch.models.model", "repro_torch.models.convert",
                 "repro_torch.serving.engine", "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.rmsnorm", "repro_torch.optim.optimizers",
                 "repro_torch.training.train_step", "repro_torch.training.trainer",
                 "repro_torch.data.pipeline", "repro_torch.checkpoint.checkpointer"):
        assert name in modules, name
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
