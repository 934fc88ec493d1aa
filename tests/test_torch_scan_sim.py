"""The port's trace-driven simulator (``repro_torch.core.scan_sim`` and
``SoASimulator.run_trace``, on the CPU) against the JAX package's, mirroring
``tests/test_scan_sim.py``: the direct engines, the trace encoding and its
checks, the multiplier rows' validation and the planes the loop does not
run.  The ensembles, the 320-host cases and the saturated fleet are in
``test_torch_scan_sim_ensemble.py``, the streaming half in
``test_torch_scan_sim_stream.py``.

Every case builds the same trace with both packages' ``trace_from_workload``
(equal column for column) and runs four engines from the same fleet: the
jitted reference ``simulate_scan``, the reference ``run_trace``, the port's
``simulate_scan`` and the port's ``run_trace``.  The port's two must equal
the reference's two bit for bit: every final state column, the per-arrival
``(host, slot, ok, n_kill)`` rows, every counter and every sample reading.
The reference results are cached per case, so a case shared by two tests
runs the reference once.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan_sim as jss
from repro.core.policy import SchedulerPolicy as JPolicy
from repro.core.simulator import SoASimulator as JSim, WorkloadSpec as JWorkload
from repro.core.types import VM_SPEC as JVM, Host as JHost
from repro_torch.core import scan_sim as tss
from repro_torch.core.convert import fleet_state_to_numpy
from repro_torch.core.policy import COST_KINDS, SchedulerPolicy as TPolicy
from repro_torch.core.simulator import SoASimulator as TSim, WorkloadSpec as TWorkload
from repro_torch.core.torch_scheduler import STATE_DTYPES
from repro_torch.core.types import VM_SPEC, Host

torch.set_num_threads(1)

K = 8
PARITY_SEEDS = (1, 2, 3, 5)
MIXED = dict(cost_kind="period", cost_kinds=("count", "revenue", "recompute"))
COUNTERS = ("placed_normal", "placed_preemptible", "failures_normal",
            "failures_preemptible", "preemptions", "storms", "storm_kills")


def _sizes(spec):
    return [spec.make(vcpus=1, ram_mb=2000, disk_gb=20),
            spec.make(vcpus=2, ram_mb=4000, disk_gb=40),
            spec.make(vcpus=4, ram_mb=8000, disk_gb=80)]


def _hosts(host_cls, spec, n, n_zones=3):
    cap = spec.make(vcpus=8, ram_mb=16000, disk_gb=160)
    return [host_cls(name=f"h{i}", capacity=cap, domain=f"dom{i % 2}",
                     zone=f"z{i % n_zones}") for i in range(n)]


def _workload(side, rate=1 / 20.0, frac=0.6):
    cls, spec = (JWorkload, JVM) if side == "jax" else (TWorkload, VM_SPEC)
    return cls(arrival_rate_per_s=rate, preemptible_fraction=frac,
               flavors=[(f"f{i}", s) for i, s in enumerate(_sizes(spec))])


def traces(rate=1 / 20.0, frac=0.6, duration=8000.0, seed=0, **kw):
    """The same trace from both packages' encoders, checked equal column
    for column: ``(jax_trace, port_trace)``."""
    j = jss.trace_from_workload(_workload("jax", rate, frac), duration, seed=seed, **kw)
    t = tss.trace_from_workload(_workload("port", rate, frac), duration, seed=seed, **kw)
    for f in dataclasses.fields(tss.EventTrace):
        a, b = getattr(j, f.name), getattr(t, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f"trace column {f.name}"
    return j, t


def rich_kw(seed, duration=8000.0, n_hosts=16):
    """The reference's randomized all-kinds trace: mixed billing and
    priorities, a storm in every zone, a failure and heal, checkpoints."""
    rng = np.random.default_rng(seed * 7919)
    storms = tuple((float(rng.integers(int(duration * 0.2), int(duration * 0.9))), int(z),
                    float(f)) for z, f in zip(range(3), (0.5, 0.3, 0.8)))
    failures = ((float(rng.integers(int(duration * 0.3), int(duration * 0.6))),
                 int(rng.integers(0, n_hosts)), duration * 0.15),)
    return dict(duration=duration, seed=seed, storms=storms, failures=failures,
                checkpoint_every=3, cost_kinds=(-1, 0, 1, 2, 3, 1, -1, 3),
                priorities=(-1, 0, 1, 2))


def sims(n_hosts, policy_kw, seed=0):
    """A reference and a port ``SoASimulator`` over the same fleet (equal
    starting states), and the reference's starting state for its scan."""
    js = JSim(_hosts(JHost, JVM, n_hosts), _workload("jax"), seed=seed, k_slots=K,
              policy=JPolicy(**policy_kw))
    ts = TSim(_hosts(Host, VM_SPEC, n_hosts), _workload("port"), seed=seed, k_slots=K,
              policy=TPolicy(**policy_kw), device="cpu")
    got = fleet_state_to_numpy(ts.fleet.state)
    for f in STATE_DTYPES:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(js.fleet.state, f)))
    j0 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)), js.fleet.state)
    return js, ts, j0


@functools.lru_cache(maxsize=None)
def run_case(n_hosts, policy_items, trace_items, seed=0, sample_every_s=300.0, mult=None):
    """The four engines on one case (cached): ``(jax_sim, jax_metrics,
    jax_scan, port_sim, port_metrics, port_scan)``."""
    policy_kw, trace_kw = dict(policy_items), dict(trace_items)
    jt, tt = traces(**trace_kw)
    js, ts, j0 = sims(n_hosts, policy_kw, seed)
    t0 = ts.fleet.state
    j_scan = jss.simulate_scan(jt, JPolicy(**policy_kw), j0, sample_every_s=sample_every_s,
                               mult=None if mult is None else np.asarray(mult, np.float32))
    t_scan = tss.simulate_scan(tt, TPolicy(**policy_kw), t0, sample_every_s=sample_every_s,
                               mult=None if mult is None else np.asarray(mult, np.float32))
    if mult is not None:
        return None, None, j_scan, None, None, t_scan
    jm = js.run_trace(jt, sample_every_s=sample_every_s)
    tm = ts.run_trace(tt, sample_every_s=sample_every_s)
    return js, jm, j_scan, ts, tm, t_scan


def _items(d):
    return tuple(sorted(d.items()))


def _arrays(state):
    """Either package's fleet state as numpy arrays by field name."""
    if isinstance(state.free_f, torch.Tensor):
        return fleet_state_to_numpy(state)
    return {f: np.asarray(getattr(state, f)) for f in STATE_DTYPES}


def state_equal(got, want, what=""):
    """Two fleet states (either package's) equal in every column."""
    got, want = _arrays(got), _arrays(want)
    for f in STATE_DTYPES:
        assert got[f].dtype == want[f].dtype, f"{what} state column {f} dtype"
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what} state column {f}")


def outcomes(res):
    return np.stack([res.host, res.slot, res.ok.astype(np.int64), res.n_kill], axis=1)


def lane_equal(a, b, what=""):
    """Two ``ScanResult``s (either package's) equal: counters, outcomes,
    samples, final state."""
    assert a.counters == b.counters, what
    for name in ("host", "slot", "ok", "n_kill", "sample_t", "sample_free0",
                 "sample_free0_normal"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and np.array_equal(x, y), f"{what} {name}"
    state_equal(a.state, b.state, what)


def metrics_equal(m_got, m_want, what=""):
    for name in COUNTERS:
        assert getattr(m_got, name) == getattr(m_want, name), f"{what} {name}"
    assert m_got.t == m_want.t, what
    assert m_got.utilization == m_want.utilization, what
    assert m_got.utilization_normal == m_want.utilization_normal, what


def assert_four_equal(case):
    """The port's scan and run_trace against the reference's scan and
    run_trace, and conservation at the end."""
    js, jm, jd, ts, tm, td = case
    lane_equal(td, jd, "port scan vs reference scan")
    state_equal(td.state, js.fleet.state, "port scan vs reference run_trace")
    state_equal(ts.fleet.state, js.fleet.state, "port run_trace vs reference run_trace")
    np.testing.assert_array_equal(outcomes(td), js.trace_outcomes)
    np.testing.assert_array_equal(ts.trace_outcomes, js.trace_outcomes)
    np.testing.assert_array_equal(outcomes(jd), js.trace_outcomes)
    cap0 = ts.fleet._cap0_total
    assert cap0 == js.fleet._cap0_total
    m_dev = td.sim_metrics(cap0)
    metrics_equal(m_dev, jm, "port scan vs reference run_trace")
    metrics_equal(tm, jm, "port run_trace vs reference run_trace")
    metrics_equal(m_dev, jd.sim_metrics(cap0), "port scan vs reference scan")
    for u in m_dev.utilization:
        assert 0.0 <= u <= 1.0 + 1e-12
    # per host: free + live preemptible + live normal == capacity
    st = fleet_state_to_numpy(td.state)
    used_pre = np.where(st["inst_valid"][:, :, None], st["inst_res"], 0.0).sum(axis=1)
    used_norm = np.zeros_like(st["free_f"])
    for iid, (h, slot) in ts.fleet.locator.items():
        if slot is None:
            used_norm[h] += ts.fleet.instances[iid].resources.vec32
    cap = np.asarray(ts.fleet.capacity[0].vec32)
    np.testing.assert_array_equal(st["free_f"] + used_pre + used_norm,
                                  np.broadcast_to(cap, st["free_f"].shape))


#: the reference's multiplier rows, then a zero under a nonzero gate
MULT_ROWS = np.array([[1.0, 1.0, 0.0, 0.0, 0.0],
                      [4.0, 0.25, 0.0, 0.0, 0.0],
                      [0.5, 2.0, 0.0, 0.0, 0.0],
                      [0.0, 1.0, 0.0, 0.0, 0.0]], np.float32)


# ---------------------------------------------------------------------------
# 1. the differential sweep: every kind, mixed billing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", PARITY_SEEDS)
def test_scan_parity_randomized_all_kinds(seed):
    case = run_case(16, _items(MIXED), _items(rich_kw(seed)), seed)
    jt, tt = traces(**rich_kw(seed))
    assert tt.n_events >= 300
    kinds = set(np.unique(tt.kind).tolist())
    assert {tss.ARRIVAL, tss.DEPARTURE, tss.FAIL_HOST, tss.HEAL_HOST, tss.CHECKPOINT,
            tss.ZONE_STORM} <= kinds
    assert len(set(np.unique(tt.cost_kind).tolist())) >= 4
    assert_four_equal(case)


def test_scan_parity_storm_only_and_empty_zone():
    """Storms on a populated and on an empty zone (counted, nobody killed),
    with the zone churn accumulators."""
    kw = dict(frac=1.0, duration=3000.0, seed=4,
              storms=((100.0, 2, 0.7), (1500.0, 0, 0.5), (2500.0, 1, 1.0)))
    case = run_case(9, (), _items(kw), 4)
    assert case[4].storms == 3
    assert_four_equal(case)


def test_scan_parity_failure_heal_cycle():
    kw = dict(duration=5000.0, seed=9, checkpoint_every=2,
              failures=((1200.0, 1, 600.0), (2400.0, 3, None), (3000.0, 0, 300.0)))
    assert_four_equal(run_case(10, (), _items(kw), 9))


def test_scan_parity_sample_cadence():
    """A non-default cadence interleaves samples and flushes differently."""
    case = run_case(16, _items(MIXED), _items(rich_kw(2, duration=4000.0)), 2,
                    sample_every_s=170.0)
    assert_four_equal(case)


# ---------------------------------------------------------------------------
# 2. the trace: round trips and malformed traces
# ---------------------------------------------------------------------------
def _random_events(rng, n: int):
    events, arrivals = [], []
    t = 0.0
    for _ in range(n):
        t += float(rng.integers(0, 30))
        k = rng.choice(["arrival", "departure", "fail_host", "heal_host",
                        "checkpoint", "zone_storm", "pad"])
        if k == "arrival":
            ev = tss.TraceEvent(
                kind=k, time=t,
                res=tuple(float(v) for v in rng.integers(1, 8, size=3)),
                preemptible=bool(rng.random() < 0.5),
                duration=float(rng.integers(60, 600)),
                cost_kind=int(rng.integers(-1, 4)),
                period=float(rng.choice([-1.0, 60.0, 3600.0])),
                price=float(rng.integers(1, 5)),
                priority=int(rng.integers(-1, 3)),
                domain=int(rng.integers(-1, 2)),
            )
            arrivals.append(len(events))
        elif k in ("departure", "checkpoint") and arrivals:
            ev = tss.TraceEvent(kind=k, time=t, inst_id=int(rng.choice(arrivals)))
        elif k == "fail_host" or k == "heal_host":
            ev = tss.TraceEvent(kind=k, time=t, host=int(rng.integers(0, 8)))
        elif k == "zone_storm":
            ev = tss.TraceEvent(kind=k, time=t, zone=int(rng.integers(0, 3)),
                                frac=float(rng.uniform(0.1, 1.0)))
        else:
            ev = tss.TraceEvent(kind="pad", time=t)
        events.append(ev)
    return events


@pytest.mark.parametrize("seed", PARITY_SEEDS)
def test_trace_round_trip_identity(seed):
    events = _random_events(np.random.default_rng(seed), 120)
    trace = tss.EventTrace.from_events(events, n_dims=3)
    back = tss.EventTrace.from_events(trace.events(), n_dims=3)
    want = jss.EventTrace.from_events(
        [jss.TraceEvent(**dataclasses.asdict(ev)) for ev in events], n_dims=3)
    for f in dataclasses.fields(tss.EventTrace):
        assert np.array_equal(getattr(trace, f.name), getattr(back, f.name)), f.name
        assert np.array_equal(getattr(trace, f.name), getattr(want, f.name)), f.name


def test_workload_trace_round_trips_too():
    _, trace = traces(**rich_kw(1, duration=2000.0))
    back = tss.EventTrace.from_events(trace.events(), n_dims=trace.n_dims)
    for f in dataclasses.fields(tss.EventTrace):
        assert np.array_equal(getattr(trace, f.name), getattr(back, f.name))


def test_padded_and_stacked_traces():
    _, a = traces(rate=1 / 40.0, duration=1500.0, seed=1)
    _, b = traces(rate=1 / 40.0, duration=1500.0, seed=2)
    ja, jb = (jss.trace_from_workload(_workload("jax", 1 / 40.0), 1500.0, seed=s)
              for s in (1, 2))
    got, want = tss.stack_traces([a, b]), jss.stack_traces([ja, jb])
    assert got.keys() == want.keys()
    for name in got:
        assert np.array_equal(got[name], want[name]), name
    emax = max(a.n_events, b.n_events)
    pad = a.padded(emax)
    assert pad.n_events == emax and np.all(pad.kind[a.n_events:] == tss.PAD)
    assert np.all(pad.time[a.n_events:] == a.time[-1])
    with pytest.raises(ValueError, match="cannot pad"):
        pad.padded(a.n_events - 1)
    with pytest.raises(ValueError, match="at least one trace"):
        tss.stack_traces([])


MALFORMED = [
    ([tss.TraceEvent(kind="pad", time=10.0), tss.TraceEvent(kind="pad", time=5.0)], 2,
     r"unsorted times: time\[1\]"),
    ([tss.TraceEvent(kind="meteor", time=0.0)], 2, "unknown event kind 'meteor'"),
    ([tss.TraceEvent(kind="zone_storm", time=0.0, zone=0, frac=np.nan)], 2,
     "NaN payload in column 'frac' at row 0"),
    ([tss.TraceEvent(kind="arrival", time=0.0, res=(1.0, np.nan), duration=60.0)], 2,
     "NaN payload in column 'res' at row 0"),
    ([tss.TraceEvent(kind="arrival", time=0.0, res=(1.0, np.inf), duration=60.0)], 2,
     "non-finite arrival size at row 0"),
    ([tss.TraceEvent(kind="pad", time=0.0), tss.TraceEvent(kind="pad", time=np.nan)], 2,
     "non-finite time at row 1"),
    ([tss.TraceEvent(kind="departure", time=0.0, inst_id=5)], 2, "departure at row 0 targets"),
    ([tss.TraceEvent(kind="checkpoint", time=0.0, inst_id=-1)], 2,
     "checkpoint at row 0 targets"),
    ([tss.TraceEvent(kind="departure", time=0.0, inst_id=1),
      tss.TraceEvent(kind="arrival", time=5.0, res=(1.0, 1.0), duration=60.0)], 2,
     "precedes its arrival"),
    ([tss.TraceEvent(kind="zone_storm", time=0.0, zone=0, frac=1.5)], 2, "kill fraction 1.5"),
    ([tss.TraceEvent(kind="fail_host", time=0.0)], 2, "fail_host at row 0 has no host"),
    ([tss.TraceEvent(kind="zone_storm", time=0.0, zone=-1, frac=0.5)], 2,
     "zone_storm at row 0 has no zone"),
    ([tss.TraceEvent(kind="arrival", time=0.0, res=(1.0, -1.0), duration=60.0)], 2,
     "negative arrival size at row 0"),
    ([tss.TraceEvent(kind="arrival", time=0.0, res=(1.0, 1.0), cost_kind=7)], 2,
     "unknown cost kind id 7 at row 0"),
    ([tss.TraceEvent(kind="pad", time=-1.0)], 2, "negative time at row 0"),
]


@pytest.mark.parametrize("events,n_dims,message", MALFORMED)
def test_malformed_traces_rejected(events, n_dims, message):
    """Every construction check, with the reference's message."""
    with pytest.raises(ValueError, match=message):
        tss.EventTrace.from_events(events, n_dims=n_dims)
    with pytest.raises(ValueError, match=message):
        jss.EventTrace.from_events(
            [jss.TraceEvent(**dataclasses.asdict(ev)) for ev in events], n_dims=n_dims)


def test_malformed_columns_rejected():
    good = tss.EventTrace.from_events([tss.TraceEvent(kind="pad", time=0.0)], n_dims=2)
    ok = tss.EventTrace.from_events(
        [tss.TraceEvent(kind="pad", time=10.0), tss.TraceEvent(kind="pad", time=5.0)][:1],
        n_dims=2)
    assert ok.n_events == 1
    with pytest.raises(ValueError, match="unknown event kind 99 at row 0"):
        dataclasses.replace(good, kind=np.array([99], np.int32))
    with pytest.raises(ValueError, match="trace column 'time' has shape"):
        dataclasses.replace(good, time=np.zeros((2,), np.float32))


def test_trace_vs_fleet_validation():
    _, ts, _ = sims(4, {})
    st = ts.fleet.state
    pol = TPolicy()
    trace = tss.EventTrace.from_events([tss.TraceEvent(kind="fail_host", time=0.0, host=99)],
                                       n_dims=3)
    with pytest.raises(ValueError, match="host index out of range"):
        tss.simulate_scan(trace, pol, st)
    kinds = tss.EventTrace.from_events(
        [tss.TraceEvent(kind="arrival", time=0.0, res=(1.0, 1.0, 1.0), duration=60.0,
                        cost_kind=COST_KINDS.index("revenue"))], n_dims=3)
    with pytest.raises(ValueError, match="not in the\\s+policy's kind table"):
        tss.simulate_scan(kinds, pol, st)
    storm = tss.EventTrace.from_events(
        [tss.TraceEvent(kind="zone_storm", time=0.0, zone=5, frac=0.5)], n_dims=3)
    with pytest.raises(ValueError, match="zone index out of range"):
        tss.simulate_scan(storm, pol, st)
    dims = tss.EventTrace.from_events([tss.TraceEvent(kind="pad", time=0.0)], n_dims=2)
    with pytest.raises(ValueError, match="2 resource dims, fleet has 3"):
        tss.simulate_scan(dims, pol, st)
    _, tt = traces(rate=1 / 100.0, duration=500.0)
    with pytest.raises(ValueError, match="one multiplier row"):
        tss.simulate_scan(tt, pol, st, mult=MULT_ROWS[:1])


def test_default_device_is_the_card():
    """With no CUDA device a state asked onto the card raises instead of
    running on the CPU."""
    _, ts, _ = sims(4, {})
    _, tt = traces(rate=1 / 100.0, duration=300.0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the CPU fallback check needs none")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tss.simulate_scan(tt, TPolicy(), ts.fleet.state, device="cuda")


def test_ensemble_multiplier_validation():
    _, ts, _ = sims(4, {})
    _, tt = traces(rate=1 / 100.0, duration=500.0)
    st = ts.fleet.state
    with pytest.raises(ValueError, match="column 2 must be 0"):
        tss.simulate_ensemble([tt], TPolicy(), st, mults=np.array([[1.0, 1.0, 0.5, 0.0, 0.0]]))
    with pytest.raises(ValueError, match="keep the\\s+static multiplier's sign"):
        tss.simulate_ensemble([tt], TPolicy(), st, mults=np.array([[1.0, -1.0, 0.0, 0.0, 0.0]]))
    with pytest.raises(ValueError, match="must have 5 entries"):
        tss.simulate_ensemble([tt], TPolicy(), st, mults=np.array([[1.0, 1.0]]))
    with pytest.raises(ValueError, match="non-finite multiplier"):
        tss.simulate_ensemble([tt], TPolicy(), st,
                              mults=np.array([[np.inf, 1.0, 0.0, 0.0, 0.0]]))
    with pytest.raises(ValueError, match=r"mults must be \(P, n_multipliers\)"):
        tss.simulate_ensemble([tt], TPolicy(), st, mults=MULT_ROWS[0])
    with pytest.raises(ValueError, match="2 traces vs 3 multiplier rows"):
        tss.simulate_ensemble([tt, tt], TPolicy(), st, mults=MULT_ROWS[:3])
    with pytest.raises(ValueError, match="at least one trace"):
        tss.simulate_ensemble([], TPolicy(), st)


# ---------------------------------------------------------------------------
# 4. planes the loop does not run
# ---------------------------------------------------------------------------
def test_unsupported_planes_raise():
    _, ts, _ = sims(4, {})
    _, tt = traces(rate=1 / 100.0, duration=400.0)
    for bad in (TPolicy(relocate_threshold=0.5),
                TPolicy(adaptive_shortlist=True, shortlist=32)):
        with pytest.raises(NotImplementedError, match="which-planes-scan"):
            tss.simulate_scan(tt, bad, ts.fleet.state)
        with pytest.raises(NotImplementedError, match="which-planes-scan"):
            tss.simulate_ensemble([tt], bad, ts.fleet.state)
    rel = TSim(_hosts(Host, VM_SPEC, 4), _workload("port"), policy=TPolicy(relocate_threshold=0.5),
               device="cpu")
    with pytest.raises(NotImplementedError, match="run_trace"):
        rel.run_trace(tt)
    # the kernel knobs the JAX package refuses in an ensemble do not exist here
    with pytest.raises(TypeError):
        TPolicy(use_pallas=True)
