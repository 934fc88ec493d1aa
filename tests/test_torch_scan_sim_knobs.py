"""The port's streaming trace replay against the JAX package's, continued
from ``test_torch_scan_sim_stream.py`` (whose helpers this file uses): the
admission-knob axis (a neutral row, a knob sweep), ensemble lanes of unequal
traces against padded single runs, and 320 hosts, where the queue's
decisions take the shortlist path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import scan_sim as jss
from repro.core.policy import SchedulerPolicy as JPolicy
from repro_torch.core import scan_sim as tss
from repro_torch.core.policy import SchedulerPolicy as TPolicy
from test_torch_scan_sim import _items, run_case, sims, traces
from test_torch_scan_sim_stream import STREAM, STREAM_MIXED, assert_stream_equal, stream_lane_equal

torch.set_num_threads(1)


def test_stream_knobs_neutral_identity():
    """A knob row equal to the policy's values runs the static program's
    results bit for bit (aging 0 keeps the order, an infinite threshold
    never demotes)."""
    _, ts, _ = sims(8, STREAM, seed=1)
    _, tt = traces(duration=3000.0, seed=1, priorities=(-1, 0, 1, 2))
    pol = TPolicy(**STREAM)
    static = tss.simulate_scan(tt, pol, ts.fleet.state)
    neutral = np.asarray([pol.aging_rate, pol.slo_target_s, np.inf], np.float32)
    stream_lane_equal(tss.simulate_scan(tt, pol, ts.fleet.state, knobs=neutral), static)


KNOB_ROWS = np.asarray([[0.0, 120.0, np.inf], [0.05, 30.0, 0.02], [0.2, 300.0, 1.0]],
                       np.float32)


def test_stream_knob_ensemble_lanes():
    """A knob sweep: each lane equals the reference's lane and the port's
    single run with that row."""
    _, ts, j0 = sims(8, STREAM, seed=1)
    jt, tt = traces(duration=3000.0, seed=1, priorities=(-1, 0, 1, 2))
    want = jss.simulate_ensemble([jt], JPolicy(**STREAM), j0, knobs=KNOB_ROWS)
    lanes = tss.simulate_ensemble([tt], TPolicy(**STREAM), ts.fleet.state, knobs=KNOB_ROWS)
    assert len(lanes) == 3
    for i, (row, lane) in enumerate(zip(KNOB_ROWS, lanes)):
        stream_lane_equal(lane, want[i], f"knob lane {i}")
        single = tss.simulate_scan(tt, TPolicy(**STREAM), ts.fleet.state, knobs=row)
        stream_lane_equal(single, lane, f"knob single {i}")


def test_stream_ensemble_lanes_match_padded_singles():
    """Traces of unequal length: each lane equals the reference's lane and a
    single run of the same padded trace (PAD rows at the last time still
    sample and may fire SLO drains)."""
    _, ts, j0 = sims(6, STREAM)
    pairs = [traces(rate=1 / 30.0, duration=1500.0, seed=s, priorities=(-1, 0, 1, 2))
             for s in (1, 2, 3, 4)]
    emax = max(t.n_events for _, t in pairs)
    want = jss.simulate_ensemble([j for j, _ in pairs], JPolicy(**STREAM), j0)
    lanes = tss.simulate_ensemble([t for _, t in pairs], TPolicy(**STREAM), ts.fleet.state)
    for i, ((_, t), lane) in enumerate(zip(pairs, lanes)):
        stream_lane_equal(lane, want[i], f"lane {i}")
        e = t.n_events
        single = tss.simulate_scan(t.padded(emax), TPolicy(**STREAM), ts.fleet.state)
        trimmed = dataclasses.replace(single, host=single.host[:e], slot=single.slot[:e],
                                      ok=single.ok[:e], n_kill=single.n_kill[:e],
                                      wait_s=single.wait_s[:e])
        stream_lane_equal(lane, trimmed, f"padded single {i}")


def test_stream_knob_validation():
    _, ts, _ = sims(4, STREAM)
    st = ts.fleet.state
    _, tt = traces(rate=1 / 100.0, duration=400.0)
    pol = TPolicy(**STREAM)
    with pytest.raises(ValueError, match="queue_capacity > 0"):
        tss.simulate_scan(tt, TPolicy(), st, knobs=np.array([0.0, 60.0, np.inf], np.float32))
    with pytest.raises(ValueError, match="knob rows must be"):
        tss.simulate_scan(tt, pol, st, knobs=np.array([0.0, 60.0], np.float32))
    with pytest.raises(ValueError, match="aging_rate knob"):
        tss.simulate_scan(tt, pol, st, knobs=np.array([-1.0, 60.0, np.inf], np.float32))
    with pytest.raises(ValueError, match="slo_target_s knob"):
        tss.simulate_scan(tt, pol, st, knobs=np.array([0.0, 0.0, np.inf], np.float32))
    with pytest.raises(ValueError, match="storm_threshold knob"):
        tss.simulate_scan(tt, pol, st, knobs=np.array([0.0, 60.0, np.nan], np.float32))
    with pytest.raises(ValueError, match="one knob row"):
        tss.simulate_scan(tt, pol, st, knobs=np.array([[0.0, 60.0, np.inf]], np.float32))
    with pytest.raises(ValueError, match="3 traces vs 2 knob rows"):
        tss.simulate_ensemble([tt, tt, tt], pol, st, knobs=np.full((2, 3), 60.0, np.float32))
    with pytest.raises(ValueError, match=r"knobs must be \(P, 3\)"):
        tss.simulate_ensemble([tt], pol, st, knobs=np.array([0.0, 60.0, np.inf], np.float32))


def test_stream_parity_shortlist_path_320_hosts():
    """320 hosts: the queue's decisions screen the fleet and weigh a
    shortlist, with demotion and aging live."""
    kw = dict(rate=1 / 3.0, duration=600.0, seed=41, priorities=(-1, 0, 1, 2),
              storms=((300.0, 2, 0.6),), failures=((200.0, 7, 150.0),), checkpoint_every=2)
    case = run_case(320, _items(STREAM_MIXED), _items(kw), 41)
    assert_stream_equal(case)
    assert case[5].admission["admitted"] >= 150
