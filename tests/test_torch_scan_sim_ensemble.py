"""The port's trace-driven simulator on the CPU against the JAX package's,
continued from ``test_torch_scan_sim.py`` (whose helpers this file uses):
the saturated fleet, the shortlist path under the loop at 320 hosts, and
the ensembles over the seed and multiplier axes, each lane equal to the
reference's lane and to the port's own padded single run.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import scan_sim as jss
from repro.core.policy import SchedulerPolicy as JPolicy
from repro_torch.core import scan_sim as tss
from repro_torch.core.convert import fleet_state_to_numpy
from repro_torch.core.policy import SchedulerPolicy as TPolicy
from repro_torch.core.torch_scheduler import STATE_DTYPES
from test_torch_scan_sim import (
    MIXED,
    MULT_ROWS,
    _items,
    assert_four_equal,
    lane_equal,
    run_case,
    sims,
    traces,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# 1. the saturated fleet and the shortlist path
# ---------------------------------------------------------------------------
def test_scan_parity_default_policy_high_pressure():
    """Saturation: rejections and scheduler preemptions dominate."""
    case = run_case(8, (), _items(dict(rate=1 / 6.0, frac=0.5, duration=4000.0, seed=11)), 11)
    tm = case[4]
    assert case[5].ok.size >= 300
    assert tm.failures_normal + tm.failures_preemptible > 0 and tm.preemptions > 0
    assert_four_equal(case)


def test_scan_parity_shortlist_path_320_hosts():
    """320 hosts: every decision screens the fleet and weighs a shortlist of
    64 (the default M past 256 hosts), under the loop."""
    kw = dict(rate=1 / 4.0, duration=900.0, seed=21, checkpoint_every=3,
              storms=((600.0, 1, 0.5),), failures=((300.0, 5, 200.0),),
              cost_kinds=(-1, 0, 1, 2, 3))
    case = run_case(320, _items(MIXED), _items(kw), 21)
    assert case[4].placed_normal + case[4].placed_preemptible >= 150
    assert_four_equal(case)


# ---------------------------------------------------------------------------
# 3. ensembles
# ---------------------------------------------------------------------------
def _trim(res, e):
    return dataclasses.replace(res, host=res.host[:e], slot=res.slot[:e], ok=res.ok[:e],
                               n_kill=res.n_kill[:e])


@functools.lru_cache(maxsize=None)
def _ensemble_32():
    js, ts, j0 = sims(8, {})
    pairs = [traces(rate=1 / 40.0, duration=1500.0, seed=s, storms=((800.0, s % 3, 0.5),))
             for s in range(32)]
    want = jss.simulate_ensemble([j for j, _ in pairs], JPolicy(), j0)
    got = tss.simulate_ensemble([t for _, t in pairs], TPolicy(), ts.fleet.state)
    return ts, pairs, want, got


def test_ensemble_equals_reference_lanes():
    """32 seeds: every lane equals the reference's lane (which the
    reference pins to its padded single runs)."""
    _, pairs, want, got = _ensemble_32()
    assert len(got) == 32
    for i, (w, g) in enumerate(zip(want, got)):
        lane_equal(g, w, f"lane {i}")


def test_ensemble_equals_padded_singles():
    """Each lane equals one ``simulate_scan`` of its padded trace."""
    ts, pairs, _, got = _ensemble_32()
    emax = max(t.n_events for _, t in pairs)
    for i in (0, 7, 19, 31):
        t = pairs[i][1]
        single = tss.simulate_scan(t.padded(emax), TPolicy(), ts.fleet.state)
        lane_equal(got[i], _trim(single, t.n_events), f"lane {i}")


def test_ensemble_bitwise_reproducible_and_state_untouched():
    _, ts, _ = sims(8, {})
    before = fleet_state_to_numpy(ts.fleet.state)
    tr = [traces(rate=1 / 50.0, duration=1200.0, seed=s)[1] for s in range(8)]
    first = tss.simulate_ensemble(tr, TPolicy(), ts.fleet.state)
    second = tss.simulate_ensemble(tr, TPolicy(), ts.fleet.state)
    for a, b in zip(first, second):
        lane_equal(a, b)
    after = fleet_state_to_numpy(ts.fleet.state)
    for f in STATE_DTYPES:
        np.testing.assert_array_equal(before[f], after[f], err_msg=f)


def test_ensemble_multiplier_axis():
    """Traced weigher multipliers, a lane each: equal to the reference's
    lanes; the policy's own row equal to the plain run; a single run with
    one row equal to its lane."""
    js, ts, j0 = sims(8, {})
    jt, tt = traces(rate=1 / 30.0, duration=1500.0, seed=3)
    want = jss.simulate_ensemble([jt], JPolicy(), j0, mults=MULT_ROWS)
    got = tss.simulate_ensemble([tt], TPolicy(), ts.fleet.state, mults=MULT_ROWS)
    assert len(got) == 4
    for i, (w, g) in enumerate(zip(want, got)):
        lane_equal(g, w, f"multiplier lane {i}")
    lane_equal(tss.simulate_scan(tt, TPolicy(), ts.fleet.state), got[0], "static row")
    lane_equal(tss.simulate_scan(tt, TPolicy(), ts.fleet.state, mult=MULT_ROWS[1]), got[1],
               "single row")


@pytest.mark.parametrize("row", [[1.0, 1.0, 0.0, 0.0, 2.0], [0.5, 4.0, 0.0, 0.0, 0.7],
                                 [1.3, 0.7, 0.0, 0.0, 0.0]])
def test_multiplier_lane_churn_policy_320_hosts(row):
    """A churn-aware policy's multiplier lanes on 320 hosts (the screen and
    the shortlist under the loop, the churn term live after a storm): the
    port's lane equals the reference's single run with the same row."""
    kw = dict(churn_multiplier=2.0, churn_threshold=0.05)
    tkw = dict(rate=1 / 4.0, duration=700.0, seed=33, storms=((200.0, 0, 0.5),))
    _, _, jd, _, _, td = run_case(320, _items(kw), _items(tkw), 33, mult=tuple(row))
    lane_equal(td, jd, f"row {row}")
    assert td.counters["storm_kills"] > 0
