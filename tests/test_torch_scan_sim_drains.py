"""The port's streaming trace replay against the JAX package's, continued
from ``test_torch_scan_sim_stream.py`` (whose helpers this file uses): a
saturated two-host fleet (overflow and spent retries), SLO-deadline drains,
and storm demotion.
"""
from __future__ import annotations

import torch

from test_torch_scan_sim import _items, run_case
from test_torch_scan_sim_stream import STREAM_MIXED, assert_stream_equal

torch.set_num_threads(1)


def test_stream_parity_overflow_and_retry_exhaustion():
    """Two hosts saturated: retries fill the queue, fresh arrivals overflow,
    retry budgets run out."""
    pol = dict(queue_capacity=8, admit_batch=4, slo_target_s=60.0, max_retries=6, n_classes=2)
    kw = dict(rate=1 / 6.0, frac=0.5, duration=4000.0, seed=11, priorities=(-1, 0, 1))
    case = run_case(2, _items(pol), _items(kw), 11)
    assert case[5].ok.size >= 400
    assert_stream_equal(case)
    adm = case[5].admission
    assert adm["rejected_overflow"] > 0 and adm["rejected_retry"] > 0 and adm["retries"] > 0


def test_stream_parity_slo_deadline_drains():
    """Sparse arrivals never fill a batch: drains fire on the SLO deadline
    throughout the run, not only in the epilogue."""
    pol = dict(queue_capacity=32, admit_batch=16, slo_target_s=25.0, max_retries=2)
    case = run_case(8, _items(pol), _items(dict(rate=1 / 60.0, duration=6000.0, seed=7)), 7)
    assert_stream_equal(case)
    adm = case[5].admission
    assert adm["admitted"] > 0 and adm["drains"] > adm["admitted"] // 16 + 1


def test_stream_parity_storm_degradation():
    """A tight storm threshold demotes preemptible attempts mid-storm."""
    pol = dict(STREAM_MIXED, storm_threshold=0.001)
    kw = dict(frac=1.0, duration=4000.0, seed=13, priorities=(-1, 0, 1, 2),
              cost_kinds=(-1, 0, 1, 2, 3),
              storms=((400.0, 0, 0.8), (1500.0, 1, 0.7), (2600.0, 2, 0.9)))
    case = run_case(9, _items(pol), _items(kw), 13)
    assert_stream_equal(case)
    assert case[5].admission["degraded"] > 0
