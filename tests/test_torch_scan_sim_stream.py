"""The port's trace-driven simulator in streaming admission mode
(``policy.queue_capacity > 0``, on the CPU) against the JAX package's,
mirroring section 5 of ``tests/test_scan_sim.py``: the wait queue in the
loop against the reference's in-scan queue and both ``run_trace``
front-end replays.

On top of the direct checks (``test_torch_scan_sim.assert_four_equal``) the
admission counters, the final queue (every column) and the sim-time waits of
the port's scan and the port's ``run_trace`` must equal the reference's.
This file holds the randomized sweep and the helpers;
``test_torch_scan_sim_drains.py`` the overflow, SLO and demotion cases,
``test_torch_scan_sim_knobs.py`` the knob axis, the padded lanes and 320
hosts.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import scan_sim as tss
from repro_torch.core.admission import QUEUE_DTYPES
from repro_torch.core.convert import queue_state_to_numpy
from repro_torch.core.policy import SchedulerPolicy as TPolicy
from test_torch_scan_sim import (
    _items,
    assert_four_equal,
    lane_equal,
    rich_kw,
    run_case,
    sims,
    traces,
)

torch.set_num_threads(1)

PARITY_SEEDS = (1, 2, 3, 5)
#: batch-full, SLO and capacity-freed drains
STREAM = dict(queue_capacity=16, admit_batch=4, slo_target_s=120.0, max_retries=2,
              n_classes=3)
#: every admission knob live at once: aging, demotion, mixed billing
STREAM_MIXED = dict(queue_capacity=16, admit_batch=4, slo_target_s=90.0, max_retries=2,
                    n_classes=3, aging_rate=0.01, storm_threshold=0.05, cost_kind="period",
                    cost_kinds=("count", "revenue", "recompute"))
ADM_KEYS = ("arrivals", "admitted", "rejected_overflow", "rejected_retry", "drains",
            "retries", "degraded")


def _queue(q):
    if isinstance(q.valid, torch.Tensor):
        return queue_state_to_numpy(q)
    return {f: np.asarray(getattr(q, f)) for f in QUEUE_DTYPES}


def queue_equal(a, b, what=""):
    a, b = _queue(a), _queue(b)
    for f in QUEUE_DTYPES:
        assert a[f].dtype == b[f].dtype, f"{what} queue column {f} dtype"
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{what} queue column {f}")


def stream_lane_equal(a, b, what=""):
    lane_equal(a, b, what)
    assert a.admission == b.admission, what
    assert a.wait_s.dtype == b.wait_s.dtype and np.array_equal(a.wait_s, b.wait_s), what
    queue_equal(a.queue, b.queue, what)


def assert_stream_equal(case):
    """The admission plane: counters, the final queue, the waits, on all
    four engines."""
    assert_four_equal(case)
    js, _, jd, ts, _, td = case
    jfront, tfront = js.fleet.admission, ts.fleet.admission
    want = {k: getattr(jfront.stats, k) for k in ADM_KEYS}
    want["queue_depth"] = jfront.waiting
    got = {k: getattr(tfront.stats, k) for k in ADM_KEYS}
    got["queue_depth"] = tfront.waiting
    assert td.admission == jd.admission == want == got
    adm = td.admission
    assert adm["arrivals"] == (adm["admitted"] + adm["rejected_overflow"]
                               + adm["rejected_retry"] + adm["queue_depth"])
    for q, what in ((jd.queue, "reference scan"), (jfront.qstate, "reference run_trace"),
                    (tfront.qstate, "port run_trace")):
        queue_equal(td.queue, q, f"port scan vs {what}")
    assert td.wait_s.dtype == jd.wait_s.dtype and np.array_equal(td.wait_s, jd.wait_s)
    waits = np.sort(td.wait_s[td.wait_s >= 0])
    assert np.array_equal(waits, np.sort(np.asarray(jfront.stats.wait_s, np.float32)))
    assert np.array_equal(waits, np.sort(np.asarray(tfront.stats.wait_s, np.float32)))
    assert td.wait_percentiles() == jd.wait_percentiles() == jfront.wait_percentiles() \
        == tfront.wait_percentiles()


@pytest.mark.parametrize("seed", PARITY_SEEDS)
def test_stream_parity_randomized_all_kinds(seed):
    """Storms under demotion, aging, mixed billing, failures and heals,
    checkpoints."""
    case = run_case(16, _items(STREAM_MIXED), _items(rich_kw(seed)), seed)
    assert case[5].ok.size >= 300
    assert_stream_equal(case)
    assert case[5].admission["admitted"] > 0 and case[5].admission["drains"] > 0


def test_stream_trace_priority_validation():
    _, ts, _ = sims(4, STREAM)
    _, tt = traces(rate=1 / 50.0, duration=800.0, priorities=(5,))
    with pytest.raises(ValueError, match="priority"):
        tss.simulate_scan(tt, TPolicy(**STREAM), ts.fleet.state)
