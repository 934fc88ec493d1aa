"""The port's stage-1 screen (``sched_screen``, ``sched_screen_consts``,
``sched_screen_topm``; plain versions on CPU tensors) against the JAX
package's Pallas kernels in interpret mode; the CUDA
kernels are held against the plain versions in test_torch_cuda_kernels.py.

Integer-valued fleets: scores, host indices (tie order included) and the 10
constants must be bitwise equal.
"""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import kernels

# the package re-exports the function under the module's name
jss = importlib.import_module("repro.kernels.sched_screen")

torch.set_num_threads(1)

DEFAULT_MULT = (1.0, 1.0, 0.0, 0.0)
CHURN_MULT = (1.0, 1.0, 0.5, 0.25, 2.0)

def _fleet(rng, n, k, d=3, tied=False):
    """Random integer-valued fleet; ``tied`` draws from tiny ranges so that
    most hosts share their score."""
    hi = 2 if tied else 9
    a = dict(
        free_f=rng.integers(0, hi, (n, d)).astype(np.float32),
        free_n=rng.integers(2, 2 + hi, (n, d)).astype(np.float32),
        schedulable=rng.random(n) < 0.9,
        domain=rng.integers(0, 3, (n,)).astype(np.int32),
        slow=rng.integers(1, 2 if tied else 5, (n,)).astype(np.float32),
        inst_res=rng.integers(0, 2 if tied else 5, (n, k, d)).astype(np.float32),
        inst_cost=(rng.integers(0, 2 if tied else 60, (n, k)) * 60).astype(np.float32),
        inst_valid=rng.random((n, k)) < 0.7,
    )
    return a


def _torch(a, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(v)).to(device) for v in a.values()]


def _case(a, req, pre, rdom, mult, m_keep, churn=None, thr=None, zone=None, excl=None,
          device="cpu"):
    """Port and JAX-interpret results of the fused screen and its split."""
    jargs = (*a.values(), req, jnp.asarray(pre), jnp.asarray(rdom, jnp.int32))
    jkw = dict(weigher_multipliers=mult, require_free_slot=True, interpret=True,
               churn=None if churn is None else jnp.asarray(churn),
               churn_threshold=thr,
               host_zone=None if zone is None else jnp.asarray(zone),
               exclude_zone=None if excl is None else jnp.asarray(excl, jnp.int32))
    # the JAX split kernels equal its fused one (tests/test_sched_screen.py),
    # so the port's split is held against the fused result
    want = jss.sched_screen(*jargs, m_keep=m_keep, **jkw)
    want_c, want_t = want[2], want[:2]
    targs = (*_torch(a, device), torch.from_numpy(req).to(device), pre, rdom)
    dev = lambda x: None if x is None else torch.from_numpy(x).to(device)
    tkw = dict(churn=dev(churn), churn_threshold=thr, host_zone=dev(zone),
               exclude_zone=excl)
    got = kernels.sched_screen(*targs, mult, True, m_keep, **tkw)
    got_c = kernels.sched_screen_consts(*targs, mult, True, **tkw)
    got_t = kernels.sched_screen_topm(*targs, got_c, mult, True, m_keep, **tkw)
    for g, w, name in ((got[0], want[0], "scores"), (got[1], want[1], "idx"),
                       (got[2], want[2], "consts"), (got_c, want_c, "split consts"),
                       (got_t[0], want_t[0], "split scores"),
                       (got_t[1], want_t[1], "split idx")):
        np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("k,n", [(4, 37), (8, 300), (12, 64)])
def test_screen_matches_pallas_interpret(k, n):
    rng = np.random.default_rng(k * 1000 + n)
    a = _fleet(rng, n, k)
    req = rng.integers(2, 14, (3,)).astype(np.float32)
    for pre in (False, True):
        _case(a, req, pre, -1, DEFAULT_MULT, min(65, n))


@pytest.mark.parametrize("pre", [False, True])
def test_heavily_tied_fleet(pre):
    """Most hosts share their score: the order must be lax.top_k's (value
    descending, lowest host index first), which torch.topk does not keep."""
    rng = np.random.default_rng(31)
    a = _fleet(rng, 400, 8, tied=True)
    req = np.array([1.0, 1.0, 1.0], np.float32)
    _case(a, req, pre, -1, DEFAULT_MULT, 65)


def test_churn_threshold_and_multipliers():
    rng = np.random.default_rng(77)
    n = 300
    a = _fleet(rng, n, 8)
    req = rng.integers(2, 10, (3,)).astype(np.float32)
    churn = (rng.integers(0, 8, (4,)).astype(np.float32) / 8.0)[rng.integers(0, 4, (n,))]
    for pre, thr in ((False, None), (True, 0.5), (True, 0.0)):
        _case(a, req, pre, 1, CHURN_MULT, 33, churn=churn, thr=thr)


def test_zone_exclusion():
    rng = np.random.default_rng(5)
    n = 200
    a = _fleet(rng, n, 6)
    req = rng.integers(2, 10, (3,)).astype(np.float32)
    zone = rng.integers(0, 4, (n,)).astype(np.int32)
    for excl in (-1, 3):
        _case(a, req, True, -1, (1.0, 2.0, 0.5, 0.25), 17, zone=zone, excl=excl)


def test_keep_every_host():
    """M + 1 = N: the shortlist plus the witness is the whole fleet."""
    rng = np.random.default_rng(2)
    a = _fleet(rng, 40, 8)
    req = rng.integers(2, 10, (3,)).astype(np.float32)
    _case(a, req, False, -1, (1.0, -1.0, 0.0, 0.5), 40)


def test_counters_stay_zero_on_cpu_and_bad_m_keep_raises():
    rng = np.random.default_rng(3)
    a = _fleet(rng, 20, 4)
    req = np.ones(3, np.float32)
    kernels.reset_launch_counts()
    args = (*_torch(a), torch.from_numpy(req), False, -1, DEFAULT_MULT, True)
    kernels.sched_screen(*args, 5)
    assert all(v == 0 for v in kernels.launch_counts().values())
    with pytest.raises(ValueError, match="m_keep"):
        kernels.sched_screen(*args, 21)


def test_merge_size_guard():
    """The one-block merge raises for a candidate set its shared memory
    cannot hold instead of truncating."""
    from repro_torch.kernels.sched_screen import _merge_size

    assert _merge_size(65536, 65) == 8192
    with pytest.raises(ValueError, match="shared memory"):
        _merge_size(65536, 257)
