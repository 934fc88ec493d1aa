"""The port's ``sched_weigh`` / ``sched_weigh_gathered`` (plain versions, on
CPU tensors) against the JAX package's Pallas kernel in interpret mode and
its jnp oracle ``host_plan_terms``; the CUDA kernel is held against the plain
version in test_torch_cuda_kernels.py.

Integer-valued inputs: every output must be bitwise equal.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core.jax_scheduler import host_plan_terms, subset_masks
from repro.kernels.sched_weigh import sched_weigh as jax_sched_weigh
from repro.kernels.sched_weigh import sched_weigh_gathered as jax_gathered
from repro_torch import kernels

torch.set_num_threads(1)

def _rand_soa(rng, n, k, d=3):
    free_f = rng.integers(0, 9, (n, d)).astype(np.float32)
    inst_res = rng.integers(1, 5, (n, k, d)).astype(np.float32)
    inst_valid = rng.random((n, k)) < 0.7
    inst_cost = (rng.integers(0, 60, (n, k)) * 60).astype(np.float32)
    req = rng.integers(2, 14, (d,)).astype(np.float32)
    return free_f, inst_res, inst_cost, inst_valid, req


def _t(*arrays, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def _assert_same(got, want):
    for g, w, name in zip(got, want, ("best_cost", "best_mask", "feasible")):
        np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("k,n", [(1, 37), (4, 130), (8, 300), (12, 48)])
def test_sched_weigh_matches_reference(k, n):
    rng = np.random.default_rng(k * 1000 + n)
    arrays = _rand_soa(rng, n, k)
    masks = subset_masks(k)
    kernels.reset_launch_counts()
    got = kernels.sched_weigh(*_t(*arrays))
    _assert_same(got, jax.jit(host_plan_terms)(*arrays, masks))
    _assert_same(got, jax_sched_weigh(*arrays, masks, interpret=True))
    assert kernels.launch_counts()["sched_weigh"] == 0   # CPU: plain version


@pytest.mark.parametrize("k,m", [(4, 5), (8, 64), (12, 17)])
def test_gathered_matches_reference(k, m):
    rng = np.random.default_rng(k * 100 + m)
    free_f, inst_res, inst_cost, inst_valid, req = _rand_soa(rng, 200, k)
    cand = rng.choice(200, size=m, replace=False)
    rows = (free_f[cand], inst_res[cand], inst_cost[cand], inst_valid[cand], req)
    got = kernels.sched_weigh_gathered(*_t(*rows))
    _assert_same(got, jax_gathered(*rows, subset_masks(k), interpret=True))


@pytest.mark.parametrize("gap_frac,want_mask", [(0.5, 0b001), (2.0, 0b110)])
def test_tie_epsilon_boundary(gap_frac, want_mask):
    """A cost gap just inside TIE_EPS ties the 1-slot plan with the cheaper
    2-slot plan (fewer instances win); just outside, the cheap plan wins."""
    free_f = np.zeros((1, 1), np.float32)
    inst_res = np.array([[[4.0], [2.0], [2.0]]], np.float32)
    inst_valid = np.ones((1, 3), bool)
    req = np.array([4.0], np.float32)
    inst_cost = np.array([[10.0 + gap_frac * kernels.TIE_EPS, 5.0, 5.0]], np.float32)
    arrays = (free_f, inst_res, inst_cost, inst_valid, req)
    got = kernels.sched_weigh(*_t(*arrays))
    _assert_same(got, jax_sched_weigh(*arrays, subset_masks(3), interpret=True))
    assert float(got[0][0]) == 10.0 and int(got[1][0]) == want_mask


def test_all_slots_invalid_host():
    """Hosts with no valid slot are feasible iff the request fits as-is."""
    k = 4
    free_f = np.array([[4.0, 4.0, 4.0], [1.0, 1.0, 1.0]], np.float32)
    arrays = (free_f, np.zeros((2, k, 3), np.float32), np.zeros((2, k), np.float32),
              np.zeros((2, k), bool), np.array([2.0, 2.0, 2.0], np.float32))
    got = kernels.sched_weigh(*_t(*arrays))
    _assert_same(got, jax_sched_weigh(*arrays, subset_masks(k), interpret=True))
    np.testing.assert_array_equal(got[2].numpy(), [True, False])
    assert float(got[0][0]) == 0.0 and int(got[1][0]) == 0


def test_non_integer_costs_match_jnp_oracle():
    """Non-integer slot costs: the subset sums run in ascending slot order
    on both sides (XLA's small dot adds in order), so the plain version still
    equals the jitted oracle bitwise."""
    rng = np.random.default_rng(9)
    free_f, inst_res, _, inst_valid, req = _rand_soa(rng, 256, 8)
    inst_cost = (rng.random((256, 8)) * 3600).astype(np.float32)
    arrays = (free_f, inst_res, inst_cost, inst_valid, req)
    _assert_same(kernels.sched_weigh(*_t(*arrays)),
                 jax.jit(host_plan_terms)(*arrays, subset_masks(8)))


def test_rejects_bad_input_on_cuda_path():
    """The CUDA wrapper validates before launching (checked without a card
    through the validation helper)."""
    from repro_torch.kernels.sched_weigh import _check_cuda

    rng = np.random.default_rng(1)
    arrays = _t(*_rand_soa(rng, 4, 13))
    with pytest.raises(ValueError, match="K <= 12"):
        _check_cuda(*arrays)
    arrays = _t(*_rand_soa(rng, 4, 4))
    with pytest.raises(ValueError, match="must be"):
        _check_cuda(arrays[0].double(), *arrays[1:])
