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
from repro_torch.core import fleets

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


def _low_bits(k):
    """Mask bits a thread of ``csrc/sched_weigh.cu`` takes from its index
    (``Geometry<K>::kLowBits``): 5 up to K = 8 (fewer below K = 5), 8 above."""
    return min(k, 5) if k <= 8 else 8


def _weigh_emulated(free_f, inst_res, inst_cost, inst_valid, req, low):
    """The kernel's order in numpy f32: each mask's slot sums start from the
    table entry of its low ``low`` bits (slots summed in ascending order, the
    ones outside the mask skipped) and add its high slots in ascending order;
    at K = 4 and 5 on two or more hosts, XLA's trees over all K slots (an
    exact 0 for a slot outside the mask), whatever ``low``; then min cost,
    the min (popcount << 16 | mask) key among masks within TIE_EPS of it, and
    the OR of feasibility."""
    f32 = np.float32
    n, k, d = inst_res.shape
    vals = np.concatenate([np.where(inst_valid[..., None], inst_res, f32(0)),
                           np.where(inst_valid, inst_cost, f32(1e30))[..., None]], axis=2)
    m = np.arange(1 << k)
    if k in XLA_TREE_K and n >= 2:
        c = [np.where(((m >> s) & 1).astype(bool)[None, :, None], vals[:, s][:, None, :], f32(0))
             for s in range(k)]
        f = (c[0] + c[1]) + (c[2] + c[3]) if k == 4 else ((c[0] + c[2]) + (c[1] + c[3])) + c[4]
    else:
        table = np.zeros((n, 1 << low, d + 1), f32)
        for t in range(1 << low):
            for s in range(low):
                if (t >> s) & 1:
                    table[:, t] = table[:, t] + vals[:, s]
        f = table[:, m & ((1 << low) - 1)]
        for s in range(low, k):
            bit = ((m >> s) & 1).astype(bool)
            f[:, bit] = f[:, bit] + vals[:, s][:, None, :]
    ok = np.all(free_f[:, None, :] + f[:, :, :d] >= req - f32(1e-6), axis=2)
    sub = np.where(ok, f[:, :, d], f32(1e30))
    best = sub.min(axis=1)
    pop = np.array([bin(int(i)).count("1") for i in m])
    keys = np.where(sub <= (best + f32(kernels.TIE_EPS))[:, None], (pop << 16) | m, 1 << 30)
    return best, (keys.min(axis=1) & 0xFFFF).astype(np.int32), ok.any(axis=1)


#: K at which XLA's CPU dot (the jitted ``host_plan_terms`` and the Pallas
#: kernel in interpret mode) does not add a mask's slots in ascending order
#: when it has two or more hosts: K=4 adds ((c0 + c1) + (c2 + c3)), K=5
#: (((c0 + c2) + (c1 + c3)) + c4) (``test_xla_dot_slot_order``).  The port
#: (plain version and kernel) adds in those trees there, so it equals the
#: JAX package bit for bit off a dyadic grid at every K.
XLA_TREE_K = (4, 5)


def _on_grid(arrays):
    return tuple(a if a.dtype == bool else (np.round(a * 4) / 4).astype(np.float32)
                 for a in arrays)


def _hosts(k, d, n, seed):
    """``fleets.weigh_arrays`` cut to ``n`` hosts; one host is host 1 (host 0
    has no valid slot)."""
    *per_host, req = fleets.weigh_arrays(max(n, 48), k, d, seed=seed)
    rows = slice(1, 2) if n == 1 else slice(0, n)
    return tuple(a[rows] for a in per_host) + (req,)


@pytest.mark.parametrize("k", range(1, 13))
def test_kernel_order_is_bitwise_plain_and_jax(k):
    """The CUDA kernel's order of additions (a table over the low slots, then
    the high slots in ascending order; XLA's trees at K = 4 and 5 on two or
    more hosts) gives the plain version's bits, and the plain version the
    JAX package's, off the integer grid: fractional resources and costs,
    exact ties, a tie at TIE_EPS, invalid slots, hosts with none valid;
    D = 1..8.  Every split of the mask bits does, the kernel's own among
    them; on 48 hosts, on and off the 1/4 grid, against the jitted
    ``host_plan_terms`` and the Pallas kernel in interpret mode; off the
    grid on 1, 2, 64 and 400 hosts against the jitted ``host_plan_terms``."""
    d = 1 + (k - 1) % 8
    arrays = fleets.weigh_arrays(48, k, d, seed=100 + k)
    splits = sorted({0, k // 2, (k + 1) // 2, k, _low_bits(k)})
    for case in (arrays, _on_grid(arrays)):
        want = kernels.sched_weigh_plain(*_t(*case))
        for low in splits:
            _assert_same(want, _weigh_emulated(*case, low))
        _assert_same(want, jax.jit(host_plan_terms)(*case, subset_masks(k)))
        _assert_same(want, jax_sched_weigh(*case, subset_masks(k), interpret=True))
        assert np.any(want[2].numpy()) and not np.all(want[2].numpy())
    for n in (1, 2, 64, 400):
        case = _hosts(k, d, n, 100 + k)
        want = kernels.sched_weigh_plain(*_t(*case))
        _assert_same(want, _weigh_emulated(*case, _low_bits(k)))
        _assert_same(want, jax.jit(host_plan_terms)(*case, subset_masks(k)))


def test_xla_dot_adds_k4_pairwise():
    """Why XLA_TREE_K holds 4: XLA's CPU dot of K=4 slot costs against the
    0/1 masks adds ((c0 + c1) + (c2 + c3)), not ((c0 + c1) + c2) + c3."""
    arrays = fleets.weigh_arrays(400, 4, 3, seed=7)
    cost = np.where(arrays[3], arrays[2], np.float32(1e30))
    got = np.asarray(jax.jit(lambda c, m: c @ m.T)(cost, subset_masks(4)))
    c = np.where(subset_masks(4)[None] > 0.5, cost[:, None, :], np.float32(0))
    np.testing.assert_array_equal(got, (c[..., 0] + c[..., 1]) + (c[..., 2] + c[..., 3]))
    assert not np.array_equal(got, ((c[..., 0] + c[..., 1]) + c[..., 2]) + c[..., 3])


@pytest.mark.parametrize("n", [1, 2, 64, 400])
@pytest.mark.parametrize("k", [4, 5])
def test_xla_dot_slot_order(k, n):
    """XLA's CPU dot of fractional slot costs against the 0/1 masks, bit for
    bit: on one host in slot order, on two or more the trees the port adds
    in ((c0 + c1) + (c2 + c3) at K=4, ((c0 + c2) + (c1 + c3)) + c4 at
    K=5)."""
    cost = (np.random.default_rng(10 * k + n).random((n, k)) * 3600).astype(np.float32)
    got = np.asarray(jax.jit(lambda c, m: c @ m.T)(cost, subset_masks(k)))
    c = [np.where(subset_masks(k)[None, :, s] > 0.5, cost[:, s][:, None], np.float32(0))
         for s in range(k)]
    in_order = c[0]
    for t in c[1:]:
        in_order = in_order + t
    tree = ((c[0] + c[1]) + (c[2] + c[3]) if k == 4 else ((c[0] + c[2]) + (c[1] + c[3])) + c[4])
    np.testing.assert_array_equal(got, tree if n >= 2 else in_order)
    if n >= 64:   # enough fractional sums that the two orders part somewhere
        assert not np.array_equal(tree, in_order)
