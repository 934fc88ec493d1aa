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
sscr = importlib.import_module("repro_torch.kernels.sched_screen")

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


@pytest.mark.parametrize("n,k,d,m_keep,sms,want", [
    (65536, 8, 3, 65, 132, (512, 128, 128, 128)),
    (1 << 20, 8, 3, 65, 132, (512, 132, 132, 128)),
    (1 << 22, 8, 3, 65, 132, (512, 132, 132, 128)),
    (1 << 22, 8, 3, 1024, 300, (512, 300, 256, 1024)),
    (1 << 20, 12, 8, 1024, 132, (128, 132, 132, 1024)),
    (40, 8, 3, 40, 132, (512, 1, 1, 64)),
])
def test_launch_geometry(n, k, d, m_keep, sms, want):
    """Any fleet size is taken: the whole card scores (one block an SM, two
    tiles in its shared memory or MERGE_GROUP lists), and the two levels of
    merges take every top-M block's list."""
    geo = sscr._geometry(n, k, d, m_keep, sms)
    assert tuple(geo) == want
    lists = sscr.MERGE_GROUP * geo.keep_pow2 * 8
    own = 8 * (geo.keep_pow2 + geo.threads)
    assert max(2 * sscr._stage_bytes(geo.threads, k, d), lists) + own <= sscr.SMEM_BUDGET
    assert geo.topm_blocks <= sscr.MERGE_GROUP ** 2


@pytest.mark.parametrize("n,m_keep", [(65536, 0), (65536, 1025), (64, 65), (1 << 22, -1)])
def test_launch_geometry_refuses_m_keep(n, m_keep):
    with pytest.raises(ValueError, match="m_keep"):
        sscr._geometry(n, 8, 3, m_keep, 132)


# ---------------------------------------------------------------------------
# The kernel's selection, emulated: each block keeps its top P of the tiles it
# walks (a tile's keys above the list's m_keep-th, bitonic-sorted, merged in
# by max against the reversed list and the half-cleaners); then the last block
# of each group of MERGE_GROUP merges the group's lists that reach tau in a
# tree, and the last group's the groups' lists the same way.
# ---------------------------------------------------------------------------


def _keys(scores):
    """The kernel's 64-bit keys: order-preserving score high (-0 as +0),
    0xFFFFFFFF - host index low."""
    b = (scores.astype(np.float32) + np.float32(0.0)).view(np.uint32).astype(np.uint64)
    enc = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    low = np.uint64(0xFFFFFFFF) - np.arange(len(scores), dtype=np.uint64)
    return (enc << np.uint64(32)) | low


def _ce(n, j):
    g = np.arange(n // 2)
    return ((g & ~(j - 1)) << 1) | (g & (j - 1))


def _sort_desc(x):
    """``sort_desc``: the bitonic network, compare-exchange by compare-exchange."""
    x, k = x.copy(), 2
    while k <= len(x):
        j = k >> 1
        while j:
            i = _ce(len(x), j)
            a, b = x[i], x[i + j]
            swap = np.where((i & k) == 0, a < b, a > b)
            x[i], x[i + j] = np.where(swap, b, a), np.where(swap, a, b)
            j >>= 1
        k <<= 1
    return x


def _merge_desc(x):
    """``merge_desc``: a bitonic list into descending order (half-cleaners)."""
    x, j = x.copy(), len(x) >> 1
    while j:
        i = _ce(len(x), j)
        a, b = x[i], x[i + j]
        x[i], x[i + j] = np.maximum(a, b), np.minimum(a, b)
        j >>= 1
    return x


def _emulate_topm(keys, m_keep, threads, blocks):
    p = 1 << (m_keep - 1).bit_length()
    tiles = -(-len(keys) // threads)
    lists = np.zeros((blocks, p), np.uint64)
    for b in range(blocks):
        lst = lists[b]
        for t in range(b, tiles, blocks):
            tile = keys[t * threads:(t + 1) * threads]
            passing = tile[tile > lst[m_keep - 1]]
            if not len(passing):
                continue
            q = 1 << (len(passing) - 1).bit_length()
            buf = _sort_desc(np.concatenate([passing, np.zeros(q - len(passing), np.uint64)]))
            rev = np.zeros(p, np.uint64)
            rev[:min(q, p)] = buf[:p]
            lst = _merge_desc(np.maximum(lst, rev[::-1]))
        lists[b] = lst
    group = sscr.MERGE_GROUP
    merged = [_merge_lists(lists[g:g + group], m_keep) for g in range(0, blocks, group)]
    top, _ = _merge_lists(np.stack([m for m, _ in merged]), m_keep)
    return top[:m_keep], sum(n for _, n in merged) if len(merged) > 1 else merged[0][1]


def _merge_lists(lists, m_keep):
    """``merge_lists``: the lists whose first key reaches tau, the largest
    m_keep-th key, merged pairwise in a tree; (the top list, lists merged)."""
    tau = lists[:, m_keep - 1].max()
    region = [lst for lst in lists if lst[0] >= tau]
    st = 1
    while st < len(region):
        for a in range(0, len(region) - st, 2 * st):
            region[a] = _merge_desc(np.maximum(region[a], region[a + st][::-1]))
        st *= 2
    return region[0], len(region)


def _scores(kind, n, threads, blocks, rng):
    if kind == "random":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "tied":      # three values, most hosts at the top one; -0 beside +0
        return rng.choice(np.array([0.0, -0.0, -1.0, -1e30], np.float32), n,
                          p=[0.45, 0.45, 0.05, 0.05])
    if kind == "ascending":  # every tile passes into its block's list
        return np.arange(n, dtype=np.float32) / n
    # interleaved: the best hosts spread evenly over every block's list, so
    # every list reaches tau and the last block merges all of them
    i = np.arange(n)
    return ((i % threads) * blocks + (i // threads) % blocks).astype(np.float32)


@pytest.mark.parametrize("kind,n,m_keep,threads,blocks", [
    ("random", 1 << 20, 65, 512, 132),
    ("tied", 1 << 20, 65, 512, 132),
    ("interleaved", 1 << 20, 65, 512, 132),
    ("ascending", 1 << 18, 65, 512, 132),
    ("interleaved", 65536, 65, 512, 128),
    ("tied", 65536, 1024, 256, 23),
    ("interleaved", 100_003, 200, 128, 37),
    ("random", 5000, 1, 512, 7),
    ("random", 40, 40, 512, 1),
])
def test_selection_emulation_matches_stable_sort(kind, n, m_keep, threads, blocks):
    """The kernel's selection algorithm, emulated on its keys, equals the
    stable descending sort's top ``m_keep`` (the plain version's rule, which
    is ``lax.top_k``'s): random, heavily tied, ascending and adversarially
    interleaved scores, up to 2^20 hosts and at several geometries."""
    rng = np.random.default_rng(n + m_keep)
    scores = _scores(kind, n, threads, blocks, rng)
    got, merged = _emulate_topm(_keys(scores), m_keep, threads, blocks)
    want = np.argsort(-scores, kind="stable")[:m_keep]
    np.testing.assert_array_equal(0xFFFFFFFF - (got & np.uint64(0xFFFFFFFF)), want)
    if kind == "interleaved":
        assert merged == blocks
