"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a CUDA
kernel has no CPU mode); the CPU tests hold the plain versions against the
JAX package.  This file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import fleets
from repro_torch.core.policy import SchedulerPolicy
from repro_torch.core.soa_fleet import SoAFleet
from repro_torch.core.torch_scheduler import (
    TorchPreemptibleScheduler,
    build_soa_state,
    fleet_slot_costs,
)
from repro_torch.core.types import Request

pytestmark = pytest.mark.cuda
CHURN_MULT = (1.0, 1.0, 0.5, 0.25, 2.0)


@pytest.fixture
def cuda_device():
    """Decided here, never at import, so every worker collects the same
    tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rand_fleet(rng, n, k, device):
    a = [rng.integers(0, 9, (n, 3)), rng.integers(2, 12, (n, 3)), rng.random(n) < 0.9,
         rng.integers(0, 3, n), rng.integers(1, 5, n), rng.integers(0, 5, (n, k, 3)),
         rng.integers(0, 60, (n, k)) * 60, rng.random((n, k)) < 0.7]
    dt = [np.float32, np.float32, bool, np.int32, np.float32, np.float32, np.float32, bool]
    return [torch.from_numpy(x.astype(t)).to(device) for x, t in zip(a, dt)]


def _eq(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("k,n", [(8, 65536), (12, 64), (3, 1000), (12, 4096)])
def test_sched_weigh_matches_plain(cuda_device, k, n):
    rng = np.random.default_rng(k + n)
    f = _rand_fleet(rng, n, k, cuda_device)
    req = torch.tensor([5.0, 4.0, 6.0], device=cuda_device)
    args = (f[0], f[5], f[6], f[7], req)
    kernels.reset_launch_counts()
    got = kernels.sched_weigh(*args)
    assert kernels.launch_counts()["sched_weigh"] == 1
    for g, w in zip(got, kernels.sched_weigh_plain(*args)):
        _eq(g, w)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("churn_zone", [False, True])
def test_sched_screen_matches_plain(cuda_device, pre, churn_zone):
    rng = np.random.default_rng(11)
    n = 65536
    f = _rand_fleet(rng, n, 8, cuda_device)
    req = torch.tensor([5.0, 4.0, 6.0], device=cuda_device)
    mult = CHURN_MULT if churn_zone else (1.0, 1.0, 0.0, 0.0)
    kw = {}
    if churn_zone:
        kw = dict(
            churn=torch.from_numpy((rng.integers(0, 8, n) / 8.0).astype(np.float32)).to(cuda_device),
            churn_threshold=0.5,
            host_zone=torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(cuda_device),
            exclude_zone=2,
        )
    head = (*f, req, pre, -1)
    kernels.reset_launch_counts()
    got = kernels.sched_screen(*head, mult, True, 65, **kw)
    counts = kernels.launch_counts()
    assert (counts["sched_screen_consts"], counts["sched_screen_topm"],
            counts["sched_screen"]) == (1, 1, 2)
    consts = kernels.sched_screen_consts_plain(*head, mult, True, **kw)
    scores, idx = kernels.sched_screen_topm_plain(*head, consts, mult, True, 65, **kw)
    _eq(got[2], consts)
    _eq(got[0], scores)
    _eq(got[1], idx)


def _packed_head(n, device):
    """``fleets.packed_arrays``'s fleet (every host alike, costs from the
    start times: nearly every host tied) as the screen's leading arguments."""
    packed, preq = fleets.packed_arrays(n, 8)
    packed["inst_cost"] = (fleets.NOW - packed["inst_start"]).astype(np.float32)
    cols = [torch.from_numpy(np.ascontiguousarray(packed[f])).to(device) for f in
            ("free_f", "free_n", "schedulable", "domain", "slow", "inst_res", "inst_cost",
             "inst_valid")]
    return (*cols, torch.from_numpy(preq).to(device))


@pytest.mark.parametrize("pre", [False, True])
def test_sched_screen_2_20_hosts_matches_plain(cuda_device, pre):
    """2^20 hosts, past the one-block merge's old ceiling of 258,048: the
    constants, scores and indices (tie order) equal the plain versions."""
    head = (*_packed_head(1 << 20, cuda_device), pre, -1)
    mult = (1.0, 1.0, 0.0, 0.0)
    got = kernels.sched_screen(*head, mult, True, 65)
    consts = kernels.sched_screen_consts_plain(*head, mult, True)
    scores, idx = kernels.sched_screen_topm_plain(*head, consts, mult, True, 65)
    _eq(got[2], consts)
    _eq(got[0], scores)
    _eq(got[1], idx)
    _eq(kernels.sched_screen_consts(*head, mult, True), consts)


@pytest.mark.parametrize("m_keep", [1, 65, 300, 1024])
def test_sched_screen_two_calls_same_bits(cuda_device, m_keep):
    """The blocks finish in any order; the keys are unique, so two calls give
    the same bits (and equal the plain version) at every list length."""
    rng = np.random.default_rng(m_keep)
    f = _rand_fleet(rng, 200_000, 8, cuda_device)
    head = (*f, torch.tensor([5.0, 4.0, 6.0], device=cuda_device), False, -1)
    runs = [kernels.sched_screen(*head, CHURN_MULT[:4], True, m_keep) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    consts = kernels.sched_screen_consts_plain(*head, CHURN_MULT[:4], True)
    want = kernels.sched_screen_topm_plain(*head, consts, CHURN_MULT[:4], True, m_keep)
    _eq(runs[0][0], want[0])
    _eq(runs[0][1], want[1])


def test_decisions_match_cpu(cuda_device):
    """The same 200 decisions on a 4,096-host saturated fleet, on the card
    (kernels) and on the CPU (plain versions): identical outcomes and state."""
    hosts = fleets.saturated_fleet(4096, seed=2)
    rng = np.random.default_rng(3)
    sizes = list(fleets.SIZES.values())
    items = [(Request(id=f"r{i}", resources=sizes[int(rng.integers(0, 3))],
                      preemptible=bool(rng.random() < 0.5)),
              fleets.NOW + 7.3 * i, 1.0) for i in range(200)]
    gpu = SoAFleet(hosts, device=cuda_device)
    cpu = SoAFleet(fleets.saturated_fleet(4096, seed=2), device="cpu")
    kernels.reset_launch_counts()
    out_g = [o for b in range(0, 200, 40) for o in gpu.schedule_batch(items[b:b + 40])]
    counts = kernels.launch_counts()
    assert counts["sched_screen_consts"] == counts["sched_screen_topm"] == 200
    assert counts["sched_screen"] == 400 and counts["sched_weigh"] >= 200
    out_c = [o for b in range(0, 200, 40) for o in cpu.schedule_batch(items[b:b + 40])]
    assert [(o.host, len(o.victims)) for o in out_g] == [(o.host, len(o.victims)) for o in out_c]
    for name in ("free_f", "free_n", "inst_valid", "inst_start", "zone_term", "zone_up"):
        _eq(getattr(gpu.state, name), getattr(cpu.state, name))
    costs = fleet_slot_costs(gpu.state, fleets.NOW + 0.3, SchedulerPolicy())
    _eq(costs, fleet_slot_costs(cpu.state, fleets.NOW + 0.3, SchedulerPolicy()))


def _screen_both_ways(head, mult, require_free_slot, m_keep=65):
    got = kernels.sched_screen(*head, mult, require_free_slot, m_keep)
    consts = kernels.sched_screen_consts_plain(*head, mult, require_free_slot)
    want = kernels.sched_screen_topm_plain(*head, consts, mult, require_free_slot, m_keep)
    _eq(got[2], consts)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    _eq(kernels.sched_screen_consts(*head, mult, require_free_slot), consts)
    top = kernels.sched_screen_topm(*head, consts, mult, require_free_slot, m_keep)
    _eq(top[0], want[0])
    _eq(top[1], want[1])
    return got


@pytest.mark.parametrize("n", [257, 2400, 65536])
@pytest.mark.parametrize("pre", [False, True])
def test_sched_screen_without_free_slot_matches_plain(cuda_device, n, pre):
    """``require_free_slot=False``, the rebuild path's screen: on the
    rebuilt state of a saturated fleet (the path's own inputs) and on a
    random fleet where some rows have no free slot, so that the flag
    changes a preemptible request's screen."""
    state, _ = build_soa_state(fleets.saturated_fleet(n, seed=n), fleets.NOW,
                               device=cuda_device)
    req = torch.tensor(fleets.SIZES["medium"].vec, dtype=torch.float32, device=cuda_device)
    head = (state.free_f, state.free_n, state.schedulable, state.domain, state.slow,
            state.inst_res, state.inst_cost, state.inst_valid, req, pre, -1)
    _screen_both_ways(head, (1.0, 1.0, 0.0, 0.0), False)
    f = _rand_fleet(np.random.default_rng(n), n, 8, cuda_device)
    f[7][::5] = True                                  # every fifth row full
    head = (*f, torch.tensor([2.0, 3.0, 2.0], device=cuda_device), pre, -1)
    off = _screen_both_ways(head, CHURN_MULT[:4], False)
    on = kernels.sched_screen(*head, CHURN_MULT[:4], True, 65)
    if pre:
        assert not torch.equal(off[1], on[1])


@pytest.mark.parametrize("n", [24, 2400])
def test_rebuild_scheduler_matches_cpu(cuda_device, n):
    """``TorchPreemptibleScheduler`` on the card and on the CPU: Fig. 2's
    scenarios and a mixed stream of requests on a saturated fleet give the
    same host, plan ids and cost; the path's kernels were launched."""
    sat, empty = fleets.saturated_fleet(n, seed=1), fleets.empty_fleet(n)
    gpu = TorchPreemptibleScheduler(device=cuda_device)
    cpu = TorchPreemptibleScheduler(device="cpu")
    rng = np.random.default_rng(n)
    sizes = list(fleets.SIZES.values())
    cases = [(empty, Request(id="e", resources=fleets.SIZES["medium"], preemptible=False)),
             (empty, Request(id="s", resources=fleets.SIZES["medium"], preemptible=True))]
    cases += [(sat, Request(id=f"r{i}", resources=sizes[int(rng.integers(0, 3))],
                            preemptible=bool(i % 2))) for i in range(12)]
    kernels.reset_launch_counts()
    for hosts, req in cases:
        a = gpu.schedule(req, hosts, fleets.NOW + 30.0)
        b = cpu.schedule(req, hosts, fleets.NOW + 30.0)
        assert (a.ok, a.host, a.plan.ids, a.plan.cost) == (b.ok, b.host, b.plan.ids, b.plan.cost)
    counts = kernels.launch_counts()
    calls = len(cases)
    if n > 256:
        assert counts["sched_screen_consts"] == counts["sched_screen_topm"] == calls
        assert counts["sched_weigh_gathered"] == calls
        assert counts["sched_weigh"] == calls + gpu.fallbacks
    else:
        assert counts["sched_screen"] == counts["sched_weigh_gathered"] == 0
        assert counts["sched_weigh"] == calls


# ---------------------------------------------------------------------------
# The model-serving kernels: flash-attention forward and RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", range(1, 13))
def test_sched_weigh_fractional_matches_plain(cuda_device, k):
    """Off the integer grid, bit for bit: fractional resources and costs,
    exact ties, a tie at TIE_EPS, invalid slots, hosts with none valid; D runs
    over 1..8 as K runs over 1..12."""
    d = 1 + (k - 1) % 8
    args = tuple(torch.from_numpy(a).to(cuda_device)
                 for a in fleets.weigh_arrays(300, k, d, seed=k))
    got = kernels.sched_weigh(*args)
    for g, w in zip(got, kernels.sched_weigh_plain(*args)):
        _eq(g, w)


@pytest.mark.parametrize("n", [1, 2, 64, 4096])
@pytest.mark.parametrize("k", [4, 5])
def test_sched_weigh_xla_tree_matches_plain(cuda_device, k, n):
    """At K = 4 and 5 the kernel adds a mask's slots in XLA's trees on two or
    more hosts and in slot order on one, bit for bit as the plain version,
    on fractional inputs."""
    *per_host, req = fleets.weigh_arrays(max(n, 48), k, 3, seed=k * n)
    rows = slice(1, 2) if n == 1 else slice(0, n)
    args = tuple(torch.from_numpy(a[rows]).to(cuda_device) for a in per_host) \
        + (torch.from_numpy(req).to(cuda_device),)
    for g, w in zip(kernels.sched_weigh(*args), kernels.sched_weigh_plain(*args)):
        _eq(g, w)


@pytest.mark.parametrize("k,n", [(8, 65536), (12, 4096)])
def test_sched_weigh_two_calls_same_bits(cuda_device, k, n):
    args = tuple(torch.from_numpy(a).to(cuda_device) for a in fleets.weigh_arrays(n, k, 3, seed=n))
    for a, b in zip(kernels.sched_weigh(*args), kernels.sched_weigh(*args)):
        assert torch.equal(a, b)


#: bf16 outputs may round one ulp apart (2e-2, as the JAX package's kernel
#: tests); f32 outputs differ by summation order only
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


#: the bf16 route (tensor cores) launches these, the f32 route its own
FWD_KEY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention"}
DQ_KEY = {torch.float32: "flash_attention_dq_f32", torch.bfloat16: "flash_attention_dq"}
DKV_KEYS = {torch.float32: ("flash_attention_dkv_f32", "flash_attention_dkv_reduce_f32"),
            torch.bfloat16: ("flash_attention_dkv", "flash_attention_dkv_reduce")}
#: several key tiles of every width, ragged tails against the 128-row tiles
#: (S=1,000; S=640 with hd 256's 64-key tiles), MQA at hd 256
SHAPES = [(2, 256, 12, 2, 128), (1, 192, 8, 1, 256), (2, 100, 4, 2, 64), (1, 33, 4, 4, 32),
          (1, 1000, 4, 2, 128), (2, 640, 8, 1, 256), (1, 300, 6, 3, 32), (1, 520, 4, 1, 64)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_matches_plain(cuda_device, shape, dtype, causal):
    b, s, h, g, hd = shape
    gen = torch.Generator(device=cuda_device).manual_seed(s + hd)
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=cuda_device).to(dtype)
               for n in (h, g, g))
    kernels.reset_launch_counts()
    o, lse = kernels.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[FWD_KEY[dtype]] == 1
    po, plse = kernels.flash_attention_plain(q, k, v, causal=causal)
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == (b * h, s)
    _close(o, po, FLASH_TOL[dtype])
    _close(lse, plse, 1e-4)


def test_flash_attention_refuses_grad(cuda_device):
    """``lse`` refuses a gradient (it is a non-differentiable output); ``o``'s
    gradient runs the dq and dk/dv kernels once each."""
    q = torch.randn((1, 64, 2, 64), device=cuda_device, requires_grad=True)
    k = torch.randn((1, 64, 1, 64), device=cuda_device, requires_grad=True)
    kernels.reset_launch_counts()
    o, lse = kernels.flash_attention(q, k, k)
    assert o.requires_grad and not lse.requires_grad
    with pytest.raises(RuntimeError):
        torch.autograd.grad(lse.sum(), (q, k))
    torch.autograd.grad(o.sum(), (q, k))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["flash_attention_f32"], counts["flash_attention_dq_f32"],
            counts["flash_attention_dkv_f32"]) == (1, 1, 1)
    assert counts["flash_attention_dq"] == counts["flash_attention_dkv"] == 0


#: head_dim 112 (zamba2-7b's shared attention, 32 heads, no grouping): the
#: hd-128 tiling of the forward, dq and dk/dv over zero-padded rows; several
#: key tiles, ragged tails, and grouping beside it
HD112_SHAPES = [(2, 256, 32, 32, 112), (1, 1000, 8, 8, 112), (1, 77, 4, 2, 112),
                (2, 300, 6, 3, 112)]


@pytest.mark.parametrize("shape", HD112_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_forward_head_dim_112_matches_plain(cuda_device, shape, dtype, causal):
    """The forward at head_dim 112 within the forward's tolerances of its
    plain version, its columns past 112 never written (o's storage is
    exactly B*S*H*112), and two calls the same bits."""
    b, s, h, g, hd = shape
    gen = torch.Generator(device=cuda_device).manual_seed(s + hd)
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=cuda_device).to(dtype)
               for n in (h, g, g))
    kernels.reset_launch_counts()
    runs = [kernels.flash_attention_fwd(q, k, v, causal=causal) for _ in range(2)]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts[FWD_KEY[dtype] + "_hd112"] == 2 and counts[FWD_KEY[dtype]] == 0
    o, lse = runs[0]
    po, plse = kernels.flash_attention_plain(q, k, v, causal=causal)
    assert o.shape == q.shape and o.untyped_storage().nbytes() == q.numel() * q.element_size()
    _close(o, po, FLASH_TOL[dtype])
    _close(lse, plse, 1e-4)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(o.view(bits), runs[1][0].view(bits))
    assert torch.equal(lse.view(torch.int32), runs[1][1].view(torch.int32))


#: the backward: f32 gradients differ by summation order (1e-4 over sums of
#: up to S*H/G terms); bf16 gradients may round one bf16 ulp apart (2e-2)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: and scaled to the tensor, ||kernel - plain|| / ||plain||: bf16 outputs
#: rounded from f32 values that differ in summation order are at most one
#: ulp (2^-8 relative) apart, so 1e-2; f32 sums of up to S*H/G terms in
#: another order, 1e-5.  A tile computed wrongly moves this by its share of
#: the norm, however small the gradients there.
BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_backward_matches_plain(cuda_device, shape, dtype, causal):
    b, s, h, g, hd = shape
    gen = torch.Generator(device=cuda_device).manual_seed(2 * s + hd)
    q, k, v, do = (torch.randn((b, s, n, hd), generator=gen, device=cuda_device).to(dtype)
                   for n in (h, g, g, h))
    o, lse = kernels.flash_attention_plain(q, k, v, causal=causal)
    kernels.reset_launch_counts()
    got = kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert [counts[key] for key in (DQ_KEY[dtype],) + DKV_KEYS[dtype]] == \
        [1] * (1 + len(DKV_KEYS[dtype]))
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    assert counts[DQ_KEY[other]] == counts[FWD_KEY[other]] == 0
    assert all(counts[key] == 0 for key in DKV_KEYS[other])
    _assert_backward_close(got, kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal),
                           dtype)


def _assert_backward_close(got, want, dtype):
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == w.shape, name
        _close(a, w, BWD_TOL[dtype])
        a64, w64 = a.double(), w.double()
        rel = float(torch.linalg.vector_norm(a64 - w64) / torch.linalg.vector_norm(w64))
        assert rel <= BWD_REL[dtype], (name, rel)


@pytest.mark.parametrize("shape", HD112_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_backward_head_dim_112_matches_plain(cuda_device, shape, dtype, causal):
    """dq and dk/dv at head_dim 112 (the hd-128 tiling over zero-padded
    rows) within the backward's tolerances of the plain backward, counted
    under their own keys; dq's, dk's and dv's storage exactly 112 wide; two
    calls the same bits."""
    b, s, h, g, hd = shape
    gen = torch.Generator(device=cuda_device).manual_seed(5 * s + hd)
    q, k, v, do = (torch.randn((b, s, n, hd), generator=gen, device=cuda_device).to(dtype)
                   for n in (h, g, g, h))
    o, lse = kernels.flash_attention_plain(q, k, v, causal=causal)
    kernels.reset_launch_counts()
    runs = [kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=causal) for _ in range(2)]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    dkv, reduce = DKV_KEYS[dtype]
    assert (counts[DQ_KEY[dtype] + "_hd112"], counts[dkv + "_hd112"], counts[reduce]) == (2, 2, 2)
    assert counts[DQ_KEY[dtype]] == counts[dkv] == 0
    got = runs[0]
    for t, ref in zip(got, (q, k, v)):
        assert t.untyped_storage().nbytes() == ref.numel() * ref.element_size()
    _assert_backward_close(got, kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal),
                           dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for a, b_ in zip(*runs):
        assert torch.equal(a.view(bits), b_.view(bits))


def test_flash_gradient_at_head_dim_112_runs_the_kernels(cuda_device):
    """A gradient through ``flash_attention`` at head_dim 112 (zamba2-7b's
    shared block, bf16) runs the hd-112 forward, dq and dk/dv once each."""
    gen = torch.Generator(device=cuda_device).manual_seed(112)
    q, k, v = (torch.randn((1, 256, 8, 112), generator=gen, device=cuda_device)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    kernels.reset_launch_counts()
    o, _ = kernels.flash_attention(q, k, v)
    grads = torch.autograd.grad(o.float().square().sum(), (q, k, v))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["flash_attention_hd112"], counts["flash_attention_dq_hd112"],
            counts["flash_attention_dkv_hd112"], counts["flash_attention_dkv_reduce"]) == (1, 1, 1, 1)
    assert all(bool(torch.isfinite(g_.float()).all()) for g_ in grads)


#: the head layouts of the four models trained at full width (chip_smoke
#: phase 11c), at small S: seamless-m4t-medium (16 on 16, hd 64),
#: moonshot-v1-16b-a3b (16 on 16, hd 128), arctic-480b (56 on 8: groups of
#: 7) and internvl2-26b (48 on 8), ragged tails against the 128-row tiles
TRAIN_LAYOUTS = [(4, 256, 16, 16, 64), (2, 320, 16, 16, 128), (2, 256, 56, 8, 128),
                 (1, 333, 48, 8, 128)]


@pytest.mark.parametrize("shape", TRAIN_LAYOUTS, ids=str)
def test_flash_bf16_backward_at_training_layouts(cuda_device, shape):
    """dq, dk and dv in bf16 within the backward's tolerances of the plain
    backward, one launch each of dq, dk/dv and the reduction; two calls the
    same bits; the reduction of dk/dv's f32 partials over each group exactly
    its plain version's sums."""
    b, s, h, g, hd = shape
    gen = torch.Generator(device=cuda_device).manual_seed(7 * s + h)
    q, k, v, do = (torch.randn((b, s, n, hd), generator=gen, device=cuda_device)
                   .to(torch.bfloat16) for n in (h, g, g, h))
    o, lse = kernels.flash_attention_fwd(q, k, v, causal=True)
    kernels.reset_launch_counts()
    runs = [kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=True) for _ in range(2)]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    dkv, reduce = DKV_KEYS[torch.bfloat16]
    assert (counts[DQ_KEY[torch.bfloat16]], counts[dkv], counts[reduce]) == (2, 2, 2)
    _assert_backward_close(runs[0], kernels.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                                      causal=True), torch.bfloat16)
    for a, b_ in zip(*runs):
        assert torch.equal(a.view(torch.int16), b_.view(torch.int16))
    parts = [torch.randn((b * h, s, hd), generator=gen, device=cuda_device) for _ in range(2)]
    for got, want in zip(kernels.flash_attention_dkv_reduce(*parts, b * g),
                         kernels.flash_attention_dkv_reduce_plain(*parts, b * g)):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


#: the f32 route at the shapes it is timed at: qwen2-1.5b's heads at
#: 1 x 2,048, and gemma-2b's hd 256 MQA at 1 x 1,024
F32_PATH_SHAPES = [(1, 2048, 12, 2, 128), (1, 1024, 8, 1, 256)]


@pytest.mark.parametrize("shape", F32_PATH_SHAPES, ids=str)
def test_flash_f32_backward_at_path_shapes(cuda_device, shape):
    b, s, h, g, hd = shape
    gen = torch.Generator(device=cuda_device).manual_seed(3 * s + hd)
    q, k, v, do = (torch.randn((b, s, n, hd), generator=gen, device=cuda_device) for n in (h, g, g, h))
    o, lse = kernels.flash_attention_plain(q, k, v, causal=True)
    kernels.reset_launch_counts()
    got = kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert [counts[key] for key in (DQ_KEY[torch.float32],) + DKV_KEYS[torch.float32]] == [1, 1, 1]
    _assert_backward_close(got, kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True),
                           torch.float32)


@pytest.mark.parametrize("shape", [(2, 1000, 12, 2, 128), (1, 640, 8, 1, 256)], ids=str)
def test_flash_bf16_kernels_are_deterministic(cuda_device, shape):
    """Two calls on the same inputs give the same bits: o, lse, dq, dk, dv
    (no atomics; dk/dv sums its grouped heads in head order)."""
    b, s, h, g, hd = shape
    gen = torch.Generator(device=cuda_device).manual_seed(s)
    q, k, v, do = (torch.randn((b, s, n, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
                   for n in (h, g, g, h))
    runs = []
    for _ in range(2):
        o, lse = kernels.flash_attention_fwd(q, k, v, causal=True)
        runs.append((o, lse) + kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=True))
    for name, a, b_ in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16 else a,
                           b_.view(torch.uint8) if b_.dtype == torch.bfloat16 else b_), name


@pytest.mark.parametrize("shape", [(2, 1000, 12, 2, 128), (1, 640, 8, 1, 256), (4, 128, 4, 2, 32)],
                         ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_f32_forward_is_deterministic(cuda_device, shape, causal):
    """Two calls of the f32 forward on the same inputs give the same bits of
    o and lse (no atomics: each row's sums have one order), as phase 10's
    bitwise resume needs."""
    b, s, h, g, hd = shape
    gen = torch.Generator(device=cuda_device).manual_seed(s + 2)
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=cuda_device) for n in (h, g, g))
    kernels.reset_launch_counts()
    runs = [kernels.flash_attention_fwd(q, k, v, causal=causal) for _ in range(2)]
    torch.cuda.synchronize()
    assert kernels.launch_counts()[FWD_KEY[torch.float32]] == 2
    for name, a, b_ in zip(("o", "lse"), *runs):
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32)), name


@pytest.mark.parametrize("shape", [(2, 1000, 12, 2, 128), (1, 640, 8, 1, 256)], ids=str)
def test_flash_f32_backward_is_deterministic(cuda_device, shape):
    """Two calls of the f32 backward on the same inputs give the same bits
    of dq, dk and dv (no atomics; dk/dv sums its grouped heads in head
    order)."""
    b, s, h, g, hd = shape
    gen = torch.Generator(device=cuda_device).manual_seed(s + 1)
    q, k, v, do = (torch.randn((b, s, n, hd), generator=gen, device=cuda_device) for n in (h, g, g, h))
    o, lse = kernels.flash_attention_fwd(q, k, v, causal=True)
    runs = [kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=True) for _ in range(2)]
    for name, a, b_ in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b_), name


@pytest.mark.parametrize("rows,d", [(4096, 1536), (8, 1536), (100, 384), (3, 2048),
                                    (8192, 1536), (64, 1001), (16, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rmsnorm_matches_plain(cuda_device, rows, d, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.randn((rows, d), generator=gen, device=cuda_device).to(dtype)
    w = (0.1 * torch.randn((d,), generator=gen, device=cuda_device)).to(dtype)
    kernels.reset_launch_counts()
    got = kernels.rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rmsnorm"] == 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    _close(got, kernels.rmsnorm_plain(x, w, 1e-6), tol)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "row_offset_1"])
@pytest.mark.parametrize("x_dt,w_dt", [(torch.bfloat16, torch.bfloat16),
                                       (torch.bfloat16, torch.float32),
                                       (torch.float32, torch.bfloat16),
                                       (torch.float32, torch.float32)], ids=str)
def test_rmsnorm_types_and_misaligned_rows(cuda_device, x_dt, w_dt, offset):
    """Every x / w type pair, and rows that start one element past a 16-byte
    boundary (a contiguous view into a larger buffer)."""
    rows, d = 37, 1536
    gen = torch.Generator(device=cuda_device).manual_seed(offset)
    flat = torch.randn((rows * d + offset,), generator=gen, device=cuda_device).to(x_dt)
    x = flat[offset:].view(rows, d)
    w = (0.1 * torch.randn((d,), generator=gen, device=cuda_device)).to(w_dt)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    kernels.reset_launch_counts()
    got = kernels.rmsnorm(x, w, 1e-6)
    assert kernels.launch_counts()["rmsnorm"] == 1
    _close(got, kernels.rmsnorm_plain(x, w, 1e-6), 2e-2 if x_dt == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("rows,d", [(8192, 1536), (64, 1001)])
def test_rmsnorm_two_calls_same_bits(cuda_device, rows, d):
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn((rows, d), generator=gen, device=cuda_device).to(torch.bfloat16)
    w = (0.1 * torch.randn((d,), generator=gen, device=cuda_device)).to(torch.bfloat16)
    a, b = kernels.rmsnorm(x, w, 1e-6), kernels.rmsnorm(x, w, 1e-6)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_reduced_model_matches_cpu(cuda_device):
    """Reduced qwen2-1.5b in f32, the same weights on the card (kernels) and
    on the CPU (plain versions): flash forward_logits agree to 1e-4, and
    every layer's two norms, the final norm and the flash attention ran as
    kernels."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as tm

    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")), attention_impl="flash")
    cpu = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = tm.Model(cfg, device="meta")
    gpu.load_state_dict({k: t.to(cuda_device) for k, t in cpu.state_dict().items()}, assign=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab_size, (2, 40)))
    kernels.reset_launch_counts()
    got = tm.forward_logits(cfg, gpu, {"tokens": toks.to(cuda_device)}, last_only=False)
    counts = kernels.launch_counts()
    assert counts["flash_attention_f32"] == cfg.n_layers      # f32: the CUDA-core route
    assert counts["rmsnorm"] == 2 * cfg.n_layers + 1
    want = tm.forward_logits(cfg, cpu, {"tokens": toks}, last_only=False)
    _close(got, want, 1e-4)


def test_reduced_model_gradients_match_cpu(cuda_device):
    """``forward_train`` of reduced qwen2-1.5b in f32 with flash attention
    and full remat, the same weights on the card and on the CPU: loss and
    every gradient within 1e-3 of its tensor's largest magnitude; the
    forward ran twice per layer (remat), the backward kernels once.  (The
    tolerance: this random network is ill-conditioned, so f32 gradients
    summed in another order differ by a few 1e-4 of their tensor's scale,
    the embedding's most; loss 1e-4.)"""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as tm

    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")), attention_impl="flash",
                              remat="full")
    cpu = tm.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    gpu = tm.Model(cfg, device="meta")
    gpu.load_state_dict({k: t.to(cuda_device) for k, t in cpu.state_dict().items()}, assign=True)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 65)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    kernels.reset_launch_counts()
    loss_g, _ = tm.forward_train(cfg, gpu, {k: t.to(cuda_device) for k, t in batch.items()})
    grads_g = torch.autograd.grad(loss_g, list(gpu.parameters()))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention_f32"] == 2 * cfg.n_layers   # f32: the CUDA-core route
    assert counts["flash_attention_dq_f32"] == counts["flash_attention_dkv_f32"] == cfg.n_layers
    loss_c, _ = tm.forward_train(cfg, cpu, batch)
    grads_c = torch.autograd.grad(loss_c, list(cpu.parameters()))
    _close(loss_g.detach(), loss_c.detach(), 1e-4)
    for a, w in zip(grads_g, grads_c):
        np.testing.assert_allclose(a.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=1e-3 * float(w.abs().max()))


# ---------------------------------------------------------------------------
# the admission plane: the queue on the card against the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap,n_classes,aging", [(7, 1, 0.0), (256, 2, 0.0), (256, 2, 0.05),
                                                 (4096, 255, 1.0)])
def test_admission_select_on_card_matches_cpu(cuda_device, cap, n_classes, aging):
    """The drain order's int64 key sort on heavily tied keys (mostly
    invalid rows, repeated tickets, classes folded by aging): the card's
    stable sort picks the CPU's rows."""
    from repro_torch.core.admission import queue_init, queue_select
    from repro_torch.core.convert import queue_state_from_numpy, queue_state_to_numpy

    rng = np.random.default_rng(cap)
    arrays = queue_state_to_numpy(queue_init(cap, 3, device="cpu"))
    arrays["valid"] = rng.random(cap) < 0.3
    arrays["klass"] = rng.integers(0, min(n_classes, 2), cap).astype(np.int32)
    arrays["seq"] = rng.integers(0, 3, cap).astype(np.int32)
    arrays["enq_t"] = rng.integers(0, 100, cap).astype(np.float32)
    got = queue_select(queue_state_from_numpy(arrays, device=cuda_device), cap // 2 + 1,
                       now=100.0, aging_rate=aging, n_classes=n_classes)
    want = queue_select(queue_state_from_numpy(arrays, device="cpu"), cap // 2 + 1,
                        now=100.0, aging_rate=aging, n_classes=n_classes)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_admission_drains_on_card_match_cpu(cuda_device):
    """A contended stream through the admission plane at 300 saturated
    hosts (the screen's path): every drain, the stats (wall clock aside),
    the final state and the final queue equal on the card and the CPU, and
    one launch of each decision kernel per drained row."""
    import dataclasses

    from repro_torch.core.admission import QUEUE_DTYPES
    from repro_torch.core.convert import fleet_state_to_numpy, queue_state_to_numpy

    def run(device):
        policy = SchedulerPolicy(queue_capacity=32, admit_batch=8, max_retries=3,
                                 storm_threshold=1e-3, aging_rate=0.01)
        fleet = SoAFleet(fleets.saturated_fleet(300, seed=2), policy=policy, device=device)
        rng = np.random.default_rng(3)
        sizes = list(fleets.SIZES.values())
        now, out = fleets.NOW, []
        kernels.reset_launch_counts()
        for i in range(96):
            now += float(rng.integers(1, 20))
            fleet.submit(Request(id=f"r{i}", resources=sizes[int(rng.integers(0, 3))],
                                 preemptible=bool(i % 2)), now)
            if (i + 1) % 8 == 0:
                out.append(fleet.drain(now))
        out += fleet.drain_all(now)
        return fleet, out, kernels.launch_counts()

    (gf, gout, counts), (cf, cout, _) = run(cuda_device), run("cpu")
    key = [[(dr.now, [(r.id, r.preemptible, p) for r, p in dr.attempts],
             [(o.host, o.instance.id, [v.id for v in o.victims]) for o in dr.outcomes],
             [r.id for r in dr.rejected], dr.queue_depth) for dr in out] for out in (gout, cout)]
    assert key[0] == key[1]
    stats = [dataclasses.asdict(f.admission.stats) for f in (gf, cf)]
    for s in stats:
        del s["wall_wait_s"]
    assert stats[0] == stats[1] and stats[0]["retries"] > 0
    g, c = fleet_state_to_numpy(gf.state), fleet_state_to_numpy(cf.state)
    for f in g:
        np.testing.assert_array_equal(g[f], c[f], err_msg=f)
    g, c = queue_state_to_numpy(gf.admission.qstate), queue_state_to_numpy(cf.admission.qstate)
    for f in QUEUE_DTYPES:
        np.testing.assert_array_equal(g[f], c[f], err_msg=f)
    assert counts["sched_screen_consts"] == counts["sched_weigh_gathered"] == gf.decisions
    assert counts["sched_weigh"] == gf.decisions + gf.fallbacks


# ---------------------------------------------------------------------------
# the relocation plane: the victim ranking and relocate_many, card against CPU
# ---------------------------------------------------------------------------


def _reloc_arrays(n, tied, seed=13):
    """Fleet state arrays of n packed hosts x 8 slots in 4 zones: slots
    started whole minutes ago and checkpointed since, or (``tied``) all
    started and checkpointed at one instant; a fifth of the slots dead."""
    rng = np.random.default_rng(seed)
    a, _ = fleets.packed_arrays(n, 8, seed=seed)
    a.update(host_zone=(np.arange(n) % 4).astype(np.int32), zone_term=np.zeros(4, np.float32),
             zone_up=np.zeros(4, np.float32), inst_valid=rng.random((n, 8)) < 0.8,
             inst_ckpt=(a["inst_start"] + rng.integers(0, 60, (n, 8)) * 60.0).astype(np.float32))
    if tied:
        a["inst_start"][:] = fleets.NOW - 3600.0
        a["inst_ckpt"][:] = fleets.NOW - 3600.0
    return a


@pytest.mark.parametrize("tied", [False, True])
def test_relocation_victims_on_card_match_cpu(cuda_device, tied):
    """The victim loss bit for bit and the stable ranking row for row."""
    from repro_torch.core.convert import fleet_state_from_numpy
    from repro_torch.core.soa_fleet import _relocation_victims, relocation_loss

    a = _reloc_arrays(65536, tied)
    g, c = fleet_state_from_numpy(a, device=cuda_device), fleet_state_from_numpy(a, device="cpu")
    now = fleets.NOW + 1800.0
    for zone in (0, 3):
        assert torch.equal(relocation_loss(g, zone, now, 3600.0).cpu().view(torch.int32),
                           relocation_loss(c, zone, now, 3600.0).view(torch.int32))
        for budget in (64, 65536 * 8):
            for x, y in zip(_relocation_victims(g, zone, now, 3600.0, budget),
                            _relocation_victims(c, zone, now, 3600.0, budget)):
                np.testing.assert_array_equal(x, y)


def test_relocate_many_on_card_matches_cpu(cuda_device):
    """One batch of 5 victims and 3 padding rows at 300 hosts (the screen's
    path), half saturated and half empty in 3 zones: the outputs and the
    state after equal the CPU's, with one decision's launches a row."""
    from repro_torch.core.admission import PAD_RES
    from repro_torch.core.convert import fleet_state_to_numpy
    from repro_torch.core.torch_scheduler import build_fleet_state, relocate_many

    hosts = fleets.saturated_fleet(300, seed=4)
    for i, h in enumerate(hosts):
        h.zone = f"z{i % 3}"
        if i % 2:
            for iid in list(h.instances):
                h.remove(iid)
    states = [build_fleet_state(hosts, device=d)[0] for d in (cuda_device, "cpu")]
    arr = fleet_state_to_numpy(states[1])
    rows = np.argwhere(arr["inst_valid"] & (arr["host_zone"][:, None] == 0))[:5]
    b = 8
    vh, vs, von = np.zeros(b, np.int32), np.zeros(b, np.int32), np.zeros(b, bool)
    res = np.full((b, 3), PAD_RES, np.float32)
    excl = np.full(b, -1, np.int32)
    for i, (h, s) in enumerate(rows):
        vh[i], vs[i], von[i], excl[i] = h, s, True, 0
        res[i] = arr["inst_res"][h, s]
    rest = (np.full(b, -1, np.int32), np.full(b, -1, np.int32), np.full(b, -1.0, np.float32),
            np.arange(1, b + 1, dtype=np.float32), excl, fleets.NOW + 100.0)
    policy = SchedulerPolicy(relocate_threshold=1e-4)
    kernels.reset_launch_counts()
    g_state, g_out = relocate_many(states[0], vh, vs, von, res, *rest, policy=policy)
    counts = kernels.launch_counts()
    c_state, c_out = relocate_many(states[1], vh, vs, von, res, *rest, policy=policy)
    for x, y in zip(g_out, c_out):
        assert torch.equal(x, y)
    assert bool(g_out[2][:5].all()) and not bool(g_out[2][5:].any())
    g, c = fleet_state_to_numpy(g_state), fleet_state_to_numpy(c_state)
    for f in g:
        np.testing.assert_array_equal(g[f], c[f], err_msg=f)
    fb = int(g_out[3].sum())
    assert counts["sched_screen_consts"] == counts["sched_screen_topm"] == b
    assert counts["sched_weigh_gathered"] == b and counts["sched_screen"] == 2 * b
    assert counts["sched_weigh"] == b + fb


#: the ensemble's multiplier rows: the reference's three, then a zero under a
#: nonzero gate; and a churn-aware policy's rows
TRACED_ROWS = ((1.0, 1.0, 0.0, 0.0), (4.0, 0.25, 0.0, 0.0), (0.5, 2.0, 0.0, 0.0),
               (0.0, 1.0, 0.0, 0.0))
TRACED_CHURN_ROWS = ((1.0, 1.0, 0.5, 0.25, 2.0), (0.7, 1.3, 0.3, 1.7, 0.5),
                     (0.0, 1.0, 0.0, 0.25, 0.0))


@pytest.mark.parametrize("n", [320, 65536])
@pytest.mark.parametrize("pre", [False, True])
def test_sched_screen_traced_mode_matches_plain(cuda_device, n, pre):
    """The screen's traced-multiplier mode (``gates=``): the row's values do
    the arithmetic, the policy's multipliers gate the terms; bit for bit
    against the plain versions, on the integer grid and at a fractional
    clock, with and without the churn and zone operands."""
    hosts = fleets.saturated_fleet(n, seed=n)
    fleet = SoAFleet(hosts, device=cuda_device)
    st = fleet.state
    req = torch.tensor(fleets.SIZES["medium"].vec, dtype=torch.float32, device=cuda_device)
    rng = np.random.default_rng(n)
    churn = dict(
        churn=torch.from_numpy((rng.integers(0, 8, n) / 8.0).astype(np.float32)).to(cuda_device),
        churn_threshold=0.5,
        host_zone=torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(cuda_device),
        exclude_zone=2)
    for now in (fleets.NOW, fleets.NOW + 0.3):
        costs = fleet_slot_costs(st, now, SchedulerPolicy())
        head = (st.free_f, st.free_n, st.schedulable, st.domain, st.slow, st.inst_res, costs,
                st.inst_valid, req, pre, -1)
        for gates, rows, kw in (((1.0, 1.0, 0.0, 0.0), TRACED_ROWS, {}),
                                (CHURN_MULT, TRACED_CHURN_ROWS, churn)):
            for row in rows:
                got = kernels.sched_screen(*head, row, True, 65, gates=gates, **kw)
                consts = kernels.sched_screen_consts_plain(*head, row, True, gates=gates, **kw)
                want = kernels.sched_screen_topm_plain(*head, consts, row, True, 65,
                                                       gates=gates, **kw)
                _eq(got[2], consts)
                _eq(got[0], want[0])
                _eq(got[1], want[1])


def test_simulate_scan_on_card_matches_cpu(cuda_device):
    """``_bench_scan``'s trace (a storm, a failure and heal, checkpoints) on
    4,096 Table 1 nodes: ``simulate_scan`` on the card equals it on the CPU
    and the card's ``run_trace`` (outcomes, counters, samples, final state),
    and each decision launched the screen twice and the gathered weigh."""
    from repro_torch.core import scan_sim
    from repro_torch.core.convert import fleet_state_to_numpy
    from repro_torch.core.simulator import SoASimulator, WorkloadSpec
    from repro_torch.core.types import Host

    spec = WorkloadSpec(arrival_rate_per_s=1 / 8.0, lifetime_min_s=300.0,
                        lifetime_mean_s=1200.0, lifetime_max_s=2400.0,
                        preemptible_fraction=0.6, flavors=list(fleets.SIZES.items()))
    trace = scan_sim.trace_from_workload(spec, 1600.0, seed=7, storms=((800.0, 0, 0.5),),
                                         failures=((640.0, 1, 320.0),), checkpoint_every=4)

    def sim(device):
        hosts = [Host(name=f"h{j}", capacity=fleets.NODE_CAP, zone=f"z{j % 3}")
                 for j in range(4096)]
        return SoASimulator(hosts, spec, seed=7, policy=SchedulerPolicy(), device=device)

    gsim, csim = sim(cuda_device), sim("cpu")
    kernels.reset_launch_counts()
    card = scan_sim.simulate_scan(trace, SchedulerPolicy(), gsim.fleet.state)
    counts = kernels.launch_counts()
    cpu = scan_sim.simulate_scan(trace, SchedulerPolicy(), csim.fleet.state)
    gsim.run_trace(trace)
    decisions = int((trace.kind == scan_sim.ARRIVAL).sum())
    assert card.decisions == cpu.decisions == decisions
    assert counts["sched_screen_consts"] == counts["sched_screen_topm"] == decisions
    assert counts["sched_weigh_gathered"] == decisions
    assert counts["sched_weigh"] == decisions + card.fallbacks
    assert card.counters == cpu.counters and card.fallbacks == cpu.fallbacks
    for name in ("host", "slot", "ok", "n_kill", "sample_t", "sample_free0",
                 "sample_free0_normal"):
        assert np.array_equal(getattr(card, name), getattr(cpu, name)), name
    np.testing.assert_array_equal(
        np.stack([card.host, card.slot, card.ok.astype(np.int64), card.n_kill], 1),
        gsim.trace_outcomes)
    g, c, r = (fleet_state_to_numpy(s) for s in (card.state, cpu.state, gsim.fleet.state))
    for f in g:
        np.testing.assert_array_equal(g[f], c[f], err_msg=f)
        np.testing.assert_array_equal(g[f], r[f], err_msg=f)


@pytest.mark.parametrize("cf", [16.0, 1.25])
def test_moe_layer_on_the_card_matches_the_cpu(cuda_device, cf):
    """The MoE layer (plain PyTorch on both devices) at moonshot-v1-16b-a3b's
    width, 256 tokens, f32: the routing identical to the CPU's, the output
    within f32 summation order of it (TF32 off; each output sums products of
    about its RMS, 130 here, so the bound scales with the RMS as well as the
    element: 1e-4 (|cpu| + RMS), an NVIDIA H100 80GB HBM3 at 700 W read
    4.9e-4 at most, and 1e-5 of the norm), and two calls on the card the
    same bits (no atomics in the combine)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import init_leaf
    from repro_torch.models.model import ParamGroup

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), capacity_factor=cf)
    gen = torch.Generator().manual_seed(0)
    cpu = ParamGroup(moe.moe_defs(cfg), "cpu")
    with torch.no_grad():
        for name, d in moe.moe_defs(cfg).items():
            getattr(cpu, name).copy_(init_leaf(d, gen, "cpu", fan_in=cfg.n_layers))
    card = ParamGroup(moe.moe_defs(cfg), cuda_device)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 128, cfg.d_model), generator=gen)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            with moe.capture_routing() as rc:
                want, _ = moe.moe_ffn(x, cpu, cfg)
            with moe.capture_routing() as rg:
                got, _ = moe.moe_ffn(x.to(cuda_device), card, cfg)
            again, _ = moe.moe_ffn(x.to(cuda_device), card, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for key in ("top_e", "keep"):
        _eq(rg[0][key], rc[0][key])
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    g, w = got.cpu().double(), want.double()
    rms = float(torch.sqrt(torch.mean(w * w)))
    assert bool(((g - w).abs() <= 1e-4 * (w.abs() + rms)).all())
    assert float(torch.linalg.vector_norm(g - w)) <= 1e-5 * float(torch.linalg.vector_norm(w))
