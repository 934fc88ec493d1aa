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
from repro_torch.core.torch_scheduler import fleet_slot_costs
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


@pytest.mark.parametrize("k,n", [(8, 65536), (12, 64), (3, 1000)])
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


# ---------------------------------------------------------------------------
# The model-serving kernels: flash-attention forward and RMSNorm
# ---------------------------------------------------------------------------

#: bf16 outputs may round one ulp apart (2e-2, as the JAX package's kernel
#: tests); f32 outputs differ by summation order only
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(2, 256, 12, 2, 128), (1, 192, 8, 1, 256), (2, 100, 4, 2, 64),
                                   (1, 33, 4, 4, 32)], ids=str)
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
    assert kernels.launch_counts()["flash_attention"] == 1
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
    assert (counts["flash_attention"], counts["flash_attention_dq"],
            counts["flash_attention_dkv"]) == (1, 1, 1)


#: the backward: f32 gradients differ by summation order (1e-4 over sums of
#: up to S*H/G terms); bf16 gradients may round one bf16 ulp apart (2e-2)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: and scaled to the tensor, ||kernel - plain|| / ||plain||: bf16 outputs
#: rounded from f32 values that differ in summation order are at most one
#: ulp (2^-8 relative) apart, so 1e-2; f32 sums of up to S*H/G terms in
#: another order, 1e-5.  A tile computed wrongly moves this by its share of
#: the norm, however small the gradients there.
BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("shape", [(2, 256, 12, 2, 128), (1, 192, 8, 1, 256), (2, 100, 4, 2, 64),
                                   (1, 33, 4, 4, 32)], ids=str)
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
    assert (counts["flash_attention_dq"], counts["flash_attention_dkv"]) == (1, 1)
    want = kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == w.shape, name
        _close(a, w, BWD_TOL[dtype])
        a64, w64 = a.double(), w.double()
        rel = float(torch.linalg.vector_norm(a64 - w64) / torch.linalg.vector_norm(w64))
        assert rel <= BWD_REL[dtype], (name, rel)


@pytest.mark.parametrize("rows,d", [(4096, 1536), (8, 1536), (100, 384), (3, 2048)])
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
    assert counts["flash_attention"] == cfg.n_layers
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
    assert counts["flash_attention"] == 2 * cfg.n_layers
    assert counts["flash_attention_dq"] == counts["flash_attention_dkv"] == cfg.n_layers
    loss_c, _ = tm.forward_train(cfg, cpu, batch)
    grads_c = torch.autograd.grad(loss_c, list(cpu.parameters()))
    _close(loss_g.detach(), loss_c.detach(), 1e-4)
    for a, w in zip(grads_g, grads_c):
        np.testing.assert_allclose(a.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=1e-3 * float(w.abs().max()))
