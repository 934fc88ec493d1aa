"""The port's flash-attention backward on the CPU: the plain backward
(``flash_attention_bwd_plain``) and the autograd function around
``flash_attention`` against ``jax.grad`` of the Pallas kernel in interpret
mode (its custom VJP runs ``_dq_kernel`` and ``_dkv_kernel``), and against
PyTorch's autograd through the plain forward.

Inputs and the output cotangent come from seeded numpy and go to both
sides.  Tolerances: 2e-3 against the Pallas kernel, as the JAX package's
own backward test (``tests/test_kernels.py``); 1e-5 against autograd
through the plain forward (both f32 in PyTorch, summation order only).  The
CUDA kernels are held against the plain backward on the card
(``tests/test_torch_cuda_kernels.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch import kernels
from repro_torch.kernels import flash_attention, flash_attention_bwd_plain, flash_attention_plain

torch.set_num_threads(1)

CASES = [
    # b, s, h, g, hd, causal: the shapes of tests/test_kernels.py, a GQA
    # group of 3 and a ragged length, one case without the mask
    (1, 128, 1, 1, 64, True),
    (2, 256, 4, 2, 64, True),     # GQA
    (1, 256, 4, 1, 128, True),    # MQA
    (2, 512, 2, 2, 32, True),
    (1, 128, 6, 2, 32, True),     # GQA, rep 3
    (2, 100, 4, 2, 64, True),     # ragged: no power-of-two tile divides 100
    (1, 128, 4, 2, 64, False),
]


def _inputs(seed, b, s, h, g, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, g, hd), (b, s, g, hd), (b, s, h, hd))]


def _jax_grads(q, k, v, do, causal):
    """jax.grad of sum(o * do) through the Pallas kernel, interpret mode."""
    def f(q, k, v):
        return jnp.sum(jflash(q, k, v, causal=causal, interpret=True) * do)

    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


def _torch_grads(fn, q, k, v, do, causal):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = fn(*leaves, causal=causal)[0]
    return torch.autograd.grad(o, leaves, torch.from_numpy(do))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_matches_pallas_grad(case):
    *shape, causal = case
    q, k, v, do = _inputs(sum(shape), *shape)
    want = _jax_grads(q, k, v, do, causal)
    got = _torch_grads(flash_attention, q, k, v, do, causal)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, causal=causal)
    plain = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal)
    for name, g, p, w in zip("qkv", got, plain, want):
        assert g.shape == p.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=2e-3,
                                   err_msg=f"d{name} (autograd function)")
        np.testing.assert_allclose(p.numpy(), np.asarray(w), atol=2e-3, rtol=2e-3,
                                   err_msg=f"d{name} (plain backward)")


@pytest.mark.parametrize("case", [(2, 77, 6, 2, 32, True), (1, 64, 4, 4, 64, False),
                                  (2, 33, 4, 1, 128, True)], ids=str)
def test_backward_matches_autograd_of_plain_forward(case):
    *shape, causal = case
    q, k, v, do = _inputs(7, *shape)
    got = _torch_grads(flash_attention, q, k, v, do, causal)
    want = _torch_grads(flash_attention_plain, q, k, v, do, causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)


def test_bf16_gradients_keep_the_input_types():
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(3, 1, 40, 4, 2, 32))
    o, lse = flash_attention_plain(q, k, v)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    f32 = flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o)), lse, do.float())
    for g, w in zip((dq, dk, dv), f32):
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), atol=2e-2, rtol=2e-2)


def test_lse_carries_no_gradient_and_cpu_launches_no_kernel():
    q, k, v, _ = (torch.from_numpy(x).requires_grad_() for x in _inputs(4, 1, 24, 2, 1, 32))
    kernels.reset_launch_counts()
    o, lse = flash_attention(q, k, v)
    assert o.requires_grad and not lse.requires_grad
    o.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_dq"] \
        == counts["flash_attention_dkv"] == 0
