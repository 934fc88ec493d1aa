"""The port's flash-attention plain version against the JAX package: the
Pallas kernel in interpret mode (``o``), its ``_flash_fwd`` (``lse``) and the
jnp oracle ``attention_ref``, on the shapes of ``tests/test_kernels.py``.

Inputs come from seeded numpy and go to both sides.  Tolerances: 2e-5 in
f32 (reduction order differs), 2e-2 in bf16 (the output's rounding), as the
JAX package's own kernel tests use.  The CUDA kernel is held against this
plain version on the card (``tests/test_torch_cuda_kernels.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _flash_fwd, flash_attention as jflash
from repro.kernels.ref import attention_ref
from repro_torch.kernels import flash_attention, flash_attention_plain

torch.set_num_threads(1)

SHAPES = [
    # b, s, h, g, hd
    (1, 128, 1, 1, 64),
    (2, 256, 4, 2, 64),     # GQA
    (1, 256, 4, 1, 128),    # MQA
    (2, 512, 2, 2, 32),
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, b, s, h, g, hd, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, g, hd)).astype(np.float32),
            rng.standard_normal((b, skv, g, hd)).astype(np.float32))


def _both(arrs, jdt, tdt):
    """The same values on both sides (bf16 rounded once, by JAX)."""
    j = [jnp.asarray(a).astype(jdt) for a in arrs]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt) for x in j]
    return j, t


def _lse_ref(q, k, causal):
    """Row log-sum-exp of the scaled (masked) scores, f64, (B*H, S)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    kx = np.repeat(k.astype(np.float64), rep, axis=2)
    sc = np.einsum("bshd,bthd->bhst", q.astype(np.float64), kx) / np.sqrt(hd)
    if causal:
        sc = np.where(np.tril(np.ones((s, k.shape[1]), bool)), sc, -1e30)
    m = sc.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(sc - m).sum(-1))).reshape(b * h, s)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_matches_pallas_kernel_and_ref(shape, dtype, causal):
    b, s, h, g, hd = shape
    _, jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, *shape), jdt, tdt)
    o, lse = flash_attention_plain(tq, tk, tv, causal=causal)
    assert o.dtype == tdt and o.shape == (b, s, h, hd)
    assert lse.dtype == torch.float32 and lse.shape == (b * h, s)
    want_o = jflash(jq, jk, jv, causal=causal, interpret=True)
    ref_o = attention_ref(jq, jk, jv, causal=causal)
    for want in (want_o, ref_o):
        np.testing.assert_allclose(o.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    qf = jq.transpose(0, 2, 1, 3).reshape(b * h, s, hd)
    kf = jk.transpose(0, 2, 1, 3).reshape(b * g, s, hd)
    vf = jv.transpose(0, 2, 1, 3).reshape(b * g, s, hd)
    bq = min(128, s)
    _, want_lse = _flash_fwd(qf, kf, vf, causal, bq, bq, True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        lse.numpy(), _lse_ref(np.asarray(jq, np.float32), np.asarray(jk, np.float32), causal),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s", [1, 100, 200])
def test_ragged_lengths_match_ref(s):
    """S that is no multiple of any tile (the CUDA kernel masks tails; the
    Pallas kernel halves its blocks), GQA rep 3."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 2, s, 6, 2, 64), jnp.float32, torch.float32)
    for causal in (True, False):
        o, lse = flash_attention(tq, tk, tv, causal=causal)
        np.testing.assert_allclose(o.numpy(), np.asarray(attention_ref(jq, jk, jv, causal=causal)),
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(
            lse.numpy(), _lse_ref(np.asarray(jq), np.asarray(jk), causal), atol=2e-5, rtol=2e-5)


def test_cpu_tensor_runs_plain_version():
    _, (tq, tk, tv) = _both(_qkv(2, 1, 64, 2, 1, 32), jnp.float32, torch.float32)
    from repro_torch import kernels

    kernels.reset_launch_counts()
    a = flash_attention(tq, tk, tv)
    b = flash_attention_plain(tq, tk, tv)
    assert kernels.launch_counts()["flash_attention"] == 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
