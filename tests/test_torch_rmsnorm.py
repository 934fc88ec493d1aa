"""The port's RMSNorm plain version (and ``layers.rms_norm``) against the JAX
package: the Pallas kernel in interpret mode and the jnp ``layers.rms_norm``
the JAX model calls, on seeded numpy inputs.  Tolerances as the JAX
package's kernel tests: 1e-5 in f32, 2e-2 in bf16 (the output's rounding).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro.models.layers import rms_norm as jrms_norm
from repro_torch import kernels
from repro_torch.kernels import rmsnorm, rmsnorm_plain
from repro_torch.models.layers import rms_norm

torch.set_num_threads(1)
TOL = {"f32": 1e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(JDT[dtype])
    w = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(TDT[dtype])
    return x, jnp.asarray(w), tx, torch.from_numpy(w)


@pytest.mark.parametrize("rows", [8, 100, 256, 1000])
@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_pallas_and_layers(rows, d, dtype):
    x, w, tx, tw = _inputs(rows + d, (rows, d), dtype)
    got = rmsnorm(tx, tw)
    assert got.dtype == TDT[dtype] and got.shape == (rows, d)
    for want in (jrmsnorm(x, w, interpret=True), jrms_norm(x, w, 1e-5)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_3d_and_model_layer(dtype):
    """3-D input, a weight in the compute dtype, and the model's entry point
    ``layers.rms_norm`` (which the port routes through the kernel)."""
    x, w, tx, tw = _inputs(5, (2, 37, 128), dtype)
    wb = w.astype(JDT[dtype])
    tb = torch.from_numpy(np.array(wb.astype(jnp.float32))).to(TDT[dtype])
    want = np.asarray(jrms_norm(x, wb, 1e-6), np.float32)
    for got in (rmsnorm(tx, tb, 1e-6), rms_norm(tx, tb, 1e-6)):
        assert got.shape == (2, 37, 128)
        np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(rmsnorm(tx, tb, 1e-6).float().numpy(),
                               np.asarray(jrmsnorm(x, wb, 1e-6, interpret=True), np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_cpu_tensor_runs_plain_version():
    _, _, tx, tw = _inputs(9, (16, 128), "f32")
    kernels.reset_launch_counts()
    assert torch.equal(rmsnorm(tx, tw), rmsnorm_plain(tx, tw))
    assert kernels.launch_counts()["rmsnorm"] == 0


def _fma(a, b, c):
    """f32 a*b + c as the kernel's FMA, through f64 (a*b is exact there; the
    sum may round twice, an ulp the tolerances hold many times over)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _warp_tree(v):
    """The kernel's butterfly over the last axis (32 lanes: xor 16, 8, 4, 2,
    1); every lane ends with the same sum (f32 addition commutes)."""
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., np.arange(32) ^ off]
    return v[..., 0]


def _rmsnorm_emulated(x, w, eps, elem_bytes, aligned=True, sms=132):
    """``csrc/rmsnorm.cu``'s order of the sum of squares in numpy f32, then
    its scale ``(x * rsqrt(ss / d + eps)) * (1 + w)``.  The vector kernel:
    lane l of the W warps a row holds 16-byte chunks l, l + 32 W, ... and
    sums their squares in order into one FMA chain, each warp sums its lanes
    by the butterfly, the W warp sums add in warp order (W as the launch
    picks it: the fewest warps that hold a row in 8 chunks a lane, doubled up
    to 8 while the blocks of 8 warps would not cover the ``sms`` SMs and a
    lane holds more than one chunk).  Other shapes (a
    width that is not a multiple of the chunk, rows not 16-byte aligned) take
    the edge kernel: thread t of 256 sums elements t, t + 256, ..., the
    butterfly in each of the 8 warps, then once more over the 8 warp sums
    and 24 zeros."""
    f32 = np.float32
    rows, d = x.shape
    e_per = 16 // elem_bytes
    chunks = d // e_per
    wpr = 1
    while wpr < 8 and chunks > 32 * wpr * 8:
        wpr *= 2
    while wpr < 8 and chunks > 32 * wpr and -(-rows * wpr // 8) < sms:
        wpr *= 2
    lanes = 32 * wpr
    if aligned and d % e_per == 0 and d <= 12288 and -(-chunks // lanes) <= 8:
        part = np.zeros((rows, lanes), f32)
        for n in range(-(-chunks // lanes)):
            c = np.arange(lanes) + n * lanes
            for e in range(e_per):
                v = x[:, np.minimum(c, chunks - 1) * e_per + e]
                part = np.where(c < chunks, _fma(v, v, part), part)
        warp_sums = _warp_tree(part.reshape(rows, wpr, 32))
        ss = warp_sums[:, 0]
        for k in range(1, wpr):
            ss = ss + warp_sums[:, k]
    else:
        part = np.zeros((rows, 256), f32)
        for i0 in range(0, d, 256):
            i = np.arange(256) + i0
            v = x[:, np.minimum(i, d - 1)]
            part = np.where(i < d, _fma(v, v, part), part)
        warp_sums = _warp_tree(part.reshape(rows, 8, 32))
        ss = _warp_tree(np.concatenate([warp_sums, np.zeros((rows, 24), f32)], axis=1))
    r = f32(1) / np.sqrt(ss / f32(d) + f32(eps))
    return (x * r[:, None]) * (f32(1) + w)


@pytest.mark.parametrize("rows,d,aligned", [(64, 1536, True), (1100, 1536, True),
                                            (64, 2048, True), (64, 1001, True),
                                            (64, 1536, False)],
                         ids=["64x1536", "1100x1536", "64x2048", "64x1001", "64x1536-misaligned"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernel_reduction_order_within_tolerance(rows, d, aligned, dtype):
    """The CUDA kernel's order of the f32 sum of squares (per-lane partials
    over 16-byte chunks, the warp tree, warps in order; or the edge kernel's
    for a width that is not a multiple of the chunk and for rows that are
    not 16-byte aligned) stays within today's tolerances of the plain version
    and of the Pallas kernel in interpret mode."""
    x, w, tx, tw = _inputs(rows + d + aligned, (rows, d), dtype)
    xf = tx.float().numpy()
    got = torch.from_numpy(_rmsnorm_emulated(xf, tw.numpy(), 1e-6, tx.element_size(), aligned))
    got = got.to(TDT[dtype]).float().numpy()
    for want in (rmsnorm_plain(tx, tw, 1e-6).float().numpy(),
                 np.asarray(jrmsnorm(x, w, 1e-6, interpret=True), np.float32)):
        np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
