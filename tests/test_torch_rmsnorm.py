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
