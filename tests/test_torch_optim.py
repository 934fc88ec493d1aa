"""The port's optimizers (``repro_torch.optim``) against the JAX package's
on the same trees: AdamW and Adafactor over three steps, the global-norm
clip and the cosine schedule.

Trees come from seeded numpy (a matrix, a vector, a 3-D leaf and a scalar
leaf) and go to both sides as flat dicts.  Tolerance: f32 rounding, rtol
1e-6 and atol 1e-9 (a few ulps: XLA and PyTorch evaluate ``b ** step``,
``sqrt`` and the means with their own f32 routines and reduction orders).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as topt

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-9)
SHAPES = {"w": (16, 8), "b": (8,), "stack": (3, 4, 6), "g": (1,)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, what):
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, tuple):
            for a, b in zip(g, w):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_updates_match_jax_over_three_steps(name):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = {"weight_decay": 0.1} if name == "adamw" else {"weight_decay": 0.01}
    jo, to = jopt.make_optimizer(name, **kw), topt.make_optimizer(name, **kw)
    jp, tp = _j(params), _t(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        grads = _tree(rng, scale=10.0 ** (step - 1))
        lr = np.float32(1e-3 * (step + 1))
        jd, js = jo.update(_j(grads), js, jp, jnp.asarray(lr))
        td, ts = to.update(_t(grads), ts, tp, torch.tensor(lr))
        _close(td, jd, f"{name} delta, step {step}")
        _close(ts.nu, js.nu, f"{name} nu, step {step}")
        if name == "adamw":
            _close(ts.mu, js.mu, f"{name} mu, step {step}")
        else:
            assert ts.mu is None and js.mu is None
        assert int(ts.step) == int(js.step) == step + 1
        jp = jopt.apply_updates(jp, jd)
        tp = topt.apply_updates(tp, td)
        _close(tp, jp, f"{name} params, step {step}")


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_jax(max_norm):
    tree = _tree(np.random.default_rng(1), scale=3.0)
    jc, jn = jopt.clip_by_global_norm(_j(tree), max_norm)
    tc, tn = topt.clip_by_global_norm(_t(tree), max_norm)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)
    np.testing.assert_allclose(float(topt.global_norm(_t(tree))), float(jopt.global_norm(_j(tree))),
                               **TOL)
    _close(tc, jc, "clipped")


def test_cosine_schedule_matches_jax():
    jf, tf = jopt.cosine_schedule(3e-4, 10, 100), topt.cosine_schedule(3e-4, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 250):
        got = tf(torch.tensor(step, dtype=torch.int32))
        want = jf(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=str(step))


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd")
