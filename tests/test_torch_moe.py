"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, on the CPU, in ``tests/test_moe.py``'s setup (E = 8, k = 2,
d = 32, f = 64, 2 x 8 tokens).

Weights and inputs are seeded numpy (``tests/test_moe.py`` draws them with
``materialize``, whose keys fold in Python's randomized ``hash`` of each
path), the same values on both sides.  Stated tolerances: in f32 the
routing (``top_e`` and the kept mask) identical, ``y`` within 1e-5, ``aux``
within 1e-6 and the gradients within 1e-5 (summation order only); in bf16
the routing identical and ``y`` within 2e-2, one bf16 ulp (the JAX package
rounds ``silu`` and the products' intermediates in bf16 where PyTorch's CPU
kernels keep f32); against the dense per-token reference 1e-4, as
``tests/test_moe.py``.
"""
from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget, reduced as jreduced
from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)
ARCH = "moonshot-v1-16b-a3b"
F32_TOL = dict(y=1e-5, aux=1e-6, grad=1e-5)


def _cfgs(e=8, k=2, d=32, f=64, cf=16.0):
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf)
    return (dataclasses.replace(jreduced(jget(ARCH), d_model=d, d_ff=f), **kw),
            dataclasses.replace(reduced(get_config(ARCH), d_model=d, d_ff=f), **kw))


def _draw(cfg, seed=0, b=2, s=8, dtype=np.float32):
    """Seeded numpy weights (std 1/sqrt(fan-in)) and input."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    shapes = {"router": (d, e), "wg": (e, d, f), "wu": (e, d, f), "wd": (e, f, d)}
    p = {n: (rng.standard_normal(s_) / np.sqrt(s_[-2])).astype(dtype) for n, s_ in shapes.items()}
    return p, rng.standard_normal((b, s, d)).astype(dtype)


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _tp(p):
    return types.SimpleNamespace(**{n: _t(a) for n, a in p.items()})


def _jp(p):
    return {n: jnp.asarray(a) for n, a in p.items()}


def _jax_routing(x, p, cfg):
    """``top_e`` and the kept mask (each token's k choices) by the lines of
    ``repro.models.moe._local_moe`` that compute them."""
    d, e, k = cfg.d_model, cfg.n_experts, cfg.top_k
    xf = jnp.asarray(x).reshape(-1, d)
    t = xf.shape[0]
    probs = jax.nn.softmax((xf @ jnp.asarray(p["router"])).astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    cap = max(1, int((t * k * cfg.capacity_factor) / e + 0.999))
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    keep = jnp.arange(t * k) - jnp.searchsorted(sorted_e, sorted_e, side="left") < cap
    kept = jnp.zeros(t * k, bool).at[order].set(keep)
    return np.asarray(top_e), np.asarray(kept).reshape(t, k)


def _port(x, p, cfg):
    """(y, aux, top_e, kept) of the port's ``moe_ffn``."""
    with tmoe.capture_routing() as calls:
        y, aux = tmoe.moe_ffn(_t(x), _tp(p), cfg)
    (r,) = calls
    return y, aux, r["top_e"].numpy(), r["keep"].numpy()


def dense_reference(x, p, cfg):
    """``tests/test_moe.py::dense_reference`` in PyTorch: every expert on
    every token, the top k combined."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax((xf @ p.router).to(torch.float32), dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    gate = torch.einsum("td,edf->tef", xf, p.wg)
    up = torch.einsum("td,edf->tef", xf, p.wu)
    out_all = torch.einsum("tef,efd->ted", F.silu(gate) * up, p.wd)
    y = torch.zeros_like(xf)
    for j in range(cfg.top_k):
        y = y + out_all[torch.arange(xf.shape[0]), top_e[:, j]] * top_p[:, j][:, None]
    return y.reshape(b, s, d)


@pytest.mark.parametrize("cf", [16.0, 0.25])
@pytest.mark.parametrize("seed", [0, 1])
def test_local_moe_matches_jax(cf, seed):
    jcfg, tcfg = _cfgs(cf=cf)
    p, x = _draw(tcfg, seed)
    top_e, kept = _jax_routing(x, p, jcfg)
    y, aux, t_top_e, t_kept = _port(x, p, tcfg)
    np.testing.assert_array_equal(t_top_e, top_e)
    np.testing.assert_array_equal(t_kept, kept)
    if cf < 1:
        assert not kept.all()                       # the tight capacity drops choices
    jy, jaux = jmoe.moe_ffn(jnp.asarray(x), _jp(p), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL["y"], rtol=F32_TOL["y"])
    np.testing.assert_allclose(float(aux), float(jaux), atol=F32_TOL["aux"], rtol=0)
    ly, laux = jmoe._local_moe(jnp.asarray(x), *(_jp(p)[n] for n in ("router", "wg", "wu", "wd")),
                               cfg=jcfg, n_peers=1, tp=1)
    ty, taux = tmoe._local_moe(_t(x), *(_t(p[n]) for n in ("router", "wg", "wu", "wd")),
                               cfg=tcfg, n_peers=1, tp=1)
    assert tuple(taux.shape) == laux.shape == (1,)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ly), atol=F32_TOL["y"], rtol=F32_TOL["y"])
    np.testing.assert_allclose(taux.numpy(), np.asarray(laux), atol=F32_TOL["aux"], rtol=0)


def test_matches_the_dense_reference():
    _, tcfg = _cfgs(cf=16.0)
    p, x = _draw(tcfg, 2)
    y, _, _, kept = _port(x, p, tcfg)
    assert kept.all()
    ref = dense_reference(_t(x), _tp(p), tcfg)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cf", [16.0, 0.25])
def test_ties_break_as_lax_top_k(cf):
    """A router whose columns come in equal pairs (experts 2j and 2j+1):
    every token's probabilities tie pairwise, and ``lax.top_k`` takes the
    lower expert first."""
    jcfg, tcfg = _cfgs(cf=cf)
    p, x = _draw(tcfg, 3)
    p["router"] = np.repeat(p["router"][:, ::2], 2, axis=1)
    top_e, kept = _jax_routing(x, p, jcfg)
    assert (top_e[:, 1] == top_e[:, 0] + 1).all() and (top_e[:, 0] % 2 == 0).all()
    y, aux, t_top_e, t_kept = _port(x, p, tcfg)
    np.testing.assert_array_equal(t_top_e, top_e)
    np.testing.assert_array_equal(t_kept, kept)
    jy, jaux = jmoe.moe_ffn(jnp.asarray(x), _jp(p), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL["y"], rtol=F32_TOL["y"])
    np.testing.assert_allclose(float(aux), float(jaux), atol=F32_TOL["aux"], rtol=0)


@pytest.mark.parametrize("cf", [16.0, 0.25])
def test_bf16_matches_jax(cf):
    """bf16 weights and input: the router's product rounds to bf16 before the
    f32 cast, on both sides, so the routing is identical."""
    jcfg, tcfg = _cfgs(cf=cf)
    p, x = _draw(tcfg, 4, dtype=ml_dtypes.bfloat16)
    top_e, kept = _jax_routing(x, p, jcfg)
    y, aux, t_top_e, t_kept = _port(x, p, tcfg)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(t_top_e, top_e)
    np.testing.assert_array_equal(t_kept, kept)
    jy, jaux = jmoe.moe_ffn(jnp.asarray(x), _jp(p), jcfg)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(float(aux), float(jaux), atol=F32_TOL["aux"], rtol=0)


@pytest.mark.parametrize("cf", [16.0, 0.25])
def test_gradients_match_jax(cf):
    """``tests/test_moe.py:73``'s loss, sum(y^2) + 0.01 aux: the gradient of
    every weight and of the input against ``jax.grad``."""
    jcfg, tcfg = _cfgs(cf=cf)
    p, x = _draw(tcfg, 5)

    def jloss(jp_, jx):
        y, aux = jmoe.moe_ffn(jx, jp_, jcfg)
        return jnp.sum(jnp.square(y)) + 0.01 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(_jp(p), jnp.asarray(x))
    tp = _tp(p)
    leaves = {n: getattr(tp, n).requires_grad_() for n in p}
    tx = _t(x).requires_grad_()
    y, aux = tmoe.moe_ffn(tx, tp, tcfg)
    grads = torch.autograd.grad(torch.sum(torch.square(y)) + 0.01 * aux, [*leaves.values(), tx])
    for (n, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), atol=F32_TOL["grad"],
                                   rtol=F32_TOL["grad"], err_msg=n)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), atol=F32_TOL["grad"],
                               rtol=F32_TOL["grad"])
    assert float(grads[0].abs().sum()) > 0          # the router learns through the combine


@pytest.mark.parametrize("t", [1, 2, 7, 16, 1000, 4096])
@pytest.mark.parametrize("cf", [0.25, 1.25, 16.0])
def test_capacity_is_the_jax_arithmetic(t, cf):
    _, tcfg = _cfgs(cf=cf)
    assert tmoe.capacity(t, tcfg) == max(1, int((t * 2 * cf) / 8 + 0.999))


def test_two_calls_give_the_same_bits():
    _, tcfg = _cfgs(cf=0.25)
    p, x = _draw(tcfg, 6)
    a, b = (tmoe.moe_ffn(_t(x), _tp(p), tcfg) for _ in range(2))
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


def test_mesh_arguments_raise():
    _, tcfg = _cfgs()
    p, x = _draw(tcfg)
    args = [_t(x)] + [_t(p[n]) for n in ("router", "wg", "wu", "wd")]
    for n_peers, tp in ((2, 1), (1, 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmoe._local_moe(*args, cfg=tcfg, n_peers=n_peers, tp=tp)
