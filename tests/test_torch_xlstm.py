"""The port's xLSTM blocks (``repro_torch.models.xlstm``) and the xLSTM stack
against the JAX package's, on the CPU in f32 with the same inputs and
weights: the mLSTM's ``_mlstm_qkvif``, ``mlstm_forward`` (one and several
chunks), ``mlstm_init_state``, ``mlstm_decode_step``; the sLSTM's
``_slstm_gates_x``, ``_slstm_step``, ``slstm_forward``, ``slstm_init_state``,
``slstm_decode_step``; reduced xlstm-125m (4 layers, the fourth an sLSTM)
through ``model_defs``, the converter's round trip, ``init_params``,
``forward_train`` (loss and gradients, finite through the -inf
stabilizers), ``forward_logits`` and a sequence of ``decode_step``s, the
decode state compared leaf by leaf.

Inputs and weights are seeded numpy in the shapes of the JAX tree (JAX's
init folds Python's randomized ``hash`` into its keys, and draws the gate
weights ``w_i`` / ``w_f`` as zeros, which would leave the input and forget
gates untested).  Tolerances, f32: atol = rtol = 1e-4 (XLA and PyTorch sum
in other orders and XLA contracts multiply-adds; ROADMAP §3 faults (b),
(e)); gradients 1e-4 of each leaf's largest entry plus 1e-8, as a leaf whose
gradient is rounding noise (the sLSTM's ``b_i``: zero in exact arithmetic
while the input gate sets the stabilizer) has no relative scale of its
own.  The greedy argmax must agree everywhere.
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models import model as jm
from repro.models import xlstm as jxl
from repro_torch.configs import get_config, reduced
from repro_torch.models import model as tm
from repro_torch.models import xlstm as txl
from repro_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)
ARCH = "xlstm-125m"
TOL = dict(atol=1e-4, rtol=1e-4)
S, B = 16, 2
#: a gradient that is zero in exact arithmetic holds f32 rounding noise (the
#: sLSTM's b_i: up to 3.5e-10 here, on both sides)
NOISE = 1e-8


def _np_tree(jcfg, seed=0):
    """Seeded numpy values in the shapes of the JAX parameter tree: embed
    std 0.02, norms 0.1, biases 0.02, the sLSTM's recurrent matrices 0.3 /
    sqrt(heads) (their init's spread), the rest 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(0)))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        std = (0.02 if "embed" in name or "'b" in name
               else 0.1 if "norm" in name
               else 0.3 / np.sqrt(s.shape[0]) if "'r_" in name
               else 1.0 / np.sqrt(s.shape[-2]))
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(**overrides):
    """(JAX cfg, port cfg, JAX params, port params) at reduced width."""
    jcfg = jreduced(jget(ARCH), **overrides)
    tcfg = reduced(get_config(ARCH), **overrides)
    tree = _np_tree(jcfg)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, device="cpu")


def _tokens(cfg, seed=1, b=B, s=S):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, (b, s)).astype(np.int32)


def _block(kind, seed=3):
    """One block's weights (``kind`` ``mlstm`` or ``slstm``): the JAX dict
    and the port's namespace."""
    tree = _np_tree(jreduced(jget(ARCH)), seed)["layers"]
    prm = tree["slstm_3" if kind == "slstm" else "mlstm_0"]
    return ({k: jnp.asarray(v) for k, v in prm.items()},
            types.SimpleNamespace(**{k: torch.from_numpy(np.asarray(v)) for k, v in prm.items()}))


def _x(cfg, seed=4, b=B, s=S):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=what, **tol)


# ---------------------------------------------------------------------------
# the blocks' functions
# ---------------------------------------------------------------------------


def test_dims_and_defs_match_jax():
    cfg, jcfg = reduced(get_config(ARCH)), jreduced(jget(ARCH))
    assert txl.mlstm_dims(cfg) == jxl.mlstm_dims(jcfg)
    assert txl.slstm_dims(cfg) == jxl.slstm_dims(jcfg)
    for got, want in ((txl.mlstm_defs(cfg), jxl.mlstm_defs(jcfg)),
                      (txl.slstm_defs(cfg), jxl.slstm_defs(jcfg))):
        assert list(got) == list(want)
        for name, d in want.items():
            assert (got[name].shape, got[name].init, got[name].scale) == \
                (d.shape, d.init, d.scale), name


def test_mlstm_qkvif_matches_jax():
    cfg, jcfg = reduced(get_config(ARCH)), jreduced(jget(ARCH))
    jprm, tprm = _block("mlstm")
    x_up = np.random.default_rng(5).standard_normal((B, S, 2 * cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda x_, p_: jxl._mlstm_qkvif(x_, p_, jcfg))(jnp.asarray(x_up), jprm)
    got = txl._mlstm_qkvif(torch.from_numpy(x_up), tprm, cfg)
    for name, g, w in zip("qkvif", got, want):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, what=name)


@pytest.mark.parametrize("s,chunk", [(16, 16), (48, 16), (12, 16)],
                         ids=["one chunk", "three chunks", "S under the chunk"])
def test_mlstm_forward_matches_jax(s, chunk):
    cfg = reduced(get_config(ARCH), ssm_chunk=chunk)
    jcfg = jreduced(jget(ARCH), ssm_chunk=chunk)
    jprm, tprm = _block("mlstm")
    x = _x(cfg, s=s)
    want = jax.jit(lambda x_, p_: jxl.mlstm_forward(x_, p_, jcfg))(jnp.asarray(x), jprm)
    got = txl.mlstm_forward(torch.from_numpy(x), tprm, cfg)
    assert got.shape == want.shape
    _close(got, want)


def test_init_states_match_jax():
    cfg, jcfg = reduced(get_config(ARCH)), jreduced(jget(ARCH))
    for got, want in ((txl.mlstm_init_state(cfg, 3, device="cpu"), jxl.mlstm_init_state(jcfg, 3)),
                      (txl.slstm_init_state(cfg, 3, device="cpu"), jxl.slstm_init_state(jcfg, 3))):
        assert type(got)._fields == type(want)._fields
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_jax_and_the_forward(kind):
    """12 steps from an empty state: each output and the state after it,
    leaf by leaf, and the outputs equal to the full-sequence forward's at
    every position."""
    cfg = reduced(get_config(ARCH), ssm_chunk=12)
    jcfg = jreduced(jget(ARCH), ssm_chunk=12)
    jprm, tprm = _block(kind)
    x = _x(cfg, s=12)
    jmod = {"mlstm": (jxl.mlstm_init_state, jxl.mlstm_decode_step),
            "slstm": (jxl.slstm_init_state, jxl.slstm_decode_step)}[kind]
    tmod = {"mlstm": (txl.mlstm_init_state, txl.mlstm_decode_step, txl.mlstm_forward),
            "slstm": (txl.slstm_init_state, txl.slstm_decode_step, txl.slstm_forward)}[kind]
    jst, tst = jmod[0](jcfg, B), tmod[0](cfg, B, device="cpu")
    jstep = jax.jit(lambda x_, p_, s_: jmod[1](x_, p_, jcfg, s_))
    outs = []
    for t in range(12):
        jy, jst = jstep(jnp.asarray(x[:, t:t + 1]), jprm, jst)
        ty, tst = tmod[1](torch.from_numpy(x[:, t:t + 1]), tprm, cfg, tst)
        _close(ty, jy, what=f"step {t} y")
        for name, g, w in zip(type(tst)._fields, tst, jst):
            _close(g, w, what=f"step {t} {name}")
        outs.append(ty)
    _close(torch.cat(outs, dim=1), tmod[2](torch.from_numpy(x), tprm, cfg))


def test_slstm_step_and_gates_match_jax():
    """``_slstm_gates_x`` and one ``_slstm_step`` from a random state."""
    cfg, jcfg = reduced(get_config(ARCH)), jreduced(jget(ARCH))
    jprm, tprm = _block("slstm")
    rng = np.random.default_rng(6)
    hx = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    h, p = txl.slstm_dims(cfg)
    carry = [rng.standard_normal((B, h, p)).astype(np.float32) for _ in range(4)]
    carry[1] = np.abs(carry[1]) + 0.5                       # a normalizer stays positive
    jg = jax.jit(lambda x_, p_: jxl._slstm_gates_x(x_, p_, jcfg))(jnp.asarray(hx), jprm)
    tg = txl._slstm_gates_x(torch.from_numpy(hx), tprm, cfg)
    for g in txl.GATES:
        _close(tg[g], jg[g], what=f"gate {g}")
    want = jax.jit(lambda p_, c_, g_: jxl._slstm_step(p_, jcfg, jxl.SLSTMState(*c_), g_))(
        jprm, [jnp.asarray(c) for c in carry], jg)
    got = txl._slstm_step(tprm, cfg, txl.SLSTMState(*map(torch.from_numpy, carry)), tg)
    for name, g, w in zip(txl.SLSTMState._fields, got, want):
        _close(g, w, what=name)


def test_slstm_forward_matches_jax():
    cfg, jcfg = reduced(get_config(ARCH)), jreduced(jget(ARCH))
    jprm, tprm = _block("slstm")
    x = _x(cfg)
    want = jax.jit(lambda x_, p_: jxl.slstm_forward(x_, p_, jcfg))(jnp.asarray(x), jprm)
    _close(txl.slstm_forward(torch.from_numpy(x), tprm, cfg), want)


def test_mlstm_backward_is_finite_through_minus_inf():
    """The masked scores and the first chunk's stabilizer are -inf; the
    gradient of the block's inputs and weights stays finite (and the
    forward's output equal to JAX's, as above)."""
    cfg = reduced(get_config(ARCH))
    _, tprm = _block("mlstm")
    for name in vars(tprm):
        getattr(tprm, name).requires_grad_(True)
    x = torch.from_numpy(_x(cfg, s=32)).requires_grad_(True)
    txl.mlstm_forward(x, tprm, cfg).square().sum().backward()
    assert torch.isfinite(x.grad).all()
    for name, t in vars(tprm).items():
        assert torch.isfinite(t.grad).all(), name


# ---------------------------------------------------------------------------
# the xLSTM stack: reduced xlstm-125m
# ---------------------------------------------------------------------------


def test_model_defs_match_jax_tree():
    cfg, jcfg = reduced(get_config(ARCH)), jreduced(jget(ARCH))
    want = dict(jax.tree_util.tree_flatten_with_path(
        jm.model_defs(jcfg), is_leaf=lambda x: isinstance(x, jm.ParamDef))[0])
    got = dict(tm._leaves(tm.model_defs(cfg)))
    assert tm.stacks(cfg) == {}
    assert len(got) == len(want)
    for path, d in want.items():
        name = ".".join(k.key for k in path)
        assert (got[name].shape, got[name].init, got[name].scale) == (d.shape, d.init, d.scale), name
    layers = dict(tm.Model(cfg, device="meta").layers.named_children())
    assert list(layers) == ["mlstm_0", "mlstm_1", "mlstm_2", "slstm_3"]


def test_params_round_trip():
    jcfg, tcfg, jp, tp = _pair()
    tree = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert sum(p.numel() for p in tp.parameters()) == sum(a.size for a in jax.tree.leaves(tree))


def test_init_params_draws_the_jax_distributions():
    """Same shapes; zeros and ones where JAX has them (the forget bias is
    ones, scaled by 3 in the forward); each normal leaf's spread within 5 %
    of JAX's (an unstacked leaf's fan-in is its leading dimension, the
    recurrent matrices' the head count)."""
    cfg = reduced(get_config(ARCH), d_model=256)
    tp = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jm.init_params(jreduced(jget(ARCH), d_model=256), jax.random.PRNGKey(0))
    tree = params_to_numpy(tp)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0],
                            jax.tree.leaves(tree)):
        name = jax.tree_util.keystr(path)
        assert a.shape == b.shape, name
        if not a.std():
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert abs(b.std() / a.std() - 1.0) < 0.05, name


def test_forward_logits_matches_jax():
    jcfg, tcfg, jp, tp = _pair()
    toks = _tokens(jcfg, s=32)
    for last_only in (False, True):
        want = jm.forward_logits(jcfg, jp, {"tokens": jnp.asarray(toks)}, last_only=last_only)
        got = tm.forward_logits(tcfg, tp, {"tokens": torch.from_numpy(toks)}, last_only=last_only)
        assert got.shape == want.shape
        _close(got, want)
        np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))


def test_forward_train_loss_and_grads_match_jax():
    jcfg, tcfg, jp, tp = _pair()
    toks = _tokens(jcfg, s=33)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.forward_train(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    loss, met = tm.forward_train(tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    _close(loss.detach(), jloss, dict(atol=1e-5, rtol=1e-5))
    assert float(met["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    grads = params_to_numpy(types.SimpleNamespace(
        state_dict=lambda: {k: p.grad for k, p in tp.named_parameters()}))
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jgrads), jax.tree.leaves(grads)):
        w = np.asarray(w)
        assert np.isfinite(g).all(), jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max() + NOISE,
                                   err_msg=jax.tree_util.keystr(path))


def test_decode_steps_match_jax():
    """12 ``decode_step``s from an empty state on both sides: each step's
    logits and every layer's state (mLSTM C, n, m; sLSTM c, n, m, h) after
    it, and the logits equal to the teacher-forced forward's."""
    jcfg, tcfg, jp, tp = _pair(ssm_chunk=12)
    toks = _tokens(jcfg, s=12)
    js = jm.init_decode_state(jcfg, batch=B, max_len=S + 1, dtype=jnp.float32)
    ts = tm.init_decode_state(tcfg, batch=B, max_len=S + 1, dtype=torch.float32, device="cpu")
    assert [type(st).__name__ for st in ts.xlstm] == [type(st).__name__ for st in js.xlstm]
    jstep = jax.jit(lambda t, s: jm.decode_step(jcfg, jp, t, s))
    outs = []
    for t in range(12):
        jl, js = jstep(jnp.asarray(toks[:, t:t + 1]), js)
        tl_, ts = tm.decode_step(tcfg, tp, torch.from_numpy(toks[:, t:t + 1]), ts)
        assert tl_.shape == jl.shape == (B, 1, jcfg.vocab_size)
        _close(tl_, jl, what=f"step {t} logits")
        np.testing.assert_array_equal(tl_.numpy().argmax(-1), np.asarray(jl).argmax(-1))
        for i, (gs, ws) in enumerate(zip(ts.xlstm, js.xlstm)):
            for name, g, w in zip(type(gs)._fields, gs, ws):
                _close(g, w, what=f"step {t} layer {i} {name}")
        outs.append(tl_[:, 0])
    assert ts.length == int(js.length) == 12
    full = tm.forward_logits(tcfg, tp, {"tokens": torch.from_numpy(toks)}, last_only=False)
    _close(torch.stack(outs, dim=1), full[..., : tcfg.vocab_size])


def test_prefill_refuses_xlstm():
    _, tcfg, _, tp = _pair()
    with pytest.raises(ValueError, match="attention family"):
        tm.prefill(tcfg, tp, torch.from_numpy(_tokens(tcfg)), S + 1)


def test_full_config_counts():
    """xlstm-125m at full width: 12 layers (sLSTM at 3, 7, 11), d 768, 4
    heads (mLSTM head dim 384, sLSTM 192), and the JAX tree's 189,088,584
    parameters (the config's analytic ``param_count`` rounds the blocks to
    4·d·d_inner + 2·d each and says 133,908,480)."""
    cfg = get_config(ARCH)
    model = tm.Model(cfg, device="meta")
    assert [n for n in dict(model.layers.named_children()) if n.startswith("slstm")] == \
        ["slstm_3", "slstm_7", "slstm_11"]
    assert txl.mlstm_dims(cfg) == (1536, 4, 384) and txl.slstm_dims(cfg) == (4, 192)
    n = sum(p.numel() for p in model.parameters())
    assert n == 189_088_584 == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jm.param_shapes(jget(ARCH))))
    assert cfg.param_count() == 133_908_480
