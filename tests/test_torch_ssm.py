"""The port's Mamba2 block (``repro_torch.models.ssm``) and the zamba2 hybrid
stack against the JAX package's, on the CPU in f32 with the same inputs and
weights: ``_causal_conv``, ``mamba_forward`` (one and several chunks),
``mamba_init_state``, ``mamba_decode_step``; reduced zamba2-7b (8 layers at
shared cadence 3: two groups and a tail of 2) through ``model_defs``, the
converter's round trip, ``init_params``, ``forward_train`` (loss and
gradients), ``forward_logits`` (reference, flash and blocked attention;
head_dim 32 and 112) and a sequence of ``decode_step``s, the decode state
compared leaf by leaf; and the flash forward's plain version at head_dim
112 against the Pallas kernel in interpret mode.

Inputs and weights are seeded numpy in the shapes of the JAX tree (JAX's
init folds Python's randomized ``hash`` into its keys, so its draws change
from run to run).  Tolerances, f32: atol = rtol = 1e-4 where a value is a
few sums deep (XLA and PyTorch sum in other orders and XLA contracts
multiply-adds; ROADMAP §3 faults (b), (e)); the whole model's logits and
states 2e-4, since 8 layers of recurrences compound those rounding steps;
gradients 1e-4 of each leaf's largest entry plus 1e-8, as a leaf whose
gradient is rounding noise (zero in exact arithmetic) has no relative
scale of its own.  The greedy argmax must agree everywhere.
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import model as jm
from repro.models import ssm as jssm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention_plain
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)
ARCH = "zamba2-7b"
TOL = dict(atol=1e-4, rtol=1e-4)
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)
S, B = 16, 2
#: a gradient that is zero in exact arithmetic holds f32 rounding noise (the
#: sLSTM's b_i: up to 3.5e-10 here, on both sides)
NOISE = 1e-8


def _np_tree(jcfg, seed=0):
    """Seeded numpy values in the shapes of the JAX parameter tree: the
    SSM's A and dt bias from the ranges of its init (A in [1, 16] as a log,
    dt the inverse softplus of [1e-3, 1e-1]); embed std 0.02, norms 0.1,
    biases 0.02; matrices 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(0)))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "a_log" in name:
            return np.log(rng.uniform(1.0, 16.0, s.shape)).astype(np.float32)
        if "dt_bias" in name:
            u = rng.uniform(1e-3, 1e-1, s.shape)
            return (u + np.log(-np.expm1(-u))).astype(np.float32)
        std = (0.02 if "embed" in name or "'b" in name or "conv_b" in name
               else 0.1 if "norm" in name else 1.0 / np.sqrt(s.shape[-2]))
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


def _layer(cfg, seed=3):
    """One Mamba layer's weights: the JAX dict and the port's namespace."""
    jcfg = jreduced(jget(ARCH))
    tree = _np_tree(jcfg, seed)["mamba_groups"]
    prm = {k: np.asarray(v)[0, 0] for k, v in tree.items()}
    return ({k: jnp.asarray(v) for k, v in prm.items()},
            types.SimpleNamespace(**{k: torch.from_numpy(v) for k, v in prm.items()}))


def _x(cfg, seed=4, b=B, s=S):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=what, **tol)


# ---------------------------------------------------------------------------
# the block's functions
# ---------------------------------------------------------------------------


def test_dims_and_defs_match_jax():
    cfg, jcfg = reduced(get_config(ARCH)), jreduced(jget(ARCH))
    assert tssm.mamba_dims(cfg) == jssm.mamba_dims(jcfg)
    got, want = tssm.mamba_defs(cfg), jssm.mamba_defs(jcfg)
    assert list(got) == list(want)
    for name, d in want.items():
        assert (got[name].shape, got[name].init, got[name].scale) == (d.shape, d.init, d.scale), name


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(5)
    xbc = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32) * 0.5
    b = rng.standard_normal((24,)).astype(np.float32) * 0.1
    want = jax.jit(jssm._causal_conv)(*map(jnp.asarray, (xbc, w, b)))
    _close(tssm._causal_conv(*map(torch.from_numpy, (xbc, w, b))), want)


@pytest.mark.parametrize("s,chunk", [(16, 16), (48, 16), (12, 16)],
                         ids=["one chunk", "three chunks", "S under the chunk"])
def test_mamba_forward_matches_jax(s, chunk):
    cfg = reduced(get_config(ARCH), ssm_chunk=chunk)
    jcfg = jreduced(jget(ARCH), ssm_chunk=chunk)
    jprm, tprm = _layer(cfg)
    x = _x(cfg, s=s)
    want = jax.jit(lambda x_, p_: jssm.mamba_forward(x_, p_, jcfg))(jnp.asarray(x), jprm)
    got = tssm.mamba_forward(torch.from_numpy(x), tprm, cfg)
    assert got.shape == want.shape
    _close(got, want)


def test_mamba_forward_refuses_a_ragged_chunk():
    cfg = reduced(get_config(ARCH))
    _, tprm = _layer(cfg)
    with pytest.raises(ValueError, match="chunks"):
        tssm.mamba_forward(torch.from_numpy(_x(cfg, s=20)), tprm, cfg)


def test_mamba_init_state_matches_jax():
    cfg = reduced(get_config(ARCH))
    want = jssm.mamba_init_state(jreduced(jget(ARCH)), 3)
    got = tssm.mamba_init_state(cfg, 3, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32 and not g.any()


def test_mamba_decode_steps_match_jax():
    """12 steps from an empty state: each output and the state after it
    (conv window, SSD state), and the outputs equal to the chunked forward's
    at every position."""
    cfg = reduced(get_config(ARCH), ssm_chunk=12)
    jcfg = jreduced(jget(ARCH), ssm_chunk=12)
    jprm, tprm = _layer(cfg)
    x = _x(cfg, s=12)
    jst = jssm.mamba_init_state(jcfg, B)
    tst = tssm.mamba_init_state(cfg, B, device="cpu")
    jstep = jax.jit(lambda x_, p_, s_: jssm.mamba_decode_step(x_, p_, jcfg, s_))
    outs = []
    for t in range(12):
        jy, jst = jstep(jnp.asarray(x[:, t:t + 1]), jprm, jst)
        ty, tst = tssm.mamba_decode_step(torch.from_numpy(x[:, t:t + 1]), tprm, cfg, tst)
        _close(ty, jy, what=f"step {t} y")
        _close(tst.conv, jst.conv, what=f"step {t} conv")
        _close(tst.ssd, jst.ssd, what=f"step {t} ssd")
        outs.append(ty)
    _close(torch.cat(outs, dim=1), tssm.mamba_forward(torch.from_numpy(x), tprm, cfg))


def test_softplus_is_jaxs_past_its_threshold():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus`` switches to
    x above 20, one f32 ulp away at most, so the port keeps JAX's."""
    x = np.array([-30.0, -1.0, 0.0, 19.9, 20.1, 40.0], np.float32)
    np.testing.assert_array_equal(tssm._softplus(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# the hybrid stack: reduced zamba2-7b
# ---------------------------------------------------------------------------


def test_model_defs_match_jax_tree():
    """Every leaf of JAX's ``model_defs``, flattened, in the port's
    ``model_defs`` (one layer where JAX stacks: (groups, every, ...) and
    (tail, ...) stripped) with its shape, init and scale; and the ``Model``'s
    parameters name every (group, layer) of both stacks."""
    cfg, jcfg = reduced(get_config(ARCH)), jreduced(jget(ARCH))
    want = dict(jax.tree_util.tree_flatten_with_path(
        jm.model_defs(jcfg), is_leaf=lambda x: isinstance(x, jm.ParamDef))[0])
    got = dict(tm._leaves(tm.model_defs(cfg)))
    lead = {k: len(v[0]) for k, v in tm.stacks(cfg).items()}
    assert lead == {"mamba_groups": 2, "mamba_tail": 1}
    assert len(got) == len(want)
    for path, d in want.items():
        name = ".".join(k.key for k in path)
        n = lead.get(name.partition(".")[0], 0)
        assert (got[name].shape, got[name].init, got[name].scale) == \
            (d.shape[n:], d.init, d.scale), name
    params = dict(tm.Model(cfg, device="meta").named_parameters())
    assert "mamba_groups.1.2.in_proj" in params and "mamba_tail.1.out_proj" in params
    assert "shared.attn.wq" in params and "shared.mlp.w_down" in params
    assert len(params) == 9 * cfg.n_layers + 3 + 4 + 3 + 2


def test_params_round_trip():
    jcfg, tcfg, jp, tp = _pair()
    tree = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert sum(p.numel() for p in tp.parameters()) == sum(a.size for a in jax.tree.leaves(tree))
    with pytest.raises(ValueError, match="stacked"):
        params_from_numpy(reduced(get_config(ARCH), n_layers=9), tree, device="cpu")


def test_init_params_draws_the_jax_distributions():
    """Same shapes; zeros and ones where JAX has them; A and the dt bias in
    their init ranges; each normal leaf's spread within 5 % of JAX's (the
    fan-in of a stacked leaf being its outer count: groups for
    ``mamba_groups``, the tail's length for ``mamba_tail``)."""
    cfg = reduced(get_config(ARCH), d_model=256)
    tp = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jm.init_params(jreduced(jget(ARCH), d_model=256), jax.random.PRNGKey(0))
    tree = params_to_numpy(tp)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0],
                            jax.tree.leaves(tree)):
        name = jax.tree_util.keystr(path)
        assert a.shape == b.shape, name
        if "a_log" in name:
            assert np.exp(b).min() >= 1.0 and np.exp(b).max() <= 16.0, name
        elif "dt_bias" in name:
            dt = np.logaddexp(b, 0.0)
            assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 1e-1 * 1.001, name
        elif not a.std():
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif b.size > 64:
            assert abs(b.std() / a.std() - 1.0) < 0.05, name


@pytest.mark.parametrize("impl", ["reference", "flash", "blocked"])
def test_forward_logits_matches_jax(impl):
    jcfg, tcfg, jp, tp = _pair(attention_impl=impl)
    toks = _tokens(jcfg)
    for last_only in (False, True):
        want = jm.forward_logits(jcfg, jp, {"tokens": jnp.asarray(toks)}, last_only=last_only)
        got = tm.forward_logits(tcfg, tp, {"tokens": torch.from_numpy(toks)}, last_only=last_only)
        assert got.shape == want.shape
        _close(got, want, MODEL_TOL)
        np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))


def test_forward_logits_at_head_dim_112_matches_jax():
    """zamba2-7b's shared attention has head_dim 112 (d 3,584 over 32
    heads): the reduced model with head_dim 112, flash attention, 32 tokens
    over two SSD chunks."""
    jcfg, tcfg, jp, tp = _pair(head_dim=112, attention_impl="flash")
    toks = _tokens(jcfg, s=32)
    want = jm.forward_logits(jcfg, jp, {"tokens": jnp.asarray(toks)}, last_only=False)
    got = tm.forward_logits(tcfg, tp, {"tokens": torch.from_numpy(toks)}, last_only=False)
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_train_loss_and_grads_match_jax(remat):
    jcfg, tcfg, jp, tp = _pair(remat=remat)
    toks = _tokens(jcfg, s=S + 1)
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
    logits, and every leaf of the decode state (the stacked Mamba states of
    the groups and the tail, the shared block's 2 KV caches) after it."""
    jcfg, tcfg, jp, tp = _pair()
    toks = _tokens(jcfg)
    js = jm.init_decode_state(jcfg, batch=B, max_len=S + 1, dtype=jnp.float32)
    ts = tm.init_decode_state(tcfg, batch=B, max_len=S + 1, dtype=torch.float32, device="cpu")
    leaves = lambda st: dict(  # noqa: E731
        groups_conv=st.mamba_groups.conv, groups_ssd=st.mamba_groups.ssd,
        tail_conv=st.mamba_tail.conv, tail_ssd=st.mamba_tail.ssd,
        shared_k=st.shared_k, shared_v=st.shared_v)
    for key, w in leaves(js).items():
        g = leaves(ts)[key]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32 and not g.any(), key
    jstep = jax.jit(lambda t, s: jm.decode_step(jcfg, jp, t, s))
    for t in range(12):
        jl, js = jstep(jnp.asarray(toks[:, t:t + 1]), js)
        tl_, ts = tm.decode_step(tcfg, tp, torch.from_numpy(toks[:, t:t + 1]), ts)
        assert tl_.shape == jl.shape == (B, 1, jcfg.vocab_size)
        _close(tl_, jl, MODEL_TOL, f"step {t} logits")
        np.testing.assert_array_equal(tl_.numpy().argmax(-1), np.asarray(jl).argmax(-1))
        for key, w in leaves(js).items():
            _close(leaves(ts)[key], w, MODEL_TOL, f"step {t} {key}")
    assert ts.length == int(js.length) == 12


def test_decode_matches_teacher_forced_forward():
    """``tests/test_decode_consistency.py``'s check on the port: decoding
    token by token gives the teacher-forced forward's logits at every
    position (one SSD chunk of 12, as there)."""
    _, tcfg, _, tp = _pair(ssm_chunk=12)
    toks = torch.from_numpy(_tokens(tcfg, s=12))
    full = tm.forward_logits(tcfg, tp, {"tokens": toks}, last_only=False)[..., : tcfg.vocab_size]
    state = tm.init_decode_state(tcfg, batch=B, max_len=13, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(12):
        logits, state = tm.decode_step(tcfg, tp, toks[:, t:t + 1], state)
        outs.append(logits[:, 0])
    _close(torch.stack(outs, dim=1), full, MODEL_TOL)


def test_prefill_and_engine_refuse_the_hybrid():
    """The JAX package's ``prefill`` and ``ServingEngine`` assert the
    attention family; the port's raise."""
    from repro_torch.serving import ServeConfig, ServingEngine

    _, tcfg, _, tp = _pair()
    with pytest.raises(ValueError, match="attention family"):
        tm.prefill(tcfg, tp, torch.from_numpy(_tokens(tcfg)), S + 1)
    with pytest.raises(ValueError, match="attention family"):
        ServingEngine(tcfg, tp, ServeConfig(max_batch=2, max_len=32))


# ---------------------------------------------------------------------------
# the flash forward's plain version at head_dim 112
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 128, 4, 4, 112), (2, 256, 4, 2, 112)], ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_plain_at_head_dim_112_matches_pallas_kernel(shape, causal):
    """The plain version the CUDA kernels are held to on the card, against
    the JAX package's Pallas kernel in interpret mode (f32, 2e-5: the
    reduction order differs)."""
    b, s, h, g, hd = shape
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32) for n in (h, g, g))
    o, lse = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=causal)
    want = jflash(*map(jnp.asarray, (q, k, v)), causal=causal, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    assert lse.shape == (b * h, s)


def test_full_config_counts():
    """zamba2-7b at full width and depth: 81 layers as 13 groups of 6 and a
    tail of 3, head_dim 112, and the JAX tree's 6,751,130,832 parameters
    (12.58 GiB in bf16; the config's analytic ``param_count`` rounds the
    Mamba layers' small leaves away and says 6,747,847,680)."""
    cfg = get_config(ARCH)
    model = tm.Model(cfg, device="meta")
    assert {k: v[0] for k, v in tm.stacks(cfg).items()} == {"mamba_groups": (13, 6),
                                                             "mamba_tail": (3,)}
    assert cfg.resolved_head_dim == 112
    n = sum(p.numel() for p in model.parameters())
    assert n == 6_751_130_832 == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jm.param_shapes(jget(ARCH))))
    assert cfg.param_count() == 6_747_847_680
