"""Training the encoder-decoder (seamless-m4t-medium) and the vision stub
(internvl2-26b) with the port, and carrying their trees across, against
the JAX package on the CPU at reduced width in f32:

* ``forward_train``'s loss and every gradient against
  ``jax.value_and_grad(forward_train)``, the encoder's stack and the
  cross-attention weights among them (tolerance atol = rtol = 1e-4, as
  ``tests/test_torch_training.py``);
* ``params_from_numpy`` / ``params_to_numpy`` exact both ways on trees from
  JAX's own ``init_params``, the ``encoder`` subtree among them;
* ``opt_state_from_numpy`` / ``opt_state_to_numpy`` exact both ways under
  AdamW and Adafactor, the ``encoder.layers`` keys among them;
* Adafactor on seamless's tree against ``repro.optim`` over two steps
  (rtol 2e-6, atol 1e-9, as ``tests/test_torch_hybrid_training.py``): the
  encoder's stack grouped and factored as JAX stacks it;
* ``make_train_step`` under Adafactor against the JAX step over two steps
  (``tests/test_torch_hybrid_training.py``'s tolerances: loss and gradient
  norm 1e-4, moves rtol 1e-5 with atol 5e-3 x lr, factors rtol 2e-4 with
  atol 1e-5 of the leaf's largest value);
* the stack prefixes: ``stack_prefix`` and Adafactor's ``_place`` on the
  names of both stacks, and the cross-attention's definitions without
  biases.

Weights for the numerics come from seeded numpy in the shapes of JAX's
tree (``test_torch_training._np_params``; ``tests/test_torch_encdec.py``
says why not JAX's init); inputs from seeded numpy.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticLMDataset as JData
from repro.models import model as jm
from repro.optim import optimizers as jopt
from repro.training import TrainSettings as JSettings, make_train_step as jmake_step
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as ta
from repro_torch.models import model as tm
from repro_torch.models.convert import (
    _tree_from_flat,
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.optim import optimizers as topt
from repro_torch.training import TrainSettings, make_train_step
from test_torch_encdec import ARCHS, TOL, _inputs, _j, _pair, _t

torch.set_num_threads(1)
OPT_TOL = dict(rtol=2e-6, atol=1e-9)


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch,impl", [("seamless-m4t-medium", "reference"),
                                       ("seamless-m4t-medium", "flash"),
                                       ("seamless-m4t-medium", "blocked"),
                                       ("internvl2-26b", "reference"),
                                       ("internvl2-26b", "flash")])
def test_forward_train_loss_and_grads_match_jax(arch, impl):
    """The loss, ``lm_loss`` and every gradient within TOL of
    ``jax.value_and_grad`` (remat full, the registry's: the encoder's
    layers are rematerialized too)."""
    jcfg, tcfg, jp, tp = _pair(arch, attention_impl=impl, remat="full")
    batch = _inputs(jcfg, labels=True)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.forward_train(jcfg, p, _j(batch)), has_aux=True)(jp)
    loss, met = tm.forward_train(tcfg, tp, _t(batch))
    names, leaves = zip(*tp.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    np.testing.assert_allclose(float(met["lm_loss"]), float(jmet["lm_loss"]), **TOL)
    assert float(met["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    got = _tree_from_flat(dict(zip(names, grads)))
    assert jax.tree.structure(got) == jax.tree.structure(jgrads)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"{arch} {impl} grad "
                                   f"{jax.tree_util.keystr(path)}", **TOL)
    if tcfg.encoder_decoder:
        assert np.abs(got["encoder"]["layers"]["attn"]["wq"]).max() > 0
        assert np.abs(got["layers"]["cross"]["wk"]).max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_with_jax_init(arch):
    """JAX's ``init_params`` tree → the port's ``Model`` → back: the same
    structure and every leaf equal; the port's parameter count the tree's."""
    jcfg, tcfg = jreduced(jget(arch)), reduced(get_config(arch))
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_numpy(tcfg, tree, device="cpu")
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    assert sum(p.numel() for p in tp.parameters()) == sum(a.size for a in jax.tree.leaves(tree))
    names = tp.state_dict()
    if tcfg.encoder_decoder:
        for i in range(tcfg.n_encoder_layers):
            np.testing.assert_array_equal(names[f"encoder.layers.{i}.attn.wq"].numpy(),
                                          tree["encoder"]["layers"]["attn"]["wq"][i])
        np.testing.assert_array_equal(names["encoder.final_norm"].numpy(), tree["encoder"]["final_norm"])
        assert "layers.0.cross.wk" in names and "layers.0.cross_norm" in names
    else:
        assert not any(n.startswith("encoder.") or ".cross" in n for n in names)


@pytest.mark.parametrize("optimizer", ["adafactor", "adamw"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_round_trip_is_exact(arch, optimizer):
    """The JAX state with random values → the port's → back, equal leaf for
    leaf in value and type; the port's own init has the converted state's
    keys and shapes (Adafactor's ``encoder.layers.<rest>`` a stacked leaf's
    factors, AdamW's ``encoder.layers.<i>.<rest>`` one a layer)."""
    jcfg, tcfg, jp, tp = _pair(arch)
    rng = np.random.default_rng(6)
    init = jax.tree.map(np.asarray, (jopt.adafactor_init if optimizer == "adafactor"
                                     else jopt.adamw_init)(jp))
    rand = lambda t: jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), t)  # noqa: E731
    st = jopt.OptState(step=np.asarray(4, np.int32), mu=None if init.mu is None else rand(init.mu),
                       nu=rand(init.nu))
    port = opt_state_from_numpy(tcfg, st, device="cpu")
    own = topt.make_optimizer(optimizer).init(dict(tp.named_parameters()))
    shape = lambda x: [tuple(y.shape) for y in x] if isinstance(x, tuple) else tuple(x.shape)  # noqa: E731
    for part in ("mu", "nu"):
        got, mine = getattr(port, part), getattr(own, part)
        if mine is None:
            assert got is None
            continue
        assert sorted(got) == sorted(mine), part
        for key, t in mine.items():
            assert shape(got[key]) == shape(t), (part, key)
    if tcfg.encoder_decoder:
        le, d = tcfg.n_encoder_layers, tcfg.d_model
        nq = tcfg.n_heads * tcfg.resolved_head_dim
        if optimizer == "adafactor":
            assert shape(port.nu["encoder.layers.attn.wq"]) == [(le, d), (le, nq)]
            assert shape(port.nu["encoder.layers.attn_norm"]) == [(le,), (d,)]
            assert shape(port.nu["encoder.final_norm"]) == (d,)
        else:
            assert shape(port.nu[f"encoder.layers.{le - 1}.attn.wq"]) == (d, nq)
    back = opt_state_to_numpy(port)
    assert int(back.step) == 4 and back.step.dtype == np.int32
    assert jax.tree.structure((back.mu, back.nu)) == jax.tree.structure((st.mu, st.nu))
    for a, b in zip(jax.tree.leaves((st.mu, st.nu)), jax.tree.leaves((back.mu, back.nu))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_adafactor_matches_jax_on_the_seamless_tree():
    """Two Adafactor updates (weight decay on) of seamless's tree from the
    same gradients: every delta and second moment within OPT_TOL of
    ``repro.optim``'s, the encoder's entries grouped into its stacked
    leaves and each stack's update clipped by the whole stack's RMS."""
    jcfg, tcfg, jp, tp = _pair("seamless-m4t-medium")
    rng = np.random.default_rng(9)
    jo, to = (m.make_optimizer("adafactor", weight_decay=0.01) for m in (jopt, topt))
    tparams = {k: p.detach().clone() for k, p in tp.named_parameters()}
    js, ts = jo.init(jp), to.init(tparams)
    jupdate = jax.jit(jo.update)
    for step in range(2):
        gtree = jax.tree.map(lambda a: (10.0 ** step * rng.standard_normal(a.shape)).astype(np.float32), jp)
        # the same gradients, split per layer as the port keeps them
        gflat = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                 dict(params_from_numpy(tcfg, gtree, device="cpu").state_dict()).items()}
        lr = np.float32(1e-3 * (step + 1))
        jd, js = jupdate(jax.tree.map(jnp.asarray, gtree), js, jp, jnp.asarray(lr))
        td, ts = to.update(gflat, ts, tparams, torch.tensor(lr))
        want = _by_path(jax.tree.map(np.asarray, jd))
        got = _by_path(_tree_from_flat(td))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, **OPT_TOL, err_msg=f"step {step} delta {k}")
        jnu, tnu = _by_path(jax.tree.map(np.asarray, js.nu)), _by_path(opt_state_to_numpy(ts).nu)
        assert sorted(jnu) == sorted(tnu)
        for k, w in jnu.items():
            np.testing.assert_allclose(tnu[k], w, **OPT_TOL, err_msg=f"step {step} nu {k}")
        jp = jopt.apply_updates(jp, jd)
        tparams = topt.apply_updates(tparams, td)
    assert "encoder.layers.mlp.w_up" in ts.nu and "encoder.layers.0.mlp.w_up" not in ts.nu


STEP_KW = dict(total_steps=50, warmup_steps=2, learning_rate=1e-3, weight_decay=0.01)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_over_two_steps(arch):
    """Two ``make_train_step`` steps under Adafactor with flash attention
    (the JAX side's Pallas kernel in interpret mode, the port's plain
    version), the batch carrying the family's embeddings beside the
    synthetic tokens: loss, gradient norm and learning rate every step, and
    every parameter's move and second moment."""
    jcfg, tcfg, jp, tp = _pair(arch, optimizer="adafactor", attention_impl="flash")
    data = JData(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=12, global_batch=2, seed=3))
    jstep = jax.jit(jmake_step(jcfg, JSettings(**STEP_KW)))
    tstep = make_train_step(tcfg, TrainSettings(**STEP_KW))
    js = jopt.adafactor_init(jp)
    ts = opt_state_from_numpy(tcfg, jax.tree.map(np.asarray, js), device="cpu")
    for i in range(2):
        extra = {k: v for k, v in _inputs(jcfg, seed=10 + i).items() if k.endswith("_embeds")}
        batch = {**data.batch_at(i), **extra}
        jbefore, tbefore = (jax.tree.map(np.array, t) for t in (jp, params_to_numpy(tp)))
        jp, js, jmet = jstep(jp, js, _j(batch))
        tp, ts, tmet = tstep(tp, ts, batch)
        for key in ("loss", "lm_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), **TOL,
                                       err_msg=f"step {i} {key}")
        lr = float(jmet["lr"])
        jd = _by_path(jax.tree.map(lambda a, b: np.asarray(a) - b, jp, jbefore))
        td = _by_path(jax.tree.map(lambda a, b: np.asarray(a) - b, params_to_numpy(tp), tbefore))
        assert sorted(td) == sorted(jd)
        for key, w in jd.items():
            np.testing.assert_allclose(td[key], w, atol=5e-3 * lr, rtol=1e-5, err_msg=f"step {i} move {key}")
        jnu, tnu = _by_path(jax.tree.map(np.asarray, js.nu)), _by_path(opt_state_to_numpy(ts).nu)
        for key, w in jnu.items():
            np.testing.assert_allclose(tnu[key], w, rtol=2e-4, atol=1e-5 * float(np.abs(w).max()),
                                       err_msg=f"step {i} nu {key}")
    assert int(opt_state_to_numpy(ts).step) == int(js.step) == 2


def test_stack_prefixes_and_cross_defs():
    """``stack_prefix`` takes the longest prefix of whole parts;
    ``_place`` puts an encoder entry in ``encoder.layers.<rest>``, a decoder
    entry (its cross-attention too) in ``layers.<rest>``, keeps
    ``encoder.final_norm`` whole and refuses a name it cannot place; the
    cross-attention's definitions drop the biases, as JAX's
    ``attn_defs(cross=True)``."""
    from repro.models.attention import attn_defs as jattn_defs

    assert tm.stack_prefix("encoder.layers.3.attn.wq", tm.STACK_DEPTH) == "encoder.layers"
    assert tm.stack_prefix("layers.3.attn.wq", tm.STACK_DEPTH) == "layers"
    assert tm.stack_prefix("encoder.final_norm", tm.STACK_DEPTH) is None
    assert tm.stack_prefix("layersx.0.w", tm.STACK_DEPTH) is None
    assert topt._place("encoder.layers.3.attn.wq") == ("encoder.layers.attn.wq", (3,))
    assert topt._place("encoder.layers.11.mlp_norm") == ("encoder.layers.mlp_norm", (11,))
    assert topt._place("layers.2.cross.wk") == ("layers.cross.wk", (2,))
    assert topt._place("encoder.final_norm") is None
    for bad in ("encoder.layers.attn.3.wq", "encoder.3.attn.wq", "encoder.layers.3"):
        with pytest.raises(ValueError):
            topt._place(bad)
    cfg = dataclasses.replace(reduced(get_config("seamless-m4t-medium")), qkv_bias=True)
    jcfg = dataclasses.replace(jreduced(jget("seamless-m4t-medium")), qkv_bias=True)
    for cross in (False, True):
        got = {k: d.shape for k, d in ta.attn_defs(cfg, cross=cross).items()}
        assert got == {k: d.shape for k, d in jattn_defs(jcfg, cross=cross).items()}
        assert ("bq" in got) == (not cross)
    assert tm.stacks(cfg) == {"layers": ((4,), 4), "encoder.layers": ((2,), 2)}
