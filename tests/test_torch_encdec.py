"""The encoder-decoder (seamless-m4t-medium) and the vision stub
(internvl2-26b) in the port's model stack against the JAX package's, on
the CPU at reduced width in f32:

* ``forward_logits`` with reference, flash and blocked attention, every
  position and the last, the batch carrying ``frame_embeds`` (the encoder's
  input) or ``patch_embeds`` (the prefix before the text);
* seamless's ``decode_step`` in both cache layouts, the cross caches primed
  on each side from its own ``_encoder_stack`` and ``encode_cross_kv``, as
  ``tests/test_models_smoke.py`` primes JAX's;
* internvl2's ``prefill`` (text only, as the JAX function) then
  ``decode_step``, and decode from an empty per-layer cache;
* ``init_params`` draws JAX's distributions, the encoder's stack with its
  own fan-in (``n_encoder_layers``);
* the serving engine on internvl2 against the JAX engine, and seamless
  refused by ``prefill`` and the engine, as the JAX package refuses it.

``forward_train``, the converters and the optimizers on these trees are in
``tests/test_torch_encdec_training.py``.

Weights come from seeded numpy in the shapes of JAX's tree
(``test_torch_training._np_params``: matrices 1/sqrt(fan-in)), not from
JAX's ``init_params``: that init takes a stacked leaf's fan-in as the layer
count, which puts the cross-attention's scores of reduced seamless near
one-hot ties, where f32 does not resolve 1e-4 (at one hash seed both the
JAX and the port's f32 logits lie 1e-2 from an f64 forward of the same
weights, 1.7e-3 from each other), and JAX folds Python's randomized
``hash`` into its keys, so those weights change from run to run.
``tests/test_torch_encdec_training.py`` carries JAX's own init through the
converters.  Inputs come from seeded numpy.  Tolerances as
``tests/test_torch_model.py`` and ``tests/test_torch_training.py``: atol =
rtol = 1e-4 (f32 in another summation order), every argmax equal.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models import attention as ja
from repro.models import model as jm
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as ta
from repro_torch.models import model as tm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from test_torch_training import _np_params

torch.set_num_threads(1)
ARCHS = ["seamless-m4t-medium", "internvl2-26b"]
TOL = dict(atol=1e-4, rtol=1e-4)
#: batch, text positions, encoder positions (seamless's frame embeddings)
B, S, S_ENC = 2, 12, 20


def _pair(arch, **overrides):
    """(JAX cfg, port cfg, JAX params, port params) at reduced width."""
    jcfg = jreduced(jget(arch), **overrides)
    tcfg = reduced(get_config(arch), **overrides)
    tree = _np_params(jcfg)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, device="cpu")


def _inputs(cfg, seed=1, labels=False):
    """Tokens, the family's embeddings, and (``labels``) next-token labels,
    as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1]}
    if labels:
        batch["labels"] = toks[:, 1:]
    if cfg.modality == "vision_stub":
        batch["patch_embeds"] = rng.standard_normal((B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_decoder:
        batch["frame_embeds"] = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want):
    got, want = got.numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("impl", ["reference", "flash", "blocked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_matches_jax(arch, impl):
    jcfg, tcfg, jp, tp = _pair(arch, attention_impl=impl)
    batch = _inputs(jcfg)
    for last_only in (False, True):
        want = jm.forward_logits(jcfg, jp, _j(batch), last_only=last_only)
        got = tm.forward_logits(tcfg, tp, _t(batch), last_only=last_only)
        assert got.shape == want.shape == (B, S if not last_only else 1, jcfg.vocab_padded)
        _close(got, want)


def _primed_jax(jcfg, jp, frames):
    """JAX's decode state with its cross caches from its own encoder, as
    ``tests/test_models_smoke.py`` primes them."""
    state = jm.init_decode_state(jcfg, batch=B, max_len=S + 1, dtype=jnp.float32,
                                 enc_len=frames.shape[1])
    pc = jm._cast(jp, jcfg)
    enc_out = jm._encoder_stack(jnp.asarray(frames), pc, jcfg)
    ks, vs = zip(*(ja.encode_cross_kv(enc_out, jax.tree.map(lambda x: x[i], pc["layers"])["cross"],
                                      jcfg) for i in range(jcfg.n_layers)))
    return state._replace(cross_k=jnp.stack(ks).astype(jnp.float32),
                          cross_v=jnp.stack(vs).astype(jnp.float32))


def _primed_port(tcfg, tp, frames):
    """The port's decode state, its cross caches primed the same way."""
    state = tm.init_decode_state(tcfg, B, S + 1, dtype=torch.float32, device="cpu",
                                 enc_len=frames.shape[1])
    with torch.no_grad():
        pc = tm._cast(tp, tcfg)
        enc_out = tm._encoder_stack(torch.from_numpy(frames), pc, tcfg)
        for i, lp in enumerate(pc.layers):
            k, v = ta.encode_cross_kv(enc_out, lp.cross, tcfg)
            state.cross_k[i].copy_(k)
            state.cross_v[i].copy_(v)
    return state


@pytest.mark.parametrize("layout", ["stacked", "per_layer"])
def test_seamless_decode_matches_jax(layout):
    """12 tokens decoded from an empty self-attention cache over primed
    cross caches: every step's logits within TOL of JAX's, and the caches'
    shapes JAX's (cross (L, B, S_enc, G, hd) in both layouts)."""
    jcfg, tcfg, jp, tp = _pair("seamless-m4t-medium", decode_cache_layout=layout)
    batch = _inputs(jcfg)
    js = _primed_jax(jcfg, jp, batch["frame_embeds"])
    ts = _primed_port(tcfg, tp, batch["frame_embeds"])
    assert tuple(ts.cross_k.shape) == js.cross_k.shape == (jcfg.n_layers, B, S_ENC, jcfg.n_kv_heads,
                                                             jcfg.resolved_head_dim)
    np.testing.assert_allclose(ts.cross_k.numpy(), np.asarray(js.cross_k), **TOL)
    np.testing.assert_allclose(ts.cross_v.numpy(), np.asarray(js.cross_v), **TOL)
    assert (ts.kv_layers_k is not None) == (layout == "per_layer") == (js.kv_layers_k is not None)
    jstep = jax.jit(lambda t, s: jm.decode_step(jcfg, jp, t, s))
    toks = batch["tokens"]
    for t in range(S):
        jl, js = jstep(jnp.asarray(toks[:, t:t + 1]), js)
        tl_, ts = tm.decode_step(tcfg, tp, torch.from_numpy(toks[:, t:t + 1]), ts)
        assert tl_.shape == jl.shape == (B, 1, jcfg.vocab_size)
        _close(tl_, jl)
    assert ts.length == int(js.length) == S


@pytest.mark.parametrize("layout", ["stacked", "per_layer"])
def test_internvl2_prefill_and_decode_match_jax(layout):
    """Prefill 8 text tokens (``extras`` passed and ignored on both sides,
    as the JAX package prefills the vision stub) then decode 4 (stacked),
    or decode all 12 from an empty per-layer cache."""
    jcfg, tcfg, jp, tp = _pair("internvl2-26b", decode_cache_layout=layout)
    batch = _inputs(jcfg)
    toks = batch["tokens"]
    if layout == "stacked":
        extras = {"patch_embeds": batch["patch_embeds"]}
        jl, js = jm.prefill(jcfg, jp, jnp.asarray(toks[:, :8]), S + 1, extras=_j(extras))
        tl_, ts = tm.prefill(tcfg, tp, torch.from_numpy(toks[:, :8]), S + 1, extras=_t(extras))
        _close(tl_, jl)
        assert ts.length == int(js.length) == 8
        np.testing.assert_allclose(ts.kv_k.numpy(), np.asarray(js.kv_k), **TOL)
        np.testing.assert_allclose(ts.kv_v.numpy(), np.asarray(js.kv_v), **TOL)
        start = 8
    else:
        js = jm.init_decode_state(jcfg, batch=B, max_len=S + 1, dtype=jnp.float32)
        ts = tm.init_decode_state(tcfg, B, S + 1, dtype=torch.float32, device="cpu")
        assert ts.cross_k is None and js.cross_k is None
        start = 0
    jstep = jax.jit(lambda t, s: jm.decode_step(jcfg, jp, t, s))
    for t in range(start, S):
        jl, js = jstep(jnp.asarray(toks[:, t:t + 1]), js)
        tl_, ts = tm.decode_step(tcfg, tp, torch.from_numpy(toks[:, t:t + 1]), ts)
        assert tl_.shape == jl.shape == (B, 1, jcfg.vocab_size)
        _close(tl_, jl)
    assert ts.length == int(js.length) == S


def test_seamless_decode_matches_its_teacher_forced_forward():
    """With the cross caches primed from the same frame embeddings, decoding
    token by token gives ``forward_logits``' logits at every position
    (``tests/test_decode_consistency.py``'s check on the port)."""
    _, tcfg, _, tp = _pair("seamless-m4t-medium")
    batch = _inputs(tcfg)
    full = tm.forward_logits(tcfg, tp, _t(batch), last_only=False)[..., : tcfg.vocab_size]
    state = _primed_port(tcfg, tp, batch["frame_embeds"])
    outs = []
    for t in range(S):
        logits, state = tm.decode_step(tcfg, tp, torch.from_numpy(batch["tokens"][:, t:t + 1]), state)
        outs.append(logits[:, 0])
    _close(torch.stack(outs, dim=1), full.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_the_jax_distributions(arch):
    """Same tree, zeros where JAX has zeros, and each leaf's spread within
    5 % of JAX's: std scale/sqrt(fan-in), the fan-in of a stacked leaf its
    stack's count (``n_layers`` for ``layers``, ``n_encoder_layers`` for
    ``encoder.layers``); the parameter count that of JAX's tree."""
    over = dict(n_layers=3, d_model=256, n_encoder_layers=2)
    cfg = reduced(get_config(arch), **over)
    tp = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jax.tree.map(np.asarray, jm.init_params(jreduced(jget(arch), **over), jax.random.PRNGKey(0)))
    tree = params_to_numpy(tp)
    assert jax.tree.structure(tree) == jax.tree.structure(jp)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0], jax.tree.leaves(tree)):
        assert a.shape == b.shape, path
        if not a.any():
            assert not b.any(), path
        else:
            assert abs(b.std() / a.std() - 1.0) < 0.05, path
    if cfg.encoder_decoder:
        want = 1.0 / np.sqrt(cfg.n_encoder_layers)
        assert abs(tree["encoder"]["layers"]["attn"]["wq"].std() / want - 1.0) < 0.05
    assert sum(p.numel() for p in tp.parameters()) == sum(a.size for a in jax.tree.leaves(jp))


def test_internvl2_engine_matches_jax():
    """5 requests at batch 3 through the port's engine and the JAX one, the
    vision stub served as text only: the same tokens and step counts."""
    from repro.serving import ServeConfig as JServeConfig, ServingEngine as JEngine
    from repro_torch.serving import ServeConfig, ServingEngine

    jcfg, tcfg, jp, tp = _pair("internvl2-26b")
    je = JEngine(jcfg, jp, JServeConfig(max_batch=3, max_len=32))
    te = ServingEngine(tcfg, tp, ServeConfig(max_batch=3, max_len=32))
    rng = np.random.default_rng(4)
    for i in range(5):
        prompt = rng.integers(2, tcfg.vocab_size, rng.integers(3, 9))
        je.submit(f"r{i}", prompt, max_new=6)
        te.submit(f"r{i}", prompt, max_new=6)
    out = te.run_until_drained()
    assert set(out) == {f"r{i}" for i in range(5)}
    assert out == je.run_until_drained()
    assert te.steps_executed == je.steps_executed


@pytest.mark.parametrize("entry", ["prefill", "engine"])
def test_seamless_refused_by_prefill_and_engine(entry):
    """The JAX package asserts ``not cfg.encoder_decoder`` in ``prefill`` and
    in the engine; the port raises ``ValueError`` in both."""
    from repro.serving import ServeConfig as JServeConfig, ServingEngine as JEngine
    from repro_torch.serving import ServeConfig, ServingEngine

    jcfg, tcfg, jp, tp = _pair("seamless-m4t-medium")
    toks = _inputs(jcfg)["tokens"]
    if entry == "prefill":
        with pytest.raises(AssertionError):
            jm.prefill(jcfg, jp, jnp.asarray(toks), S + 1)
        with pytest.raises(ValueError, match="encoder-decoder"):
            tm.prefill(tcfg, tp, torch.from_numpy(toks), S + 1)
    else:
        with pytest.raises(AssertionError):
            JEngine(jcfg, jp, JServeConfig())
        with pytest.raises(ValueError, match="encoder-decoder"):
            ServingEngine(tcfg, tp, ServeConfig())
