"""The port's model stack (``repro_torch.models``) against the JAX package's,
on reduced qwen2-1.5b, gemma-2b, yi-9b, moonshot-v1-16b-a3b (experts) and
arctic-480b (experts beside a dense MLP) in f32 with the same weights: the
converter's round trip, ``forward_logits`` with reference, flash and
blocked attention, and ``prefill`` + ``decode_step`` in both cache layouts.

Weights of the dense models come from JAX's ``init_params`` through
``params_from_numpy``; those of the MoE models from seeded numpy in the
shapes of JAX's tree (JAX's init folds Python's randomized ``hash`` into
its keys, and a routing decision near a tie would then change from run to
run); tokens from seeded numpy.  Tolerance atol = rtol = 1e-4 (f32,
summation order differs between XLA and PyTorch), and the greedy argmax must
agree everywhere.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models import layers as jlayers
from repro.models import model as jm
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from test_torch_training import _np_params

torch.set_num_threads(1)
ARCHS = ["qwen2-1.5b", "gemma-2b", "yi-9b", "moonshot-v1-16b-a3b", "arctic-480b"]
MOE = ["moonshot-v1-16b-a3b", "arctic-480b"]
TOL = dict(atol=1e-4, rtol=1e-4)
S, B = 12, 2


def _pair(arch, **overrides):
    """(JAX cfg, port cfg, JAX params, port params) at reduced width."""
    jcfg = jreduced(jget(arch), **overrides)
    tcfg = reduced(get_config(arch), **overrides)
    if jcfg.is_moe:
        jp = jax.tree.map(jnp.asarray, _np_params(jcfg))
    else:
        jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, seed=1, b=B, s=S):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want):
    got, want = got.numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_config_registry_is_a_copy():
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget(arch))
        assert dataclasses.asdict(reduced(get_config(arch))) == \
            dataclasses.asdict(jreduced(jget(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    tree = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert sum(p.numel() for p in tp.parameters()) == sum(a.size for a in jax.tree.leaves(tree))


@pytest.mark.parametrize("impl", ["reference", "flash", "blocked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_matches_jax(arch, impl):
    jcfg, tcfg, jp, tp = _pair(arch, attention_impl=impl)
    toks = _tokens(jcfg)
    for last_only in (False, True):
        want = jm.forward_logits(jcfg, jp, {"tokens": jnp.asarray(toks)}, last_only=last_only)
        got = tm.forward_logits(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                last_only=last_only)
        assert got.shape == want.shape
        _close(got, want)


#: the primed cache's gap to JAX's in relative norm: f32 summation order
#: (71 hash seeds x qwen2-1.5b and gemma-2b: at most 4.2e-6)
KV_REL = 1e-5


def _kv_close(tcfg, tp, toks, got, want):
    """The primed cache within KV_REL of JAX's in norm, and within TOL of it
    at every element that f32 resolves to TOL.  JAX's ``init_params`` folds
    ``hash(path)`` into each leaf's key, so the weights change with the
    interpreter's hash seed; at about one seed in twenty, an element of the
    last layer's cache lands more than TOL from JAX's.  An f64 evaluation of
    the same weights shows at every such element that one of the two f32
    values (JAX's as often as the port's) is more than TOL/2 from the exact
    value: the network amplifies summation-order rounding there.  Those
    elements are the only ones excused."""
    got, want = got.numpy(), np.asarray(want)
    rel = np.linalg.norm(got.astype(np.float64) - want) / np.linalg.norm(want.astype(np.float64))
    assert rel <= KV_REL, rel
    off = ~np.isclose(got, want, **TOL)
    if not off.any():
        return
    c64 = dataclasses.replace(tcfg, dtype="float64")
    p64 = tm.Model(c64, device="meta")
    p64.load_state_dict({k: t.double() for k, t in tp.state_dict().items()}, assign=True)
    ref = tm.prefill(c64, p64, torch.from_numpy(toks), S + 1)[1].kv_k.numpy()
    half = (TOL["atol"] + TOL["rtol"] * np.abs(ref)) / 2
    unresolved = (np.abs(want - ref) > half) | (np.abs(got - ref) > half)
    bad = off & ~unresolved
    assert not bad.any(), (
        f"{int(bad.sum())} cache elements outside TOL of JAX's where both f32 values are "
        f"within TOL/2 of the f64 evaluation: port {got[bad][:4]}, JAX {want[bad][:4]}, "
        f"f64 {ref[bad][:4]}")


@pytest.mark.parametrize("layout", ["stacked", "per_layer"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, layout):
    """Prefill 8 tokens then decode 4 (stacked cache, as the serving engine
    does), or decode all 12 from an empty per-layer cache."""
    jcfg, tcfg, jp, tp = _pair(arch, decode_cache_layout=layout)
    toks = _tokens(jcfg)
    if layout == "stacked":
        jl, js = jm.prefill(jcfg, jp, jnp.asarray(toks[:, :8]), S + 1)
        tl_, ts = tm.prefill(tcfg, tp, torch.from_numpy(toks[:, :8]), S + 1)
        _close(tl_, jl)
        assert ts.length == int(js.length) == 8
        _kv_close(tcfg, tp, toks[:, :8], ts.kv_k, js.kv_k)
        start = 8
    else:
        js = jm.init_decode_state(jcfg, batch=B, max_len=S + 1, dtype=jnp.float32)
        ts = tm.init_decode_state(tcfg, batch=B, max_len=S + 1, dtype=torch.float32,
                                  device="cpu")
        assert ts.kv_layers_k is not None and len(ts.kv_layers_k) == tcfg.n_layers
        start = 0
    jstep = jax.jit(lambda t, s: jm.decode_step(jcfg, jp, t, s))
    for t in range(start, S):
        jl, js = jstep(jnp.asarray(toks[:, t:t + 1]), js)
        tl_, ts = tm.decode_step(tcfg, tp, torch.from_numpy(toks[:, t:t + 1]), ts)
        assert tl_.shape == jl.shape == (B, 1, jcfg.vocab_size)
        _close(tl_, jl)
    assert ts.length == int(js.length) == S


def test_layers_match_jax():
    """RoPE, SwiGLU and the tanh-GELU GeGLU on their own."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5), (2, 5)).astype(np.int32)
    np.testing.assert_allclose(tl.rope_frequencies(32, 1e4).numpy(),
                               np.asarray(jlayers.rope_frequencies(32, 1e4)), rtol=1e-6)
    np.testing.assert_allclose(
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)), atol=1e-5)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    p = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
         for k, s in (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    tp = tm.ParamGroup(tl.mlp_defs(16, 24))
    tp.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    for kind in ("swiglu", "geglu"):
        with torch.no_grad():
            got = tl.glu_mlp(torch.from_numpy(h), tp, kind).numpy()
        want = np.asarray(jlayers.glu_mlp(jnp.asarray(h), {k: jnp.asarray(v) for k, v in p.items()},
                                          kind))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-1.5b"] + MOE)
def test_init_params_draws_the_jax_distributions(arch):
    """Same shapes, zeros where JAX has zeros, and each leaf's spread within
    5 % of JAX's (std scale/sqrt(fan-in), the fan-in of a stacked leaf being
    the layer count, as in ``layers._init_leaf``; the experts' (L, E, D, F)
    leaves too)."""
    cfg = reduced(get_config(arch), n_layers=3, d_model=256)
    tp = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jm.init_params(jreduced(jget(arch), n_layers=3, d_model=256), jax.random.PRNGKey(0))
    tree = params_to_numpy(tp)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0],
                            jax.tree.leaves(tree)):
        assert a.shape == b.shape, path
        if not a.any():
            assert not b.any(), path
        else:
            assert abs(b.std() / a.std() - 1.0) < 0.05, path
    with pytest.raises(RuntimeError):
        tm.init_params(cfg, torch.Generator().manual_seed(0))   # the card by default


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-26b"])
def test_encdec_and_vision_families_run(arch):
    """The encoder-decoder and the vision stub run through every entry point
    on the CPU (the values against JAX's are in tests/test_torch_encdec.py
    and tests/test_torch_encdec_training.py): ``init_params``,
    ``forward_logits`` (the batch carrying ``frame_embeds`` or
    ``patch_embeds``), ``init_decode_state``, ``decode_step`` and
    ``forward_train``.  seamless decodes over cross caches primed from
    ``_encoder_stack`` and ``encode_cross_kv``, its logits those of the
    forward's last position; internvl2 decodes text only, as ``prefill``
    reads it, its logits those of ``prefill`` over the same tokens."""
    from repro_torch.models.attention import encode_cross_kv

    cfg = reduced(get_config(arch))
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(cfg))
    rng = np.random.default_rng(2)
    batch = {"tokens": toks}
    if cfg.encoder_decoder:
        batch["frame_embeds"] = torch.from_numpy(rng.standard_normal((B, 10, cfg.d_model)).astype(np.float32))
    else:
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32))
    full = tm.forward_logits(cfg, params, batch, last_only=False)
    assert full.shape == (B, S, cfg.vocab_padded) and torch.isfinite(full).all()
    state = tm.init_decode_state(cfg, B, S + 1, dtype=torch.float32, device="cpu", enc_len=10)
    if cfg.encoder_decoder:
        assert tuple(state.cross_k.shape) == (cfg.n_layers, B, 10, cfg.n_kv_heads, cfg.resolved_head_dim)
        with torch.no_grad():
            enc_out = tm._encoder_stack(batch["frame_embeds"], params, cfg)
            for i, lp in enumerate(params.layers):
                k, v = encode_cross_kv(enc_out, lp.cross, cfg)
                state.cross_k[i].copy_(k)
                state.cross_v[i].copy_(v)
        want = full[:, -1, : cfg.vocab_size]
    else:
        assert state.cross_k is None
        want = tm.prefill(cfg, params, toks, S + 1, extras={"patch_embeds": batch["patch_embeds"]}
                          )[0][:, 0]
    for t in range(S):
        logits, state = tm.decode_step(cfg, params, toks[:, t:t + 1], state)
    assert state.length == S
    np.testing.assert_allclose(logits[:, 0].numpy(), want.numpy(), atol=2e-4, rtol=2e-4)
    loss, _ = tm.forward_train(cfg, params, {**batch, "labels": toks})
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in params.parameters())


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m"])
def test_hybrid_and_xlstm_families_run(arch):
    """The hybrid and xLSTM run through every entry point on the CPU (the values against
    JAX's are in tests/test_torch_ssm.py and tests/test_torch_xlstm.py):
    ``init_params``, ``forward_logits``, ``init_decode_state``,
    ``decode_step`` (its logits those of the forward's last position) and
    ``forward_train``."""
    cfg = reduced(get_config(arch))
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(cfg))
    full = tm.forward_logits(cfg, params, {"tokens": toks}, last_only=False)
    assert full.shape == (B, S, cfg.vocab_padded) and torch.isfinite(full).all()
    state = tm.init_decode_state(cfg, B, S + 1, dtype=torch.float32, device="cpu")
    for t in range(S):
        logits, state = tm.decode_step(cfg, params, toks[:, t:t + 1], state)
    assert state.length == S
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1, : cfg.vocab_size].numpy(),
                               atol=2e-4, rtol=2e-4)
    loss, _ = tm.forward_train(cfg, params, {"tokens": toks, "labels": toks})
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in params.parameters())


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_teacher_forced_forward(arch):
    """``tests/test_decode_consistency.py``'s check on the port: decoding
    token by token from an empty cache gives the logits of the
    teacher-forced forward at every position.  Capacity factor 16, so that
    neither path drops a choice (which choices drop depends on the tokens
    routed together, which differ between the two)."""
    _, tcfg, _, tp = _pair(arch, capacity_factor=16.0)
    toks = torch.from_numpy(_tokens(tcfg))
    full = tm.forward_logits(tcfg, tp, {"tokens": toks}, last_only=False)[..., : tcfg.vocab_size]
    state = tm.init_decode_state(tcfg, batch=B, max_len=S + 1, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(S):
        logits, state = tm.decode_step(tcfg, tp, toks[:, t:t + 1], state)
        outs.append(logits[:, 0])
    _close(torch.stack(outs, dim=1), full.numpy())


@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_matches_jax(arch, monkeypatch):
    """Each layer's routing in ``forward_logits``: ``top_e`` and the kept mask
    identical to the JAX package's on the same layer inputs (captured from
    the port, fed to the JAX ``_local_moe``'s own routing lines)."""
    from repro_torch.models import moe as tmoe

    jcfg, tcfg, jp, tp = _pair(arch)
    captured = []
    real = tmoe._local_moe

    def spy(x, *args, **kw):
        captured.append(x.detach().clone())
        return real(x, *args, **kw)

    monkeypatch.setattr(tmoe, "_local_moe", spy)
    with tmoe.capture_routing() as calls:
        tm.forward_logits(tcfg, tp, {"tokens": torch.from_numpy(_tokens(jcfg))})
    assert len(calls) == len(captured) == tcfg.n_layers
    k, e = jcfg.top_k, jcfg.n_experts
    for i, (x, got) in enumerate(zip(captured, calls)):
        xf = jnp.asarray(x.numpy()).reshape(-1, jcfg.d_model)
        probs = jax.nn.softmax((xf @ jp["layers"]["moe"]["router"][i]).astype(jnp.float32), -1)
        top_e = np.asarray(jax.lax.top_k(probs, k)[1])
        flat = top_e.reshape(-1)
        order = np.argsort(flat, kind="stable")
        cap = max(1, int((xf.shape[0] * k * jcfg.capacity_factor) / e + 0.999))
        sorted_e = flat[order]
        kept = np.zeros(flat.size, bool)
        kept[order] = np.arange(flat.size) - np.searchsorted(sorted_e, sorted_e) < cap
        np.testing.assert_array_equal(got["top_e"].numpy(), top_e, err_msg=f"layer {i}")
        np.testing.assert_array_equal(got["keep"].numpy(), kept.reshape(-1, k), err_msg=f"layer {i}")


def test_init_kv_cache_matches_jax():
    from repro.models.attention import init_kv_cache as jinit_kv
    from repro_torch.models.attention import init_kv_cache

    cfg = reduced(get_config("qwen2-1.5b"))
    want = jinit_kv(jreduced(jget("qwen2-1.5b")), 3, 2, 16)
    got = init_kv_cache(cfg, 3, 2, 16, device="cpu")
    for g, w in ((got.k, want.k), (got.v, want.v)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16 and not g.any()
    assert got.length == int(want.length) == 0
