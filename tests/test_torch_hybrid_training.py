"""Training the Mamba2 hybrid and xLSTM with the port, against the JAX
package on the CPU.

* Adafactor (``repro_torch.optim``) over trees shaped as the hybrid's
  (``mamba_groups`` (groups, every, ...) with 1-D and 2-D leaves,
  ``mamba_tail`` (tail, ...), the shared block's leaves) and as xLSTM's
  (``layers.mlstm_<i>``, ``layers.slstm_<i>``: whole leaves) against
  ``repro.optim`` over three steps, deltas and second moments;
* the stacked leaves' entry-by-entry update against the whole-stack one,
  and no f32 temporary as large as a stack;
* ``opt_state_from_numpy`` / ``opt_state_to_numpy`` exact both ways for
  reduced zamba2-7b and xlstm-125m, under both optimizers;
* ``make_train_step`` on reduced zamba2-7b (head_dim 32 and 112) and
  reduced xlstm-125m, flash attention, against the JAX ``make_train_step``
  over three steps under Adafactor and AdamW;
* a ``Trainer`` on the reduced hybrid under Adafactor, preempted and
  resumed, bitwise equal to an uninterrupted one.

Trees and weights come from seeded numpy (JAX's init folds Python's
randomized ``hash`` into its keys).  Tolerances:

* the optimizers alone, rtol 2e-6 and atol 1e-9: a few f32 ulps, as
  ``tests/test_torch_optim.py`` (XLA and PyTorch evaluate ``b ** step``,
  ``sqrt`` and the means with their own routines), and the port adds a
  stack's ``update²`` entry by entry where XLA sums the whole leaf at once:
  the RMS clip's one sum in another order moves each delta by a few ulps;
* the entry-by-entry update against the whole-stack one in PyTorch: the
  factors equal (the same operations on the same values), the deltas rtol
  1e-6 (that one sum's order);
* the train steps, as ``tests/test_torch_training.py``'s: loss and gradient
  norm 1e-4 (f32 in another summation order); Adafactor's moves rtol 1e-5
  with atol 5e-3 x lr; its factors rtol 2e-4 with atol 1e-5 of the leaf's
  largest value: a factor is a mean of g², so it carries twice the
  gradient's relative error, and the model tests hold these families'
  gradients to 1e-4 (``tests/test_torch_ssm.py``, ``test_torch_xlstm.py``;
  xlstm-125m's embedding row factor of one token reads 7.9e-5 here, where
  qwen2-1.5b's read 2.4e-6); AdamW's parameters within 2x the summed learning rates
  (a first move is about +-lr whatever the gradient's size) and its first
  moment atol 1e-4, rtol 1e-3.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget, reduced as jreduced
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticLMDataset as JData
from repro.models import model as jm
from repro.optim import optimizers as jopt
from repro.training import TrainSettings as JSettings, make_train_step as jmake_step
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import model as tm
from repro_torch.models.convert import (
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.optim import optimizers as topt
from repro_torch.training import Trainer, TrainerConfig, TrainSettings, make_train_step
from repro_torch.training.trainer import state_tensors

torch.set_num_threads(1)
OPT_TOL = dict(rtol=2e-6, atol=1e-9)
TOL = dict(atol=1e-4, rtol=1e-4)

# ---------------------------------------------------------------------------
# Adafactor over the JAX trees' stacks
# ---------------------------------------------------------------------------

#: a hybrid-shaped tree: 2 groups of 3 Mamba layers, a tail of 2, the shared
#: block, with 1-D (norm, a_log, d_skip) and 2-D or deeper leaves
HYBRID = {"embed": (12, 8), "final_norm": (8,),
          "mamba_groups": {"in_proj": (2, 3, 8, 20), "conv_w": (2, 3, 4, 6), "norm": (2, 3, 8),
                           "a_log": (2, 3, 4), "d_skip": (2, 3, 4)},
          "mamba_tail": {"in_proj": (2, 8, 20), "norm": (2, 8), "d_skip": (2, 4)},
          "shared": {"attn_norm": (8,), "attn": {"wq": (8, 16), "wo": (16, 8)},
                     "mlp": {"wg": (8, 12)}}}
#: an xLSTM-shaped tree: its blocks are whole leaves (the JAX tree is not
#: stacked), an sLSTM recurrent leaf 3-D
XLSTM = {"embed": (12, 8), "final_norm": (8,),
         "layers": {"mlstm_0": {"w_up": (8, 24), "norm": (8,), "b_if": (4,)},
                    "mlstm_1": {"w_up": (8, 24), "norm": (8,), "b_if": (4,)},
                    "slstm_2": {"r_z": (2, 4, 4), "w_in": (8, 16), "b": (8,)}}}
#: the stacked subtrees of each tree and their depth
STACKED = {"hybrid": {"mamba_groups": 2, "mamba_tail": 1}, "xlstm": {}}
TREES = {"hybrid": HYBRID, "xlstm": XLSTM}


def _draw(shapes, rng, scale, stacked):
    """Seeded values in the tree's shapes; every entry of a stack gets its
    own scale, so that a clip over one entry alone would not pass."""
    def leaf(shape, depth):
        a = scale * rng.standard_normal(shape)
        if depth:
            lead = shape[:depth]
            entry_scale = (1.0 + np.arange(int(np.prod(lead)))) ** 2
            a *= entry_scale.reshape(lead + (1,) * (len(shape) - depth))
        return a.astype(np.float32)

    def walk(node, depth):
        return {k: walk(v, stacked.get(k, depth)) if isinstance(v, dict) else leaf(v, depth)
                for k, v in node.items()}

    return walk(shapes, 0)


def _flat(tree, stacked, prefix="", depth=0):
    """A nested numpy tree as the port's flat names: a stacked leaf split
    into its entries, ``<prefix>.<i>[.<j>].<rest>``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            sub = _flat(v, stacked, f"{name}.", stacked.get(k, depth))
            for n, a in sub.items():
                out[n] = a
            continue
        if not depth:
            out[name] = np.asarray(v)
            continue
        head, _, rest = name.partition(".")
        for index in np.ndindex(*np.shape(v)[:depth]):
            out[".".join((head, *map(str, index), rest))] = np.asarray(v)[index]
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _t(flat):
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close_nu(got, want, what):
    """The port's nu (keyed by stacked leaf) against the JAX nu tree."""
    want = dict(_leaves(want))
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        pairs = zip(g, w) if isinstance(w, tuple) else [(g, w)]
        assert isinstance(g, tuple) == isinstance(w, tuple), (what, k)
        for a, b in pairs:
            assert tuple(a.shape) == np.shape(b), (what, k)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("kind", ["hybrid", "xlstm"])
def test_adafactor_matches_jax_over_three_steps(kind):
    """Deltas and second moments at every step, weight decay on; the
    stacked leaves' factors keyed by the stack (``mamba_groups.norm`` is
    factored over (every, d) in each group, ``mamba_tail.norm`` over
    (tail, d)), xLSTM's blocks leaf by leaf."""
    shapes, stacked = TREES[kind], STACKED[kind]
    rng = np.random.default_rng(11)
    params = _draw(shapes, rng, 1.0, stacked)
    jo, to = (m.make_optimizer("adafactor", weight_decay=0.01) for m in (jopt, topt))
    jp, tp = _j(params), _t(_flat(params, stacked))
    js, ts = jo.init(jp), to.init(tp)
    _close_nu(ts.nu, js.nu, "init")
    for step in range(3):
        grads = _draw(shapes, rng, 10.0 ** (step - 1), stacked)
        lr = np.float32(1e-3 * (step + 1))
        jd, js = jo.update(_j(grads), js, jp, jnp.asarray(lr))
        td, ts = to.update(_t(_flat(grads, stacked)), ts, tp, torch.tensor(lr))
        want = _flat(jax.tree.map(np.asarray, jd), stacked)
        assert sorted(td) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(td[k].numpy(), w, **OPT_TOL, err_msg=f"step {step} {k}")
        _close_nu(ts.nu, jax.tree.map(np.asarray, js.nu), f"step {step}")
        assert int(ts.step) == int(js.step) == step + 1
        jp = jopt.apply_updates(jp, jd)
        tp = topt.apply_updates(tp, td)
    if kind == "hybrid":
        assert [tuple(x.shape) for x in ts.nu["mamba_groups.norm"]] == [(2, 3), (2, 8)]
        assert [tuple(x.shape) for x in ts.nu["mamba_tail.norm"]] == [(2,), (8,)]
        assert [tuple(x.shape) for x in ts.nu["mamba_groups.in_proj"]] == [(2, 3, 8), (2, 3, 20)]
    else:
        assert [tuple(x.shape) for x in ts.nu["layers.slstm_2.r_z"]] == [(2, 4), (2, 4)]


def _one_stack(rng, lead=(2, 3), entry=(6, 10)):
    names = [f"mamba_groups.{g}.{i}.w" for g in range(lead[0]) for i in range(lead[1])]
    scale = lambda n: (1 + n) ** 2  # noqa: E731
    return {name: torch.from_numpy((scale(n) * rng.standard_normal(entry)).astype(np.float32))
            for n, name in enumerate(names)}


def test_entry_by_entry_update_matches_the_stacked_leaf():
    """``adafactor_update`` on a stack of 2-D entries, entry by entry,
    against ``_adafactor_leaf`` on the whole stacked leaf, three steps: the
    same factors, the deltas within the order of the clip's one sum."""
    rng = np.random.default_rng(3)
    params = _one_stack(rng)
    state = topt.adafactor_init(params)
    nu = state.nu["mamba_groups.w"]
    assert [tuple(x.shape) for x in nu] == [(2, 3, 6), (2, 3, 10)]
    for step in range(3):
        grads = {k: v * 10.0 ** (step - 1) for k, v in _one_stack(rng).items()}
        lr = torch.tensor(np.float32(1e-3))
        delta, new = topt.adafactor_update(grads, state, params, lr)
        beta = 1.0 - (new.step.to(torch.float32) + 1.0) ** (-0.8)
        stacked = torch.stack(list(grads.values())).reshape(2, 3, 6, 10)
        want_nu, update = topt._adafactor_leaf(stacked, nu, beta, 1e-30, 1.0)
        for got, want in zip(new.nu["mamba_groups.w"], want_nu):
            assert torch.equal(got, want), step
        for n, (k, d) in enumerate(delta.items()):
            np.testing.assert_allclose(d.numpy(), (-lr * update.reshape(6, 6, 10)[n]).numpy(),
                                       rtol=1e-6, atol=0, err_msg=f"step {step} {k}")
        state, nu = new, new.nu["mamba_groups.w"]


class _F32Sizes(TorchDispatchMode):
    """The element count of every f32 tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.sizes.append(t.numel())
        return out


def test_no_f32_temporary_spans_a_stack():
    """A stack of 2-D entries in bf16 (zamba2-7b's parameters at full
    width): no op of the update returns an f32 tensor larger than one entry
    (the whole stack holds 6x as many values)."""
    rng = np.random.default_rng(4)
    params = {k: v.to(torch.bfloat16) for k, v in _one_stack(rng, entry=(16, 32)).items()}
    grads = {k: v.to(torch.bfloat16) for k, v in _one_stack(rng, entry=(16, 32)).items()}
    state = topt.adafactor_init(params)
    with _F32Sizes() as mode:
        delta, _ = topt.adafactor_update(grads, state, params, torch.tensor(1e-3))
    assert all(d.dtype == torch.bfloat16 for d in delta.values())
    assert mode.sizes and max(mode.sizes) == 16 * 32 < 6 * 16 * 32


@pytest.mark.parametrize("name", ["mamba_groups.0.norm", "shared.0.w", "layers.0.1.w",
                                  "layers.0"])
def test_adafactor_refuses_a_name_it_cannot_place(name):
    with pytest.raises(ValueError, match="cannot|neither"):
        topt.adafactor_init({name: torch.zeros(4)})


def test_adafactor_refuses_a_ragged_stack():
    with pytest.raises(ValueError, match="full grid"):
        topt.adafactor_init({"mamba_tail.0.w": torch.zeros(4), "mamba_tail.2.w": torch.zeros(4)})


# ---------------------------------------------------------------------------
# reduced models: weights, the opt-state round trip, the train step
# ---------------------------------------------------------------------------


def _np_tree(jcfg, seed=0):
    """Seeded numpy values in the shapes of the JAX parameter tree: the
    SSM's A and dt bias from the ranges of its init, the sLSTM's recurrent
    matrices 0.3 / sqrt(heads); embed std 0.02, norms 0.1, biases 0.02;
    matrices 1/sqrt(fan-in)."""
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
               else 0.1 if "norm" in name
               else 0.3 / np.sqrt(s.shape[0]) if "'r_" in name
               else 1.0 / np.sqrt(s.shape[-2]))
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


MODELS = {"zamba2-7b": ("zamba2-7b", {}), "zamba2-7b hd 112": ("zamba2-7b", {"head_dim": 112}),
          "xlstm-125m": ("xlstm-125m", {})}


def _pair(model, **overrides):
    """(JAX cfg, port cfg, JAX params, port params) at reduced width."""
    arch, over = MODELS[model]
    over = dict(over, **overrides)
    jcfg, tcfg = jreduced(jget(arch), **over), reduced(get_config(arch), **over)
    tree = _np_tree(jcfg)
    return jcfg, tcfg, _j(tree), params_from_numpy(tcfg, tree, device="cpu")


@pytest.mark.parametrize("optimizer", ["adafactor", "adamw"])
@pytest.mark.parametrize("model", ["zamba2-7b", "xlstm-125m"])
def test_opt_state_round_trip_is_exact(model, optimizer):
    """The JAX state with random values → the port's → back, equal leaf for
    leaf in value and type; the port's own init has the converted state's
    keys and shapes."""
    jcfg, tcfg, jp, tp = _pair(model)
    rng = np.random.default_rng(6)
    init = jax.tree.map(np.asarray, (jopt.adafactor_init if optimizer == "adafactor"
                                     else jopt.adamw_init)(jp))
    rand = lambda t: jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), t)  # noqa: E731
    st = jopt.OptState(step=np.asarray(4, np.int32), mu=None if init.mu is None else rand(init.mu),
                       nu=rand(init.nu))
    port = opt_state_from_numpy(tcfg, st, device="cpu")
    own = topt.make_optimizer(optimizer).init(dict(tp.named_parameters()))
    for part in ("mu", "nu"):
        got, mine = getattr(port, part), getattr(own, part)
        if mine is None:
            assert got is None
            continue
        assert sorted(got) == sorted(mine), part
        for key, t in mine.items():
            shape = lambda x: [tuple(y.shape) for y in x] if isinstance(x, tuple) else tuple(x.shape)  # noqa: E731
            assert shape(got[key]) == shape(t), (part, key)
    back = opt_state_to_numpy(port)
    assert int(back.step) == 4 and back.step.dtype == np.int32
    assert jax.tree.structure((back.mu, back.nu)) == jax.tree.structure((st.mu, st.nu))
    for a, b in zip(jax.tree.leaves((st.mu, st.nu)), jax.tree.leaves((back.mu, back.nu))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


STEP_KW = dict(total_steps=50, warmup_steps=2, learning_rate=1e-3, weight_decay=0.01)


#: a gradient that is zero in exact arithmetic holds f32 rounding noise (the
#: sLSTM's input-gate bias b_i: its stabilized exponential gate cancels a
#: shift of the bias; up to 3.5e-10, tests/test_torch_xlstm.py)
NOISE = 1e-8


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _noise_leaves(nu):
    """The parameters whose gradient is rounding noise on the JAX side:
    every second-moment value (or factor) under NOISE²."""
    out = set()
    for path, v in jax.tree_util.tree_leaves_with_path(nu):
        if float(np.max(np.asarray(v))) < NOISE ** 2:
            out.add(jax.tree_util.keystr(path[:-1] if isinstance(path[-1], jax.tree_util.SequenceKey)
                                         else path))
    return out


def _close_except(got, want, what, noise, lr, **tol):
    """Leaf by leaf within ``tol``; a leaf in ``noise`` (a parameter whose
    gradient is rounding noise) only finite and within 2 x lr x sqrt(its
    size) of ``want`` elementwise: the RMS clip lets no element of an
    update pass sqrt(size)."""
    got, want = _by_path(got), _by_path(want)
    assert sorted(got) == sorted(want), what
    for key, w in want.items():
        if any(key.startswith(n) for n in noise):
            assert np.isfinite(got[key]).all(), (what, key)
            assert np.abs(got[key] - w).max() <= 2 * lr * np.sqrt(w.size), (what, key)
            continue
        np.testing.assert_allclose(got[key], w, err_msg=f"{what} {key}", **tol)


@pytest.mark.parametrize("optimizer", ["adafactor", "adamw"])
@pytest.mark.parametrize("model", list(MODELS))
def test_train_step_matches_jax_over_three_steps(model, optimizer):
    """Three ``make_train_step`` steps, flash attention (the JAX side's
    Pallas kernel in interpret mode, the port's plain version), from the
    same weights and batches: loss, gradient norm and learning rate every
    step; Adafactor's parameter moves and factors every step, AdamW's
    parameters and first moment at the end.  Adafactor divides a gradient
    by its own RMS, so a parameter whose gradient is rounding noise (zero in
    exact arithmetic: xlstm-125m's sLSTM b_i) moves by normalized noise, a
    sign apart on the two sides: such a leaf (the JAX side's second moment
    under NOISE² everywhere) must have the port's second moment under NOISE²
    too, and its move is held within 2 x lr x sqrt(size) (the clip's bound
    on one element, either way) instead of elementwise."""
    jcfg, tcfg, jp, tp = _pair(model, optimizer=optimizer, attention_impl="flash")
    data = JData(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4, seed=3))
    jstep = jax.jit(jmake_step(jcfg, JSettings(**STEP_KW)))
    tstep = make_train_step(tcfg, TrainSettings(**STEP_KW))
    js = (jopt.adafactor_init if optimizer == "adafactor" else jopt.adamw_init)(jp)
    ts = opt_state_from_numpy(tcfg, jax.tree.map(np.asarray, js), device="cpu")
    lrs, noise = 0.0, set()
    for i in range(3):
        batch = data.batch_at(i)
        # copies: params_to_numpy's arrays share the parameters' memory
        jbefore, tbefore = (jax.tree.map(np.array, t) for t in (jp, params_to_numpy(tp)))
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, ts, tmet = tstep(tp, ts, batch)
        for key in ("loss", "lm_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), **TOL,
                                       err_msg=f"step {i} {key}")
        lr = float(jmet["lr"])
        lrs += lr
        if optimizer != "adafactor":
            continue
        jnu, back = jax.tree.map(np.asarray, js.nu), opt_state_to_numpy(ts)
        noise |= _noise_leaves(jnu)
        for key, v in _by_path(back.nu).items():
            if any(key.startswith(n) for n in noise):
                assert float(np.max(v)) < NOISE ** 2, (i, key)
        jd = jax.tree.map(lambda a, b: np.asarray(a) - b, jp, jbefore)
        td = jax.tree.map(lambda a, b: np.asarray(a) - b, params_to_numpy(tp), tbefore)
        _close_except(td, jd, f"step {i} move", noise, lr, atol=5e-3 * lr, rtol=1e-5)
        for key, w in _by_path(jnu).items():
            if not any(key.startswith(n) for n in noise):
                np.testing.assert_allclose(_by_path(back.nu)[key], w, rtol=2e-4,
                                           atol=1e-5 * float(np.abs(w).max()),
                                           err_msg=f"step {i} nu {key}")
    assert int(opt_state_to_numpy(ts).step) == int(js.step) == 3
    assert noise == (set() if model != "xlstm-125m" or optimizer != "adafactor" else
                     {"['layers']['slstm_3']['b_i']"}), noise
    if optimizer == "adafactor":
        _close_except(params_to_numpy(tp), jp, "params", noise, lrs, atol=5e-3 * lrs, rtol=1e-5)
    else:
        _close_except(params_to_numpy(tp), jp, "params", set(), 0, atol=2 * lrs, rtol=0)
        _close_except(opt_state_to_numpy(ts).mu, js.mu, "mu", set(), 0, atol=1e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# preempt → checkpoint → resume on the reduced hybrid
# ---------------------------------------------------------------------------


def _trainer(tmpdir):
    cfg = dataclasses.replace(reduced(get_config("zamba2-7b")), optimizer="adafactor",
                              attention_impl="flash", remat="full")
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                                         seed=2))
    return Trainer(cfg, TrainSettings(total_steps=50, warmup_steps=2, learning_rate=1e-3),
                   TrainerConfig(ckpt_dir=str(tmpdir), ckpt_every=1000, log_every=1, seed=5),
                   data=data, device="cpu")


def test_hybrid_trainer_preempt_resume_is_bit_exact(tmp_path):
    """Adafactor on reduced zamba2-7b: 4 steps uninterrupted against 2, a
    drain, and a fresh ``Trainer`` restoring and taking 2 more; every
    parameter and factor bitwise equal, the stacks' factors among them."""
    ref = _trainer(tmp_path / "ref")
    ref.run(4)
    first = _trainer(tmp_path / "pre")
    first.run(2)
    assert first.on_preempt(now=0.0, deadline=60.0).value == "drained"
    second = _trainer(tmp_path / "pre")
    second.init_or_restore()
    assert second.step == 2
    second.run(until_step=4)
    want = state_tensors(ref.params, ref.opt_state)
    got = state_tensors(second.params, second.opt_state)
    assert sorted(want) == sorted(got)
    assert {"opt.nu.mamba_groups.in_proj.row", "opt.nu.mamba_tail.norm.col",
            "opt.nu.shared.attn.wq.row"} <= set(want)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert len(tm.stacks(ref.cfg)) == 2
