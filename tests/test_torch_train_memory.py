"""The port's training step at full width on one card: its memory plan
(``repro_torch.optim.optimizers``: the clip in place, each delta added to
its parameter as it is made, an expert stack's entry updated slice by slice
along its leading axes) and the mixture-of-experts training it serves, on
the CPU.

* Adafactor on a stack of (E, d, f) entries in slices of experts, against
  ``_adafactor_leaf`` on the whole stacked leaf: the factors bit for bit,
  the update within the f32 rounding of the clip's one sum (whose order
  the slices change), and no f32 temporary larger than a slice;
* the global norm of a leaf taken in slices, against the whole leaf's;
* ``make_train_step`` (the clip in place, ``Optimizer.apply``) bit for bit
  against a step that holds the trees of scaled gradients and deltas
  (``Optimizer.update`` and ``apply_updates``), under AdamW and Adafactor,
  with one and two microbatches, with the slices forced small;
* reduced arctic-480b under its own Adafactor over three steps against the
  JAX step, at ``test_torch_training.py``'s Adafactor tolerances;
* a ``Trainer`` on reduced moonshot-v1-16b-a3b preempted and resumed, bit
  for bit against an uninterrupted one.

Weights are seeded numpy in the JAX tree's shapes (the JAX package's own
init folds Python's randomized ``hash`` into its keys).
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
from repro_torch.models.convert import opt_state_from_numpy, opt_state_to_numpy, params_from_numpy
from repro_torch.models.convert import params_to_numpy
from repro_torch.optim import optimizers as topt
from repro_torch.training import Trainer, TrainerConfig, TrainSettings, make_train_step
from repro_torch.training.trainer import state_tensors

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
STEP_KW = dict(total_steps=50, warmup_steps=2, learning_rate=1e-3)


# ---------------------------------------------------------------------------
# Adafactor in slices
# ---------------------------------------------------------------------------

#: one layer's expert stack: 5 experts of (6, 10), 2 layers
LEAD, ENTRY = 2, (5, 6, 10)


def _experts(rng, dtype=torch.float32):
    scale = lambda n: (1 + n) ** 2  # noqa: E731
    return {f"layers.{i}.moe.wg": torch.from_numpy(
        (scale(i) * rng.standard_normal(ENTRY)).astype(np.float32)).to(dtype) for i in range(LEAD)}


@pytest.fixture
def two_experts_a_slice(monkeypatch):
    """Slices of 2 of the 5 experts (3 slices an entry)."""
    monkeypatch.setattr(topt, "SLICE_BYTES", 2 * 4 * ENTRY[1] * ENTRY[2])
    assert len(topt._entry_slices(ENTRY)) == 3


def test_sliced_entries_match_the_stacked_leaf(two_experts_a_slice):
    """Three steps of ``adafactor_update`` on the stack, each entry in 3
    slices of experts, against ``_adafactor_leaf`` on the (L, E, d, f) leaf:
    the factors bit for bit (each expert's are its own), each delta within
    the f32 rounding of the clip's sum of ``update²``, whose order the
    slices change (rtol 1e-6)."""
    rng = np.random.default_rng(7)
    params = _experts(rng)
    state = topt.adafactor_init(params)
    nu = state.nu["layers.moe.wg"]
    assert [tuple(x.shape) for x in nu] == [(LEAD, 5, 6), (LEAD, 5, 10)]
    for step in range(3):
        grads = {k: v * 10.0 ** (step - 1) for k, v in _experts(rng).items()}
        lr = torch.tensor(np.float32(1e-3))
        delta, new = topt.adafactor_update(grads, state, params, lr)
        beta = 1.0 - (new.step.to(torch.float32) + 1.0) ** (-0.8)
        stacked = torch.stack(list(grads.values()))
        want_nu, update = topt._adafactor_leaf(stacked, nu, beta, 1e-30, 1.0)
        for got, want in zip(new.nu["layers.moe.wg"], want_nu):
            assert torch.equal(got, want), step
        for n, (k, d) in enumerate(delta.items()):
            np.testing.assert_allclose(d.numpy(), (-lr * update[n]).numpy(), rtol=1e-6, atol=0,
                                       err_msg=f"step {step} {k}")
        state, nu = new, new.nu["layers.moe.wg"]


def test_apply_in_slices_equals_update(two_experts_a_slice):
    """``adafactor_apply`` (each slice's delta added as made, weight decay
    on) gives the parameters of ``adafactor_update`` + ``apply_updates``,
    bit for bit, in bf16 and f32."""
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(8)
        params = _experts(rng, dtype)
        grads = _experts(rng, dtype)
        state = topt.adafactor_init(params)
        lr = torch.tensor(np.float32(1e-2))
        delta, want_state = topt.adafactor_update(grads, state, params, lr, weight_decay=0.1)
        want = topt.apply_updates({k: v.clone() for k, v in params.items()}, delta)
        got_state = topt.adafactor_apply(grads, state, params, lr, weight_decay=0.1)
        for k in want:
            assert torch.equal(params[k], want[k]), (dtype, k)
        for a, b in zip(got_state.nu["layers.moe.wg"], want_state.nu["layers.moe.wg"]):
            assert torch.equal(a, b), dtype


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


def test_no_f32_temporary_spans_a_slice(two_experts_a_slice):
    """bf16 experts (arctic-480b's parameters): no op of the norm, the clip
    or the in-place update returns an f32 tensor larger than one slice of 2
    experts (an entry holds 5)."""
    rng = np.random.default_rng(9)
    params = _experts(rng, torch.bfloat16)
    grads = _experts(rng, torch.bfloat16)
    state = topt.adafactor_init(params)
    with _F32Sizes() as mode:
        _, norm = topt.clip_by_global_norm(grads, 1.0)
        topt.adafactor_apply(grads, state, params, torch.tensor(1e-3), weight_decay=0.1)
    slice_ = 2 * ENTRY[1] * ENTRY[2]
    assert mode.sizes and max(mode.sizes) == slice_ < ENTRY[0] * ENTRY[1] * ENTRY[2]
    assert all(p.dtype == torch.bfloat16 for p in params.values()) and bool(torch.isfinite(norm))


def test_sliced_global_norm_matches_the_whole_leaf(two_experts_a_slice):
    """A leaf over ``SLICE_BYTES`` is summed in slices along its leading
    axis: the norm within the rounding of the sum's order; a small leaf
    keeps the whole sum's bits."""
    rng = np.random.default_rng(10)
    big = torch.from_numpy(rng.standard_normal((7, 6, 10)).astype(np.float32))
    small = torch.from_numpy(rng.standard_normal((6, 10)).astype(np.float32))
    whole = lambda x: torch.sqrt(torch.sum(torch.square(x)))  # noqa: E731
    assert torch.equal(topt.global_norm({"a": small}), whole(small))
    assert len(torch.split(big, topt._rows_per_slice(big.shape))) == 4
    np.testing.assert_allclose(float(topt.global_norm({"a": big})), float(whole(big)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the step in place against the step that holds its trees
# ---------------------------------------------------------------------------


def _held_tree_step(cfg, settings, optimizer):
    """``make_train_step`` as it was before the memory plan: the clipped
    gradients a new tree (``g * scale``), the deltas a tree
    (``Optimizer.update``) added by ``apply_updates``."""
    schedule = topt.cosine_schedule(settings.learning_rate, settings.warmup_steps,
                                    settings.total_steps)
    n_mb = settings.microbatches

    def grads_of(params, batch):
        loss, _ = tm.forward_train(cfg, params, batch)
        names, leaves = zip(*params.named_parameters())
        return dict(zip(names, torch.autograd.grad(loss, leaves)))

    def step(params, opt_state, batch):
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        if n_mb == 1:
            grads = grads_of(params, batch)
        else:
            rows = next(iter(batch.values())).shape[0] // n_mb
            acc = {n: torch.zeros(p.shape, dtype=torch.float32) for n, p in params.named_parameters()}
            for i in range(n_mb):
                g = grads_of(params, {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()})
                acc = {n: a + g[n].to(torch.float32) for n, a in acc.items()}
            grads = {n: (a / n_mb).to(torch.float32) for n, a in acc.items()}
        norm = topt.global_norm(grads)
        scale = torch.clamp(settings.clip_norm / (norm + 1e-9), max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
        lr = schedule(opt_state.step)
        with torch.no_grad():
            pdict = dict(params.named_parameters())
            delta, opt_state = optimizer.update(grads, opt_state, pdict, lr)
            topt.apply_updates(pdict, delta)
        return params, opt_state

    return step


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_step_in_place_equals_the_held_trees(monkeypatch, optimizer, microbatches):
    """Reduced arctic-480b (bf16 parameters and compute, its dense residual and 8
    experts), slices of 200,000 bytes (every expert entry in 8 slices of one
    expert, the embedding's norm in 2): three steps of ``make_train_step``
    against ``_held_tree_step`` from the same state, every parameter and
    moment bit for bit."""
    monkeypatch.setattr(topt, "SLICE_BYTES", 200_000)
    assert len(topt._entry_slices((8, 128, 256))) == 8 and topt._rows_per_slice((512, 128)) == 390
    cfg = reduced(get_config("arctic-480b"), optimizer=optimizer, params_dtype="bfloat16", dtype="bfloat16",
                  attention_impl="flash", remat="full")
    settings = TrainSettings(microbatches=microbatches, accum_dtype="float32", **STEP_KW)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                                         seed=11))
    runs = []
    for make in (make_train_step, _held_tree_step):
        params = tm.init_params(cfg, torch.Generator().manual_seed(12), device="cpu")
        opt = topt.make_optimizer(optimizer, weight_decay=settings.weight_decay)
        state = opt.init(dict(params.named_parameters()))
        step = make(cfg, settings, opt)
        for i in range(3):
            params, state = step(params, state, data.batch_at(i))[:2]
        runs.append(state_tensors(params, state))
    got, want = runs
    assert sorted(got) == sorted(want)
    assert any(k.startswith("opt.nu.") and ".moe.wg" in k for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# reduced arctic-480b under Adafactor against the JAX step
# ---------------------------------------------------------------------------


def _np_params(jcfg, seed=0):
    """Seeded numpy values in the shapes of the JAX parameter tree: embed
    std 0.02, norms 0.1, biases 0.02, matrices 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(0)))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        std = (0.02 if "embed" in name or "'b" in name else 0.1 if "norm" in name
               else 1.0 / np.sqrt(s.shape[-2]))
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _leaves_close(got_tree, want_tree, what, **tol):
    assert jax.tree.structure(got_tree) == jax.tree.structure(want_tree), what
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got_tree),
                            jax.tree.leaves(want_tree)):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}", **tol)


def test_arctic_adafactor_train_step_matches_jax_over_three_steps():
    """Reduced arctic-480b (4 layers, 8 experts top-2, the dense residual)
    in f32 under its own Adafactor: loss, ``aux_loss``, gradient norm and
    learning rate within 1e-4 each step; each parameter's move at rtol 1e-5
    with atol 5e-3 x lr and in norm within 1e-3 of the leaf's move; the
    factors at rtol 1e-5 with atol 1e-5 of the leaf's largest value (the
    tolerances of ``test_adafactor_train_step_matches_jax_over_three_steps``
    and their reasons).  The expert stacks' factors are (L, E, d) and
    (L, E, f): per layer and expert."""
    settings = dict(STEP_KW, weight_decay=0.01)
    jcfg = jreduced(jget("arctic-480b"))
    tcfg = reduced(get_config("arctic-480b"))
    assert jcfg.optimizer == tcfg.optimizer == "adafactor" and tcfg.moe_dense_residual
    tree = _np_params(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, device="cpu")
    data = JData(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4, seed=3))
    jstep = jax.jit(jmake_step(jcfg, JSettings(**settings)))
    tstep = make_train_step(tcfg, TrainSettings(**settings))
    js = jopt.adafactor_init(jp)
    ts = opt_state_from_numpy(tcfg, jax.tree.map(np.asarray, js), device="cpu")
    moved = 0.0
    for i in range(3):
        batch = data.batch_at(i)
        jbefore, tbefore = jax.tree.map(np.array, jp), jax.tree.map(np.array, params_to_numpy(tp))
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, ts, tmet = tstep(tp, ts, batch)
        for key in ("loss", "lm_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), **TOL, err_msg=key)
        np.testing.assert_allclose(float(tmet["aux_loss"]), float(jmet["aux_loss"]), atol=1e-6,
                                   rtol=0)
        assert float(tmet["aux_loss"]) > 0
        lr = float(jmet["lr"])
        moved += lr
        jd = jax.tree.map(lambda a, b: np.asarray(a) - b, jp, jbefore)
        td = jax.tree.map(lambda a, b: np.asarray(a) - b, params_to_numpy(tp), tbefore)
        _leaves_close(td, jd, f"step {i} move", atol=5e-3 * lr, rtol=1e-5)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(td), jax.tree.leaves(jd)):
            assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w), (i, jax.tree_util.keystr(path))
        back = opt_state_to_numpy(ts)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(back.nu),
                                jax.tree.leaves(jax.tree.map(np.asarray, js.nu))):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()),
                                       err_msg=f"step {i} nu {jax.tree_util.keystr(path)}")
    assert moved > 0 and int(back.step) == int(js.step) == 3 and back.mu is None
    row, col = back.nu["layers"]["moe"]["wg"]
    assert row.shape == (jcfg.n_layers, jcfg.n_experts, jcfg.d_model)
    assert col.shape == (jcfg.n_layers, jcfg.n_experts, jcfg.d_ff)


# ---------------------------------------------------------------------------
# preempt → checkpoint → resume on reduced moonshot
# ---------------------------------------------------------------------------


def _moe_trainer(tmpdir):
    cfg = dataclasses.replace(reduced(get_config("moonshot-v1-16b-a3b")),
                              attention_impl="flash", remat="full")
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                                         seed=13))
    return Trainer(cfg, TrainSettings(**STEP_KW),
                   TrainerConfig(ckpt_dir=str(tmpdir), ckpt_every=1000, log_every=1, seed=14),
                   data=data, device="cpu")


def test_moe_trainer_preempt_resume_is_bit_exact(tmp_path):
    """AdamW on reduced moonshot-v1-16b-a3b (8 experts top-2): 4 steps
    uninterrupted against 2, a drain and a fresh ``Trainer`` restoring and
    taking 2 more; every parameter and moment bitwise equal, the experts'
    among them."""
    ref = _moe_trainer(tmp_path / "ref")
    ref.run(4)
    first = _moe_trainer(tmp_path / "pre")
    first.run(2)
    assert first.on_preempt(now=0.0, deadline=60.0).value == "drained"
    second = _moe_trainer(tmp_path / "pre")
    second.init_or_restore()
    assert second.step == 2
    second.run(until_step=4)
    want = state_tensors(ref.params, ref.opt_state)
    got = state_tensors(second.params, second.opt_state)
    assert sorted(want) == sorted(got)
    assert {"params.layers.0.moe.wg", "opt.mu.layers.1.moe.router", "opt.nu.layers.0.moe.wd"} <= set(want)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert all(h["aux_loss"] > 0 for h in ref.history)
