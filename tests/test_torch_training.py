"""The port's training path (``repro_torch.models.model.forward_train``,
``repro_torch.training``, ``repro_torch.checkpoint``) against the JAX
package, on the CPU.

* ``forward_train``'s loss and every gradient against
  ``jax.value_and_grad(forward_train)``, reduced qwen2-1.5b and gemma-2b in
  f32 (the JAX flash path runs the Pallas kernel in interpret mode):
  atol = rtol = 1e-4, f32 with another summation order, as the model tests;
* ``remat="full"`` gives the gradients of ``"none"``, bit for bit;
* ``make_train_step`` over 3 steps against the JAX step (loss and gradient
  norm within 1e-4), with microbatches and int8 compression too;
* the checkpoint round trip (mirroring ``tests/test_checkpoint.py``) and
  the three tests of ``tests/test_e2e_preemption.py`` on the port's
  ``Trainer``.

Weights are drawn with seeded numpy (the shapes of the JAX package's
``init_params``, whose own values vary with Python's hash seed), tokens come
from seeded numpy or the shared synthetic stream, and both sides get the
same values.
"""
from __future__ import annotations

import dataclasses
import os

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
from repro_torch.checkpoint import Checkpointer, checkpointer as tck
from repro_torch.configs import get_config, reduced
from repro_torch.core.preemption import PreemptAck, PreemptionController
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import model as tm
from repro_torch.models.convert import (
    _tree_from_flat,
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.training import Trainer, TrainerConfig, TrainSettings, make_train_step

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


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


def _pair(arch, **overrides):
    """(JAX cfg, port cfg, JAX params, port params) at reduced width."""
    jcfg = jreduced(jget(arch), **overrides)
    tcfg = reduced(get_config(arch), **overrides)
    tree = _np_params(jcfg)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, device="cpu")


def _batch(cfg, seed=1, b=2, s=16):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _leaves_close(got_tree, want_tree, what, **tol):
    assert jax.tree.structure(got_tree) == jax.tree.structure(want_tree), what
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got_tree),
                            jax.tree.leaves(want_tree)):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}", **(tol or TOL))


# ---------------------------------------------------------------------------
# forward_train and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,impl", [("qwen2-1.5b", "reference"), ("gemma-2b", "reference"),
                                       ("qwen2-1.5b", "flash")])
def test_forward_train_loss_and_grads_match_jax(arch, impl):
    jcfg, tcfg, jp, tp = _pair(arch, attention_impl=impl)
    batch = _batch(jcfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.forward_train(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    loss, met = tm.forward_train(tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    names, leaves = zip(*tp.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    np.testing.assert_allclose(float(met["lm_loss"]), float(jmet["lm_loss"]), **TOL)
    assert float(met["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    _leaves_close(_tree_from_flat(dict(zip(names, grads))), jgrads, f"{arch} {impl} grad")


def test_remat_full_gives_the_gradients_of_none():
    grads = {}
    for remat in ("none", "full"):
        _, cfg, _, tp = _pair("qwen2-1.5b", remat=remat, attention_impl="flash")
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=2).items()}
        loss, _ = tm.forward_train(cfg, tp, batch)
        grads[remat] = (loss, torch.autograd.grad(loss, list(tp.parameters())))
    assert torch.equal(grads["none"][0], grads["full"][0])
    for a, b in zip(grads["none"][1], grads["full"][1]):
        assert torch.equal(a, b)


def test_remat_dots_is_not_ported():
    _, cfg, _, tp = _pair("qwen2-1.5b", remat="dots")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.forward_train(cfg, tp, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})


def test_bf16_compute_reaches_the_f32_master_weights():
    """The differentiable cast: bf16 compute, f32 gradients on every leaf."""
    _, cfg, _, tp = _pair("qwen2-1.5b", dtype="bfloat16")
    loss, _ = tm.forward_train(cfg, tp, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
    grads = torch.autograd.grad(loss, list(tp.parameters()))
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)
    assert all(float(g.abs().sum()) > 0 for g in grads)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEP_KW = dict(total_steps=50, warmup_steps=2, learning_rate=1e-3)


def _steps_against_jax(n, jset, tset, arch="qwen2-1.5b", batch_rows=4, seq=16):
    jcfg, tcfg, jp, tp = _pair(arch)
    data = JData(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=seq, global_batch=batch_rows,
                             seed=3))
    jstep = jax.jit(jmake_step(jcfg, jset))
    tstep = make_train_step(tcfg, tset)
    js = jopt.adamw_init(jp)
    ts = opt_state_from_numpy(tcfg, jax.tree.map(np.asarray, js), device="cpu")
    out = []
    for i in range(n):
        batch = data.batch_at(i)
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, ts, tmet = tstep(tp, ts, batch)
        out.append((jmet, tmet))
    return out, (jp, js), (tp, ts)


def test_train_step_matches_jax_over_three_steps():
    """Loss and gradient norm within 1e-4 at every step.  Parameters within
    2x the summed learning rates (atol 3e-3): AdamW's first moves are about
    ±lr whatever a gradient's size, so an element whose gradient is within
    rounding of 0 may move the other way on the other side."""
    settings = dict(STEP_KW, weight_decay=0.1)
    out, (jp, js), (tp, ts) = _steps_against_jax(3, JSettings(**settings), TrainSettings(**settings))
    lrs = 0.0
    for jmet, tmet in out:
        for key in ("loss", "lm_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), **TOL, err_msg=key)
        lrs += float(jmet["lr"])
    _leaves_close(params_to_numpy(tp), jax.tree.map(np.asarray, jp), "params",
                  atol=2 * lrs, rtol=0)
    back = opt_state_to_numpy(ts)
    assert int(back.step) == int(js.step) == 3
    _leaves_close(back.mu, jax.tree.map(np.asarray, js.mu), "mu", atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("variant", ["microbatches", "int8"])
def test_train_step_variants_match_jax(variant):
    """Two microbatches with a bf16 accumulator, or int8 gradient
    compression: loss and gradient norm within 1e-4 over 2 steps."""
    kw = dict(STEP_KW)
    kw.update(microbatches=2, accum_dtype="bfloat16") if variant == "microbatches" else \
        kw.update(grad_compression="int8")
    out, _, _ = _steps_against_jax(2, JSettings(**kw), TrainSettings(**kw))
    for jmet, tmet in out:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), **TOL, err_msg=key)


def test_opt_state_round_trip_is_exact():
    jcfg, tcfg, jp, _ = _pair("gemma-2b")
    rng = np.random.default_rng(5)
    st = jopt.OptState(step=np.asarray(7, np.int32),
                       mu=jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jp),
                       nu=jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), jp))
    back = opt_state_to_numpy(opt_state_from_numpy(tcfg, st, device="cpu"))
    assert int(back.step) == 7 and back.step.dtype == np.int32
    for a, b in zip(jax.tree.leaves((st.mu, st.nu)), jax.tree.leaves((back.mu, back.nu))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the checkpointer (mirrors tests/test_checkpoint.py)
# ---------------------------------------------------------------------------


def _ck_tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b.w": torch.ones((5,), dtype=torch.bfloat16) * 1.5,
            "b.s": torch.tensor(7, dtype=torch.int32),
            "c": torch.from_numpy(np.random.default_rng(0).standard_normal(9).astype(np.float32))
            .to(torch.bfloat16)}


def _template(tree):
    return {k: torch.empty_like(v) for k, v in tree.items()}


def test_checkpoint_roundtrip_exact(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _ck_tree()
    ck.save(3, t, extra={"note": "x"}, blocking=True)
    restored, meta = ck.restore(_template(t))
    assert meta.step == 3 and meta.extra["note"] == "x"
    for k, v in t.items():
        assert restored[k].dtype == v.dtype
        assert torch.equal(restored[k].view(torch.uint8) if v.dim() else restored[k],
                           v.view(torch.uint8) if v.dim() else v), k


def test_checkpoint_many_shards_roundtrip_exact(tmp_path, monkeypatch):
    """Shards written and read by several threads: every byte comes back."""
    monkeypatch.setattr(tck, "SHARD_BYTES", 64)
    rng = np.random.default_rng(1)
    t = {f"t{i}": torch.from_numpy(rng.standard_normal(int(rng.integers(1, 40))).astype(np.float32))
         .to(torch.bfloat16 if i % 3 else torch.float32) for i in range(30)}
    ck = Checkpointer(str(tmp_path))
    ck.save(2, t)
    ck.wait()
    assert len([n for n in os.listdir(tmp_path / "step_2") if n.startswith("shard_")]) > 5
    restored, _ = ck.restore(_template(t))
    for k, v in t.items():
        assert torch.equal(restored[k].view(torch.uint8), v.view(torch.uint8)), k


def test_checkpoint_compression_fallback_shard_naming(tmp_path):
    """Without the optional ``zstandard`` package shards are plain ``.bin``
    (and still restore); with it they are ``.bin.zst``."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _ck_tree(), blocking=True)
    shards = [n for n in os.listdir(tmp_path / "step_1") if n.startswith("shard_")]
    want = ".bin" if tck.zstandard is None else ".bin.zst"
    assert shards and all(n.endswith(want) for n in shards)
    restored, _ = ck.restore(_template(_ck_tree()))
    assert torch.equal(restored["a"], _ck_tree()["a"])


def test_checkpoint_async_save_then_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _ck_tree()
    ck.save(1, t)
    t["a"].add_(1.0)                 # the snapshot was taken at save()
    ck.wait()
    assert ck.latest_step() == 1
    restored, _ = ck.restore(_template(t))
    assert torch.equal(restored["a"], t["a"] - 1.0)


def test_checkpoint_latest_pointer_flips_only_on_complete_write(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _ck_tree(), blocking=True)
    ck.save(2, _ck_tree(), blocking=True)
    assert ck.latest_step() == 2
    os.makedirs(tmp_path / "step_3.tmp", exist_ok=True)
    assert ck.latest_step() == 2


def test_checkpoint_gc_keeps_latest_k(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _ck_tree(), blocking=True)
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("step_")) == ["step_3", "step_4"]


@pytest.mark.parametrize("bad", ["shape", "dtype", "names"])
def test_checkpoint_mismatch_rejected(tmp_path, bad):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros((2, 2))}, blocking=True)
    template = {"shape": {"a": torch.zeros((3, 3))},
                "dtype": {"a": torch.zeros((2, 2), dtype=torch.bfloat16)},
                "names": {"b": torch.zeros((2, 2))}}[bad]
    with pytest.raises(ValueError, match="mismatch"):
        ck.restore(template)


# ---------------------------------------------------------------------------
# preempt → checkpoint → resume (mirrors tests/test_e2e_preemption.py)
# ---------------------------------------------------------------------------


def make_trainer(tmpdir, seed=0):
    cfg = reduced(get_config("qwen2-1.5b"))
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                                         seed=seed))
    return Trainer(cfg, TrainSettings(total_steps=50, warmup_steps=2, learning_rate=1e-3),
                   TrainerConfig(ckpt_dir=str(tmpdir), ckpt_every=1000, log_every=1),
                   data=data, device="cpu")


def _state_vec(trainer):
    from repro_torch.training.trainer import state_tensors

    return {k: v.clone() for k, v in state_tensors(trainer.params, trainer.opt_state).items()}


def test_preempt_resume_is_bit_exact(tmp_path):
    ref = make_trainer(tmp_path / "ref")
    ref.run(10)
    t1 = make_trainer(tmp_path / "pre")
    t1.run(6)
    assert t1.on_preempt(now=0.0, deadline=60.0) is PreemptAck.DRAINED
    t1.run(2)                         # a preempted trainer takes no more steps
    assert t1.step == 6
    t2 = make_trainer(tmp_path / "pre")
    t2.init_or_restore()
    assert t2.step == t2.resume_marker() == 6
    t2.run(until_step=10)
    want, got = _state_vec(ref), _state_vec(t2)
    assert sorted(want) == sorted(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_hard_kill_loses_only_since_last_checkpoint(tmp_path):
    t1 = make_trainer(tmp_path / "hk")
    t1.tcfg.ckpt_every = 5
    t1.run(8)
    t1.ckpt.wait()
    t2 = make_trainer(tmp_path / "hk")
    t2.init_or_restore()
    assert t2.step == 5
    t2.run(until_step=10)
    assert t2.step == 10


def test_controller_records_lost_work(tmp_path):
    from repro_torch.core.types import TPU_SPEC, Instance

    ctrl = PreemptionController(notice_s=60.0)
    trainer = make_trainer(tmp_path / "rec")
    trainer.run(3)
    inst = Instance(id="i0", resources=TPU_SPEC.make(chips=4, hbm_gb=32, host_ram_gb=16),
                    preemptible=True, host="h0", start_time=0.0)
    ctrl.register("i0", trainer)
    ctrl(inst, now=100.0)
    assert ctrl.records[-1].ack is PreemptAck.DRAINED
    assert ctrl.records[-1].lost_work_s == 0.0
    assert ctrl.drain_rate == 1.0
    assert trainer.ckpt.latest_step() == 3


def test_trainer_defaults_to_the_card(tmp_path):
    cfg = reduced(get_config("qwen2-1.5b"))
    if torch.cuda.is_available():
        assert Trainer(cfg, TrainSettings(), TrainerConfig(str(tmp_path))).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainSettings(), TrainerConfig(str(tmp_path)))


def test_port_stream_equals_the_jax_package_stream():
    cfg = DataConfig(vocab_size=512, seq_len=24, global_batch=3, seed=4)
    mine = SyntheticLMDataset(cfg)
    theirs = JData(JDataConfig(**dataclasses.asdict(cfg)))
    for step in (0, 5):
        for k, v in theirs.batch_at(step).items():
            np.testing.assert_array_equal(mine.batch_at(step)[k], v)
