"""The port's ``ServingEngine`` against the JAX package's, mirroring
``tests/test_serving.py``: the same weights (JAX's ``init_params`` through
``params_from_numpy``) and requests give the same ``completed`` dicts, the
same decode step counts and the same preemption re-queue.  Reduced
qwen2-1.5b in f32; reduced moonshot-v1-16b-a3b and arctic-480b (experts,
seeded numpy weights in the shapes of JAX's tree) serve through the same
engine unchanged.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models.model import init_params as jinit
from repro.serving import ServeConfig as JServeConfig, ServingEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.core.preemption import PreemptAck
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServeConfig, ServingEngine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(jget("qwen2-1.5b"))
    tcfg = reduced(get_config("qwen2-1.5b"))
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def _engines(weights, max_batch=3, max_len=64):
    jcfg, tcfg, jp, tp = weights
    return (JEngine(jcfg, jp, JServeConfig(max_batch=max_batch, max_len=max_len)),
            ServingEngine(tcfg, tp, ServeConfig(max_batch=max_batch, max_len=max_len)))


def _submit(engines, requests):
    for e in engines:
        for rid, prompt, max_new in requests:
            e.submit(rid, prompt, max_new=max_new)


def test_serves_batched_requests(weights):
    """5 requests of 3-8 tokens, batch 3: two waves, the same tokens."""
    je, te = _engines(weights)
    rng = np.random.default_rng(0)
    cfg = weights[1]
    reqs = [(f"r{i}", rng.integers(2, cfg.vocab_size, rng.integers(3, 9)), 6) for i in range(5)]
    _submit((je, te), reqs)
    out = te.run_until_drained()
    assert set(out) == {f"r{i}" for i in range(5)}
    for toks in out.values():
        assert 1 <= len(toks) <= 6
        assert all(0 <= t < cfg.vocab_size for t in toks)
    assert out == je.run_until_drained()
    assert te.steps_executed == je.steps_executed


def test_greedy_decode_is_deterministic(weights):
    je, te1 = _engines(weights, max_batch=1)
    _, te2 = _engines(weights, max_batch=1)
    prompt = np.arange(2, 8, dtype=np.int64)
    _submit((je, te1, te2), [("a", prompt, 8)])
    a = te1.run_until_drained()["a"]
    assert a == te2.run_until_drained()["a"] == je.run_until_drained()["a"]


def test_preemption_requeues_unfinished(weights):
    je, te = _engines(weights, max_batch=2)
    rng = np.random.default_rng(1)
    reqs = [(f"r{i}", rng.integers(2, weights[1].vocab_size, 4), 50) for i in range(2)]
    _submit((je, te), reqs)
    assert te.on_preempt(now=0.0, deadline=30.0) is PreemptAck.DRAINED
    je.on_preempt(now=0.0, deadline=30.0)
    assert te.run_until_drained() == {} == je.run_until_drained()
    assert [r.rid for r in te.queue] == [r.rid for r in je.queue] == ["r0", "r1"]


def test_preempt_mid_wave_requeues_like_jax(weights):
    """A PREEMPT after the third decode step: finished requests complete,
    the rest go back to the queue from scratch in the JAX engine's order,
    and a second engine drains them to the same tokens."""
    rng = np.random.default_rng(2)
    cfg = weights[1]
    reqs = [(f"r{i}", rng.integers(2, cfg.vocab_size, 5), m) for i, m in enumerate((3, 9, 2, 9))]
    results = []
    for make in (lambda e: e[0], lambda e: e[1]):
        first, second = (make(_engines(weights, max_batch=4)) for _ in range(2))
        for rid, prompt, max_new in reqs:
            first.submit(rid, prompt, max_new=max_new)
        decode = first._decode

        def decode_then_preempt(p, t, s, first=first, decode=decode):
            out = decode(p, t, s)
            if first.steps_executed == 2:      # counted after this call returns
                first.on_preempt(now=0.0, deadline=30.0)
            return out

        first._decode = decode_then_preempt
        first.run_until_drained()
        queued = [(r.rid, list(r.out)) for r in first.queue]
        second.queue = first.queue
        results.append((dict(first.completed), queued, second.run_until_drained(),
                        first.steps_executed, second.steps_executed))
    jres, tres = results
    assert tres == jres
    assert set(tres[0]) == {"r0", "r2"} and [rid for rid, _ in tres[1]] == ["r3", "r1"]
    assert all(out == [] for _, out in tres[1])
    assert set(tres[0]) | set(tres[2]) == {"r0", "r1", "r2", "r3"}


def test_preemption_controller_drains_the_engine(weights):
    """The port's ``PreemptionController`` routes a scheduler preemption to
    the engine as the JAX package's does: the engine acks DRAINED, no work
    is lost, the checkpoint moves to the preemption time, and an instance
    with no job registered records a stateless drain."""
    from repro.core.preemption import PreemptionController as JController
    from repro.core.types import Instance as JInstance
    from repro_torch.core.preemption import PreemptionController
    from repro_torch.core.types import Instance

    records = []
    for engine, controller, inst_t in zip(
            _engines(weights), (JController(), PreemptionController()), (JInstance, Instance)):
        insts = [inst_t(id=f"i{j}", resources=None, preemptible=True, host="h0",
                        start_time=100.0) for j in range(2)]
        controller.register("i0", engine)
        engine.submit("r0", np.arange(2, 8), max_new=4)
        for inst in insts:
            controller(inst, 1800.0)
        assert engine.run_until_drained() == {} and [r.rid for r in engine.queue] == ["r0"]
        records.append(([(r.instance_id, r.job_id, r.time, r.ack.value, r.lost_work_s)
                         for r in controller.records],
                        insts[0].last_checkpoint, controller.drain_rate,
                        controller.total_lost_work_s))
    assert records[0] == records[1]
    assert records[1][0] == [("i0", "serve", 1800.0, "drained", 0.0),
                             ("i1", "-", 1800.0, "drained", 0.0)]


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "arctic-480b"])
def test_moe_engine_matches_jax(arch):
    """5 requests, batch 3, at the config's capacity factor (1.25: prefill
    and decode drop choices, each side as the other): the same tokens and
    step counts as the JAX engine."""
    from test_torch_training import _np_params

    jcfg, tcfg = jreduced(jget(arch)), reduced(get_config(arch))
    tree = _np_params(jcfg)
    je = JEngine(jcfg, jax.tree.map(jax.numpy.asarray, tree), JServeConfig(max_batch=3, max_len=32))
    te = ServingEngine(tcfg, params_from_numpy(tcfg, tree, device="cpu"),
                       ServeConfig(max_batch=3, max_len=32))
    rng = np.random.default_rng(4)
    _submit((je, te), [(f"r{i}", rng.integers(2, tcfg.vocab_size, rng.integers(3, 9)), 6)
                       for i in range(5)])
    out = te.run_until_drained()
    assert set(out) == {f"r{i}" for i in range(5)}
    assert out == je.run_until_drained()
    assert te.steps_executed == je.steps_executed
