"""The CPU side of ``chip_smoke.py``'s card-against-CPU checks: the
simulators' (phases 4 to 5f), the reduced hybrid and xLSTM models'
(phase 8c), the reduced encoder-decoder and vision stub (phase 8d), the
hybrid's training (phase 11b) and the training of the mixture-of-experts,
encoder-decoder and vision-stub models (phase 11c).

    python3 chip_smoke_cpu.py OUT_DIR

``chip_smoke.py`` starts this script in a process of its own when it
starts, so that the CPU runs it compares the card with take place while
the card works.  Each scenario is built by a function of this module,
which ``chip_smoke.py`` also calls for the card's run; here each runs on
the CPU, in the order the phases need them, and what the card's run is
compared with (a plain dict of numbers, lists and numpy arrays, built by
the ``*_view`` functions below that ``chip_smoke.py`` applies to the card's
run too) goes to ``OUT_DIR/<name>.pkl``, written whole and then renamed
into place, with the run's wall clock under ``seconds``.  A failure writes
its traceback to the standard error and exits non-zero.

The module imports torch, numpy and the port (``src/repro_torch``); it
touches no CUDA device.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.core import fleets  # noqa: E402
from repro_torch.core import scan_sim  # noqa: E402
from repro_torch.core.cluster import Cluster, make_uniform_fleet  # noqa: E402
from repro_torch.core.convert import fleet_state_to_numpy, queue_state_to_numpy  # noqa: E402
from repro_torch.core.fleet_sharding import fleet_mesh, pad_fleet_state  # noqa: E402
from repro_torch.core.policy import SchedulerPolicy  # noqa: E402
from repro_torch.core.simulator import Simulator, SoASimulator, WorkloadSpec  # noqa: E402
from repro_torch.core.soa_fleet import SoAFleet  # noqa: E402
from repro_torch.core.torch_scheduler import TorchPreemptibleScheduler  # noqa: E402
from repro_torch.core.types import Host  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.training import TrainSettings, make_train_step  # noqa: E402
from repro_torch.training.trainer import state_tensors  # noqa: E402

MEDIUM = fleets.SIZES["medium"]
COUNTERS = ("failures_normal", "failures_preemptible", "placed_normal",
            "placed_preemptible", "preemptions")
#: phase 5c's streaming policy
ADMISSION = dict(queue_capacity=256, admit_batch=64, max_retries=4, slo_target_s=60.0)
#: tests/test_relocation.py::_storm_sim's policy (its budget per run below)
RELOC = dict(cost_kind="period", churn_multiplier=2.0, churn_threshold=1e-4,
             relocate_threshold=1e-4, relocate_every_s=60.0, relocate_cooldown_s=600.0)
#: arrivals a second at 4,096 hosts: the reference test's 1/20 raised
#: five-fold, so that new spot work keeps arriving as storms and moves thin z2
RELOC_RATE = 0.25
#: benchmarks/bench_screen.py::_bench_scan's workload: Table 1 nodes in 3
#: zones; small, medium and large; 1/8 arrivals/s; lifetimes 300 / 1,200 /
#: 2,400 s; 60 % preemptible; 3,200 s from seed 7 with a storm on z0 at
#: 1,600 s killing half, host 1 failing at 1,280 s and healing 640 s later,
#: a checkpoint row every 4th preemptible arrival.  Streaming takes
#: _bench_scan_stream's policy and priorities
SCAN_SPEC = WorkloadSpec(arrival_rate_per_s=1 / 8.0, lifetime_min_s=300.0,
                         lifetime_mean_s=1200.0, lifetime_max_s=2400.0,
                         preemptible_fraction=0.6, flavors=list(fleets.SIZES.items()))
SCAN_POLICY = {"direct": SchedulerPolicy(), "streaming": SchedulerPolicy(
    queue_capacity=64, admit_batch=4, slo_target_s=120.0, max_retries=4, n_classes=3,
    aging_rate=0.005, storm_threshold=0.05)}
SCAN_S, SCAN_ENS_S = 3200.0, 1200.0
#: the ensemble's multiplier axis
MULT_ROWS = np.array([[1.0, 1.0, 0.0, 0.0, 0.0], [4.0, 0.25, 0.0, 0.0, 0.0],
                      [0.5, 2.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0, 0.0]], np.float32)


def _timed_run(s, until, before_run):
    if before_run is not None:
        before_run()
    t = time.perf_counter()
    metrics = s.run(until)
    return s, metrics, time.perf_counter() - t


# -- the scenarios: each returns (simulator, metrics, run seconds) ---------------------
def parity_sim(device, before_run=None):
    """Phase 4: 4,096 saturated hosts, 0.5 arrivals/s, stragglers and two
    host failures, 2,200 s."""
    s = SoASimulator(
        fleets.saturated_fleet(4096, seed=5),
        WorkloadSpec(arrival_rate_per_s=0.5, flavors=list(fleets.SIZES.items())),
        seed=6, device=device,
    )
    s.inject_stragglers(0.02)
    s.inject_host_failure("h17", at_s=600.0, heal_after_s=900.0)
    s.inject_host_failure("h2048", at_s=1500.0)
    return _timed_run(s, 2200.0, before_run)


def stream_sim(device, before_run=None):
    """Phase 5c: phase 4's simulator, streaming."""
    s = SoASimulator(
        fleets.saturated_fleet(4096, seed=5),
        WorkloadSpec(arrival_rate_per_s=0.5, flavors=list(fleets.SIZES.items())),
        seed=6, policy=SchedulerPolicy(**ADMISSION), device=device,
    )
    s.inject_stragglers(0.02)
    s.inject_host_failure("h17", at_s=600.0, heal_after_s=900.0)
    s.inject_host_failure("h2048", at_s=1500.0)
    return _timed_run(s, 2200.0, before_run)


def reloc_sim(device, streaming, before_run=None):
    """Phase 5d: tests/test_relocation.py::_storm_sim's regime on 4,096
    Table 1 nodes in 3 zones, each host holding 3 medium instances started
    before the run's clock."""
    knobs = dict(RELOC, relocate_budget=8,
                 **(dict(queue_capacity=64, admit_batch=8, slo_target_s=30.0) if streaming else {}))
    s = SoASimulator(
        fleets.zoned_fleet(4096, (3, 3, 3), seed=5, now=0.0),
        WorkloadSpec(arrival_rate_per_s=RELOC_RATE, preemptible_fraction=1.0,
                     flavors=(("medium", MEDIUM),)),
        seed=11, policy=SchedulerPolicy(**knobs), device=device)
    s.inject_churn_regime("z2", until_s=4000.0, mean_on_s=300.0, mean_off_s=800.0,
                          storm_every_s=100.0, kill_frac=0.3, start_s=0.0)
    s.inject_zone_storm("z2", at_s=3500.0, kill_frac=1.0)
    return _timed_run(s, 4000.0, before_run)


def ragged_sim(device, mesh, before_run=None):
    """Phase 5f: the simulator at 4,099 hosts (padded to 4,100 on a mesh)."""
    s = SoASimulator(fleets.saturated_fleet(4099, seed=5),
                     WorkloadSpec(arrival_rate_per_s=0.5, flavors=list(fleets.SIZES.items())),
                     seed=6, device=device, policy=SchedulerPolicy(mesh=mesh))
    s.inject_host_failure("h17", at_s=300.0, heal_after_s=300.0)
    s.inject_host_failure("h4098", at_s=500.0)
    return _timed_run(s, 900.0, before_run)


def rebuild_sim(device):
    """Phase 5b: the python Simulator with the rebuild scheduler,
    test_soa_incremental.py's workload, 16 hosts, 24 simulated hours.
    Returns (metrics, cluster, run seconds, scheduler)."""
    sched = TorchPreemptibleScheduler(k_slots=4, device=device)
    cluster = Cluster(make_uniform_fleet(16, fleets.NODE_CAP))
    t = time.perf_counter()
    m = Simulator(cluster, sched, WorkloadSpec(arrival_rate_per_s=1 / 40.0,
                                               preemptible_fraction=0.5,
                                               flavors=(("medium", MEDIUM),)),
                  seed=5).run(24 * 3600.0)
    return m, cluster, time.perf_counter() - t, sched


def scan_trace(mode, duration=SCAN_S, seed=7, storm=True, fail=True, ckpt=4, zone=0):
    return scan_sim.trace_from_workload(
        SCAN_SPEC, duration, seed=seed, storms=((duration * 0.5, zone, 0.5),) if storm else (),
        failures=((duration * 0.4, 1, duration * 0.2),) if fail else (), checkpoint_every=ckpt,
        priorities=(-1, 0, 1, 2) if mode == "streaming" else ())


def zoned_hosts(n):
    return [Host(name=f"h{j}", capacity=fleets.NODE_CAP, zone=f"z{j % 3}") for j in range(n)]


def saturated_zoned(n, seed):
    """Phase 5's saturated draws, the hosts dealt into 3 zones."""
    hosts = fleets.saturated_fleet(n, seed=seed)
    for j, h in enumerate(hosts):
        h.zone = f"z{j % 3}"
    return hosts


def on_clock(trace):
    """A trace moved onto the fleets' clock (fleets.NOW on; integer times
    stay exact in f32)."""
    return dataclasses.replace(trace, time=trace.time + np.float32(fleets.NOW))


def mult_trace():
    """The multiplier axis's trace: 1,200 s from seed 3 on the fleets' clock."""
    return on_clock(scan_trace("direct", SCAN_ENS_S, seed=3, fail=False, ckpt=0))


def mult_state(device):
    """The multiplier axis's fleet: 1,024 saturated hosts (seed 1) in 3 zones."""
    return SoAFleet(saturated_zoned(1024, 1), device=device).state


# -- what the card's runs are compared with ---------------------------------------------
def sim_view(s, m, streaming=False):
    """Phases 4 and 5c: counters, samples, mirrors, final state (and,
    streaming, the admission stats, waits and final queue)."""
    out = dict(counters={key: getattr(m, key) for key in COUNTERS}, utilization=list(m.utilization),
               t=list(m.t), instances=list(s.fleet.instances), locator=dict(s.fleet.locator),
               preempted=[i.id for i in s.fleet.preempted],
               state=fleet_state_to_numpy(s.fleet.state))
    if streaming:
        front = s.fleet.admission
        out.update(admission=adm_stats(front),
                   wait_bits=np.asarray(front.stats.wait_s, np.float32).tobytes(),
                   queue=queue_state_to_numpy(front.qstate))
    return out


def adm_stats(front):
    """An admission front end's stats, the wall clock aside."""
    out = dataclasses.asdict(front.stats)
    del out["wall_wait_s"]
    return out


def fleet_summary(fleet):
    """A fleet's python mirror and relocation records, by identities."""
    return ([(i.id, i.host, i.start_time, i.last_checkpoint) for i in fleet.instances.values()],
            fleet.locator, [i.id for i in fleet.preempted],
            dataclasses.asdict(fleet.relocation), fleet.relocated_ids,
            {z: dataclasses.asdict(r) for z, r in fleet._reloc_zone.items()})


def reloc_view(s, m, streaming):
    """Phase 5d: every metric (the latencies by their count), the mirror and
    relocation records, final state (and, streaming, stats and queue)."""
    metrics = dataclasses.asdict(m)
    metrics["sched_latency_s"] = len(metrics["sched_latency_s"])
    out = dict(metrics=metrics, summary=fleet_summary(s.fleet),
               state=fleet_state_to_numpy(s.fleet.state))
    if streaming:
        out.update(admission=adm_stats(s.fleet.admission),
                   queue=queue_state_to_numpy(s.fleet.admission.qstate))
    return out


def ragged_view(s, m):
    """Phase 5f: the summary but latencies, samples, mirrors and the final
    state padded to the mesh's 4,100 hosts."""
    st = s.fleet.state
    return dict(summary={key: v for key, v in m.summary().items() if "latency" not in key},
                utilization=list(m.utilization), instances=list(s.fleet.instances),
                locator=dict(s.fleet.locator),
                state=fleet_state_to_numpy(st if st.mesh is not None else pad_fleet_state(st, 4100)))


def rebuild_view(m, cluster):
    """Phase 5b: counters, samples, placements and preemptions."""
    return dict(counters={key: getattr(m, key) for key in COUNTERS},
                utilization=list(m.utilization), t=list(m.t),
                placements={n: sorted(h.instances) for n, h in cluster.hosts.items()},
                preempted=[i.id for i in cluster.preempted], preemptions=m.preemptions)


def scan_view(res):
    """Phase 5e: one trajectory's outcomes, counters, samples, final state
    and, streaming, admission counters, waits and final queue."""
    return dict(
        counters=dict(res.counters), decisions=res.decisions, fallbacks=res.fallbacks,
        **{name: np.asarray(getattr(res, name)) for name in (
            "host", "slot", "ok", "n_kill", "sample_t", "sample_free0", "sample_free0_normal")},
        state=fleet_state_to_numpy(res.state),
        admission=None if res.admission is None else dict(res.admission),
        wait_s=None if res.wait_s is None else np.asarray(res.wait_s),
        queue=None if res.queue is None else queue_state_to_numpy(res.queue))


# -- the CPU runs, in the order chip_smoke.py reads them ---------------------------------
def _parity():
    s, m, sec = parity_sim("cpu")
    return dict(sim_view(s, m), seconds=sec)


def _rebuild():
    m, cluster, sec, _ = rebuild_sim("cpu")
    return dict(rebuild_view(m, cluster), seconds=sec)


def _admission():
    s, m, sec = stream_sim("cpu")
    return dict(sim_view(s, m, streaming=True), seconds=sec)


def _reloc(streaming):
    s, m, sec = reloc_sim("cpu", streaming)
    return dict(reloc_view(s, m, streaming), seconds=sec)


def _scan(mode):
    pol = SCAN_POLICY[mode]
    tr = scan_trace(mode)
    state = SoAFleet(zoned_hosts(4096), policy=pol, device="cpu").state
    t = time.perf_counter()
    res = scan_sim.simulate_scan(tr, pol, state)
    return dict(scan_view(res), seconds=time.perf_counter() - t)


def _mult():
    lanes = scan_sim.simulate_ensemble([mult_trace()], SCAN_POLICY["direct"], mult_state("cpu"),
                                       mults=MULT_ROWS)
    return dict(lanes=[scan_view(lane) for lane in lanes])


def _ragged():
    s, m, sec = ragged_sim("cpu", fleet_mesh(devices=["cpu"] * 4))
    return dict(ragged_view(s, m), seconds=sec)


#: phase 8c's reduced models in f32, flash attention: (name, arch, config
#: overrides, weight seed); zamba2-7b reduced has 8 layers at shared cadence
#: 3 (two groups and a tail of 2), once at its own head_dim 112
HYBRID_CASES = (("zamba2-7b", "zamba2-7b", {}, 31),
                ("zamba2-7b hd 112", "zamba2-7b", {"head_dim": 112}, 32),
                ("xlstm-125m", "xlstm-125m", {}, 33))
#: their tokens: 3 sequences of 192 (12 chunks of 16)
HYBRID_TOKENS = (3, 192)


def hybrid_config(arch, overrides):
    return dataclasses.replace(reduced(get_config(arch)), attention_impl="flash", **overrides)


def hybrid_tokens(cfg, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(2, cfg.vocab_size, HYBRID_TOKENS))


def _hybrid(arch, overrides, seed):
    """The reduced model's weights (drawn here, sent to the card), its f32
    ``forward_logits`` on the CPU and, as the exact reference, the same
    weights' f64 forward (reference attention: the flash plain version
    computes in f32)."""
    cfg = hybrid_config(arch, overrides)
    params = tm.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    toks = hybrid_tokens(cfg, seed)
    t = time.perf_counter()
    logits = tm.forward_logits(cfg, params, {"tokens": toks}, last_only=False)
    sec = time.perf_counter() - t
    c64 = dataclasses.replace(cfg, dtype="float64", attention_impl="reference")
    p64 = tm.Model(c64, device="meta")
    p64.load_state_dict({k: v.double() for k, v in params.state_dict().items()}, assign=True)
    exact = tm.forward_logits(c64, p64, {"tokens": toks}, last_only=False)
    return dict(state={k: v.numpy() for k, v in params.state_dict().items()},
                logits=logits.numpy(), exact=exact.numpy(), seconds=sec)


#: phase 8d's reduced models in f32, flash attention: (arch, weight and
#: input seed)
ENCDEC_CASES = (("seamless-m4t-medium", 41), ("internvl2-26b", 42))
#: their inputs: 3 sequences of 64 text tokens; seamless's 48 frame
#: embeddings (internvl2's patch embeddings are its reduced n_prefix_tokens, 16)
ENCDEC_SHAPE = (3, 64, 48)


def encdec_config(arch, remat="none"):
    return dataclasses.replace(reduced(get_config(arch)), attention_impl="flash", remat=remat)


def encdec_batch(cfg, seed):
    """Tokens, labels (the next tokens) and the family's embeddings (N(0, 1),
    f32), on the CPU."""
    rng = np.random.default_rng(seed)
    b, s, s_enc = ENCDEC_SHAPE
    toks = rng.integers(2, cfg.vocab_size, (b, s + 1))
    out = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    key, n = (("frame_embeds", s_enc) if cfg.encoder_decoder else
              ("patch_embeds", cfg.n_prefix_tokens))
    out[key] = torch.from_numpy(rng.standard_normal((b, n, cfg.d_model)).astype(np.float32))
    return out


def _encdec(arch, seed):
    """The reduced model's weights (drawn here, sent to the card), its f32
    ``forward_logits`` and, as the exact reference, the same weights' f64
    forward (reference attention); then ``forward_train`` under remat
    "full": the f32 loss, gradient norm and gradients, and the f64 ones."""
    cfg = encdec_config(arch)
    params = tm.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    batch = encdec_batch(cfg, seed)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    t = time.perf_counter()
    logits = tm.forward_logits(cfg, params, inputs, last_only=False)
    sec = time.perf_counter() - t
    c64 = dataclasses.replace(cfg, dtype="float64", attention_impl="reference")
    p64 = tm.Model(c64, device="meta")
    p64.load_state_dict({k: v.double() for k, v in params.state_dict().items()}, assign=True)
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    exact = tm.forward_logits(c64, p64, {k: v for k, v in b64.items() if k != "labels"},
                              last_only=False)
    out = dict(state={k: v.numpy() for k, v in params.state_dict().items()},
               logits=logits.numpy(), exact=exact.numpy(), seconds=sec)
    for tag, c_, p_, b_ in (("", encdec_config(arch, remat="full"), params, batch),
                            ("64", c64, p64, b64)):
        loss, _ = tm.forward_train(c_, p_, b_)
        names, leaves = zip(*p_.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
        out[f"loss{tag}"] = float(loss.detach())
        out[f"grad_norm{tag}"] = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)))
        out[f"grads{tag}"] = {n: g.numpy() for n, g in zip(names, grads)}
    return out


#: phase 11b trains the same reduced models (f32, flash, remat full) under
#: each optimizer: 3 ``make_train_step`` steps of 4 x 64 tokens, with phase
#: 10's settings (the first step's learning rate 0: AdamW's first move is
#: +-lr whatever the gradient's size)
HYBRID_TRAIN = dict(optimizers=("adafactor", "adamw"), steps=3,
                    settings=TrainSettings(total_steps=50, warmup_steps=2, learning_rate=1e-3))


def hybrid_train_config(arch, overrides, optimizer):
    return dataclasses.replace(hybrid_config(arch, overrides), optimizer=optimizer, remat="full")


def hybrid_train_data(cfg, seed):
    return SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                                         seed=seed))


def _state(params, opt_state):
    return {k: t.detach().numpy().copy() for k, t in state_tensors(params, opt_state).items()}


def _exact(cfg, params, batch):
    """The loss and gradient norm of ``params`` on ``batch`` in f64
    (reference attention: the flash plain version computes in f32)."""
    c64 = dataclasses.replace(cfg, dtype="float64", attention_impl="reference")
    p64 = tm.Model(c64, device="meta")
    p64.load_state_dict({k: v.double() for k, v in params.state_dict().items()}, assign=True)
    b64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in ((k, torch.from_numpy(np.asarray(v))) for k, v in batch.items())}
    loss, _ = tm.forward_train(c64, p64, b64)
    grads = torch.autograd.grad(loss, list(p64.parameters()))
    return float(loss.detach()), float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))


def _train_run(cfg, seed, batch_at, exact=False):
    """A reduced model's training on the CPU under ``cfg.optimizer``: its
    state (``state_tensors`` as numpy) before the first step and after each,
    and each step's loss and gradient norm (with ``exact``, also those of
    the state before the step in f64, ``loss64`` and ``grad_norm64``)."""
    settings = HYBRID_TRAIN["settings"]
    params = tm.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    opt = make_optimizer(cfg.optimizer, weight_decay=settings.weight_decay)
    opt_state = opt.init(dict(params.named_parameters()))
    step = make_train_step(cfg, settings, opt)
    states, metrics = [_state(params, opt_state)], []
    t = time.perf_counter()
    for i in range(HYBRID_TRAIN["steps"]):
        f64 = _exact(cfg, params, batch_at(i)) if exact else None
        params, opt_state, met = step(params, opt_state, batch_at(i))
        states.append(_state(params, opt_state))
        metrics.append({k: float(met[k]) for k in ("loss", "grad_norm")})
        if f64:
            metrics[-1].update(loss64=f64[0], grad_norm64=f64[1])
    return dict(states=states, metrics=metrics, seconds=time.perf_counter() - t)


def _hybrid_train(arch, overrides, seed, optimizer):
    cfg = hybrid_train_config(arch, overrides, optimizer)
    return _train_run(cfg, seed, hybrid_train_data(cfg, seed).batch_at)


#: phase 11c trains the reduced mixture-of-experts, encoder-decoder and
#: vision-stub models (f32, flash, remat full) as 11b trains the hybrid,
#: under each optimizer: (arch, weight and data seed)
TRAIN_CASES = (("moonshot-v1-16b-a3b", 51), ("arctic-480b", 52), ("seamless-m4t-medium", 53),
               ("internvl2-26b", 54))


def train_config(arch, optimizer):
    return dataclasses.replace(reduced(get_config(arch)), attention_impl="flash", remat="full",
                               optimizer=optimizer)


def train_batch_at(cfg, seed):
    """Step i's batch: 4 x 64 tokens of the synthetic stream and, for the
    encoder-decoder and the vision stub, the step's 48 frame or 16 patch
    embeddings (N(0, 1), f32, drawn from the seed and i)."""
    data = hybrid_train_data(cfg, seed)

    def batch_at(i):
        batch = data.batch_at(i)
        if cfg.encoder_decoder or cfg.modality == "vision_stub":
            key, n = (("frame_embeds", ENCDEC_SHAPE[2]) if cfg.encoder_decoder else
                      ("patch_embeds", cfg.n_prefix_tokens))
            rng = np.random.default_rng((seed, i))
            batch[key] = rng.standard_normal((4, n, cfg.d_model)).astype(np.float32)
        return batch
    return batch_at


def _train(arch, seed, optimizer):
    cfg = train_config(arch, optimizer)
    return _train_run(cfg, seed, train_batch_at(cfg, seed), exact=True)


JOBS = (("parity", _parity), ("rebuild", _rebuild), ("admission", _admission),
        ("reloc_direct", lambda: _reloc(False)), ("reloc_streaming", lambda: _reloc(True)),
        ("scan_direct", lambda: _scan("direct")), ("scan_streaming", lambda: _scan("streaming")),
        ("scan_mult", _mult), ("ragged", _ragged)) + tuple(
    (f"hybrid {name}", lambda a=arch, o=over, sd=seed: _hybrid(a, o, sd))
    for name, arch, over, seed in HYBRID_CASES) + tuple(
    (f"encdec {arch}", lambda a=arch, sd=seed: _encdec(a, sd)) for arch, seed in ENCDEC_CASES) + tuple(
    (f"hybrid train {name} {opt}", lambda a=arch, o=over, sd=seed, op=opt: _hybrid_train(a, o, sd, op))
    for name, arch, over, seed in HYBRID_CASES for opt in HYBRID_TRAIN["optimizers"]) + tuple(
    (f"train {arch} {opt}", lambda a=arch, sd=seed, op=opt: _train(a, sd, op))
    for arch, seed in TRAIN_CASES for opt in HYBRID_TRAIN["optimizers"])


#: CPU threads of this process: it runs beside chip_smoke.py's host loop on
#: the card's machine.  These runs give the same bits on 2 threads as on 8
THREADS = 2


def main(out_dir: str) -> None:
    torch.set_num_threads(THREADS)
    for name, job in JOBS:
        out = job()
        tmp = os.path.join(out_dir, f".{name}.pkl")
        with open(tmp, "wb") as fh:
            pickle.dump(out, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, os.path.join(out_dir, f"{name}.pkl"))


if __name__ == "__main__":
    main(sys.argv[1])
