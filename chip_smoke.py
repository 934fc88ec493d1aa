"""End-to-end smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the run
exits non-zero:

1. device    — the card's name and power limit (nvidia-smi), torch and CUDA
               versions;
2. build     — compile every CUDA source of the port (one nvcc each, all
               started together);
3. kernels   — the decision path's kernels at the paper's saturated geometry
               (65,536 hosts, K=8, D=3, M=64; plus the enumeration at K=12),
               each against its plain PyTorch version on the same inputs:
               exactly equal on integer-valued inputs and on the non-integer
               cases (a fractional clock; the weigher vector (2, 1, 0.7, 1));
               kernel / plain / bound times (CUDA events, medians);
4. parity    — the simulator on the card and on the CPU, 4,096 hosts, the
               same seed: identical placements, counters and final state;
5. main path — ``SoAFleet`` on the card at 65,536 hosts, 2,048 decisions in
               batches of 64 (half normal, so preemptions happen) plus 512
               single decisions: decisions/s, latency, fallbacks, memory,
               the device's busy share, and every kernel's launch count;
6. model_kernels — flash-attention forward and RMSNorm against their plain
               versions at qwen2-1.5b's and gemma-2b's shapes (plus a full,
               a ragged and an f32 case; RMSNorm at the prefill and decode
               shapes), each gap against a stated tolerance; kernel / plain /
               bound / library times;
7. model_parity — reduced qwen2-1.5b in f32, the same weights on the card
               and on the CPU: flash ``forward_logits`` within 1e-4, and a
               ``ServingEngine`` run with identical tokens and step counts;
8. serve     — full-width qwen2-1.5b (28 layers, random f32 master weights
               from a seed, bf16 compute): ``forward_logits`` with flash and
               reference attention on 4 x 1,024 tokens against the f32
               forward, then a ``ServingEngine`` (batch 8, max_len 1,024)
               answering 8 requests across a preemption halfway through,
               drained by a second engine: prefill tokens/s, decode ms per
               step, decode tokens/s, peak memory, launch counts, and the
               device's busy share over a traced decode window;
9. train_kernels — the flash-attention backward kernels (dq, dk/dv)
               against ``flash_attention_bwd_plain`` on the same inputs at
               qwen2-1.5b's training shape (B=2, S=4,096, bf16), gemma-2b's
               (hd=256, MQA), a ragged (S=1,000), a full and an f32 case,
               each gap against a stated tolerance; kernel / plain / bound /
               library times;
10. train_parity — reduced qwen2-1.5b in f32, flash attention, full remat,
               the same weights on the card and on the CPU: three
               ``make_train_step`` steps agree; then a ``Trainer`` run of 8
               steps against one preempted after 4 and resumed by a fresh
               ``Trainer``, which must end bitwise equal;
11. train    — full-width qwen2-1.5b (f32 master weights and AdamW state,
               bf16 compute, flash attention, full remat, 4 x 4,096 tokens a
               step as 2 microbatches): 3 steps, a preemption through the
               ``PreemptionController`` with a checkpoint, a fresh
               ``Trainer`` restoring and taking 2 more: step time, tokens/s,
               model-flops utilisation, peak memory, checkpoint bytes,
               drain and restore seconds, launch counts checked against the
               path, the device's busy share and time by kernel class over
               one traced step, and the first step against reference
               attention on the same batch;
12. the ``kernels`` line, then the card's name and power limit, then the
    result line.

TF32 is off for matmuls and cuDNN (``allow_tf32 = False``), so every f32
product here is full f32.  The script imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device visible; this script needs an NVIDIA GPU")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.core import fleets  # noqa: E402
from repro_torch.core.convert import fleet_state_to_numpy  # noqa: E402
from repro_torch.core.policy import SchedulerPolicy  # noqa: E402
from repro_torch.core.simulator import SoASimulator, WorkloadSpec  # noqa: E402
from repro_torch.core.soa_fleet import SoAFleet  # noqa: E402
from repro_torch.core.torch_scheduler import STATE_DTYPES, fleet_slot_costs  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.core.preemption import PreemptAck, PreemptionController  # noqa: E402
from repro_torch.core.types import TPU_SPEC, Instance  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.training import Trainer, TrainerConfig, TrainSettings, make_train_step  # noqa: E402
from repro_torch.training.trainer import state_tensors  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N_HOSTS = 65_536
M = 64
DEV = torch.device("cuda")
CHURN_MULT = (1.0, 1.0, 0.5, 0.25, 2.0)
#: (HBM bytes/s, FP32 flop/s, BF16 tensor-core flop/s) from NVIDIA's data
#: sheets, dense rates
PEAKS = {"SXM": (3.35e12, 67e12, 989e12), "PCIe": (2.0e12, 51e12, 756e12)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` runs of ``fn`` timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_spans(prof):
    """(start_us, end_us, name) of every device activity in a trace."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


#: the ``device_ms`` measurements (by the line of their lambda) and
#: ``kernel_ms`` kernels that the profiler could not time and CUDA events
#: timed instead
EVENT_TIMED = []


def traced_spans(fn, reps: int, warmup: int):
    """Device spans of ``reps`` calls of ``fn`` (each followed by a
    synchronize, so calls never overlap) after ``warmup`` calls.  The
    profiler on the card's machine now and then returns a trace with no
    device activity at all (twice in a row at one and the same measurement,
    ``F.rms_norm`` at the decode shape); such a trace is taken again, up to
    3 times, and ``[]`` returned after the third."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
        spans = device_spans(prof)
        if spans:
            return spans
    return []


def device_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``: the durations of the
    kernels (and fills) it runs, from a ``torch.profiler`` trace of ``reps``
    calls (the mean when the trace's span count does not split evenly into
    calls).  Where no trace shows device activity, the median of ``reps``
    calls timed with CUDA events (``median_ms``), which counts the host's
    launch gaps too, so reads high for a call of a few microseconds."""
    spans = traced_spans(fn, reps, warmup)
    if not spans:
        EVENT_TIMED.append(f"chip_smoke.py:{fn.__code__.co_firstlineno}")
        return median_ms(fn, reps, warmup=0)
    if len(spans) % reps:           # a one-off span: fall back to the mean
        return sum(b - a for a, b, _ in spans) / reps / 1e3
    per = len(spans) // reps
    return float(np.median([sum(b - a for a, b, _ in spans[i * per:(i + 1) * per])
                            for i in range(reps)])) / 1e3


def launch_event_ms(fn, symbols, reps: int) -> dict:
    """Median time of each named launch over ``reps`` calls of ``fn``, from
    CUDA events recorded on the launch's stream just before and after it:
    ``_build.entry`` is wrapped for the duration, so the port's wrappers run
    unchanged.  ``symbols`` maps a key to a C launch entry's name."""
    real, marks = _build.entry, {key: [] for key in symbols}

    def entry(name, symbol, argtypes):
        launch = real(name, symbol, argtypes)
        key = next((key for key, sym in symbols.items() if sym == symbol), None)
        if key is None:
            return launch

        def timed(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            err = launch(*args)
            end.record()
            marks[key].append((start, end))
            return err
        return timed

    _build.entry = entry
    try:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
    finally:
        _build.entry = real
    for key, m in marks.items():
        check(len(m) == reps, f"{len(m)} launches of {symbols[key]} in {reps} calls")
    return {key: float(np.median([a.elapsed_time(b) for a, b in m])) for key, m in marks.items()}


def max_gap(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max()) if a.numel() else 0.0


#: largest |kernel - plain| measured per kernel (phases 3 and 6)
GAPS = {"sched_screen_consts": 0.0, "sched_screen_topm": 0.0, "sched_screen": 0.0,
        "sched_weigh": 0.0, "flash_attention": 0.0, "rmsnorm": 0.0,
        "flash_attention_dq": 0.0, "flash_attention_dkv": 0.0}


def same(a, b, what: str, kernel: str) -> None:
    gap = max_gap(a, b)
    GAPS[kernel] = max(GAPS[kernel], gap)
    check(torch.equal(a.cpu(), b.cpu()),
          f"{what}: kernel differs from its plain version (max gap {gap})")


def busy_us(prof) -> float:
    """Union of the device activity intervals in a profiler trace."""
    total, end = 0.0, float("-inf")
    for a, b, _ in device_spans(prof):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------
smi = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, check=True,
).stdout.strip().splitlines()[0]
kind = torch.cuda.get_device_name(0)
form = "PCIe" if "PCIe" in kind else "SXM"
HBM_BPS, FP32_FLOPS, BF16_FLOPS = PEAKS[form]
emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
     name=kind, count=torch.cuda.device_count(), peaks_for=form,
     tf32="off (matmul and cudnn)")

# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------
t0 = time.perf_counter()
paths = _build.build(kernels.SOURCES)
for name in kernels.SOURCES:
    _build.load(name)
emit("build", seconds=time.perf_counter() - t0, libraries=sorted(os.path.basename(p) for p in paths.values()))

# ---------------------------------------------------------------------------
# 3. kernels against their plain versions at the main path's shapes
# ---------------------------------------------------------------------------
t0 = time.perf_counter()
fleet = SoAFleet(fleets.saturated_fleet(N_HOSTS, seed=0), device=DEV)
emit("fleet", hosts=N_HOSTS, k=fleet.k_slots, build_seconds=time.perf_counter() - t0)
st = fleet.state
policy = SchedulerPolicy()
n, k, d = st.inst_res.shape
req = torch.tensor(fleets.SIZES["medium"].vec, dtype=torch.float32, device=DEV)
costs = fleet_slot_costs(st, fleets.NOW, policy)
head = (st.free_f, st.free_n, st.schedulable, st.domain, st.slow, st.inst_res, costs,
        st.inst_valid, req, False, -1)
mult = policy.weigher_multipliers

rng = np.random.default_rng(1)
churn = torch.from_numpy((rng.integers(0, 8, n) / 8.0).astype(np.float32)).to(DEV)
zone = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(DEV)
churn_kw = dict(churn=churn, churn_threshold=0.5, host_zone=zone, exclude_zone=2)

records = {}
host_bytes = 4 * (2 * d + 2 + k * d + k) + (1 + k)   # f32 columns + bool flags


def record(name, source, replaces, ms, plain_ms, bytes_moved, ops, flops=None,
           library_ms=None):
    """One entry of the kernels line; ``flops`` is the peak rate of the
    operations' type (FP32 unless given)."""
    t_bytes, t_ops = bytes_moved / HBM_BPS * 1e3, ops / (flops or FP32_FLOPS) * 1e3
    records[name] = dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=0,
        max_abs_err=GAPS[name], ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=library_ms,
    )


for case, kw, mlt in (("default", {}, mult), ("churn_zone", churn_kw, CHURN_MULT)):
    for pre in (False, True):
        h = head[:9] + (pre, -1)
        consts = kernels.sched_screen_consts(*h, mlt, True, **kw)
        consts_p = kernels.sched_screen_consts_plain(*h, mlt, True, **kw)
        same(consts, consts_p, f"sched_screen_consts {case} pre={pre}", "sched_screen_consts")
        top = kernels.sched_screen_topm(*h, consts_p, mlt, True, M + 1, **kw)
        top_p = kernels.sched_screen_topm_plain(*h, consts_p, mlt, True, M + 1, **kw)
        same(top[0], top_p[0], f"sched_screen_topm scores {case} pre={pre}", "sched_screen_topm")
        same(top[1], top_p[1], f"sched_screen_topm idx {case} pre={pre}", "sched_screen_topm")
        fused = kernels.sched_screen(*h, mlt, True, M + 1, **kw)
        same(fused[1], top_p[1], f"sched_screen idx {case} pre={pre}", "sched_screen")
        same(fused[0], top_p[0], f"sched_screen scores {case} pre={pre}", "sched_screen")
        same(fused[2], consts_p, f"sched_screen consts {case} pre={pre}", "sched_screen")

# the main path's own case: the default policy, a normal request
consts_p = kernels.sched_screen_consts_plain(*head, mult, True)
top_p = kernels.sched_screen_topm_plain(*head, consts_p, mult, True, M + 1)
cand = top_p[1][:M].long()
rows = (st.free_f[cand], st.inst_res[cand], costs[cand], st.inst_valid[cand], req)
got, want = kernels.sched_weigh_gathered(*rows), kernels.sched_weigh_plain(*rows)
for g, w, what in zip(got, want, ("cost", "mask", "feasible")):
    same(g, w, f"sched_weigh_gathered K=8 {what}", "sched_weigh")
full_args = (st.free_f, st.inst_res, costs, st.inst_valid, req)
got, want = kernels.sched_weigh(*full_args), kernels.sched_weigh_plain(*full_args)
for g, w, what in zip(got, want, ("cost", "mask", "feasible")):
    same(g, w, f"sched_weigh full fleet {what}", "sched_weigh")
packed, preq = fleets.packed_arrays(M, 12, seed=2)
packed["inst_cost"] = (fleets.NOW - packed["inst_start"]).astype(np.float32)
rows12 = tuple(torch.from_numpy(packed[f]).to(DEV) for f in
               ("free_f", "inst_res", "inst_cost", "inst_valid")) + (torch.from_numpy(preq).to(DEV),)
got12, want12 = kernels.sched_weigh_gathered(*rows12), kernels.sched_weigh_plain(*rows12)
for g, w, what in zip(got12, want12, ("cost", "mask", "feasible")):
    same(g, w, f"sched_weigh_gathered K=12 {what}", "sched_weigh")

# one non-integer case: costs at a fractional clock
costs_f = fleet_slot_costs(st, fleets.NOW + 0.3, policy)
hf = head[:6] + (costs_f,) + head[7:]
frac = kernels.sched_screen(*hf, mult, True, M + 1)
frac_c = kernels.sched_screen_consts_plain(*hf, mult, True)
frac_p = kernels.sched_screen_topm_plain(*hf, frac_c, mult, True, M + 1)
frac_gap = max(max_gap(frac[0], frac_p[0]), max_gap(frac[2], frac_c))
for name in ("sched_screen", "sched_screen_topm"):
    GAPS[name] = max(GAPS[name], max_gap(frac[0], frac_p[0]))
for name in ("sched_screen", "sched_screen_consts"):
    GAPS[name] = max(GAPS[name], max_gap(frac[2], frac_c))
frac_same = bool(torch.equal(frac[1].cpu(), frac_p[1].cpu()))
rows_f = (st.free_f[cand], st.inst_res[cand], costs_f[cand], st.inst_valid[cand], req)
wf, wfp = kernels.sched_weigh_gathered(*rows_f), kernels.sched_weigh_plain(*rows_f)
frac_gap = max(frac_gap, max_gap(wf[0], wfp[0]))
GAPS["sched_weigh"] = max(GAPS["sched_weigh"], max_gap(wf[0], wfp[0]))
frac_same = frac_same and bool(torch.equal(wf[1].cpu(), wfp[1].cpu()))
check(frac_same, "non-integer case: kernel and plain version pick different hosts/plans")
# a weigher vector that mixes exact and inexact multipliers, on the
# fractional costs: the fused multiply-add sites must agree bit for bit
mixed = (2.0, 1.0, 0.7, 1.0)
mix = kernels.sched_screen(*hf, mixed, True, M + 1)
mix_c = kernels.sched_screen_consts_plain(*hf, mixed, True)
mix_p = kernels.sched_screen_topm_plain(*hf, mix_c, mixed, True, M + 1)
same(mix[0], mix_p[0], "sched_screen scores (2, 1, 0.7, 1)", "sched_screen")
same(mix[1], mix_p[1], "sched_screen idx (2, 1, 0.7, 1)", "sched_screen")
same(mix[2], mix_c, "sched_screen consts (2, 1, 0.7, 1)", "sched_screen")
emit("kernels_vs_plain", hosts=n, k=k, d=d, m=M, integer_cases="exact",
     non_integer_max_gap=frac_gap, non_integer_decisions_agree=frac_same,
     mixed_multipliers=list(mixed), mixed_multipliers_case="exact")

# times at the main path's shapes
screen_ops = n * 400                        # compares/adds/mins per host and pass
weigh_ops = lambda rows_, kk: rows_ * ((1 << (kk - 1)) * kk * (d + 1) + (1 << kk) * (d + 3))
c_ms = device_ms(lambda: kernels.sched_screen_consts(*head, mult, True))
c_pms = device_ms(lambda: kernels.sched_screen_consts_plain(*head, mult, True))
record("sched_screen_consts", "src/repro_torch/kernels/csrc/sched_screen.cu",
       "src/repro/kernels/sched_screen.py:267", c_ms, c_pms, n * host_bytes + 40,
       screen_ops)
t_ms = device_ms(lambda: kernels.sched_screen_topm(*head, consts_p, mult, True, M + 1))
t_pms = device_ms(lambda: kernels.sched_screen_topm_plain(*head, consts_p, mult, True, M + 1))
record("sched_screen_topm", "src/repro_torch/kernels/csrc/sched_screen.cu",
       "src/repro/kernels/sched_screen.py:302", t_ms, t_pms,
       n * host_bytes + 40 + (M + 1) * 8, screen_ops)
s_ms = device_ms(lambda: kernels.sched_screen(*head, mult, True, M + 1))
s_pms = device_ms(lambda: kernels.sched_screen_topm_plain(
    *head, kernels.sched_screen_consts_plain(*head, mult, True), mult, True, M + 1))
record("sched_screen", "src/repro_torch/kernels/csrc/sched_screen.cu",
       "src/repro/kernels/sched_screen.py:210", s_ms, s_pms,
       n * host_bytes + 40 + (M + 1) * 8, 2 * screen_ops)
w_ms = device_ms(lambda: kernels.sched_weigh_gathered(*rows))
w_pms = device_ms(lambda: kernels.sched_weigh_plain(*rows))
record("sched_weigh", "src/repro_torch/kernels/csrc/sched_weigh.cu",
       "src/repro/kernels/sched_weigh.py:35", w_ms, w_pms,
       M * (4 * (d + k * d + k) + k) + d * 4 + M * 9, weigh_ops(M, k))
extra = dict(
    sched_weigh_full_fleet_ms=device_ms(lambda: kernels.sched_weigh(*full_args), reps=20),
    sched_weigh_full_fleet_plain_ms=device_ms(lambda: kernels.sched_weigh_plain(*full_args), reps=20),
    sched_weigh_full_fleet_bound_ms=weigh_ops(n, k) / FP32_FLOPS * 1e3,
    sched_weigh_k12_gathered_ms=device_ms(lambda: kernels.sched_weigh_gathered(*rows12)),
    sched_weigh_k12_gathered_plain_ms=device_ms(lambda: kernels.sched_weigh_plain(*rows12)),
    sched_weigh_k12_gathered_bound_ms=weigh_ops(M, 12) / FP32_FLOPS * 1e3,
)
call_ms = dict(
    sched_screen_consts=median_ms(lambda: kernels.sched_screen_consts(*head, mult, True)),
    sched_screen_topm=median_ms(
        lambda: kernels.sched_screen_topm(*head, consts_p, mult, True, M + 1)),
    sched_screen=median_ms(lambda: kernels.sched_screen(*head, mult, True, M + 1)),
    sched_weigh=median_ms(lambda: kernels.sched_weigh_gathered(*rows)),
)
emit("kernel_times", card=smi, method="ms/plain_ms: device time per call (trace); "
     "call_ms: CUDA events around one call, host enqueue included",
     **{r["name"]: {key: r[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")}
        | {"call_ms": call_ms[r["name"]]} for r in records.values()}, **extra)

# ---------------------------------------------------------------------------
# 4. main-path parity: the simulator on the card and on the CPU
# ---------------------------------------------------------------------------
def sim(device):
    s = SoASimulator(
        fleets.saturated_fleet(4096, seed=5),
        WorkloadSpec(arrival_rate_per_s=0.5, flavors=list(fleets.SIZES.items())),
        seed=6, device=device,
    )
    s.inject_stragglers(0.02)
    s.inject_host_failure("h17", at_s=600.0, heal_after_s=900.0)
    s.inject_host_failure("h2048", at_s=1500.0)
    t = time.perf_counter()
    metrics = s.run(2200.0)
    return s, metrics, time.perf_counter() - t


gsim, gm, g_s = sim(DEV)
csim, cm, c_s = sim("cpu")
counters = ("failures_normal", "failures_preemptible", "placed_normal",
            "placed_preemptible", "preemptions")
for key in counters:
    check(getattr(gm, key) == getattr(cm, key), f"parity: {key} differs")
check(gm.utilization == cm.utilization, "parity: utilization samples differ")
check(list(gsim.fleet.instances) == list(csim.fleet.instances), "parity: placements differ")
check(gsim.fleet.locator == csim.fleet.locator, "parity: instance locations differ")
check([i.id for i in gsim.fleet.preempted] == [i.id for i in csim.fleet.preempted],
      "parity: preemptions differ")
g_arr, c_arr = fleet_state_to_numpy(gsim.fleet.state), fleet_state_to_numpy(csim.fleet.state)
for f in STATE_DTYPES:
    check(np.array_equal(g_arr[f], c_arr[f]), f"parity: final state {f} differs")
check(gsim.fleet.decisions >= 1000, "parity: fewer than 1,000 decisions")
emit("parity", hosts=4096, decisions=gsim.fleet.decisions,
     fallbacks=gsim.fleet.fallbacks, **{key: getattr(gm, key) for key in counters},
     gpu_seconds=g_s, cpu_seconds=c_s)

# ---------------------------------------------------------------------------
# 5. main path at full size
# ---------------------------------------------------------------------------
sizes = list(fleets.SIZES.values())
rng = np.random.default_rng(7)
clock = [fleets.NOW]


def batch(b, tag):
    items = []
    for i in range(b):
        clock[0] += float(rng.integers(1, 20))
        items.append((Request(id=f"{tag}{i}", resources=sizes[int(rng.integers(0, 3))],
                              preemptible=bool(i % 2)), clock[0], 1.0))
    return items


fleet.schedule_batch(batch(64, "warm"))          # warm-up: caches, allocator
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
kernels.reset_launch_counts()
d0, f0, pre0 = fleet.decisions, fleet.fallbacks, len(fleet.preempted)
batch_s = []
for j in range(32):
    items = batch(64, f"b{j}-")
    t = time.perf_counter()
    fleet.schedule_batch(items)
    batch_s.append(time.perf_counter() - t)
single_s = []
for i, item in enumerate(batch(512, "s")):
    t = time.perf_counter()
    fleet.schedule_request(*item)
    single_s.append(time.perf_counter() - t)
with torch.profiler.profile(
    activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
) as prof:
    torch.cuda.synchronize()
    t = time.perf_counter()
    for j in range(4):
        fleet.schedule_batch(batch(64, f"p{j}-"))
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t
counts = kernels.launch_counts()
decisions = fleet.decisions - d0
device_us = busy_us(prof)
by_kernel = {}
for a, b, name in device_spans(prof):
    key = name if ("sched_weigh" in name or "screen_" in name) else "pytorch ops"
    by_kernel[key] = by_kernel.get(key, 0.0) + (b - a)
emit("trace", decisions=4 * 64, window_ms=window_s * 1e3,
     host_ms_per_decision=window_s * 1e3 / (4 * 64),
     device_us_per_decision={key: v / (4 * 64) for key, v in sorted(by_kernel.items())})
for name in records:
    records[name]["launches"] = counts[name]
    check(counts[name] > 0, f"main path: kernel {name} was never launched")
check(decisions >= 2000, "main path: fewer than 2,000 decisions")
check(len(fleet.preempted) > pre0, "main path: no preemptions")
t = time.perf_counter()
synced = fleet.sync_hosts()                      # Host.place re-checks capacity
check(sum(len(h.instances) for h in synced) == len(fleet.instances), "sync_hosts lost instances")
emit("main_path", hosts=N_HOSTS, k=fleet.k_slots, m=M, decisions=decisions,
     batch_decisions_per_s=32 * 64 / sum(batch_s),
     batch_p50_ms_per_decision=float(np.median(batch_s)) / 64 * 1e3,
     single_p50_ms=float(np.percentile(single_s, 50)) * 1e3,
     single_p99_ms=float(np.percentile(single_s, 99)) * 1e3,
     single_samples=len(single_s), fallbacks=fleet.fallbacks - f0,
     preemptions=len(fleet.preempted) - pre0, launches=counts,
     peak_device_mib=torch.cuda.max_memory_allocated() / 2**20,
     traced_window_ms=window_s * 1e3, device_busy_ms=device_us / 1e3,
     device_busy_share=(device_us / 1e6) / window_s if device_us else "not measured",
     sync_hosts_seconds=time.perf_counter() - t)

# ---------------------------------------------------------------------------
# 6. model kernels against their plain versions
# ---------------------------------------------------------------------------
#: tolerances (|kernel - plain| <= tol + tol * |plain|), with their reasons:
#: a bf16 output may round one bf16 ulp apart (2e-2, as the JAX package's
#: kernel tests, tests/test_kernels.py:40); an f32 output and the f32 lse
#: differ by summation order only (flash 2e-5, lse 1e-4, RMSNorm 1e-5).
OUT_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
LSE_TOL = 1e-4
RMS_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
BF16, F32 = torch.bfloat16, torch.float32


def within(got, want, tol, what, kernel):
    """Record the max gap; raise unless every element is within tol."""
    gap = max_gap(got, want)
    GAPS[kernel] = max(GAPS[kernel], gap)
    g, w = got.double(), want.double()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite kernel output")
    check(bool(((g - w).abs() <= tol + tol * w.abs()).all()),
          f"{what}: kernel beyond tolerance {tol} of its plain version (max gap {gap})")
    return gap


gen = torch.Generator(device=DEV).manual_seed(12)
flash_cases = [  # name, B, S, H, G, hd, dtype, causal
    ("qwen2-1.5b", 4, 1024, 12, 2, 128, BF16, True),
    ("gemma-2b", 1, 512, 8, 1, 256, BF16, True),
    ("full", 2, 512, 12, 2, 128, BF16, False),
    ("ragged S=1000", 2, 1000, 12, 2, 128, BF16, True),
    ("f32 S=77", 2, 77, 4, 2, 64, F32, True),
]
flash_rows = {}
for name, b_, s_, h_, g_, hd_, dt, causal in flash_cases:
    qkv = [torch.randn((b_, s_, n_, hd_), generator=gen, device=DEV).to(dt) for n_ in (h_, g_, g_)]
    o, lse = kernels.flash_attention(*qkv, causal=causal)
    po, plse = kernels.flash_attention_plain(*qkv, causal=causal)
    flash_rows[name] = dict(
        o_gap=within(o, po, OUT_TOL[dt], f"flash {name} o", "flash_attention"),
        o_tol=OUT_TOL[dt], lse_gap=within(lse, plse, LSE_TOL, f"flash {name} lse", "flash_attention"),
        lse_tol=LSE_TOL)
rms_rows = {}
for name, rows_, d_, dt in (("prefill bf16", 4096, 1536, BF16), ("prefill f32", 4096, 1536, F32),
                            ("decode bf16", 8, 1536, BF16)):
    x = torch.randn((rows_, d_), generator=gen, device=DEV).to(dt)
    w = (0.1 * torch.randn((d_,), generator=gen, device=DEV)).to(dt)
    rms_rows[name] = dict(gap=within(kernels.rmsnorm(x, w, 1e-6), kernels.rmsnorm_plain(x, w, 1e-6),
                                     RMS_TOL[dt], f"rmsnorm {name}", "rmsnorm"), tol=RMS_TOL[dt])
emit("model_kernels_vs_plain", flash_attention=flash_rows, rmsnorm=rms_rows,
     tolerance="|kernel - plain| <= tol * (1 + |plain|): bf16 outputs 2e-2 (one bf16 ulp, "
               "tests/test_kernels.py:40), f32 by summation order")

# times at the main path's shapes: the qwen2-1.5b prefill (4 x 1,024 tokens)
q, k, v = (torch.randn((4, 1024, n_, 128), generator=gen, device=DEV).to(BF16) for n_ in (12, 2, 2))
qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
pairs = 4 * 12 * 1024 * 1025 // 2                  # (query, key) pairs the causal mask keeps
record("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
       "src/repro/kernels/flash_attention.py:52",
       device_ms(lambda: kernels.flash_attention(q, k, v, causal=True)),
       device_ms(lambda: kernels.flash_attention_plain(q, k, v, causal=True)),
       2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * 4 * 12 * 1024, 4 * 128 * pairs,
       flops=BF16_FLOPS,
       library_ms=device_ms(lambda: F.scaled_dot_product_attention(
           qt, kt, vt, is_causal=True, enable_gqa=True)))
x = torch.randn((4096, 1536), generator=gen, device=DEV).to(BF16)
w = (0.1 * torch.randn((1536,), generator=gen, device=DEV)).to(BF16)
w1 = 1.0 + w
record("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:18",
       device_ms(lambda: kernels.rmsnorm(x, w, 1e-6)),
       device_ms(lambda: kernels.rmsnorm_plain(x, w, 1e-6)),
       2 * 2 * 4096 * 1536 + 2 * 1536, 4 * 4096 * 1536,
       library_ms=device_ms(lambda: F.rms_norm(x, (1536,), weight=w1, eps=1e-6)))
xd = x[:8].contiguous()
emit("model_kernel_times", card=smi, method="device time per call (trace), median of 25",
     **{r: {key: records[r][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in ("flash_attention", "rmsnorm")},
     rmsnorm_decode_8x1536=dict(
         ms=device_ms(lambda: kernels.rmsnorm(xd, w, 1e-6)),
         plain_ms=device_ms(lambda: kernels.rmsnorm_plain(xd, w, 1e-6)),
         library_ms=device_ms(lambda: F.rms_norm(xd, (1536,), weight=w1, eps=1e-6)),
         bound_ms=(2 * 2 * 8 * 1536 + 2 * 1536) / HBM_BPS * 1e3))
del q, k, v, qt, kt, vt, x, w, w1, xd

# ---------------------------------------------------------------------------
# 7. model parity: reduced qwen2-1.5b, the card against the CPU, f32
# ---------------------------------------------------------------------------
rcfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")), attention_impl="flash")
cpu_params = tm.init_params(rcfg, torch.Generator().manual_seed(3), device="cpu")
gpu_params = tm.Model(rcfg, device="meta")
gpu_params.load_state_dict({key: t.to(DEV) for key, t in cpu_params.state_dict().items()},
                           assign=True)
toks = torch.from_numpy(np.random.default_rng(4).integers(2, rcfg.vocab_size, (3, 200)))
lg = tm.forward_logits(rcfg, gpu_params, {"tokens": toks.to(DEV)}, last_only=False)
lc = tm.forward_logits(rcfg, cpu_params, {"tokens": toks}, last_only=False)
parity_gap = max_gap(lg, lc)
check(bool(torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4)),
      f"model parity: forward_logits on the card vs the CPU, max gap {parity_gap} (f32 tol 1e-4)")
check(torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)), "model parity: argmax differs")
rng = np.random.default_rng(5)
reqs = [(f"r{i}", rng.integers(2, rcfg.vocab_size, int(rng.integers(3, 40))), 12) for i in range(5)]
served = []
for params_ in (gpu_params, cpu_params):
    eng = ServingEngine(rcfg, params_, ServeConfig(max_batch=3, max_len=64))
    for rid, prompt, max_new in reqs:
        eng.submit(rid, prompt, max_new=max_new)
    served.append((eng.run_until_drained(), eng.steps_executed))
check(served[0] == served[1], "model parity: the engines' completed tokens or steps differ")
emit("model_parity", config="qwen2-1.5b reduced (4 layers, d=128, f32)",
     forward_logits_max_gap=parity_gap, tolerance=1e-4, requests=len(reqs),
     steps_executed=served[0][1], completed_identical=True)
del cpu_params, gpu_params, lg, lc

# ---------------------------------------------------------------------------
# 8. serve: full-width qwen2-1.5b
# ---------------------------------------------------------------------------
cfg = get_config("qwen2-1.5b")
t0 = time.perf_counter()
params = tm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
torch.cuda.synchronize()
init_s = time.perf_counter() - t0
toks = torch.from_numpy(np.random.default_rng(6).integers(2, cfg.vocab_size, (4, 1024))).to(DEV)
# the f32 forward (f32 weights and math) is the truth the bf16 paths are held to
truth = tm.forward_logits(dataclasses.replace(cfg, dtype="float32"), params,
                          {"tokens": toks}, last_only=False)
impl_cfg = {impl: dataclasses.replace(cfg, attention_impl=impl) for impl in ("flash", "reference")}
for c in impl_cfg.values():                         # warm-up: cuBLAS's bf16 plans
    tm.forward_logits(c, params, {"tokens": toks})
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
kernels.reset_launch_counts()
fwd, fwd_s = {}, {}
for impl, c in impl_cfg.items():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tm.forward_logits(c, params, {"tokens": toks}, last_only=False)
    torch.cuda.synchronize()
    fwd_s[impl] = time.perf_counter() - t0
    fwd[impl] = out.float()
    del out
gaps = {}
for impl, lgt in fwd.items():
    check(bool(torch.isfinite(lgt).all()), f"serve: {impl} logits not finite")
    check(lgt.shape == (4, 1024, cfg.vocab_padded), f"serve: {impl} logits shape {lgt.shape}")
    dlt = (lgt - truth).abs()
    gaps[impl] = dict(max=float(dlt.max()), mean=float(dlt.mean()),
                      argmax_agree=float((lgt.argmax(-1) == truth.argmax(-1)).float().mean()))
flash_vs_ref = float((fwd["flash"] - fwd["reference"]).abs().max())
# the stated bf16 bound: the flash path may be no further from the f32
# forward than 1.25x the distance of the JAX package's own bf16 path (the
# reference attention) — both gaps are bf16 rounding, which these random
# weights amplify: JAX's init draws layer weights with std 1/sqrt(L), so
# attention scores are large and softmax is near one-hot
for stat in ("max", "mean"):
    check(gaps["flash"][stat] <= 1.25 * gaps["reference"][stat],
          f"serve: flash logits {stat} gap to f32 {gaps['flash'][stat]} exceeds 1.25x the "
          f"bf16 reference path's {gaps['reference'][stat]}")
del fwd, truth

engine_rng = np.random.default_rng(7)
prompts = [engine_rng.integers(2, cfg.vocab_size, int(n_)) for n_ in engine_rng.integers(64, 513, 8)]
prefill_s, decode_s = [], []
PREEMPT_AFTER = 32                                  # decode steps: half of max_new = 64


def timed(engine, preempt_after=None):
    """Time the engine's prefill and decode calls (each synchronized); with
    ``preempt_after``, signal PREEMPT after that many decode steps, as a
    preemption controller would."""
    prefill_fn, decode_fn = engine._prefill, engine._decode

    def prefill_timed(p, toks_):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out_ = prefill_fn(p, toks_)
        torch.cuda.synchronize()
        prefill_s.append((time.perf_counter() - t, toks_.numel()))
        return out_

    def decode_timed(p, tok, st):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out_ = decode_fn(p, tok, st)
        torch.cuda.synchronize()
        decode_s.append((time.perf_counter() - t, tok.shape[0]))
        if preempt_after is not None and engine.steps_executed + 1 == preempt_after:
            engine.on_preempt(now=0.0, deadline=30.0)
        return out_

    engine._prefill, engine._decode = prefill_timed, decode_timed
    return engine


scfg = ServeConfig(max_batch=8, max_len=1024)
first = timed(ServingEngine(cfg, params, scfg), PREEMPT_AFTER)
for i, prompt in enumerate(prompts):
    first.submit(f"req{i}", prompt, max_new=64)
first.run_until_drained()
requeued = [r.rid for r in first.queue]
second = timed(ServingEngine(cfg, params, scfg))
second.queue = first.queue
second.run_until_drained()
torch.cuda.synchronize()
counts = kernels.launch_counts()
done = {**first.completed, **second.completed}
check(first.steps_executed == PREEMPT_AFTER, f"serve: preempted after {first.steps_executed} steps")
check(len(requeued) > 0, "serve: the preemption re-queued nothing")
check(sorted(done) == sorted(f"req{i}" for i in range(8)), f"serve: completed {sorted(done)}")
for rid, out in done.items():
    check(1 <= len(out) <= 64 and all(0 <= t_ < cfg.vocab_size for t_ in out),
          f"serve: {rid} returned {len(out)} tokens or an id outside the vocabulary")
peak_gib = torch.cuda.max_memory_allocated() / 2**30
for name in ("flash_attention", "rmsnorm"):
    records[name]["launches"] = counts[name]
    check(counts[name] > 0, f"serve: kernel {name} was never launched")
check(counts["flash_attention"] == cfg.n_layers, "serve: one flash launch per layer expected")

# a traced decode window: 8 steps of the engine's loop on a cache primed
# with the first 64 tokens of every prompt
pc = first._params_c
wave = torch.from_numpy(np.stack([p_[:64] for p_ in prompts])).to(DEV)
lgt, st = tm.prefill(cfg, pc, wave, 1024)
nxt = torch.argmax(lgt[:, -1, :], -1)[:, None]
torch.cuda.synchronize()
with torch.profiler.profile(
    activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
) as prof:
    t0 = time.perf_counter()
    for _ in range(8):
        lgt, st = tm.decode_step(cfg, pc, nxt, st)
        nxt = torch.argmax(lgt[:, -1, :], -1)[:, None]
        nxt[:, 0].tolist()
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
busy = busy_us(prof)
by_kernel = {}
for a, b_, name in device_spans(prof):
    key = ("flash_attention" if "flash_fwd" in name else "rmsnorm" if "rmsnorm" in name
           else "gemm" if any(t in name for t in ("gemm", "nvjet", "sm90", "cutlass"))
           else "other ops")
    by_kernel[key] = by_kernel.get(key, 0.0) + (b_ - a)
# where the host's time goes: the PyTorch ops with the most self CPU time
host_ops = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:10]
pf_time = sum(t_ for t_, _ in prefill_s)
dec = [t_ for t_, _ in decode_s]
emit("serve", config="qwen2-1.5b full width: 28 layers, d=1536, 12/2 heads, hd=128, "
     "d_ff=8960, vocab 151,936; f32 master weights (seed 0), bf16 compute",
     params=sum(p_.numel() for p_ in params.parameters()), init_seconds=init_s,
     forward_logits_tokens=4 * 1024, forward_logits_seconds=fwd_s,
     forward_logits_tokens_per_s={impl: 4 * 1024 / s_ for impl, s_ in fwd_s.items()},
     logit_gap_to_f32=gaps, flash_vs_reference_max_gap=flash_vs_ref,
     requests=8, prompt_lens=[len(p_) for p_ in prompts], max_new=64,
     preempted_after_steps=PREEMPT_AFTER, requeued=requeued,
     completed_by_first=sorted(first.completed), completed_by_second=sorted(second.completed),
     tokens_returned=sum(len(o_) for o_ in done.values()),
     prefill_tokens_per_s=sum(n_ for _, n_ in prefill_s) / pf_time,
     prefill_calls=len(prefill_s),
     decode_steps=len(dec), decode_p50_ms=float(np.median(dec)) * 1e3,
     decode_p99_ms=float(np.percentile(dec, 99)) * 1e3,
     decode_tokens_per_s=sum(n_ for _, n_ in decode_s) / sum(dec),
     peak_device_gib=peak_gib, launches=dict(flash_attention=counts["flash_attention"],
                                             rmsnorm=counts["rmsnorm"]),
     traced_decode_window_ms=window_s * 1e3, device_busy_ms=busy / 1e3,
     device_busy_share=(busy / 1e6) / window_s if busy else "not measured (empty trace)",
     device_us_per_decode_step={key: v_ / 8 for key, v_ in sorted(by_kernel.items())},
     host_top_ops_per_decode_step={e.key: dict(calls=e.count / 8,
                                               self_cpu_us=e.self_cpu_time_total / 8)
                                   for e in host_ops})

# ---------------------------------------------------------------------------
# 9. the backward kernels against their plain version
# ---------------------------------------------------------------------------
#: tolerances (|kernel - plain| <= tol + tol * |plain|), with their reasons:
#: bf16 gradients may round one bf16 ulp apart (2e-2, as the forward); f32
#: gradients differ by summation order only, over sums of up to S*H/G terms
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
#: and scaled to the tensor, ||kernel - plain|| / ||plain||, since most
#: gradients at S=4,096 lie near the elementwise floor: bf16 outputs rounded
#: from f32 values that differ in summation order are at most one ulp (2^-8
#: relative) apart, so 1e-2; f32, 1e-5.  A wrong tile moves this by its share
#: of the norm, however small the gradients there.
BWD_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def kernel_ms(fn, names, reps: int = 10, warmup: int = 2):
    """Median device time of each kernel over ``reps`` calls of ``fn`` (one
    launch of each per call); ``names`` maps a key to (a substring of the
    kernel's name in a trace, its C launch entry).  From a
    ``torch.profiler`` trace, whose median stands if it holds at least half
    the launches; else from CUDA events around each launch."""
    spans = traced_spans(fn, reps, warmup)
    durs = {key: [b_ - a for a, b_, name in spans if match in name]
            for key, (match, _) in names.items()}
    if all(2 * len(d_) >= reps for d_ in durs.values()):
        return {key: float(np.median(d_)) / 1e3 for key, d_ in durs.items()}
    EVENT_TIMED.extend(sym for _, sym in names.values())
    return launch_event_ms(fn, {key: sym for key, (_, sym) in names.items()}, reps)


bwd_cases = [  # name, B, S, H, G, hd, dtype, causal
    ("qwen2-1.5b train", 2, 4096, 12, 2, 128, BF16, True),
    ("gemma-2b", 1, 1024, 8, 1, 256, BF16, True),
    ("ragged S=1000", 2, 1000, 12, 2, 128, BF16, True),
    ("full", 2, 512, 12, 2, 128, BF16, False),
    ("f32 S=77", 2, 77, 4, 2, 64, F32, True),
]
bwd_rows = {}
for name, b_, s_, h_, g_, hd_, dt, causal in bwd_cases:
    q, k, v, do = (torch.randn((b_, s_, n_, hd_), generator=gen, device=DEV).to(dt)
                   for n_ in (h_, g_, g_, h_))
    o, lse = kernels.flash_attention_plain(q, k, v, causal=causal)
    got = kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    row = {}
    for grad, kname, g_k, g_p in zip(("dq", "dk", "dv"), ("flash_attention_dq",) + ("flash_attention_dkv",) * 2,
                                     got, want):
        check(g_k.dtype == dt and g_k.shape == g_p.shape, f"backward {name} {grad}: type or shape")
        gap = within(g_k, g_p, BWD_TOL[dt], f"backward {name} {grad}", kname)
        k64, p64 = g_k.double(), g_p.double()
        rms = float(torch.sqrt(torch.mean(p64 * p64)))
        rel = float(torch.linalg.vector_norm(k64 - p64) / torch.linalg.vector_norm(p64))
        check(rel <= BWD_REL[dt], f"backward {name} {grad}: relative gap {rel} beyond {BWD_REL[dt]}")
        row[grad] = dict(max_gap=gap, rel_gap=rel, rms_plain=rms)
        del k64, p64
    bwd_rows[name] = dict(row, tol=BWD_TOL[dt], rel_tol=BWD_REL[dt])
    del q, k, v, do, o, lse, got, want
emit("train_kernels_vs_plain", flash_attention_backward=bwd_rows,
     tolerance="|kernel - plain| <= tol * (1 + |plain|): bf16 2e-2 (one bf16 ulp), "
               "f32 1e-4 (summation order); ||kernel - plain|| / ||plain|| <= rel_tol: "
               "bf16 1e-2, f32 1e-5")

# times at the training path's shape: qwen2-1.5b, one microbatch of 2 x 4,096
B_T, S_T = 2, 4096
q, k, v, do = (torch.randn((B_T, S_T, n_, 128), generator=gen, device=DEV).to(BF16)
               for n_ in (12, 2, 2, 12))
o, lse = kernels.flash_attention_fwd(q, k, v, causal=True)
bwd_ms = kernel_ms(lambda: kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=True),
                   {"dq": ("flash_bwd_dq", "flash_attention_dq_launch"),
                    "dkv": ("flash_bwd_dkv", "flash_attention_dkv_launch")})
bwd_plain_ms = device_ms(lambda: kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True),
                         reps=10)
qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
sdpa_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
dot = do.transpose(1, 2)
lib_bwd_ms = device_ms(lambda: torch.autograd.grad(sdpa_o, (qt, kt, vt), dot, retain_graph=True),
                       reps=10)
pairs_t = B_T * 12 * S_T * (S_T + 1) // 2          # (query, key) pairs the causal mask keeps
io_q = 2 * B_T * S_T * 12 * 128                     # bytes of one bf16 (B,S,H,hd) tensor
io_kv = 2 * B_T * S_T * 2 * 128
rows_f32 = 4 * B_T * 12 * S_T                       # bytes of lse or delta
record("flash_attention_dq", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
       "src/repro/kernels/flash_attention.py:152", bwd_ms["dq"], bwd_plain_ms,
       2 * io_q + 2 * io_kv + 2 * rows_f32 + io_q, 6 * 128 * pairs_t, flops=BF16_FLOPS,
       library_ms=lib_bwd_ms)
record("flash_attention_dkv", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
       "src/repro/kernels/flash_attention.py:191", bwd_ms["dkv"], bwd_plain_ms,
       2 * io_q + 2 * io_kv + 2 * rows_f32 + 2 * io_kv, 8 * 128 * pairs_t, flops=BF16_FLOPS,
       library_ms=lib_bwd_ms)
# the same launches timed by CUDA events, kernel_ms's fallback, so that
# path runs on every card and its reading stands beside the trace's
bwd_event_ms = launch_event_ms(lambda: kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=True),
                               {"dq": "flash_attention_dq_launch", "dkv": "flash_attention_dkv_launch"},
                               reps=10)
fwd_t_ms = device_ms(lambda: kernels.flash_attention_fwd(q, k, v, causal=True), reps=10)
emit("train_kernel_times", card=smi, shape="B=2, S=4,096, H=12, G=2, hd=128, bf16, causal",
     method="device time per call (trace), median of 10; plain_ms and library_ms compute "
            "dq, dk and dv together (the plain backward; the backward of "
            "scaled_dot_product_attention through torch.autograd.grad)",
     **{r: {key: records[r][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in ("flash_attention_dq", "flash_attention_dkv")},
     event_timed_ms=bwd_event_ms, forward_ms_at_this_shape=fwd_t_ms,
     forward_bound_ms=4 * 128 * pairs_t / BF16_FLOPS * 1e3)
del q, k, v, do, o, lse, qt, kt, vt, sdpa_o, dot
torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# 10. training parity: reduced qwen2-1.5b, the card against the CPU, f32
# ---------------------------------------------------------------------------
pcfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")), attention_impl="flash", remat="full")
psettings = TrainSettings(total_steps=50, warmup_steps=2, learning_rate=1e-3)
pdata = SyntheticLMDataset(DataConfig(vocab_size=pcfg.vocab_size, seq_len=128, global_batch=4,
                                      seed=8))
#: f32 on both sides: the card's products and the kernels sum in another
#: order than the CPU's.  Each step starts from the CPU's weights and AdamW
#: state, copied to the card, so that the two trajectories cannot drift
#: apart (AdamW moves an element whose gradient is within rounding of 0 by
#: about lr either way, and this random network amplifies that from step to
#: step).  Losses agree to 1e-4; gradient norms to 1e-3 relative.  The same
#: steps with reference attention on both sides are the witness for that
#: bound: on an H100 they read the same gap as flash (3.5e-4 and 4.1e-4 at
#: the first step), so it comes from the card's products, not from the
#: flash kernels.
PARITY_TOL = {"loss": 1e-4, "grad_norm": 1e-3}
#: the card's update of each step against the CPU's from the same state,
#: ||d_card - d_cpu|| / ||d_cpu|| over each tensor's change d, the largest
#: over tensors, a few times what an H100 reads (params 1.6e-3, mu 6.6e-4,
#: nu 1.6e-3, with either attention): mu and nu follow the gradient; a
#: parameter's first AdamW moves are +-lr whatever its gradient's size, so
#: elements whose gradient is within rounding of 0 may move 2 lr apart.  An
#: update the card got wrong (not applied, no bias correction) reads 1 or
#: more.
UPDATE_TOL = {"params": 1e-2, "mu": 3e-3, "nu": 5e-3}


def card_vs_cpu(impl):
    """Three ``make_train_step`` steps of reduced qwen2-1.5b with ``impl``
    attention on the card and on the CPU, each from the CPU's state: per
    step the two sides' loss and gradient norm, and the largest relative gap
    of the card's update of params, mu and nu against the CPU's."""
    cfg_ = dataclasses.replace(pcfg, attention_impl=impl)
    cpu_params = tm.init_params(cfg_, torch.Generator().manual_seed(8), device="cpu")
    gpu_params = tm.Model(cfg_, device="meta")
    gpu_params.load_state_dict({key: t.to(DEV, copy=True) for key, t in cpu_params.state_dict().items()},
                               assign=True)
    step_fn = make_train_step(cfg_, psettings)
    states = {"gpu": (gpu_params, adamw_init(dict(gpu_params.named_parameters()))),
              "cpu": (cpu_params, adamw_init(dict(cpu_params.named_parameters())))}
    rows = []
    for i in range(3):
        with torch.no_grad():
            for dst, src in zip(state_tensors(*states["gpu"]).values(),
                                state_tensors(*states["cpu"]).values()):
                dst.copy_(src)
        before = {key: t.detach().clone() for key, t in state_tensors(*states["cpu"]).items()}
        row = {}
        for tag in ("gpu", "cpu"):
            prm, st_, met = step_fn(*states[tag], pdata.batch_at(i))
            states[tag] = (prm, st_)
            row[tag] = {key: float(met[key]) for key in PARITY_TOL}
        after = {tag: state_tensors(*states[tag]) for tag in states}
        check(int(after["gpu"]["opt.step"]) == int(after["cpu"]["opt.step"]) == i + 1,
              f"train parity {impl}: optimizer step count")
        upd = dict.fromkeys(UPDATE_TOL, 0.0)
        for key, old in before.items():
            if key == "opt.step":
                continue
            grp = "params" if key.startswith("params.") else key.split(".")[1]
            d_cpu = after["cpu"][key].detach().double() - old.double()
            d_gpu = after["gpu"][key].detach().cpu().double() - old.double()
            diff = float(torch.linalg.vector_norm(d_gpu - d_cpu))
            ref = float(torch.linalg.vector_norm(d_cpu))
            upd[grp] = max(upd[grp], diff / ref if ref > 0 else (0.0 if diff == 0 else math.inf))
        row["update_rel_gap"] = upd
        rows.append(row)
    return rows


parity = {impl: card_vs_cpu(impl) for impl in ("flash", "reference")}
emit("train_parity_steps", config="qwen2-1.5b reduced (4 layers, d=128, f32), remat full",
     tolerance=PARITY_TOL, update_tolerance=UPDATE_TOL, **parity)
for impl, rows in parity.items():
    for i, row in enumerate(rows):
        for key, tol in PARITY_TOL.items():
            a_, c_ = row["gpu"][key], row["cpu"][key]
            check(abs(a_ - c_) <= tol * (1 + abs(c_)),
                  f"train parity {impl}: step {i} {key} card {a_} vs CPU {c_} (tol {tol})")
        for grp, tol in UPDATE_TOL.items():
            check(row["update_rel_gap"][grp] <= tol,
                  f"train parity {impl}: step {i} the card's {grp} update "
                  f"{row['update_rel_gap'][grp]} from the CPU's (tol {tol})")

ptmp = tempfile.mkdtemp(prefix="chip_smoke_parity_")


def parity_trainer(sub):
    return Trainer(pcfg, psettings, TrainerConfig(ckpt_dir=os.path.join(ptmp, sub), ckpt_every=1000,
                                                  log_every=1, seed=9),
                   data=SyntheticLMDataset(DataConfig(vocab_size=pcfg.vocab_size, seq_len=128,
                                                      global_batch=4, seed=9)), device=DEV)


ref_t = parity_trainer("ref")
ref_t.run(8)
pre_t = parity_trainer("pre")
pre_t.run(4)
check(pre_t.on_preempt(now=0.0, deadline=60.0) is PreemptAck.DRAINED, "train parity: drain not DRAINED")
res_t = parity_trainer("pre")
res_t.init_or_restore()
check(res_t.step == 4, f"train parity: resumed at step {res_t.step}")
res_t.run(until_step=8)
want_st, got_st = state_tensors(ref_t.params, ref_t.opt_state), state_tensors(res_t.params, res_t.opt_state)
check(sorted(want_st) == sorted(got_st), "train parity: state names differ")
unequal = [key for key in want_st if not torch.equal(want_st[key], got_st[key])]
check(not unequal, f"train parity: resumed state differs from the uninterrupted run at {unequal[:5]}")
emit("train_parity", config="qwen2-1.5b reduced (4 layers, d=128, f32), flash, remat full",
     resume=dict(uninterrupted_steps=8, preempted_after=4, tensors=len(want_st),
                 bitwise_equal=True, final_loss=ref_t.history[-1]["loss"]))
del ref_t, pre_t, res_t, want_st, got_st
shutil.rmtree(ptmp, ignore_errors=True)
torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# 11. train: full-width qwen2-1.5b, preempted and resumed
# ---------------------------------------------------------------------------
tcfg_ = dataclasses.replace(get_config("qwen2-1.5b"), attention_impl="flash")
check(tcfg_.remat == "full" and tcfg_.dtype == "bfloat16" and tcfg_.params_dtype == "float32",
      "train: the registry's qwen2-1.5b is expected with full remat, bf16 compute, f32 weights")
SEQ, GB, N_MB, STEPS, PREEMPT_AT = 4096, 4, 2, 5, 3
tsettings = TrainSettings(learning_rate=3e-4, warmup_steps=2, total_steps=1000, microbatches=N_MB)
tdata = SyntheticLMDataset(DataConfig(vocab_size=tcfg_.vocab_size, seq_len=SEQ, global_batch=GB, seed=0))
ttmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
free_tmp_gib = shutil.disk_usage(ttmp).free / 2**30


def full_trainer():
    return Trainer(tcfg_, tsettings, TrainerConfig(ckpt_dir=ttmp, ckpt_every=1000, log_every=1,
                                                   seed=0),
                   data=tdata, device=DEV)


step_s = []


def timed_run(trainer, until):
    while trainer.step < until:
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.run(until_step=trainer.step + 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)


torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
first_t = full_trainer()
first_t.init_or_restore()
torch.cuda.synchronize()
tinit_s = time.perf_counter() - t0

ATTN_W = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")


def first_step(cfg_, n_mb):
    """Loss and gradient norm of the first step on the trainer's weights and
    batch, accumulated over ``n_mb`` microbatches as the train step does
    (``n_mb=1``: the first microbatch alone), and the gradient of each
    attention projection over all layers, flattened (f32)."""
    b0 = {key: torch.from_numpy(val).to(DEV) for key, val in tdata.batch_at(0).items()}
    rows = GB // N_MB
    names = [n_ for n_, _ in first_t.params.named_parameters()]
    acc, losses = None, []
    for i in range(n_mb):
        one = {key: val[i * rows:(i + 1) * rows] for key, val in b0.items()}
        loss_, _ = tm.forward_train(cfg_, first_t.params, one)
        grads_ = torch.autograd.grad(loss_, list(first_t.params.parameters()))
        acc = list(grads_) if acc is None else [a + g_ for a, g_ in zip(acc, grads_)]
        losses.append(float(loss_.detach()))
        del grads_, loss_
    gnorm = float(torch.sqrt(sum(torch.sum(torch.square(a / n_mb)) for a in acc)))
    proj = {w_: torch.cat([(a / n_mb).flatten() for n_, a in zip(names, acc) if n_.endswith(w_)])
            for w_ in ATTN_W}
    del acc
    torch.cuda.empty_cache()
    return float(np.mean(losses)), gnorm, proj


def proj_gaps(got, want):
    """Per attention projection: the relative gap of the gradients' norms
    and of the gradients themselves.  A backward that loses dq, dk or dv
    leaves wq, wk or wv without a gradient: both read 1."""
    out = {}
    for w_ in ATTN_W:
        a_, b_ = got[w_].double(), want[w_].double()
        nb = float(torch.linalg.vector_norm(b_))
        out[w_] = dict(norm=abs(float(torch.linalg.vector_norm(a_)) - nb) / nb,
                       vector=float(torch.linalg.vector_norm(a_ - b_)) / nb)
    return out


# the first step with flash and with reference attention on the same weights
# and batch: in bf16 as trained (both microbatches), and in f32 compute on
# the first microbatch, where the two differ only in summation order
first_gaps = {}


def flash_and_reference(cfg_, n_mb, key):
    pair = {impl: first_step(dataclasses.replace(cfg_, attention_impl=impl), n_mb)
            for impl in ("flash", "reference")}
    first_gaps[key] = proj_gaps(pair["flash"][2], pair["reference"][2])
    return {impl: v_[:2] for impl, v_ in pair.items()}


bf16_pair = flash_and_reference(tcfg_, N_MB, "bf16")
f32_pair = flash_and_reference(dataclasses.replace(tcfg_, dtype="float32"), 1, "f32")
torch.cuda.empty_cache()
torch.cuda.synchronize()

kernels.reset_launch_counts()
timed_run(first_t, PREEMPT_AT)
ctrl = PreemptionController(notice_s=30.0)
inst = Instance(id="train0", resources=TPU_SPEC.make(chips=1, hbm_gb=80, host_ram_gb=96),
                preemptible=True, host="h0", start_time=0.0)
ctrl.register(inst.id, first_t)
t0 = time.perf_counter()
ctrl(inst, now=1000.0)
drain_s = time.perf_counter() - t0
# the drain ends when every shard is written to its file, as in the JAX
# package, which does not fsync either: the writeback to disk comes after
t0 = time.perf_counter()
os.sync()
writeback_s = time.perf_counter() - t0
ckpt_bytes = first_t.ckpt.nbytes()
history = list(first_t.history)
check(ctrl.records[-1].ack is PreemptAck.DRAINED,
      f"train: the drain took {drain_s:.1f} s and acked {ctrl.records[-1].ack}")
del first_t
torch.cuda.empty_cache()

second_t = full_trainer()
t0 = time.perf_counter()
second_t.init_or_restore()
torch.cuda.synchronize()
restore_s = time.perf_counter() - t0
check(second_t.step == PREEMPT_AT, f"train: restored at step {second_t.step}")
timed_run(second_t, STEPS - 1)
with torch.profiler.profile(
    activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
) as prof:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    second_t.run(until_step=STEPS)
    torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
counts = kernels.launch_counts()
history += second_t.history
peak_gib = torch.cuda.max_memory_allocated() / 2**30
for h_ in history:
    check(np.isfinite(h_["loss"]) and np.isfinite(h_["grad_norm"]),
          f"train: step {h_['step']} loss {h_['loss']} grad norm {h_['grad_norm']}")
check([h_["step"] for h_ in history] == list(range(1, STEPS + 1)), "train: steps missing")
# the path: per microbatch the forward runs once and again in the backward
# (remat), the backward kernels once, each layer; the norms 2 a layer + 1
L_ = tcfg_.n_layers
want_counts = dict(flash_attention=STEPS * N_MB * 2 * L_, flash_attention_dq=STEPS * N_MB * L_,
                   flash_attention_dkv=STEPS * N_MB * L_, rmsnorm=STEPS * N_MB * (2 * 2 * L_ + 1))
for name, n_ in want_counts.items():
    records[name]["launches"] = counts[name]
    check(counts[name] == n_, f"train: {counts[name]} launches of {name}, the path implies {n_}")
#: the stated bounds, relative, each a few times what an H100 reads (the run
#: is deterministic: seeded weights and batch, deterministic kernels).  f32
#: compute, summation order only: loss 1e-5 (read equal), gradient norm
#: 5e-5 (read 4.6e-6).  bf16 compute, as trained: flash keeps the scores in
#: f32 where the reference rounds them to bf16, and this random network (the
#: JAX init's layer std 1/sqrt(L)) amplifies rounding: loss 1e-3 (read
#: 2.0e-4), gradient norm 3e-2 (read 6.2e-3).  The attention projections'
#: gradients are the witness for the backward kernels, since a lost dq, dk
#: or dv reads 1 there however little it moves the whole norm: in bf16 their
#: norms, 3e-2 (read up to 6.9e-3; the vectors themselves read 1.3, the
#: bf16 gradients' directions being chaotic here), in f32 the vectors, 3e-3
#: (read 7.0e-4).
FIRST_TOL = {"f32 loss": 1e-5, "f32 grad norm": 5e-5, "bf16 loss": 1e-3, "bf16 grad norm": 3e-2}
ATTN_TOL = {"bf16": ("norm", 3e-2), "f32": ("vector", 3e-3)}
first_loss, first_gnorm = history[0]["loss"], history[0]["grad_norm"]
first_pairs = {"f32 loss": (f32_pair["flash"][0], f32_pair["reference"][0]),
               "f32 grad norm": (f32_pair["flash"][1], f32_pair["reference"][1]),
               "bf16 loss": (first_loss, bf16_pair["reference"][0]),
               "bf16 grad norm": (first_gnorm, bf16_pair["reference"][1])}
emit("train_first_step", trained=[first_loss, first_gnorm], bf16=bf16_pair, f32_first_microbatch=f32_pair,
     bounds=FIRST_TOL, attention_projection_gaps=first_gaps,
     attention_bounds={key: f"{what} {tol}" for key, (what, tol) in ATTN_TOL.items()})
check(abs(first_loss - bf16_pair["flash"][0]) <= 1e-5 * abs(first_loss),
      f"train: the trainer's first loss {first_loss} is not the flash first step's {bf16_pair['flash'][0]}")
for what, (a_, b_) in first_pairs.items():
    check(abs(a_ - b_) <= FIRST_TOL[what] * abs(b_),
          f"train: first step {what}: flash {a_} vs reference {b_} (relative bound {FIRST_TOL[what]})")
for key, (what, tol) in ATTN_TOL.items():
    for w_, g_ in first_gaps[key].items():
        check(g_[what] <= tol, f"train: first step {key} {w_} gradient {what} gap {g_[what]} (bound {tol})")
busy = busy_us(prof)
by_class = {}
for a, b_, name in device_spans(prof):
    key = ("flash_fwd" if "flash_fwd" in name else "flash_bwd_dq" if "flash_bwd_dq" in name
           else "flash_bwd_dkv" if "flash_bwd_dkv" in name else "rmsnorm" if "rmsnorm" in name
           else "gemm" if any(t in name for t in ("gemm", "nvjet", "sm90", "cutlass", "Kernel2"))
           else "other ops")
    by_class[key] = by_class.get(key, 0.0) + (b_ - a)
tokens = GB * SEQ
model_flops = tokens * (6 * tcfg_.param_count() + 6 * L_ * tcfg_.n_heads * 128 * SEQ)
p50 = float(np.median(step_s))
emit("train", config="qwen2-1.5b full width: 28 layers, d=1536, 12/2 heads, hd=128, d_ff=8960, "
     "vocab 151,936; f32 master weights and AdamW state (seed 0), bf16 compute, flash "
     "attention, remat full", card=smi,
     batch=f"{GB} x {SEQ} tokens a step, {N_MB} microbatches of {GB // N_MB}",
     steps=STEPS, preempted_after=PREEMPT_AT, init_seconds=tinit_s,
     step_seconds=step_s, step_p50_s=p50, tokens_per_s=tokens / p50,
     model_flops_per_step=model_flops, mfu_vs_989_tflops=model_flops / p50 / BF16_FLOPS,
     peak_device_gib=peak_gib, checkpoint_bytes=ckpt_bytes, tmp_free_gib_before=free_tmp_gib,
     drain_seconds=drain_s, writeback_seconds_after_drain=writeback_s, notice_window_s=ctrl.notice_s, ack=ctrl.records[-1].ack.value,
     restore_seconds=restore_s, losses=[h_["loss"] for h_ in history],
     grad_norms=[h_["grad_norm"] for h_ in history],
     launches=counts, launches_implied=want_counts,
     traced_step_s=traced_s, device_busy_s=busy / 1e6,
     device_busy_share=(busy / 1e6) / traced_s if busy else "not measured (empty trace)",
     device_ms_per_step_by_class={key: v_ / 1e3 for key, v_ in sorted(by_class.items())})
del second_t
shutil.rmtree(ttmp, ignore_errors=True)

# ---------------------------------------------------------------------------
# 12. the kernels line, the card, the result
# ---------------------------------------------------------------------------
emit("timing", profiler_empty_timed_by_cuda_events=EVENT_TIMED)
print(json.dumps({"kernels": list(records.values())}))
print(smi)
print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
