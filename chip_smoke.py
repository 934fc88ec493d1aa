"""End-to-end smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the run
exits non-zero:

1. device    — the card's name and power limit (nvidia-smi), torch and CUDA
               versions;
2. build     — compile every CUDA source of the decision path (one nvcc each,
               all started together);
3. kernels   — at the paper's saturated geometry (65,536 hosts, K=8, D=3,
               M=64; plus the enumeration at K=12) each kernel against its
               plain PyTorch version on the same inputs: exactly equal on
               integer-valued inputs, and one non-integer case with its gap;
               kernel / plain / bound times (CUDA events, medians);
4. parity    — the simulator on the card and on the CPU, 4,096 hosts, the
               same seed: identical placements, counters and final state;
5. main path — ``SoAFleet`` on the card at 65,536 hosts, 2,048 decisions in
               batches of 64 (half normal, so preemptions happen) plus 512
               single decisions: decisions/s, latency, fallbacks, memory,
               the device's busy share, and every kernel's launch count;
6. the ``kernels`` line, then the card's name and power limit, then the
   result line.

TF32 is off for matmuls and cuDNN (``allow_tf32 = False``); nothing here
multiplies matrices, so this only rules out a silent precision change.
The script imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

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

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N_HOSTS = 65_536
M = 64
DEV = torch.device("cuda")
CHURN_MULT = (1.0, 1.0, 0.5, 0.25, 2.0)
#: (HBM bytes/s, FP32 flop/s) from NVIDIA's data sheets, dense rates
PEAKS = {"SXM": (3.35e12, 67e12), "PCIe": (2.0e12, 51e12)}


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


def device_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``: the durations of the
    kernels (and fills) it runs, from a ``torch.profiler`` trace of ``reps``
    calls, each followed by a synchronize so calls never overlap (the mean
    when the trace's span count does not split evenly into calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
    spans = device_spans(prof)
    check(len(spans) > 0, "the trace shows no device activity")
    if len(spans) % reps:           # a one-off span: fall back to the mean
        return sum(b - a for a, b, _ in spans) / reps / 1e3
    per = len(spans) // reps
    return float(np.median([sum(b - a for a, b, _ in spans[i * per:(i + 1) * per])
                            for i in range(reps)])) / 1e3


def max_gap(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max()) if a.numel() else 0.0


#: largest |kernel - plain| measured per kernel in phase 3
GAPS = {"sched_screen_consts": 0.0, "sched_screen_topm": 0.0, "sched_screen": 0.0,
        "sched_weigh": 0.0}


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
HBM_BPS, FP32_FLOPS = PEAKS[form]
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


def record(name, source, replaces, ms, plain_ms, bytes_moved, ops):
    t_bytes, t_ops = bytes_moved / HBM_BPS * 1e3, ops / FP32_FLOPS * 1e3
    records[name] = dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=0,
        max_abs_err=GAPS[name], ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
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
emit("kernels_vs_plain", hosts=n, k=k, d=d, m=M, integer_cases="exact",
     non_integer_max_gap=frac_gap, non_integer_decisions_agree=frac_same)

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
# 6. the kernels line, the card, the result
# ---------------------------------------------------------------------------
print(json.dumps({"kernels": list(records.values())}))
print(smi)
print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
