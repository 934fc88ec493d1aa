"""Time this checkout's RMSNorm, ``sched_weigh`` and f32 flash-attention
forward and backward CUDA kernels against another checkout's, on one NVIDIA
GPU, in turns (other, this, this, other).

    python3 tools/kernel_ab.py --other DIR

``DIR`` is the root of another checkout of this repository (for example an
earlier commit unpacked with ``git archive``).  Both trees'
``src/repro_torch/kernels/csrc/rmsnorm.cu``, ``sched_weigh.cu``,
``flash_attention.cu`` and ``flash_attention_bwd.cu`` are compiled with
this checkout's ``nvcc`` flags, all eight at once, and called through their
C entries (``rmsnorm_launch``, ``sched_weigh_launch``,
``flash_attention_fwd_f32_launch``, ``flash_attention_{dq,dkv}_f32_launch``),
whose signatures both trees must share.  A tree whose library has
``flash_attention_dkv_reduce_f32_launch`` writes f32 dk/dv partials per q
head and sums them with it; an older one writes dk and dv at once.  Each
case prints one JSON line: the device time of one call (``torch.profiler``
spans, median of ``--reps``) for each turn, warm and, for RMSNorm, with the
L2 flushed before every call; ``F.rms_norm`` beside RMSNorm,
``scaled_dot_product_attention`` and its backward (TF32 off) beside the
flash forward and backward, the flash forward's also by CUDA events; the
device time of a one-element PyTorch op (the launch floor); and whether the
two trees' outputs agree (bit for bit for ``sched_weigh``; the largest gap
between the trees and to the plain version for RMSNorm and the flash
kernels).  Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.fleets import weigh_arrays  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _DKV_ARGTYPES, _DQ_ARGTYPES, _LAUNCH_ARGTYPES as FLASH_ARGTYPES, _REDUCE_ARGTYPES, _delta, _flatten,
    flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.kernels.rmsnorm import _LAUNCH_ARGTYPES as RMS_ARGTYPES  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_plain  # noqa: E402
from repro_torch.kernels.sched_weigh import _LAUNCH_ARGTYPES as WEIGH_ARGTYPES  # noqa: E402
from repro_torch.kernels.sched_weigh import TIE_EPS, sched_weigh_plain  # noqa: E402

#: each source's C entries (a tree may lack the optional ones) and their types
SOURCES = {"rmsnorm": {"rmsnorm_launch": RMS_ARGTYPES},
           "sched_weigh": {"sched_weigh_launch": WEIGH_ARGTYPES},
           "flash_attention": {"flash_attention_fwd_f32_launch": FLASH_ARGTYPES},
           "flash_attention_bwd": {"flash_attention_dq_f32_launch": _DQ_ARGTYPES,
                                   "flash_attention_dkv_f32_launch": _DKV_ARGTYPES,
                                   "flash_attention_dkv_reduce_f32_launch": _REDUCE_ARGTYPES}}
OPTIONAL = {"flash_attention_dkv_reduce_f32_launch"}


def build(trees, out_dir):
    """One library per (tree, source), all ``nvcc`` runs started together;
    returns {(tree, symbol): C entry} and each library's compiler output."""
    procs = {}
    for tree in trees:
        for name in SOURCES:
            lib = os.path.join(out_dir, f"{tree}-{name}.so")
            src = os.path.join(trees[tree], "src/repro_torch/kernels/csrc", f"{name}.cu")
            procs[tree, name] = (lib, subprocess.Popen(
                [_build.nvcc_path(), *_build._flags(name), "-o", lib, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    entries, logs = {}, {}
    for (tree, name), (lib, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            sys.exit(f"nvcc failed for {tree} {name}:\n{log}")
        loaded = ctypes.CDLL(lib)
        for symbol, argtypes in SOURCES[name].items():
            if symbol in OPTIONAL and not hasattr(loaded, symbol):
                continue
            fn = getattr(loaded, symbol)
            fn.restype, fn.argtypes = ctypes.c_int, list(argtypes)
            entries[tree, symbol] = fn
        logs[tree, name] = log
    return entries, logs


def device_ms(fn, reps, flush=None):
    """Median device time of one call of ``fn`` from a profiler trace (the
    spans of ``flush``'s fill left out)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.fill_(1)
            fn()
            torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "FillFunctor" not in e.name)
    if not spans:
        raise RuntimeError(f"no device spans in {reps} calls")
    if len(spans) % reps:                       # a span lost or one-off: the mean
        return sum(b - a for a, b in spans) / reps / 1e3
    per = len(spans) // reps
    return float(np.median([sum(b - a for a, b in spans[i * per:(i + 1) * per])
                            for i in range(reps)])) / 1e3


def turns(fns, reps, flush=None):
    """other, this, this, other: each turn's time."""
    return {f"{tree}_{i}": device_ms(fns[tree], reps, flush)
            for i, tree in enumerate(("other", "this", "this", "other"))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py: no CUDA device visible")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "torch": torch.__version__, "other": args.other}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        entries, logs = build({"other": os.path.abspath(args.other), "this": ROOT}, tmp)
        for name in SOURCES:
            _build.BUILD_LOG[name] = logs["this", name]
            report = _build.ptxas_report(name)
            if name.startswith("flash_attention"):  # the f32 kernels, in full
                report = {f: c for f, c in report.items() if "f32_kernel" in f}
                print(json.dumps({f"ptxas_f32 {name}": report}), flush=True)
            print(json.dumps({"ptxas": name, "kernels": len(report),
                              "max_registers": max(c.get("registers", 0) for c in report.values()),
                              "max_stack": max(c.get("stack", 0) for c in report.values()),
                              "spill_bytes": sum(c.get("spill_stores", 0) + c.get("spill_loads", 0)
                                                 for c in report.values()),
                              "with_stack_or_spills": {f: c for f, c in report.items()
                                                       if c.get("stack") or c.get("spill_stores")}}),
                  flush=True)
        one = torch.zeros(1, device="cuda")
        print(json.dumps({"launch_floor_ms": device_ms(lambda: one.add_(1), args.reps)}), flush=True)
        stream = torch.cuda.current_stream().cuda_stream
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

        gen = torch.Generator(device="cuda").manual_seed(0)
        for rows, d, dt in ((8, 1536, torch.bfloat16), (4096, 1536, torch.bfloat16),
                            (8192, 1536, torch.bfloat16), (4096, 1536, torch.float32)):
            x = torch.randn((rows, d), generator=gen, device="cuda").to(dt)
            w = (0.1 * torch.randn((d,), generator=gen, device="cuda")).to(dt)
            w1 = 1.0 + w
            outs = {tree: torch.empty_like(x) for tree in ("other", "this")}
            bf = int(dt == torch.bfloat16)
            fns = {tree: (lambda t=tree: _build.check(entries[t, "rmsnorm_launch"](
                x.data_ptr(), w.data_ptr(), outs[t].data_ptr(), rows, d, 1e-6, bf, bf, stream),
                t)) for tree in outs}
            for fn in fns.values():
                fn()
            plain = rmsnorm_plain(x, w, 1e-6).double()
            lib = lambda: F.rms_norm(x, (d,), weight=w1, eps=1e-6)  # noqa: E731
            print(json.dumps({
                "case": f"rmsnorm {rows}x{d} {str(dt)[6:]}",
                "gap_this_other": float((outs["this"].double() - outs["other"].double()).abs().max()),
                "gap_this_plain": float((outs["this"].double() - plain).abs().max()),
                "bound_ms": (2 * x.element_size() * rows * d + w.element_size() * d) / 3.35e12 * 1e3,
                "warm": turns(fns, args.reps), "library_warm": device_ms(lib, args.reps),
                "l2_flushed": turns(fns, args.reps, flush),
                "library_l2_flushed": device_ms(lib, args.reps, flush)}), flush=True)

        for n, k in ((64, 8), (64, 12), (65536, 8), (4096, 12), (65536, 12)):
            d = 3
            inp = tuple(torch.from_numpy(a).cuda() for a in weigh_arrays(n, k, d, seed=n + k))
            outs = {tree: (torch.empty(n, device="cuda"),
                           torch.empty(n, dtype=torch.int32, device="cuda"),
                           torch.empty(n, dtype=torch.bool, device="cuda")) for tree in ("other", "this")}
            fns = {tree: (lambda t=tree: _build.check(entries[t, "sched_weigh_launch"](
                *(a.data_ptr() for a in inp), n, k, d, TIE_EPS,
                *(o.data_ptr() for o in outs[t]), stream), t)) for tree in outs}
            for fn in fns.values():
                fn()
            plain = sched_weigh_plain(*inp)
            print(json.dumps({
                "case": f"sched_weigh n={n} k={k} d={d}",
                "this_equals_other": all(torch.equal(a, b) for a, b in zip(outs["this"], outs["other"])),
                "this_equals_plain": all(torch.equal(a, b) for a, b in zip(outs["this"], plain)),
                "bound_ms": n * ((1 << (k - 1)) * k * (d + 1) + (1 << k) * (d + 3)) / 67e12 * 1e3,
                "warm": turns(fns, args.reps)}), flush=True)

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # qwen2-1.5b's heads at the prefill and training shapes, and the
        # reduced model of chip_smoke's phase 10 (H=4, G=2, hd=32)
        for b, s, h, g, hd in ((4, 1024, 12, 2, 128), (2, 4096, 12, 2, 128), (4, 128, 4, 2, 32)):
            flash_fwd_case(entries, stream, args.reps if s <= 1024 else max(args.reps // 5, 5),
                           gen, b, s, h, g, hd)
        for b, s, h, g, hd in ((1, 2048, 12, 2, 128), (2, 4096, 12, 2, 128)):
            flash_bwd_case(entries, stream, args.reps if s <= 2048 else max(args.reps // 5, 5),
                           gen, b, s, h, g, hd)


def events_ms(fn, reps):
    """Median time of one call of ``fn`` by CUDA events around it."""
    for _ in range(3):
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


def flash_fwd_case(entries, stream, reps, gen, b, s, h, g, hd):
    """The f32 forward of both trees at (B, S, H, G, hd), causal."""
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device="cuda") for n in (h, g, g))
    qf, kf, vf = _flatten(q, k, v)
    outs = {tree: (torch.empty_like(qf), torch.empty((b * h, s), device="cuda"))
            for tree in ("other", "this")}

    def fwd(t):
        _build.check(entries[t, "flash_attention_fwd_f32_launch"](
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), outs[t][0].data_ptr(), outs[t][1].data_ptr(),
            b * h, b * g, s, s, hd, 1, 1.0 / math.sqrt(hd), stream), t)

    for t in outs:
        fwd(t)
    po, plse = flash_attention_plain(q, k, v, causal=True)
    plain = (po.transpose(1, 2).reshape(b * h, s, hd).double(), plse.double())
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
    fns = {t: (lambda t=t: fwd(t)) for t in outs}
    print(json.dumps({
        "case": f"flash forward f32 B={b} S={s} H={h} G={g} hd={hd} causal",
        "gap_this_other": [float((x.double() - y.double()).abs().max())
                           for x, y in zip(outs["this"], outs["other"])],
        "gap_this_plain": [float((x.double() - p).abs().max()) for x, p in zip(outs["this"], plain)],
        "gap_other_plain": [float((x.double() - p).abs().max()) for x, p in zip(outs["other"], plain)],
        "bound_ms": 4 * hd * b * h * s * (s + 1) // 2 / 67e12 * 1e3,
        "o_lse": turns(fns, reps),
        "o_lse_events": {f"{tree}_{i}": events_ms(fns[tree], reps)
                         for i, tree in enumerate(("other", "this", "this", "other"))},
        "library": device_ms(lib, reps), "library_events": events_ms(lib, reps)}), flush=True)


def flash_bwd_case(entries, stream, reps, gen, b, s, h, g, hd):
    """The f32 dq and dk/dv (with the reduction, where the tree has one) of
    both trees at (B, S, H, G, hd), causal."""
    q, k, v, do = (torch.randn((b, s, n, hd), generator=gen, device="cuda") for n in (h, g, g, h))
    o, lse = flash_attention_plain(q, k, v, causal=True)
    qf, kf, vf = _flatten(q, k, v)
    dof = do.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    delta = _delta(o.transpose(1, 2).reshape(b * h, s, hd), dof).contiguous()
    common = (qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(), lse.data_ptr(),
              delta.data_ptr())
    shape = (b * h, b * g, s, s, hd, 1, 1.0 / math.sqrt(hd))
    outs = {tree: [torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vf)]
            for tree in ("other", "this")}
    parts = [torch.empty((b * h, s, hd), device="cuda") for _ in range(2)]

    def dq(t):
        _build.check(entries[t, "flash_attention_dq_f32_launch"](*common, outs[t][0].data_ptr(), *shape,
                                                                 stream), t)

    def dkv(t):
        reduce = entries.get((t, "flash_attention_dkv_reduce_f32_launch"))
        dst = parts if reduce else outs[t][1:]
        _build.check(entries[t, "flash_attention_dkv_f32_launch"](
            *common, dst[0].data_ptr(), dst[1].data_ptr(), *shape, stream), t)
        if reduce:
            _build.check(reduce(parts[0].data_ptr(), parts[1].data_ptr(), outs[t][1].data_ptr(),
                                outs[t][2].data_ptr(), b * h, b * g, s, hd, stream), t)

    for t in outs:
        dq(t)
        dkv(t)
    plain = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    plain = [p.transpose(1, 2).reshape(-1, s, hd).double() for p in plain]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    pairs = b * h * s * (s + 1) // 2
    print(json.dumps({
        "case": f"flash backward f32 B={b} S={s} H={h} G={g} hd={hd} causal",
        "gap_this_other": [float((x.double() - y.double()).abs().max())
                           for x, y in zip(outs["this"], outs["other"])],
        "gap_this_plain": [float((x.double() - p).abs().max()) for x, p in zip(outs["this"], plain)],
        "gap_other_plain": [float((x.double() - p).abs().max()) for x, p in zip(outs["other"], plain)],
        "bound_ms": {"dq": 6 * hd * pairs / 67e12 * 1e3, "dkv": 8 * hd * pairs / 67e12 * 1e3},
        "dq": turns({t: (lambda t=t: dq(t)) for t in outs}, reps),
        "dkv_with_reduce": turns({t: (lambda t=t: dkv(t)) for t in outs}, reps),
        "library_dq_dk_dv": device_ms(lambda: torch.autograd.grad(
            sdpa_o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), reps)}), flush=True)


if __name__ == "__main__":
    main()
