"""Where the f32 flash-attention backward kernels spend their time, on one
NVIDIA GPU: variants of ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
and the f32 tiles it includes (``f32_tiles.cuh``), each this checkout's
sources with one textual change, built together and timed on the same
inputs.

    python3 tools/flash_f32_variants.py [--reps N]

Variants: ``full`` (the source as it is); ``no_scores`` (S and dP set to 0
instead of computed), ``no_accumulate`` (no dV, dK or dQ products),
``no_exp`` (p without ``expf``), ``no_stream`` (no tile after the first two
copied in), whose outputs are wrong and only timed; ``rowmajor_lanes`` (the
lanes laid out row by row) and ``accumulate_unroll4`` (the accumulation
loop unrolled 4 deep instead of 8), which give the same bits.  Each prints
one JSON line: the device time of one f32 dq and one f32 dk/dv launch
(``torch.profiler`` spans, median of ``--reps``), in two passes (the second
in reverse order), at B=1, S=2,048, H=12, G=2, hd=128, causal, and whether
the outputs equal ``full``'s.  A variant whose text no longer matches the
source fails.  Nothing here imports JAX or the JAX package.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _DKV_ARGTYPES, _DQ_ARGTYPES, _delta, _flatten, flash_attention_plain)

ZERO = "for (int i = 0; i < TS; ++i) for (int j = 0; j < TS; ++j) s[i][j] = dp[i][j] = 0.0f;"
#: name -> (text, replacement) pairs applied to the source; True where the
#: variant computes the same function
VARIANTS = {
    "full": ([], True),
    "no_scores": ([("scores<HD, TS>(ks, qs, vs, dos, kg, qg, s, dp);", ZERO),
                   ("scores<HD, TS>(qs, ks, dos, vs, qg, kg, s, dp);", ZERO)], False),
    "no_accumulate": ([("accumulate<HD, true>(ps, dos, dss, qs, r0, cg, dv, dk);", ""),
                       ("accumulate<HD, false>(dss, ks, nullptr, nullptr, r0, cg, acc, acc);", "")],
                      False),
    "no_exp": ([("float p = expf(s[i][j] * scale - lse_s[qr]);", "float p = s[i][j] * scale - lse_s[qr];"),
                ("float p = expf(s[i][j] * scale - row_lse[i]);", "float p = s[i][j] * scale - row_lse[i];")],
               False),
    "no_stream": ([("if (it + 2 < n_qt) load_q(it + 2);", ""), ("if (it + 2 < n_kt) load_kv(it + 2);", "")],
                  False),
    "rowmajor_lanes": ([("""        own = 4 * (warp >> 1) + (lane >> 3);
        str = 8 * (warp & 1) + (lane & 7);
        cg = 8 * (warp % (C::NCG / 8)) + (lane & 7);
        r0 = (4 * (warp / (C::NCG / 8)) + (lane >> 3)) * C::TR;""", """        own = 2 * warp + (lane >> 4);
        str = lane & 15;
        cg = threadIdx.x % C::NCG;
        r0 = threadIdx.x / C::NCG * C::TR;""")], True),
    "accumulate_unroll4": ([("#pragma unroll 8\n    for (int j = 0; j < C::B; ++j) {",
                             "#pragma unroll 4\n    for (int j = 0; j < C::B; ++j) {")], True),
}


#: the files a variant may change: the kernels and the f32 tiles they share
FILES = ("flash_attention_bwd.cu", "f32_tiles.cuh")


def variant_sources():
    """name -> {file: the variant's text}; each change goes to the file that
    holds its text; exits if a variant's text is gone."""
    src = {f: open(os.path.join(_build.CSRC, f)).read() for f in FILES}
    out = {}
    for name, (pairs, _) in VARIANTS.items():
        texts = dict(src)
        for old, new in pairs:
            where = [f for f in FILES if old in texts[f]]
            if not where:
                sys.exit(f"flash_f32_variants.py: variant {name}: text not found in the sources:\n{old}")
            texts[where[0]] = texts[where[0]].replace(old, new)
        out[name] = texts
    return out


def build(out_dir):
    """Every variant's library, all ``nvcc`` runs started together (each
    variant's files in a directory of its own, which its quoted includes
    search first; the other shared headers found through ``-I``)."""
    procs = {}
    for name, texts in variant_sources().items():
        os.makedirs(os.path.join(out_dir, name))
        for f, text in texts.items():
            with open(os.path.join(out_dir, name, f), "w") as fh:
                fh.write(text)
        path, lib = os.path.join(out_dir, name, FILES[0]), os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build._flags("flash_attention_bwd"), "-I", _build.CSRC, "-o", lib,
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            sys.exit(f"nvcc failed for variant {name}:\n{log}")
        loaded = ctypes.CDLL(lib)
        for symbol, types in (("flash_attention_dq_f32_launch", _DQ_ARGTYPES),
                              ("flash_attention_dkv_f32_launch", _DKV_ARGTYPES)):
            fn = getattr(loaded, symbol)
            fn.restype, fn.argtypes = ctypes.c_int, list(types)
        libs[name] = loaded
    return libs


def device_ms(fn, reps):
    """Median device time of one call of ``fn`` (one launch) from a profiler
    trace."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
    spans = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if len(spans) != reps:
        raise RuntimeError(f"{len(spans)} device spans in {reps} calls")
    return float(np.median(spans))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_f32_variants.py: no CUDA device visible")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    b, s, h, g, hd = 1, 2048, 12, 2, 128
    print(json.dumps({"card": smi, "shape": f"B={b}, S={s}, H={h}, G={g}, hd={hd}, f32, causal"}),
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn((b, s, n, hd), generator=gen, device="cuda") for n in (h, g, g, h))
        o, lse = flash_attention_plain(q, k, v, causal=True)
        qf, kf, vf = _flatten(q, k, v)
        dof = do.transpose(1, 2).reshape(b * h, s, hd).contiguous()
        delta = _delta(o.transpose(1, 2).reshape(b * h, s, hd), dof).contiguous()
        common = (qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(), lse.data_ptr(),
                  delta.data_ptr())
        shape = (b * h, b * g, s, s, hd, 1, 1.0 / math.sqrt(hd))
        stream = torch.cuda.current_stream().cuda_stream
        dq = torch.empty_like(qf)
        parts = [torch.empty((b * h, s, hd), device="cuda") for _ in range(2)]

        def calls(lib):
            return (lambda: _build.check(lib.flash_attention_dq_f32_launch(
                        *common, dq.data_ptr(), *shape, stream), "dq"),
                    lambda: _build.check(lib.flash_attention_dkv_f32_launch(
                        *common, parts[0].data_ptr(), parts[1].data_ptr(), *shape, stream), "dkv"))

        outs = {}
        for name, lib in libs.items():
            for fn in calls(lib):
                fn()
            torch.cuda.synchronize()
            outs[name] = (dq.clone(), parts[0].clone(), parts[1].clone())
        times = {name: [] for name in libs}
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                times[name].append([device_ms(fn, args.reps) for fn in calls(libs[name])])
        for name in libs:
            print(json.dumps({
                "variant": name, "same_function": VARIANTS[name][1],
                "dq_ms": [t[0] for t in times[name]], "dkv_ms": [t[1] for t in times[name]],
                "outputs_equal_full": all(torch.equal(a, b_) for a, b_ in zip(outs[name], outs["full"]))}),
                flush=True)


if __name__ == "__main__":
    main()
