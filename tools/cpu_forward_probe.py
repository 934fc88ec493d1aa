"""Look for the CPU operation that moves ``chip_smoke.py`` phase 7's CPU
forward (ROADMAP §3 fault (j)): reduced qwen2-1.5b in f32, phase 7's seeded
weights and tokens, ``forward_logits`` on the CPU only.

    python3 tools/cpu_forward_probe.py [OUT_DIR]

Each run is a fresh process that records every operation of the forward
(its name, output shape and a hash of the output's bytes) and the logits.
The runs, by setting:

- ``default``: the machine's default thread count, 3 processes;
- ``one_thread``: ``OMP_NUM_THREADS=1`` and ``torch.set_num_threads(1)``;
- ``mkl_cbwr_strict``: ``MKL_CBWR=AUTO,STRICT`` (MKL's reproducible
  paths);
- ``under_load``: default threads while two other processes keep two cores
  busy, as chip_smoke.py's CPU worker does beside phase 7;
- ``cuda_first``: the card initialized and a product run on it first, as
  in chip_smoke.py's process (the default run where no card is visible);
- ``verbose``: ``ONEDNN_VERBOSE=1`` and ``MKL_VERBOSE=1``, the log kept in
  OUT_DIR and its oneDNN and MKL lines counted;
- ``in_process``: phase 7's own way, the forward repeated 5 times in one
  process after the weights are drawn.

One JSON line a setting: the largest logit gap of each run to the first
``default`` run, and the first operation whose output differs from that
run's (index, name, shape), or none; first, the BLAS and LAPACK this
PyTorch was built with.  The traces and logs go to OUT_DIR
(default ``bench_out/cpu_forward_probe``).  Needs no GPU; imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(REPO, "src"))
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402


class _Trace(TorchDispatchMode):
    """(op, shape, hash of the output's bytes) of every operation."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if isinstance(t, torch.Tensor):
                raw = t.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes()
                self.ops.append([str(func), list(t.shape), hashlib.sha1(raw).hexdigest()[:16]])
        return out


def _forward(reps=1):
    """Phase 7's CPU forward: its config, weights (seed 3) and tokens (seed 4)."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")), attention_impl="flash")
    params = tm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(2, cfg.vocab_size, (3, 200)))
    outs = []
    for _ in range(reps):
        with _Trace() as trace:
            logits = tm.forward_logits(cfg, params, {"tokens": toks}, last_only=False)
        outs.append((logits.numpy(), trace.ops))
    return outs


def child(out_prefix: str, reps: int) -> None:
    if os.environ.get("PROBE_ONE_THREAD"):
        torch.set_num_threads(1)
    if os.environ.get("PROBE_CUDA_FIRST") and torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        x = torch.randn((1024, 1024), device="cuda")
        float((x @ x).sum())
    for i, (logits, ops) in enumerate(_forward(reps)):
        np.save(f"{out_prefix}.{i}.npy", logits)
        with open(f"{out_prefix}.{i}.json", "w") as fh:
            json.dump(dict(ops=ops, threads=torch.get_num_threads()), fh)


def _run(out_dir, name, env=(), reps=1, load=False, log=False):
    prefix = os.path.join(out_dir, name)
    env = dict(os.environ, **dict(env))
    busy = [subprocess.Popen([sys.executable, "-c", "import time\nend = time.time() + 120\n"
                              "while time.time() < end: pass"]) for _ in range(2)] if load else []
    try:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", prefix, str(reps)],
                             env=env, capture_output=True, text=True, timeout=600)
    finally:
        for p in busy:
            p.kill()
            p.wait()
    if log:
        with open(prefix + ".log", "w") as fh:
            fh.write(res.stdout + res.stderr)
    if res.returncode:
        raise RuntimeError(f"{name}: {res.stderr[-2000:]}")
    runs = []
    for i in range(reps):
        with open(f"{prefix}.{i}.json") as fh:
            meta = json.load(fh)
        runs.append((np.load(f"{prefix}.{i}.npy"), meta["ops"], meta["threads"],
                     {"onednn": res.stdout.count("onednn_verbose"), "mkl": res.stdout.count("MKL_VERBOSE")}))
    return runs


def _against(base, runs):
    """Each run's largest logit gap to ``base`` and its first differing op."""
    out = []
    for logits, ops, threads, verbose in runs:
        first = next(({"index": i, "op": a[0], "shape": a[1]} for i, (a, b) in
                      enumerate(zip(ops, base[1])) if a != b), None)
        out.append(dict(max_gap=float(np.abs(logits.astype(np.float64) - base[0]).max()),
                        first_differing_op=first, ops=len(ops), threads=threads,
                        verbose_lines=verbose))
    return out


def main(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    settings = [("default", {}, 3, False, False),
                ("one_thread", {"OMP_NUM_THREADS": "1", "PROBE_ONE_THREAD": "1"}, 1, False, False),
                ("mkl_cbwr_strict", {"MKL_CBWR": "AUTO,STRICT"}, 1, False, False),
                ("under_load", {}, 2, True, False),
                ("cuda_first", {"PROBE_CUDA_FIRST": "1"}, 2, True, False),
                ("verbose", {"ONEDNN_VERBOSE": "1", "DNNL_VERBOSE": "1", "MKL_VERBOSE": "1"}, 1,
                 False, True)]
    config = torch.__config__.show()
    print(json.dumps({"torch": torch.__version__, "blas": [line.strip() for line in config.splitlines()
                                                            if "BLAS" in line or "LAPACK" in line
                                                            or "MKL" in line]}), flush=True)
    base = None
    for name, env, reps, load, log in settings:
        runs = _run(out_dir, name, env, reps, load, log)
        base = base or runs[0]
        print(json.dumps({"setting": name, "runs": _against(base, runs)}), flush=True)
    runs = [(logits, ops, torch.get_num_threads(), None) for logits, ops in _forward(5)]
    print(json.dumps({"setting": "in_process", "runs": _against(base, runs)}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(sys.argv[2], int(sys.argv[3]))
    else:
        main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(REPO, "bench_out", "cpu_forward_probe"))
