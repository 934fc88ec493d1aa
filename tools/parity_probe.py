"""Probe how steady ``chip_smoke.py`` phase 7's parity is: reduced
qwen2-1.5b in f32, the same seeded weights and tokens as phase 7,
``forward_logits`` on one NVIDIA GPU against the CPU.

    python3 tools/parity_probe.py

Each reading prints one JSON line, the gap given as
``[max |card - CPU|, its (batch, position, vocab) index, max |CPU|]``:

- ``fresh``: the flash forward once;
- ``reference_attention``: the same with reference attention, card
  against CPU, and each route against the other;
- ``garbage``: 20 flash forwards, each after the caching allocator was
  filled with NaN, +-1e30, 3 or inf and freed, so a read of memory that
  was never written would move the result; the worst gap and how many
  results differ from ``fresh`` in any bit;
- ``kernels_repeat``: the f32 flash forward and RMSNorm at phase 7's
  shapes, 200 calls each, against their plain versions and against their
  first call bit for bit;
- ``under_load``: 30 forwards while another process keeps the card busy
  with f32 matmuls, so blocks run in other orders and at other times;
- ``tf32_allowed`` / ``tf32_off_again``: the gap with TF32 matmuls allowed
  (what a TF32 path would look like), then with them off again;
- ``tf32_env_override``: a fresh process with
  ``TORCH_ALLOW_TF32_CUBLAS_OVERRIDE=1``.

Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("parity_probe.py: no CUDA device visible")
DEV = torch.device("cuda")


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def gap_of(card: torch.Tensor, cpu: torch.Tensor):
    cpu = cpu.cpu()
    d = (card.double().cpu() - cpu.double()).abs()
    at = np.unravel_index(int(d.argmax()), d.shape)
    return float(d.max()), [int(i) for i in at], float(cpu.abs().max())


# phase 7's model, weights and tokens
RCFG = dataclasses.replace(reduced(get_config("qwen2-1.5b")), attention_impl="flash")
REF = dataclasses.replace(RCFG, attention_impl="reference")
CPU_PARAMS = tm.init_params(RCFG, torch.Generator().manual_seed(3), device="cpu")
GPU_PARAMS = tm.Model(RCFG, device="meta")
GPU_PARAMS.load_state_dict({k: t.to(DEV) for k, t in CPU_PARAMS.state_dict().items()},
                           assign=True)
TOKS = torch.from_numpy(np.random.default_rng(4).integers(2, RCFG.vocab_size, (3, 200)))


def logits(cfg, params, device):
    return tm.forward_logits(cfg, params, {"tokens": TOKS.to(device)}, last_only=False)


LC = logits(RCFG, CPU_PARAMS, "cpu")

if sys.argv[1:] == ["--tf32-env"]:
    emit(mode="tf32_env_override", env=os.environ.get("TORCH_ALLOW_TF32_CUBLAS_OVERRIDE"),
         gap=gap_of(logits(RCFG, GPU_PARAMS, DEV), LC))
    sys.exit(0)

emit(card=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
     torch=torch.__version__, cpu_threads=torch.get_num_threads(),
     fp32_precision=str(getattr(torch.backends.cuda.matmul, "fp32_precision", None)))
LG = logits(RCFG, GPU_PARAMS, DEV)
emit(mode="fresh", gap=gap_of(LG, LC))

lr_card, lr_cpu = logits(REF, GPU_PARAMS, DEV), logits(REF, CPU_PARAMS, "cpu")
emit(mode="reference_attention", card_vs_cpu=gap_of(lr_card, lr_cpu),
     cpu_flash_vs_cpu_reference=gap_of(LC, lr_cpu), card_flash_vs_card_reference=gap_of(LG, lr_card))

worst, differing = 0.0, 0
for fill in [float("nan"), 1e30, -1e30, 3.0, float("inf")] * 4:
    junk = [torch.full((n,), fill, device=DEV) for n in (1 << 10, 1 << 14, 1 << 18, 1 << 20, 1 << 22, 77777)]
    del junk
    lg = logits(RCFG, GPU_PARAMS, DEV)
    worst = max(worst, gap_of(lg, LC)[0])
    differing += int(not torch.equal(lg, LG))
emit(mode="garbage", runs=20, worst=worst, runs_differing_bitwise=differing)
torch.cuda.empty_cache()

gen = torch.Generator(device=DEV).manual_seed(1)
q = torch.randn((3, 200, 4, 32), generator=gen, device=DEV)
k = torch.randn((3, 200, 2, 32), generator=gen, device=DEV)
v = torch.randn((3, 200, 2, 32), generator=gen, device=DEV)
o0, lse0 = kernels.flash_attention_fwd(q, k, v, causal=True)
o_plain, _ = kernels.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu(), causal=True)
flash_differing = 0
for _ in range(200):
    o, lse = kernels.flash_attention_fwd(q, k, v, causal=True)
    flash_differing += int(not (torch.equal(o, o0) and torch.equal(lse, lse0)))
x = torch.randn((600, 128), generator=gen, device=DEV)
w = torch.randn((128,), generator=gen, device=DEV)
r0 = kernels.rmsnorm(x, w, 1e-5)
rms_differing = sum(int(not torch.equal(kernels.rmsnorm(x, w, 1e-5), r0)) for _ in range(200))
emit(mode="kernels_repeat", calls=200, flash_vs_plain=float((o0.cpu() - o_plain).abs().max()),
     flash_differing=flash_differing,
     rmsnorm_vs_plain=float((r0.cpu() - kernels.rmsnorm(x.cpu(), w.cpu(), 1e-5)).abs().max()),
     rmsnorm_differing=rms_differing)

load = subprocess.Popen([sys.executable, "-c",
                         "import time, torch\na = torch.randn(8192, 8192, device='cuda')\n"
                         "t = time.time()\nwhile time.time() - t < 40:\n"
                         "    b = a @ a\n    torch.cuda.synchronize()\n"])
time.sleep(8)
worst, differing, flash_differing = 0.0, 0, 0
for _ in range(30):
    lg = logits(RCFG, GPU_PARAMS, DEV)
    worst = max(worst, gap_of(lg, LC)[0])
    differing += int(not torch.equal(lg, LG))
    o, lse = kernels.flash_attention_fwd(q, k, v, causal=True)
    flash_differing += int(not (torch.equal(o, o0) and torch.equal(lse, lse0)))
load.wait()
emit(mode="under_load", runs=30, worst=worst, runs_differing_bitwise=differing,
     flash_differing=flash_differing)

torch.backends.cuda.matmul.allow_tf32 = True
emit(mode="tf32_allowed", gap=gap_of(logits(RCFG, GPU_PARAMS, DEV), LC))
torch.backends.cuda.matmul.allow_tf32 = False
emit(mode="tf32_off_again", gap=gap_of(logits(RCFG, GPU_PARAMS, DEV), LC))
out = subprocess.run([sys.executable, os.path.abspath(__file__), "--tf32-env"], capture_output=True,
                     text=True, env=dict(os.environ, TORCH_ALLOW_TF32_CUBLAS_OVERRIDE="1"))
print(out.stdout.strip(), flush=True)
sys.exit(out.returncode)
