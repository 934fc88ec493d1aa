"""End-to-end smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the run
exits non-zero:

1. device    — the card's name and power limit (nvidia-smi), torch and CUDA
               versions;
2. build     — compile every CUDA source of the port (one nvcc each, all
               started together): seconds per source, the flash kernels'
               instantiations counted apart for the forward and the
               backward (head dims 32, 64, 112, 128, 256 each), and
               the count of HGMMA (wgmma) and UTMALDG (TMA load)
               instructions in the SASS of each tensor-core kernel, which
               must not be 0, and ptxas's
               registers and spill bytes of each; the f32 kernels' (forward,
               dq, dk/dv) SASS, which must hold no HMMA or HGMMA, and their
               ptxas registers, none with a stack frame or spills; ptxas's
               registers, stack frame and spill bytes of every screen
               kernel, the K=8 ones with no stack frame and no spills; of
               every RMSNorm and sched_weigh instantiation, none with spills;
3. kernels   — the decision path's kernels at the paper's saturated geometry
               (65,536 hosts, K=8, D=3, M=64; plus the enumeration at K=12),
               each against its plain PyTorch version on the same inputs:
               exactly equal on integer-valued inputs and on the non-integer
               cases (a fractional clock; the weigher vectors (2, 1, 0.7, 1)
               and (8, 1, 8, 8); the enumeration on fractional inputs at
               K=1..12 and D=1..8, on 64 and 4,096 hosts, and at K=4 and 5,
               whose sums follow XLA's trees, on 1 and 2), two calls of the
               enumeration the same bits; the screen's traced-multiplier
               mode (the ensemble's rows under the default and the churn
               gates, a zero under a gate) exactly equal on both clocks;
               kernel / plain / bound times (medians) beside a one-element
               op's (the launch floor); then the screen at 2^20 packed
               hosts, nearly all tied: exactly equal, two calls the same
               bits, its times;
4. parity    — the simulator on the card and on the CPU, 4,096 hosts, the
               same seed: identical placements, counters and final state;
5. main path — ``SoAFleet`` on the card at 65,536 hosts, 2,048 decisions in
               batches of 64 (half normal, so preemptions happen) plus 512
               single decisions: decisions/s, latency, fallbacks, memory,
               the device's busy share, and every kernel's launch count;
5b. rebuild  — the paper's Fig. 2 scenarios (a normal and a preemptible
               request on an empty fleet, a normal one on a saturated fleet)
               at 24, 240 and 2,400 Table 1 nodes: the p50 latency of a call
               of ``FilterScheduler``, ``RetryScheduler`` and
               ``PreemptibleScheduler`` on the host and of the rebuild-per-
               call ``TorchPreemptibleScheduler`` on the card (build and
               decision apart); each card result equal to the CPU's and in
               ok and plan cost to ``PreemptibleScheduler``'s; at 65,536
               saturated hosts 4 calls, whole and build, the decision equal
               to a fresh ``SoAFleet``'s first; the screen without the
               free-slot test against its plain versions at 257, 2,400 and
               65,536 hosts; the python ``Simulator`` with the rebuild
               scheduler on the card and on the CPU (16 hosts, 24 hours):
               identical; the launches of each decision kernel against what
               the path implies;
5c. admission — the streaming admission plane: the drain order's int64 key
               sort on the card against the CPU on heavily tied keys; phase
               4's simulator streaming (queue 256, batch 64, 4 tries, SLO
               60 s) on the card and on the CPU: identical counters,
               samples, admission stats (the waits bit for bit),
               placements, preemptions, final state and final queue; at
               65,536 saturated hosts 512 arrivals (half normal, two
               classes) in blocking drains every 64, then ``drain_all``:
               decisions/s, drain ms, sim-time waits, wall submit→absorbed
               latency and the counts, conservation, every drain in
               (class, seq) order, no class-1 attempt while a class-0 entry
               waits, then every drain replayed through ``schedule_many``
               from the state before the stream (the same decisions, the
               same state after each drain); at 65,536 empty hosts 512
               arrivals in non-blocking drains of 16 and of 64, every one
               admitted: decisions/s and wall latency; the launches of each
               decision kernel against what the path implies;
5d. relocation — the relocation plane: the victim ranking (a stable sort
               of 524,288 losses, 65,536 hosts x 8 slots, and a heavily tied
               case) on the card against the CPU, the loss bit for bit;
               ``tests/test_relocation.py::_storm_sim``'s churn regime and
               storms on 4,096 Table 1 nodes in 3 zones (3 medium instances
               a host, 0.25 arrivals/s), direct and streaming, on the card
               and on the CPU: identical metrics, storm kills, relocation
               records, ``relocated_ids``, final state (and queue); at
               65,536 nodes in 4 zones (z0-z2 2 instances a host, z3
               saturated at 4) one storm of kill_frac 0.25 on z3, then 8
               relocation passes 60 s apart, direct and through the
               admission plane: moved / failed / lost / stale / pending,
               relocations/s, pass, ranking and batch ms, the device's busy
               share; no replacement in z3, conservation, every direct pass
               replayed victim by victim (checkpoint, ``schedule_step`` with
               z3 excluded, voluntary termination) from a clone of the state
               before it, equal bit for bit; the launches of each decision
               kernel against what the path implies;
5e. scan     — the trace-driven simulator on benchmarks/bench_screen.py::
               _bench_scan's trace (772 rows over 3,200 s: arrivals,
               departures, checkpoints, a storm, a host failure and heal;
               streaming with _bench_scan_stream's policy): at 4,096 Table 1
               nodes ``simulate_scan`` on the card, on the CPU and the card's
               ``SoASimulator.run_trace`` identical, direct and streaming
               (outcomes, counters, samples, final state; admission
               counters, queue and waits); at 65,536 empty nodes both engines
               identical, events/s, decisions/s, a decision's p50 and the
               busy share of a traced 200-row prefix; phase 5's saturated
               draws in 3 zones, the trace cut to 1,600 s, both engines
               identical in outcomes (zone_up by its gap: the storm's uptime
               sum passes 2^24), preemptions, storm kills, events/s; at
               1,024 nodes 8 seed lanes (trajectories/s; every fourth lane
               against its padded single run), the multiplier axis on
               saturated nodes card against CPU, 8 admission-knob lanes;
               every decision kernel's launches against what the path
               implies;
5f. sharded  — the fleet split host-major into 4 shards on the card
               (``fleet_mesh(devices=[cuda] * 4)``; the visible device count
               printed): phase 3's 2^20 packed hosts screened per shard,
               each shard's forwarded (scores, idx) and the merged
               constants against the plain route, the constants against
               the fleet-wide fold and the merge against the unsharded
               kernel screen, all exact; phase 5's 65,536 saturated hosts
               in a sharded ``SoAFleet`` and an unsharded one, the same 512
               decisions in batches of 64 and 128 singles: every (host,
               slot, ok, kill, fell_back, margin), the mirrors and the final
               state identical; decisions/s, single p50 / p99, fallbacks,
               the busy share of 2 traced batches and peak memory of each;
               ``SoASimulator`` at 4,099 hosts (padded to 4,100) sharded on
               the card, unsharded on the card and sharded on the CPU:
               identical; ``test_sharded_parity.py``'s fallback fixture on
               the shards: host 1, fell back; the same over every visible
               device where there are several; the launches of each
               decision kernel against what the sharded path implies;
6. model_kernels — flash-attention forward and RMSNorm against their plain
               versions at qwen2-1.5b's, gemma-2b's, moonshot-v1-16b-a3b's (4 x
               1,024, 16 heads) and arctic-480b's (2 x 512, 56 heads on 8)
               shapes (plus a full and a ragged case; the f32 route at S=77 and
               at every shape its paths run: 4 x 1,024, 2 x 4,096, phase 10's,
               gemma-2b's, ragged and full; RMSNorm at the prefill, decode and
               training shapes, both type mixes, an odd width, rows off 16-byte
               alignment, 2,048 and 7,168 wide), each gap against a stated
               tolerance, and two calls of the forward (both routes) and of
               RMSNorm giving the same bits; kernel / plain / bound / library
               times (bf16 tensor-core and f32 routes; the f32 route at 4 x
               1,024 and 2 x 4,096, by the trace and by CUDA events), and
               RMSNorm's and the library's at 8, 4,096 and 8,192 rows of 1,536,
               warm and with the L2 flushed; both kernels' times at phase 8b's
               prefill shapes;
7. model_parity — reduced qwen2-1.5b in f32, the same weights on the card
               and on the CPU: flash ``forward_logits`` within 1e-4 (past
               it, the failure's message says which side moved: each
               forward again, both with reference attention, the TF32
               settings, the CPU threads, the BLAS environment), and a
               ``ServingEngine`` run with identical tokens and step counts;
8. serve     — full-width qwen2-1.5b (28 layers, random f32 master weights from
               a seed, bf16 compute): ``forward_logits`` with flash, reference
               and blocked attention on 4 x 1,024 tokens against the f32
               forward (flash and blocked within 1.25x the reference's gap),
               then a ``ServingEngine`` (batch 8, max_len 1,024) answering 8
               requests across a preemption halfway through, drained by a
               second engine: prefill tokens/s, decode ms per step, decode
               tokens/s, peak memory, launch counts, and the device's busy
               share over a traced decode window;
8b. moe      — the mixture-of-experts family, each load after printing the
               card's free memory: reduced moonshot-v1-16b-a3b in f32, the same
               weights on the card and on the CPU, flash: every layer's routing
               (``top_e``, the kept mask) identical (a difference fails with
               the token's top-k probability gap), ``forward_logits`` no
               further from an f64 forward than 3x the CPU's f32 (which this
               network puts 2e-3 from it), a ``ServingEngine`` run with
               identical tokens; one full-width moonshot MoE layer in f32 on
               512 tokens at capacity factor 16 against the dense per-token
               reference (stated bound), two calls the same bits, and the share
               of choices dropped at the config's 1.25; full-width
               moonshot-v1-16b-a3b (48 layers, bf16 parameters drawn on the
               card): ``forward_logits`` on 4 x 1,024 tokens with flash and
               reference attention (their gap and the share of tokens routed
               apart, by layer; at depth 4, each against the f32 forward of
               those layers, flash within 1.25x the reference's gap, phase 8's
               bound), a ``ServingEngine`` (batch 8, max_len 1,024) answering 8
               requests of 32 new tokens across a preemption after 16
               steps, drained by a second engine, with the tokens of an
               uninterrupted engine (capacity factor 16, so
               that no choice drops), then at the config's 1.25: prefill
               tokens/s, decode ms p50 / p99, dropped shares, peak memory,
               launches against the path, the busy share of a traced decode
               window; arctic-480b at full width cut to 1 layer (bf16): its
               layer (128 experts top-2 beside the dense MLP) against the dense
               reference plus ``glu_mlp`` on 256 tokens (stated bf16 bound),
               two calls the same bits; then ``forward_logits`` on 2 x 512
               tokens, flash and reference against the f32 forward (the weights
               cast in place), flash within 1.25x the reference's gap;
8c. hybrid   — the Mamba2 hybrid and xLSTM: the flash forward at head_dim
               112 (zamba2-7b's) against its plain version (bf16 at the
               shared block's prefill shape 4 x 1,024 with 32 heads, ragged
               S=1,000 and full; f32 at S=77 and 1 x 1,024), two calls the
               same bits, its SASS (HGMMA and UTMALDG in the bf16
               instantiation, none in the f32 one), kernel / plain / bound /
               library times; RMSNorm at 3,584, 7,168 and 768 wide against
               its plain version and F.rms_norm, with times; reduced
               zamba2-7b (8 layers at cadence 3, hd 32 and 112) and
               xlstm-125m in f32, the weights and the CPU's forward from
               chip_smoke_cpu.py: the card's gap to an f64 forward at most
               3x the CPU's, 24 decode steps against the card's forward;
               full-width zamba2-7b (81 layers, 6.75 B bf16 parameters drawn
               on the card): ``forward_logits`` on 4 x 1,024 tokens with
               flash and reference attention, at two groups' depth each
               against the f32 forward (flash within 1.25x the reference's
               gap), batch 8 served by ``decode_step`` (64 prompt tokens,
               32 new), decode ms p50 / p99, tokens/s, peak memory, the busy
               share of a traced decode window; the decode against
               ``forward_logits`` at every position, in bf16 at two groups'
               depth (within 2.5x the bf16 forward's gap to the f32
               forward) and in f32 at 81 layers (16 steps, within 2.5x the
               f32 forward's spread between chunks of 16 and of 1), the
               81-layer bf16 gaps printed; full-width xlstm-125m:
               ``forward_logits`` on 4 x 1,024 tokens, 32 decode steps held
               to it as zamba2-7b's, tokens/s; every kernel's launches
               against what the path implies;
8d. encdec   — the encoder-decoder and the vision stub: the flash forward
               at seamless-m4t-medium's shape (4 x 1,024, 16 heads on 16, hd
               64) and internvl2-26b's (2 x 2,048, 48 on 8, hd 128) and the
               f32 route at the reduced models' against its plain version,
               two calls the same bits, kernel / plain / bound / library
               times; RMSNorm at 1,024 and 6,144 wide likewise; reduced
               seamless-m4t-medium and internvl2-26b in f32, flash, the
               weights and the CPU's side from chip_smoke_cpu.py: the card's
               gap to an f64 forward at most 3x the CPU's, 24 decode steps
               against the card's forward (seamless over cross caches
               primed from its encoder, internvl2 text only), and
               ``forward_train`` (remat full: the f32 dq and dk/dv at hd 32)
               with its loss and gradient norm within phase 10's bounds and
               each gradient's gap to the f64 one at most 3x the CPU's;
               full-width seamless-m4t-medium (its f32 parameters, bf16
               compute) on 4 x 1,024 frame embeddings and tokens:
               ``forward_logits`` with flash and reference attention, at 1 +
               1 layers against the f32 forward (flash within 1.25x the
               reference's gap), decode at batch 4 over primed cross
               caches (32 new tokens; held in bf16 at 1 + 1 layers and in f32
               at full depth), decode ms p50 / p99, peak memory, the busy
               share of a traced window; full-width internvl2-26b (19.86 B
               bf16 parameters drawn on the card) on 2 x (1,024 patch
               embeddings + 1,024 tokens): ``forward_logits`` with flash
               and reference attention, at depth 4 against the f32 forward
               (``forward_train`` at full width: phase 11c), the serving
               engine (text
               only, as the JAX package serves it: 8 requests, batch 8, 32
               new tokens), prefill tokens/s, decode ms p50 / p99, peak
               memory, busy share; every kernel's launches against what
               the path implies;
9. train_kernels — the flash-attention backward kernels (dq, dk/dv and its
               reduction over grouped heads; bf16 on the tensor cores, f32
               on the CUDA cores) against
               ``flash_attention_bwd_plain`` on the same inputs at
               qwen2-1.5b's training shape (B=2, S=4,096, bf16), gemma-2b's
               (hd=256, MQA), a ragged (S=1,000), a full and three f32
               cases (S=77; 1 x 2,048 at qwen2's heads; gemma-2b's), and at
               head_dim 112 zamba2-7b's training shape (4 x 1,024, 32 heads
               on 32), ragged, full and the f32 route at S=77 and 1 x 1,024,
               each gap against a stated tolerance, two calls giving the
               same bits, both reductions exactly equal to their plain
               versions; kernel / plain / bound / library times (the
               reduction's library: two torch.sum over the group axis, by
               the trace and by CUDA events), the forward's too, the f32
               route's dq, dk/dv and reduction at 1 x 2,048, 2 x 4,096 and
               phase 10's shape, and the hd-112 kernels' on both routes
               with their SASS (HGMMA and UTMALDG in the bf16 ones, none in
               the f32 ones) and ptxas registers and spills; and the bf16
               kernels at the head layouts phase 11c trains
               (seamless-m4t-medium 4 x 1,024, 16 on 16, hd 64;
               moonshot-v1-16b-a3b 16 on 16, hd 128; arctic-480b 56 on 8;
               internvl2-26b 2 x 2,048, 48 on 8): against the plain
               backward, two calls the same bits, the reduction exactly its
               plain version's, each kernel's time by the trace and by CUDA
               events beside its bound, the plain backward's and the
               library's (by both methods);
10. train_parity — reduced qwen2-1.5b in f32, flash attention, full remat, the
               same weights on the card and on the CPU: three
               ``make_train_step`` steps agree, and one more under
               ``remat="dots"`` and one with blocked attention; then a
               ``Trainer`` run of 8 steps against one preempted after 4 and
               resumed by a fresh ``Trainer``, which must end bitwise equal;
               the launches of the f32 flash kernels this path runs;
11. train    — full-width qwen2-1.5b (f32 master weights and AdamW state,
               bf16 compute, flash attention, full remat, 4 x 4,096 tokens a
               step as 2 microbatches): 3 steps, a preemption through the
               ``PreemptionController`` with a checkpoint, a fresh
               ``Trainer`` restoring and taking 2 more: step time, tokens/s,
               model-flops utilisation, peak memory, checkpoint bytes,
               drain and restore seconds, launch counts checked against the
               path, the device's busy share and time by kernel class over
               one traced step, and the first step against reference
               attention on the same batch (its f32 half runs the f32 flash
               kernels, whose launches are counted against the path); one
               more step under ``remat="full"`` and one under ``"dots"``,
               each with its time and peak memory;
11b. hybrid_train — the Mamba2 hybrid and xLSTM trained: reduced
               zamba2-7b (hd 32 and 112) and xlstm-125m in f32, flash, full
               remat, three ``make_train_step`` steps under Adafactor and
               under AdamW, each from the CPU's state (chip_smoke_cpu.py's
               run), losses and gradient norms within phase 10's bounds,
               each update within bounds set by phase 10's rule (a few
               times what an H100 reads); a ``Trainer`` on the reduced
               hybrid at hd 112 under Adafactor, 4 steps against one
               preempted after 2 and resumed, bitwise equal; full-width
               zamba2-7b cut to 39 of 81 layers (3.48 B bf16 parameters
               drawn on the card, Adafactor, flash, full remat, 4 x 1,024
               tokens a step): the free memory and the reckoned peak, the
               first step's loss and gradient norm against reference
               attention's, three timed steps (step time, tokens/s, MFU,
               peak memory), the busy share and device ms by kernel class
               of a fourth, traced; full-width xlstm-125m (f32, AdamW) two
               steps of 4 x 256 tokens; every kernel's launches against
               what the path implies;
11c. train_full — the mixture-of-experts, the encoder-decoder and the
               vision stub trained: reduced moonshot-v1-16b-a3b, arctic-480b,
               seamless-m4t-medium and internvl2-26b in f32, flash, full
               remat, three ``make_train_step`` steps under Adafactor and
               under AdamW, each from the CPU's state, held as 11b holds the
               hybrid; a ``Trainer`` on reduced moonshot preempted after 2 of
               4 steps and resumed, bitwise equal; then at full width, each
               with the free memory and the reckoned peak before it is
               drawn on the card, the first step against reference
               attention, three timed steps and a fourth traced (step time,
               tokens/s, MFU, peak memory, busy share, device ms by class):
               moonshot-v1-16b-a3b (8 of 48 layers, 6 if the reckoning
               leaves under 8 GiB free; bf16 parameters, its own AdamW),
               arctic-480b (1 of 35 layers, its own bf16 parameters and
               Adafactor, its peak within its reckoning plus 10 %), both
               MoE steps taken twice from the same state with every
               tensor's bits equal, seamless-m4t-medium (full depth, its own
               f32 parameters and AdamW) and internvl2-26b (32 of 48 layers,
               bf16 parameters, Adafactor); 4 x 1,024 tokens a step (2 x
               (1,024 patches + 1,024 tokens) for internvl2); every kernel's
               launches against what the path implies;
12. every library time of a flash kernel's function by the trace and by
    CUDA events, marking any reading under its bound; the ``kernels`` line,
    then the card's name and power limit, then the result line.

The CPU side of phases 4 to 5f's card-against-CPU simulator runs and of
phases 8c's, 8d's, 11b's and 11c's reduced models (chip_smoke_cpu.py, the scenarios and what is
compared) runs in a process of its own, started with the script on 2 CPU threads, while the card
works; the ``cpu_refs`` line after phase 5f gives the seconds the script
waited for each run, and every line's ``at_s`` its seconds since the start.

TF32 is off for matmuls and cuDNN (``allow_tf32 = False``), so every f32
product here is full f32.  The script imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import atexit
import dataclasses
import gc
import json
import math
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device visible; this script needs an NVIDIA GPU")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.core import fleets  # noqa: E402
from repro_torch.core.admission import QUEUE_DTYPES, queue_init, queue_select  # noqa: E402
from repro_torch.core import soa_fleet as soa_mod  # noqa: E402
from repro_torch.core import scan_sim  # noqa: E402
from repro_torch.core.convert import (  # noqa: E402
    fleet_state_from_numpy,
    fleet_state_to_numpy,
    host_state_from_numpy,
    queue_state_from_numpy,
    queue_state_to_numpy,
)
from repro_torch.core import torch_scheduler as tsched  # noqa: E402
from repro_torch.core.fleet_sharding import (  # noqa: E402
    fleet_mesh,
    merge_shortlists,
    padded_hosts,
)
from repro_torch.core.policy import SchedulerPolicy  # noqa: E402
from repro_torch.core.scheduler import SCHEDULER_REGISTRY  # noqa: E402
from repro_torch.core.simulator import SoASimulator, WorkloadSpec  # noqa: E402
from repro_torch.core.soa_fleet import SoAFleet  # noqa: E402
from repro_torch.core.torch_scheduler import (  # noqa: E402
    STATE_DTYPES,
    TorchPreemptibleScheduler,
    apply_checkpoint,
    apply_termination,
    build_soa_state,
    fleet_slot_costs,
    schedule_many,
    schedule_step,
)
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS, FWD_HEAD_DIMS  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.attention import encode_cross_kv  # noqa: E402
from repro_torch.models.layers import glu_mlp, init_leaf  # noqa: E402
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.core.preemption import PreemptAck, PreemptionController  # noqa: E402
from repro_torch.core.types import TPU_SPEC, Instance  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.optim import adamw_init, make_optimizer  # noqa: E402
from repro_torch.optim import optimizers as optim_mod  # noqa: E402
from repro_torch.training import Trainer, TrainerConfig, TrainSettings, make_train_step  # noqa: E402
from repro_torch.training.trainer import state_tensors  # noqa: E402
from chip_smoke_cpu import (  # noqa: E402
    ADMISSION,
    COUNTERS,
    ENCDEC_CASES,
    ENCDEC_SHAPE,
    HYBRID_CASES,
    HYBRID_TRAIN,
    MULT_ROWS,
    TRAIN_CASES,
    RELOC,
    RELOC_RATE,
    SCAN_ENS_S,
    SCAN_POLICY,
    SCAN_S,
    SCAN_SPEC,
    adm_stats,
    mult_state,
    mult_trace,
    on_clock,
    parity_sim,
    ragged_sim,
    encdec_batch,
    encdec_config,
    hybrid_config,
    hybrid_tokens,
    hybrid_train_config,
    hybrid_train_data,
    ragged_view,
    rebuild_sim,
    rebuild_view,
    reloc_sim,
    reloc_view,
    saturated_zoned,
    scan_trace,
    scan_view,
    sim_view,
    stream_sim,
    train_batch_at,
    train_config,
    zoned_hosts,
)

T_START = time.perf_counter()
# the CPU side of the simulators' card-against-CPU checks (phases 4 to 5f)
# runs in a process of its own from the start, while the card works; each
# phase reads its CPU run's view from CPU_DIR.  SIGTERM exits through
# atexit, which stops that process
CPU_DIR = tempfile.mkdtemp(prefix="chip_smoke_cpu_")
_cpu_log = open(os.path.join(CPU_DIR, "worker.log"), "wb")
cpu_proc = subprocess.Popen(
    [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke_cpu.py"),
     CPU_DIR], stdout=_cpu_log, stderr=subprocess.STDOUT, env=dict(os.environ, OMP_NUM_THREADS="2"))
CPU_WAITED = {}


def _stop_cpu_process() -> None:
    if cpu_proc.poll() is None:
        cpu_proc.kill()
    cpu_proc.wait()
    _cpu_log.close()
    shutil.rmtree(CPU_DIR, ignore_errors=True)


atexit.register(_stop_cpu_process)
signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))

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
    """One JSON line; ``at_s`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - T_START}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cpu_ref(name: str, timeout_s: float = 900.0) -> dict:
    """The CPU run ``name`` of chip_smoke_cpu.py, waiting for it; fails if
    that process ended without it or it takes ``timeout_s``."""
    path, t = os.path.join(CPU_DIR, f"{name}.pkl"), time.perf_counter()
    while not os.path.exists(path):
        if cpu_proc.poll() is not None and not os.path.exists(path):
            with open(os.path.join(CPU_DIR, "worker.log"), "rb") as fh:
                tail = fh.read()[-4000:].decode(errors="replace")
            raise AssertionError(f"chip_smoke_cpu.py ended (rc {cpu_proc.returncode}) before "
                                 f"its run {name}: {tail}")
        check(time.perf_counter() - t < timeout_s, f"chip_smoke_cpu.py: no run {name} in {timeout_s} s")
        time.sleep(0.05)
    with open(path, "rb") as fh:
        out = pickle.load(fh)
    CPU_WAITED[name] = time.perf_counter() - t
    return out


def same_view(got: dict, want: dict, what: str) -> None:
    """Two views of a run (chip_smoke_cpu.py's ``*_view``) equal entry by
    entry: arrays by value, dicts of arrays field by field, the rest by
    ``==``; ``seconds`` aside."""
    for key, w_ in want.items():
        if key == "seconds":
            continue
        g_ = got[key]
        if isinstance(w_, dict) and w_ and all(isinstance(v_, np.ndarray) for v_ in w_.values()):
            for f_, wv_ in w_.items():
                check(np.array_equal(g_[f_], wv_), f"{what}: {key} {f_} differs")
        elif isinstance(w_, np.ndarray):
            check(np.array_equal(g_, w_), f"{what}: {key} differs")
        else:
            check(g_ == w_, f"{what}: {key} differ")


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


#: every library call timed for a flash kernel's function: its reading by the
#: trace and by CUDA events, beside the function's bound
LIBRARY_READINGS = {}


def library_time(what: str, fn, bound_ms: float, reps: int = 25) -> float:
    """The device time of one PyTorch call that computes a kernel's function,
    by ``device_ms`` (the trace) and by ``median_ms`` (CUDA events, which
    count the host's launch gaps too), both kept in ``LIBRARY_READINGS``.
    Returns the trace's reading, or the events' where the trace's lies under
    the function's bound, which no call can beat."""
    trace, events = device_ms(fn, reps), median_ms(fn, reps)
    LIBRARY_READINGS[what] = dict(trace_ms=trace, events_ms=events, bound_ms=bound_ms)
    return events if trace < bound_ms else trace


def max_gap(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max()) if a.numel() else 0.0


#: largest |kernel - plain| measured per kernel (phases 3 and 6)
GAPS = {"sched_screen_consts": 0.0, "sched_screen_topm": 0.0, "sched_screen": 0.0,
        "sched_weigh": 0.0, "flash_attention": 0.0, "flash_attention_f32": 0.0, "rmsnorm": 0.0,
        "flash_attention_hd112": 0.0, "flash_attention_f32_hd112": 0.0,
        "flash_attention_dq": 0.0, "flash_attention_dq_f32": 0.0, "flash_attention_dkv": 0.0,
        "flash_attention_dkv_reduce": 0.0, "flash_attention_dkv_f32": 0.0,
        "flash_attention_dkv_reduce_f32": 0.0, "flash_attention_dq_hd112": 0.0,
        "flash_attention_dkv_hd112": 0.0, "flash_attention_dq_f32_hd112": 0.0,
        "flash_attention_dkv_f32_hd112": 0.0}


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


# -- the model phases' helpers (8, 8b, 8c, 8d) ---------------------------------------
def free_gib(what, phase="moe_memory"):
    """Print the card's free memory before a model is loaded."""
    free_, total_ = torch.cuda.mem_get_info()
    emit(phase, before=what, free_gib=free_ / 2**30, total_gib=total_ / 2**30)


def forwards(cfg_, params_, toks_, extra=None):
    """``forward_logits`` (every position) with flash and with reference
    attention, each after a warm-up at the same shape (cuBLAS picks its
    plans on a shape's first call): the logits, the seconds, and each MoE
    call's ``top_e`` (none without experts).  ``extra`` holds the batch's
    other inputs (``frame_embeds``, ``patch_embeds``)."""
    outs, secs, tops = {}, {}, {}
    batch_ = {"tokens": toks_, **(extra or {})}
    for impl in ("flash", "reference"):
        c_ = dataclasses.replace(cfg_, attention_impl=impl)
        tm.forward_logits(c_, params_, batch_)                           # warm-up
        torch.cuda.synchronize()
        t_ = time.perf_counter()
        with tmoe.capture_routing() as r_:
            outs[impl] = tm.forward_logits(c_, params_, batch_, last_only=False)
        torch.cuda.synchronize()
        secs[impl] = time.perf_counter() - t_
        tops[impl] = [c["top_e"] for c in r_]
        check(bool(torch.isfinite(outs[impl]).all()), f"{cfg_.name} {impl} logits not finite")
        check(outs[impl].shape == (*toks_.shape, cfg_.vocab_padded),
              f"{cfg_.name} {impl} logits shape {outs[impl].shape}")
    return outs, secs, tops


def logit_gap(a, b):
    """|a - b| (max, mean), b's RMS and the share of positions whose argmax
    agrees, a sequence at a time in f32."""
    rows_ = []
    for a_, b_ in zip(a, b):
        a_, b_ = a_.float(), b_.float()
        d_ = (a_ - b_).abs()
        rows_.append((float(d_.max()), float(d_.sum()), float(torch.sum(b_ * b_)),
                      float((a_.argmax(-1) == b_.argmax(-1)).sum())))
        del a_, b_, d_
    n_ = b.numel()
    return dict(max=max(r_[0] for r_ in rows_), mean=sum(r_[1] for r_ in rows_) / n_,
                rms=math.sqrt(sum(r_[2] for r_ in rows_) / n_),
                argmax_agree=sum(r_[3] for r_ in rows_) * b.shape[-1] / n_)


#: phase 10's bounds, card against CPU (phases 8d and 11b hold them too).  f32
#: on both sides: the card's products and the kernels sum in another
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


def against_f32(outs, truth, what):
    """Each bf16 path's gap to the f32 forward; flash may be no further from
    it than 1.25x the reference attention's gap (phase 8's bound: both are
    bf16 rounding, which these random weights amplify)."""
    gaps_ = {impl: logit_gap(o_, truth) for impl, o_ in outs.items()}
    for stat in ("max", "mean"):
        check(gaps_["flash"][stat] <= 1.25 * gaps_["reference"][stat],
              f"{what}: flash logits {stat} gap to f32 {gaps_['flash'][stat]} exceeds 1.25x the "
              f"bf16 reference path's {gaps_['reference'][stat]}")
    return gaps_


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
build_s = time.perf_counter() - t0
# the tensor-core kernels reach the tensor cores (HGMMA: wgmma) and TMA
# (UTMALDG), read from the SASS of each library
cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
sass_counts, f32_sass = {}, {}
for src in ("flash_attention", "flash_attention_bwd"):
    sass = subprocess.run([cuobjdump, "--dump-sass", paths[src]], capture_output=True, text=True,
                          check=True).stdout
    for chunk in sass.split("Function : ")[1:]:
        fn_name = chunk.split(None, 1)[0]
        if "wgmma_kernel" in fn_name:
            sass_counts[fn_name] = dict(HGMMA=chunk.count("HGMMA"), UTMALDG=chunk.count("UTMALDG"))
        if "f32_kernel" in fn_name:
            f32_sass[fn_name] = dict(HMMA=chunk.count("HMMA"), HGMMA=chunk.count("HGMMA"),
                                     FFMA=chunk.count("FFMA"))
# the f32 kernels (the forward at each of its head dims, dq and dk/dv at
# each of theirs, the reduction) stay on the CUDA cores in full f32: no
# tensor-core instruction
check(len(f32_sass) == len(FWD_HEAD_DIMS) + 2 * len(BWD_HEAD_DIMS) + 1,
      f"build: {len(f32_sass)} f32 kernels in the SASS")
for f, c in f32_sass.items():
    check(c["HMMA"] == 0 and c["HGMMA"] == 0 and (c["FFMA"] > 0 or "reduce" in f),
          f"build: {f} has {c} in its SASS")
# instantiations of the forward (FWD_HEAD_DIMS, 112 among them) and of the
# backward (BWD_HEAD_DIMS), counted apart
instantiations = dict(head_dims=dict(forward=FWD_HEAD_DIMS, backward=BWD_HEAD_DIMS),
                      f32_kernels=len(f32_sass))
for kernel_name, dims in (("flash_fwd_wgmma_kernel", FWD_HEAD_DIMS),
                          ("flash_bwd_dq_wgmma_kernel", BWD_HEAD_DIMS),
                          ("flash_bwd_dkv_wgmma_kernel", BWD_HEAD_DIMS)):
    found = {f: c for f, c in sass_counts.items() if kernel_name in f}
    check(len(found) == len(dims), f"build: {len(found)} instantiations of {kernel_name}")
    instantiations[kernel_name] = len(found)
    for f, c in found.items():
        check(c["HGMMA"] > 0 and c["UTMALDG"] > 0, f"build: {f} has {c} in its SASS")
# ptxas's registers and spills of each tensor-core kernel instantiation
# (a library already built by an earlier run of this checkout has no report)
ptxas = {}
for src in ("flash_attention", "flash_attention_bwd"):
    if src not in _build.BUILD_LOG:
        ptxas[src] = "library cached from an earlier build: no report"
        continue
    found = {f: c for f, c in _build.ptxas_report(src).items() if "wgmma_kernel" in f}
    check(len(found) == (len(FWD_HEAD_DIMS) if src == "flash_attention" else 2 * len(BWD_HEAD_DIMS)),
          f"build: ptxas reported {len(found)} tensor-core kernels of {src}.cu")
    ptxas.update(found)
# and of the f32 kernels, none with a stack frame or spills
f32_ptxas = {}
for src, count in (("flash_attention", len(FWD_HEAD_DIMS)),
                   ("flash_attention_bwd", 2 * len(BWD_HEAD_DIMS) + 1)):
    if src not in _build.BUILD_LOG:
        f32_ptxas[src] = "library cached from an earlier build: no report"
        continue
    found = {f: c for f, c in _build.ptxas_report(src).items() if "f32_kernel" in f}
    check(len(found) == count, f"build: ptxas reported {len(found)} f32 kernels of {src}.cu")
    for f, c in found.items():
        check(c["stack"] == 0 and c["spill_stores"] == 0 and c["spill_loads"] == 0,
              f"build: {f} has a stack frame or spills: {c}")
    f32_ptxas.update(found)
# and of every screen kernel (a template instantiation for each K <= 12):
# the K=8 ones, the main path's, keep every value in registers
screen_ptxas = "library cached from an earlier build: no report"
if "sched_screen" in _build.BUILD_LOG:
    screen_ptxas = {f: c for f, c in _build.ptxas_report("sched_screen").items()
                    if "screen_consts_kernel" in f or "screen_topm_kernel" in f}
    check(len(screen_ptxas) == 2 * 12, f"build: ptxas reported {len(screen_ptxas)} screen kernels")
    for f, c in screen_ptxas.items():
        if "ILi8E" in f:
            check(c["stack"] == 0 and c["spill_stores"] == 0 and c["spill_loads"] == 0,
                  f"build: {f} has a stack frame or spills: {c}")
# and of every RMSNorm (x and w types x chunks a lane, and the edge kernel)
# and sched_weigh (K = 1..12 x D = 1..8) instantiation: none spills; each
# source's largest registers and stack, and the main path's instantiations
# (sched_weigh K=8 D=3; RMSNorm bf16 at 6 chunks a lane, d = 1,536) in full
small_ptxas = {}
for src, tags, count, main in (
        ("rmsnorm", ("rmsnorm_vec_kernel", "rmsnorm_edge_kernel"), 4 * 8 + 4,
         ("rmsnorm_vec_kernelI13__nv_bfloat16S", "Li6E")),      # <bf16, bf16, 6>
        ("sched_weigh", ("sched_weigh_kernel",), 12 * 8, ("sched_weigh_kernelILi8ELi3E",))):
    if src not in _build.BUILD_LOG:
        small_ptxas[src] = "library cached from an earlier build: no report"
        continue
    found = {f: c for f, c in _build.ptxas_report(src).items() if any(t in f for t in tags)}
    check(len(found) == count, f"build: ptxas reported {len(found)} kernels of {src}.cu")
    for f, c in found.items():
        check(c["spill_stores"] == 0 and c["spill_loads"] == 0, f"build: {f} spills: {c}")
    small_ptxas[src] = dict(
        kernels=len(found), spill_bytes=0,
        max_registers=max(c["registers"] for c in found.values()),
        max_stack=max(c["stack"] for c in found.values()),
        main_path={f: c for f, c in found.items() if all(m_ in f for m_ in main)})
    check(len(small_ptxas[src]["main_path"]) == 1, f"build: {main} not found in {src}.cu")
# the backward's hd-112 instantiations (dq and dk/dv, each route): HGMMA
# and UTMALDG in the bf16 ones, no tensor-core instruction in the f32 ones,
# with ptxas's registers and spills
bwd_hd112_sass = {f: dict(c, **(ptxas.get(f) or f32_ptxas.get(f) or {}))
                  for f, c in {**sass_counts, **f32_sass}.items() if "flash_bwd" in f and "Li112E" in f}
check(len(bwd_hd112_sass) == 4, f"backward hd 112: {len(bwd_hd112_sass)} instantiations in the SASS")
for f, c in bwd_hd112_sass.items():
    check(c["HGMMA"] > 0 and c["UTMALDG"] > 0 if "wgmma" in f else c["HGMMA"] == 0 and c["HMMA"] == 0,
          f"backward hd 112: {f} has {c} in its SASS")
emit("build", seconds=build_s, seconds_by_source=dict(_build.BUILD_SECONDS),
     flash_instantiations=instantiations, backward_hd112=bwd_hd112_sass,
     libraries=sorted(os.path.basename(p) for p in paths.values()),
     sass_hgmma_utmaldg=sass_counts, ptxas_registers_spills=ptxas,
     sass_f32_hmma_hgmma_ffma=f32_sass, ptxas_f32=f32_ptxas,
     ptxas_sched_screen=screen_ptxas, ptxas_rmsnorm_sched_weigh=small_ptxas)

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


def bound_of(bytes_moved, ops, flops=None):
    """(ms, "bytes" or "operations"): the least time for the work, the larger
    of the bytes over the HBM rate and the operations over the peak rate of
    their type (FP32 unless ``flops`` is given)."""
    t_bytes, t_ops = bytes_moved / HBM_BPS * 1e3, ops / (flops or FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(name, source, replaces, ms, plain_ms, bytes_moved, ops, flops=None,
           library_ms=None):
    """One entry of the kernels line; ``flops`` is the peak rate of the
    operations' type (FP32 unless given)."""
    bound, by = bound_of(bytes_moved, ops, flops)
    records[name] = dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=0,
        max_abs_err=GAPS[name], ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=library_ms,
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
runs = [kernels.sched_weigh(*full_args) for _ in range(2)]
check(all(torch.equal(a_, b_) for a_, b_ in zip(*runs)), "sched_weigh full fleet: two calls differ")
# off the integer grid at every K = 1..12 (D = 1..8 as K runs): fractional
# resources and costs, exact ties, a tie at TIE_EPS, invalid slots, hosts
# with none valid; on a shortlist of M hosts and on 4,096; at K = 4 and 5,
# where the sums follow XLA's trees on two or more hosts and slot order on
# one, also on 1 (host 1; host 0 has no valid slot) and 2
for kk in range(1, 13):
    for n_ in (M, 4096) + ((1, 2) if kk in (4, 5) else ()):
        *per_host, req_ = fleets.weigh_arrays(max(n_, M), kk, 1 + (kk - 1) % 8, seed=kk * n_)
        rows_n = slice(1, 2) if n_ == 1 else slice(0, n_)
        case = tuple(torch.from_numpy(a_[rows_n]).to(DEV) for a_ in per_host) \
            + (torch.from_numpy(req_).to(DEV),)
        for g, w, what in zip(kernels.sched_weigh(*case), kernels.sched_weigh_plain(*case),
                              ("cost", "mask", "feasible")):
            same(g, w, f"sched_weigh fractional K={kk} N={n_} {what}", "sched_weigh")
del runs, case

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
# weigher vectors that mix exact and inexact multipliers, and one shared
# power of two beyond 4, on the fractional costs: the fused multiply-add
# sites must agree bit for bit
MIXED = ((2.0, 1.0, 0.7, 1.0), (8.0, 1.0, 8.0, 8.0))
for mixed in MIXED:
    mix = kernels.sched_screen(*hf, mixed, True, M + 1)
    mix_c = kernels.sched_screen_consts_plain(*hf, mixed, True)
    mix_p = kernels.sched_screen_topm_plain(*hf, mix_c, mixed, True, M + 1)
    same(mix[0], mix_p[0], f"sched_screen scores {mixed}", "sched_screen")
    same(mix[1], mix_p[1], f"sched_screen idx {mixed}", "sched_screen")
    same(mix[2], mix_c, f"sched_screen consts {mixed}", "sched_screen")
# the traced-multiplier mode (phase 5e's multiplier axis): the row's values
# do the arithmetic, the policy's multipliers gate the terms; bit for bit on
# the integer grid and at the fractional clock, for the default policy's
# gates (the ensemble's rows and a zero under a gate) and the churn gates
TRACED = (((1.0, 1.0, 0.0, 0.0), ((1.0, 1.0, 0.0, 0.0), (4.0, 0.25, 0.0, 0.0),
                                  (0.5, 2.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0)), {}),
          (CHURN_MULT, ((1.0, 1.0, 0.5, 0.25, 2.0), (0.7, 1.3, 0.3, 1.7, 0.5),
                        (0.0, 1.0, 0.0, 0.25, 0.0)), churn_kw))
for clock_, h_ in (("integer", head), ("fractional", hf)):
    for gates_, rows_, kw_ in TRACED:
        for row_ in rows_:
            for pre in (False, True):
                hh_ = h_[:9] + (pre, -1)
                got_ = kernels.sched_screen(*hh_, row_, True, M + 1, gates=gates_, **kw_)
                c_ = kernels.sched_screen_consts_plain(*hh_, row_, True, gates=gates_, **kw_)
                t_ = kernels.sched_screen_topm_plain(*hh_, c_, row_, True, M + 1, gates=gates_,
                                                     **kw_)
                what_ = f"sched_screen traced {clock_} gates {gates_} row {row_} pre={pre}"
                same(got_[2], c_, f"{what_} consts", "sched_screen")
                same(got_[0], t_[0], f"{what_} scores", "sched_screen")
                same(got_[1], t_[1], f"{what_} idx", "sched_screen")
emit("screen_traced", hosts=n, k=k, d=d, m=M, exact=True,
     cases={str(gates_): [list(r_) for r_ in rows_] for gates_, rows_, _ in TRACED},
     clocks=["integer", "fractional"], requests=["normal", "preemptible"])
emit("kernels_vs_plain", hosts=n, k=k, d=d, m=M, integer_cases="exact",
     non_integer_max_gap=frac_gap, non_integer_decisions_agree=frac_same,
     mixed_multipliers=[list(m_) for m_ in MIXED], mixed_multipliers_case="exact",
     sched_weigh="exact: the shortlist at K=8 and K=12, the full fleet (two calls the same "
                 "bits), a fractional clock, fractional inputs at K=1..12 (D=1..8) on 64 and "
                 "4,096 hosts, and at K=4 and 5 (XLA's summation trees) on 1 and 2")

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
one = torch.zeros(1, device=DEV)     # a one-element op: the least a launch shows
extra = dict(
    launch_floor_ms=device_ms(lambda: one.add_(1)),
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

# 2^20 hosts, the JAX package's strong-scaling fleet (benchmarks/bench_screen.py)
# and four times the old one-block merge's ceiling of 258,048: packed nodes
# with costs as above (start times a minute apart), nearly every host tied
N_BIG = 1 << 20
packed, preq = fleets.packed_arrays(N_BIG, k, seed=0)
packed["inst_cost"] = (fleets.NOW - packed["inst_start"]).astype(np.float32)
big = tuple(torch.from_numpy(np.ascontiguousarray(packed[f])).to(DEV) for f in (
    "free_f", "free_n", "schedulable", "domain", "slow", "inst_res", "inst_cost",
    "inst_valid")) + (torch.from_numpy(preq).to(DEV), False, -1)
del packed
big_cp = kernels.sched_screen_consts_plain(*big, mult, True)
big_tp = kernels.sched_screen_topm_plain(*big, big_cp, mult, True, M + 1)
same(kernels.sched_screen_consts(*big, mult, True), big_cp, "2^20 sched_screen_consts",
     "sched_screen_consts")
big_t = kernels.sched_screen_topm(*big, big_cp, mult, True, M + 1)
same(big_t[0], big_tp[0], "2^20 sched_screen_topm scores", "sched_screen_topm")
same(big_t[1], big_tp[1], "2^20 sched_screen_topm idx", "sched_screen_topm")
runs = [kernels.sched_screen(*big, mult, True, M + 1) for _ in range(2)]
for got_, want_, what in zip(runs[0], (*big_tp, big_cp), ("scores", "idx", "consts")):
    same(got_, want_, f"2^20 sched_screen {what}", "sched_screen")
check(all(torch.equal(a_.view(torch.int32), b_.view(torch.int32)) for a_, b_ in zip(*runs)),
      "2^20 sched_screen: two calls differ")
big_bound = lambda extra_bytes: (N_BIG * host_bytes + extra_bytes) / HBM_BPS * 1e3
emit("screen_2_20", card=smi, hosts=N_BIG, k=k, d=d, m=M, exact=True,
     two_calls_bitwise_equal=True, distinct_top_scores=len(set(big_tp[0].tolist())),
     sched_screen_consts=dict(
         ms=device_ms(lambda: kernels.sched_screen_consts(*big, mult, True)),
         plain_ms=device_ms(lambda: kernels.sched_screen_consts_plain(*big, mult, True), reps=5),
         bound_ms=big_bound(40)),
     sched_screen_topm=dict(
         ms=device_ms(lambda: kernels.sched_screen_topm(*big, big_cp, mult, True, M + 1)),
         plain_ms=device_ms(lambda: kernels.sched_screen_topm_plain(
             *big, big_cp, mult, True, M + 1), reps=5),
         bound_ms=big_bound(40 + (M + 1) * 8)),
     sched_screen=dict(
         ms=device_ms(lambda: kernels.sched_screen(*big, mult, True, M + 1)),
         bound_ms=big_bound(40 + (M + 1) * 8), bound_note="a pass; the screen makes two"))
del big, big_cp, big_tp, big_t, runs

# ---------------------------------------------------------------------------
# 4. main-path parity: the simulator on the card and on the CPU
# ---------------------------------------------------------------------------
gsim, gm, g_s = parity_sim(DEV)
cref = cpu_ref("parity")
counters = COUNTERS
same_view(sim_view(gsim, gm), cref, "parity: the card against the CPU")
check(gsim.fleet.decisions >= 1000, "parity: fewer than 1,000 decisions")
emit("parity", hosts=4096, decisions=gsim.fleet.decisions,
     fallbacks=gsim.fleet.fallbacks, **{key: getattr(gm, key) for key in counters},
     gpu_seconds=g_s, cpu_seconds=cref["seconds"])
del gsim, gm, cref

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
# the trace records device activity only: with the host's ops too it holds
# several hundred thousand events, which take tens of seconds to read back,
# and nothing here reads them
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
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
# 5b. rebuild: the paper's schedulers and the rebuild-per-call scheduler
# ---------------------------------------------------------------------------
t_rebuild = time.perf_counter()
FIG2_SIZES = (24, 240, 2400)        # the paper's testbed; bench_fig2_latency's sizes
medium = fleets.SIZES["medium"]


def p50_ms(fn, min_calls=8):
    """Median wall clock of one call: 8 calls, 16 where a call is under
    50 ms.  Returns (ms, calls, last result)."""
    times, out = [], None
    while len(times) < min_calls or (len(times) < 16 and np.median(times) < 0.05):
        t = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t)
    return float(np.median(times)) * 1e3, len(times), out


def same_choice(a, b, what):
    check((a.ok, a.host, a.plan.ids, a.plan.cost) == (b.ok, b.host, b.plan.ids, b.plan.cost),
          f"rebuild: {what}: card {a.host} {a.plan.ids} {a.plan.cost} against CPU "
          f"{b.host} {b.plan.ids} {b.plan.cost}")


def agrees_with_paper(card, ref, what):
    """``test_jax_scheduler.py``'s rule: the same ok and plan cost; the
    host may differ only on an exact tie."""
    check(card.ok == ref.ok, f"rebuild: {what}: ok {card.ok} against the paper's {ref.ok}")
    if card.ok:
        check(card.plan.cost == ref.plan.cost,
              f"rebuild: {what}: cost {card.plan.cost} against the paper's {ref.plan.cost}")
        check(card.host != ref.host or set(card.plan.ids) == set(ref.plan.ids),
              f"rebuild: {what}: victims {card.plan.ids} against the paper's {ref.plan.ids}")


# the screen without the free-slot test (the rebuild path's), against its
# plain version bit for bit on the rebuilt states, before any launch is
# counted
hosts_big = fleets.saturated_fleet(N_HOSTS, seed=0)
free_slot_checked = []
for n_ in (257, 2400, N_HOSTS):
    state_, _ = build_soa_state(hosts_big[:n_], fleets.NOW, device=DEV)
    req_ = torch.tensor(medium.vec, dtype=torch.float32, device=DEV)
    for pre in (False, True):
        h_ = (state_.free_f, state_.free_n, state_.schedulable, state_.domain, state_.slow,
              state_.inst_res, state_.inst_cost, state_.inst_valid, req_, pre, -1)
        c_p = kernels.sched_screen_consts_plain(*h_, mult, False)
        t_p = kernels.sched_screen_topm_plain(*h_, c_p, mult, False, M + 1)
        same(kernels.sched_screen_consts(*h_, mult, False), c_p,
             f"rebuild {n_} pre={pre} sched_screen_consts", "sched_screen_consts")
        t_k = kernels.sched_screen_topm(*h_, c_p, mult, False, M + 1)
        same(t_k[0], t_p[0], f"rebuild {n_} pre={pre} sched_screen_topm scores", "sched_screen_topm")
        same(t_k[1], t_p[1], f"rebuild {n_} pre={pre} sched_screen_topm idx", "sched_screen_topm")
        f_k = kernels.sched_screen(*h_, mult, False, M + 1)
        for got_, want_, what in zip(f_k, (*t_p, c_p), ("scores", "idx", "consts")):
            same(got_, want_, f"rebuild {n_} pre={pre} sched_screen {what}", "sched_screen")
        free_slot_checked.append(f"{n_} hosts, {'preemptible' if pre else 'normal'}")
del state_, h_

# the path's own launches from here on
kernels.reset_launch_counts()
rebuild_counts = {key: 0 for key in kernels.launch_counts()}
implied = dict(sched_screen_consts=0, sched_screen_topm=0, sched_screen=0, sched_weigh=0,
               sched_weigh_gathered=0)


def absorb(sched, n_hosts_):
    """Add this scheduler's launches to the phase's, each against the count
    its calls imply (full weigh at <= 256 hosts; above, 2 screen launches
    and a gathered weigh a call and a full weigh a fallback)."""
    counts_ = kernels.launch_counts()
    kernels.reset_launch_counts()
    calls_ = sched.calls
    if n_hosts_ > 4 * M:
        want_ = dict(sched_screen_consts=calls_, sched_screen_topm=calls_,
                     sched_screen=2 * calls_, sched_weigh=calls_ + sched.fallbacks,
                     sched_weigh_gathered=calls_)
    else:
        want_ = dict(sched_screen_consts=0, sched_screen_topm=0, sched_screen=0,
                     sched_weigh=calls_, sched_weigh_gathered=0)
    for key, v_ in want_.items():
        check(counts_[key] == v_, f"rebuild: {n_hosts_} hosts: {key} launched {counts_[key]} "
                                  f"times, the path implies {v_}")
        implied[key] += v_
    for key, v_ in counts_.items():
        rebuild_counts[key] += v_


fig2 = {}
for n_ in FIG2_SIZES:
    fleets_ = {"empty": fleets.empty_fleet(n_), "saturated": fleets.saturated_fleet(n_, seed=0)}
    gsched = TorchPreemptibleScheduler(device=DEV)
    csched = TorchPreemptibleScheduler(device="cpu")
    for scen, hosts_key, pre in (("empty", "empty", False), ("empty-spot", "empty", True),
                                 ("saturated", "saturated", False)):
        hosts_ = fleets_[hosts_key]
        req_ = Request(id=f"fig2-{scen}", resources=medium, preemptible=pre)
        row = {}
        for name, cls in SCHEDULER_REGISTRY.items():     # filter, retry, preemptible
            py_ = cls()
            row[f"{name}_ms"], row[f"{name}_calls"], res_ = p50_ms(
                lambda: py_.schedule(req_, hosts_, fleets.NOW))
            if name == "preemptible":
                ref = res_
        gsched.schedule(req_, hosts_, fleets.NOW)            # warm-up
        builds, decides = [], []

        def card_call():
            out_ = gsched.schedule(req_, hosts_, fleets.NOW)
            builds.append(gsched.last_build_s)
            decides.append(gsched.last_decision_s)
            return out_

        row["card_ms"], row["card_calls"], got = p50_ms(card_call)
        row["card_build_ms"] = float(np.median(builds)) * 1e3
        row["card_decision_ms"] = float(np.median(decides)) * 1e3
        same_choice(got, csched.schedule(req_, hosts_, fleets.NOW), f"{scen} at {n_} hosts")
        agrees_with_paper(got, ref, f"{scen} at {n_} hosts")
        check(got.ok and bool(got.plan.ids) == (scen == "saturated"),
              f"rebuild: {scen} at {n_} hosts: ok {got.ok}, victims {got.plan.ids}")
        row["victims"] = len(got.plan.ids)
        fig2[f"{scen}@{n_}"] = row
    absorb(gsched, n_)
    fig2[f"fallbacks@{n_}"] = gsched.fallbacks

# 65,536 saturated hosts (phase 5's fleet): 4 calls, whole and build; the
# decision against a fresh SoAFleet's first one on the same fleet
hosts_ = hosts_big
req_ = Request(id="big", resources=medium, preemptible=False)
gsched = TorchPreemptibleScheduler(device=DEV)
big_calls, big_builds, big_decides = [], [], []
for _ in range(4):
    t_ = time.perf_counter()
    got = gsched.schedule(req_, hosts_, fleets.NOW)
    big_calls.append(time.perf_counter() - t_)
    big_builds.append(gsched.last_build_s)
    big_decides.append(gsched.last_decision_s)
absorb(gsched, N_HOSTS)
big_fallbacks = gsched.fallbacks
persistent = SoAFleet(hosts_, device=DEV)
first = persistent.schedule_request(req_, fleets.NOW)
kernels.reset_launch_counts()                         # the persistent path's, not this one's
check(got.ok and first.ok and got.host == first.host
      and set(got.plan.ids) == {v_.id for v_ in first.victims},
      f"rebuild: 65,536 hosts: {got.host} {got.plan.ids} against SoAFleet's "
      f"{first.host} {[v_.id for v_ in first.victims]}")
del hosts_, hosts_big, persistent

# the python Simulator with the rebuild scheduler, on the card and the CPU:
# test_soa_incremental.py's workload, 16 hosts, 24 simulated hours
gm_, gc_, gs_, gsch_ = rebuild_sim(DEV)
absorb(gsch_, 16)
cref = cpu_ref("rebuild")
same_view(rebuild_view(gm_, gc_), cref, "rebuild Simulator: the card against the CPU")
check(gm_.preemptions > 0, "rebuild Simulator: no preemptions")

for name in records:
    records[name]["launches"] += rebuild_counts[name]
    check(rebuild_counts[name] > 0, f"rebuild: kernel {name} was never launched")
check(rebuild_counts["sched_weigh_gathered"] > 0, "rebuild: no gathered weigh")
emit("rebuild", card=smi, method="wall clock per call, p50 of 8 calls (16 where a call "
     "is under 50 ms); python schedulers on the host, TorchPreemptibleScheduler on the card "
     "(build: python hosts to state tensors; decision: screen, weigh, one host sync)",
     fig2=fig2, screen_without_free_slot_exact=free_slot_checked,
     big=dict(hosts=N_HOSTS, calls=len(big_calls),
              call_p50_ms=float(np.median(big_calls)) * 1e3,
              build_p50_ms=float(np.median(big_builds)) * 1e3,
              decision_p50_ms=float(np.median(big_decides)) * 1e3,
              fallbacks=big_fallbacks, host=got.host, victims=list(got.plan.ids),
              equals_soafleet_first_decision=True),
     simulator=dict(hosts=16, hours=24, decisions=gsch_.calls,
                    placed=gm_.placed_normal + gm_.placed_preemptible,
                    preemptions=gm_.preemptions, failures_normal=gm_.failures_normal,
                    failures_preemptible=gm_.failures_preemptible, identical=True,
                    gpu_seconds=gs_, cpu_seconds=cref["seconds"]),
     launches=rebuild_counts, launches_implied=implied,
     seconds=time.perf_counter() - t_rebuild)
del gm_, gc_, gsch_, cref

# ---------------------------------------------------------------------------
# 5c. admission: the streaming admission plane
# ---------------------------------------------------------------------------
t_adm = time.perf_counter()
ADM_KERNELS = ("sched_screen_consts", "sched_screen_topm", "sched_screen", "sched_weigh",
               "sched_weigh_gathered")
adm_counts = {key: 0 for key in ADM_KERNELS}
adm_implied = {key: 0 for key in ADM_KERNELS}


def adm_absorb(fleet_, d0_, f0_, what, extra=0, phase="admission", into=None):
    """Add the launches since the last reset to the phase's (``into``: its
    counts and implied counts, this phase's by default), each against what
    ``fleet_``'s decisions since (d0_, f0_), and ``extra`` decisions the
    fleet does not count, imply: per decision (> 256 hosts) one of each
    screen kernel and a gathered weigh, plus a full weigh per fallback."""
    counts_into, implied_into = into or (adm_counts, adm_implied)
    counts_ = kernels.launch_counts()
    kernels.reset_launch_counts()
    dec_, fb_ = fleet_.decisions - d0_ + extra, fleet_.fallbacks - f0_
    want_ = dict(sched_screen_consts=dec_, sched_screen_topm=dec_, sched_screen=2 * dec_,
                 sched_weigh=dec_ + fb_, sched_weigh_gathered=dec_)
    for key, v_ in want_.items():
        check(counts_[key] == v_, f"{phase}: {what}: {key} launched {counts_[key]} times, "
                                  f"the path implies {v_}")
        counts_into[key] += counts_[key]
        implied_into[key] += v_


def clone_state(st_):
    return dataclasses.replace(st_, **{f: getattr(st_, f).clone() for f in STATE_DTYPES})


# the drain order's int64 key sort, card against CPU, on heavily tied keys:
# mostly invalid rows, one or two classes, repeated tickets, aging
rng = np.random.default_rng(11)
tied_cases = 0
for cap_ in (1, 7, 256, 4096):
    for nc_, aging_ in ((1, 0.0), (2, 0.0), (2, 0.05), (255, 1.0)):
        arrays_ = queue_state_to_numpy(queue_init(cap_, 3, device="cpu"))
        arrays_["valid"] = rng.random(cap_) < 0.3
        arrays_["klass"] = rng.integers(0, min(nc_, 2), cap_).astype(np.int32)
        arrays_["seq"] = rng.integers(0, 3, cap_).astype(np.int32)
        arrays_["enq_t"] = rng.integers(0, 100, cap_).astype(np.float32)
        b_ = max(1, cap_ // 2)
        got_ = queue_select(queue_state_from_numpy(arrays_, device=DEV), b_, now=100.0,
                            aging_rate=aging_, n_classes=nc_)
        want_ = queue_select(queue_state_from_numpy(arrays_, device="cpu"), b_, now=100.0,
                             aging_rate=aging_, n_classes=nc_)
        for g_, w_, what in zip(got_, want_, ("idx", "take")):
            check(torch.equal(g_.cpu(), w_), f"admission: tied select {what} differs on the "
                                             f"card ({cap_} rows, {nc_} classes, aging {aging_})")
        tied_cases += 1


# parity: phase 4's simulator, streaming, on the card and on the CPU
gsim, gm, g_s = stream_sim(DEV, before_run=kernels.reset_launch_counts)
adm_absorb(gsim.fleet, 0, 0, "parity at 4,096 hosts")
cref = cpu_ref("admission")
same_view(sim_view(gsim, gm, streaming=True), cref, "admission parity: the card against the CPU")
gfront = gsim.fleet.admission
check(gfront.stats.retries > 0 and gfront.stats.admitted >= 500,
      "admission parity: the run should admit and retry")
parity_out = dict(hosts=4096, decisions=gsim.fleet.decisions, fallbacks=gsim.fleet.fallbacks,
                  **{key: getattr(gm, key) for key in counters},
                  **{key: v_ for key, v_ in adm_stats(gfront).items() if key != "wait_s"},
                  gpu_seconds=g_s, cpu_seconds=cref["seconds"], identical=True)
del gsim, gm, gfront, cref

# full size, contended: phase 5's 65,536 saturated hosts, 512 arrivals
# (half normal, drawn as phase 5 draws them) in blocking drains every 64,
# then drain_all; every drain replayed afterwards through schedule_many.
# The uncontended streams below take 512 arrivals too: each arrival is a
# host-bound decision, and the whole script must end well inside its limit
ADM_ARRIVALS = 512
t_ = time.perf_counter()
afleet = SoAFleet(fleets.saturated_fleet(N_HOSTS, seed=0), device=DEV,
                  policy=SchedulerPolicy(n_classes=2, **ADMISSION))
afleet_build_s = time.perf_counter() - t_
state0 = clone_state(afleet.state)
rng = np.random.default_rng(7)
clock_ = fleets.NOW
meta = {}                 # request id -> (class, submission index)
unresolved = {}           # request id -> class, submitted and not yet placed or rejected
drains, drain_s, snapshots = [], [], []
out_of_order, class_1_first = [], []   # the drains that break the order


def absorb_drain(dr):
    """Check one drain's order and fold it into the bookkeeping."""
    keys_ = [meta[r.id] for r, _ in dr.attempts]
    if keys_ != sorted(keys_):
        out_of_order.append(len(drains))
    attempted = {r.id for r, _ in dr.attempts}
    overflow = {r.id for r in dr.rejected} - attempted
    if any(meta[r.id][0] == 1 for r, _ in dr.attempts) and any(
            c == 0 and rid not in attempted and rid not in overflow
            for rid, c in unresolved.items()):
        class_1_first.append(len(drains))
    for rid in {o.request.id for o in dr.outcomes} | {r.id for r in dr.rejected}:
        unresolved.pop(rid)
    drains.append(dr)
    snapshots.append(clone_state(afleet.state))


kernels.reset_launch_counts()
d0, f0 = afleet.decisions, afleet.fallbacks
for i in range(ADM_ARRIVALS):
    clock_ += float(rng.integers(1, 20))
    req_ = Request(id=f"a{i}", resources=sizes[int(rng.integers(0, 3))], preemptible=bool(i % 2))
    meta[req_.id] = (i % 2, i)
    unresolved[req_.id] = i % 2
    afleet.submit(req_, clock_)
    if (i + 1) % 64 == 0:
        t_ = time.perf_counter()
        dr_ = afleet.drain(clock_)
        drain_s.append(time.perf_counter() - t_)
        absorb_drain(dr_)
t_ = time.perf_counter()
tail = afleet.drain_all(clock_)
tail_s = time.perf_counter() - t_
for dr_ in tail:
    absorb_drain(dr_)
adm_absorb(afleet, d0, f0, "contended at 65,536 hosts")
front = afleet.admission
s_ = front.stats
check(s_.arrivals == ADM_ARRIVALS and s_.arrivals == s_.admitted + s_.rejected + s_.queue_depth
      + front.pending, "admission: conservation broken at 65,536 hosts")
check(not out_of_order, f"admission: drains {out_of_order} left (class, seq) order")
check(not class_1_first,
      f"admission: drains {class_1_first} attempted class 1 while a class-0 entry waited")
check(s_.admitted > 0 and s_.retries > 0, "admission: the contended run should admit and retry")
attempts_n = sum(len(dr_.attempts) for dr_ in drains)
check(afleet.decisions - d0 == attempts_n, "admission: decisions differ from attempts")
summary_ = front.stats.summary()
contended = dict(
    hosts=N_HOSTS, k=afleet.k_slots, m=M, arrivals=ADM_ARRIVALS, drains=len(drains),
    blocking_drains=len(drain_s), tail_drains=len(tail), attempts=attempts_n,
    decisions_per_s=attempts_n / (sum(drain_s) + tail_s),
    admitted_per_s=s_.admitted / (sum(drain_s) + tail_s),
    drain_p50_ms=float(np.percentile(drain_s, 50)) * 1e3,
    drain_p99_ms=float(np.percentile(drain_s, 99)) * 1e3,
    wait_p50_s=summary_["wait_p50_s"], wait_p99_s=summary_["wait_p99_s"],
    wall_p50_ms=summary_["wall_p50_us"] / 1e3, wall_p99_ms=summary_["wall_p99_us"] / 1e3,
    admitted=s_.admitted, rejected_retry=s_.rejected_retry,
    rejected_overflow=s_.rejected_overflow, retries=s_.retries, degraded=s_.degraded,
    fallbacks=afleet.fallbacks - f0, queue_depth=s_.queue_depth,
    preemptions=sum(len(o.victims) for dr_ in drains for o in dr_.outcomes),
    fleet_build_s=afleet_build_s)

# the oracle replay: each drain's attempts in service order, at the drain's
# now and as demoted, through schedule_many from the state before the stream
t_ = time.perf_counter()
replay, fell = state0, 0
for j_, (dr_, snap) in enumerate(zip(drains, snapshots)):
    if not dr_.attempts:
        continue
    cols_ = [afleet._req_arrays(r) for r, _ in dr_.attempts]
    n_ = len(cols_)
    replay, (rh, rslot, rok, rkill, rfb, _) = schedule_many(
        replay, np.stack([c[0] for c in cols_]), [c[1] for c in cols_],
        [c[2] for c in cols_], np.full((n_,), dr_.now), np.ones((n_,)),
        policy=afleet.policy, req_cost_kind=[c[3] for c in cols_],
        req_period=[c[4] for c in cols_])
    fell += int(rfb.sum())
    check(rok.tolist() == [p for _, p in dr_.attempts],
          f"admission replay: drain {j_}: placements differ")
    placed_hosts = [afleet.names[int(h)] for h, ok in zip(rh, rok) if ok]
    check(placed_hosts == [o.host for o in dr_.outcomes], f"admission replay: drain {j_}: hosts differ")
    for f in STATE_DTYPES:
        check(torch.equal(getattr(replay, f), getattr(snap, f)),
              f"admission replay: drain {j_}: state {f} differs")
check(fell == contended["fallbacks"], "admission replay: fallbacks differ")
kernels.reset_launch_counts()        # the replay's launches are a check's, not the path's
contended.update(replayed_drains=len(drains), replay_seconds=time.perf_counter() - t_)
del afleet, state0, replay, snapshots, drains, front

# full size, uncontended: 65,536 empty hosts, every request admitted on its
# first attempt (bench_screen.py::_bench_sustained's stream)
uncontended = {}
for b_ in (16, 64):
    ufleet = SoAFleet(fleets.empty_fleet(N_HOSTS), device=DEV,
                      policy=SchedulerPolicy(queue_capacity=4 * b_, admit_batch=b_,
                                             max_retries=4))
    rng = np.random.default_rng(7)
    now_ = fleets.NOW
    kernels.reset_launch_counts()
    t_ = time.perf_counter()
    for i0 in range(0, ADM_ARRIVALS, b_):
        for j_ in range(i0, i0 + b_):
            now_ += 1.0
            ufleet.submit(Request(id=f"s{j_}", resources=medium,
                                  preemptible=bool(rng.random() < 0.5)), now_)
        ufleet.drain(now_, block=False)
    ufleet.drain_all(now_ + 1.0)
    ufleet.admission.sync()
    elapsed_ = time.perf_counter() - t_
    adm_absorb(ufleet, 0, 0, f"uncontended, batch {b_}")
    us_ = ufleet.admission.stats
    check(us_.admitted == ADM_ARRIVALS and us_.retries == 0 and us_.rejected == 0,
          f"admission: uncontended batch {b_}: {us_.admitted} of {ADM_ARRIVALS} admitted")
    wall_ = np.asarray(us_.wall_wait_s)
    uncontended[f"batch_{b_}"] = dict(
        decisions=ufleet.decisions, decisions_per_s=us_.admitted / elapsed_,
        wall_p50_ms=float(np.percentile(wall_, 50)) * 1e3,
        wall_p99_ms=float(np.percentile(wall_, 99)) * 1e3,
        fallbacks=ufleet.fallbacks, drains=us_.drains, seconds=elapsed_)
    del ufleet

for name in records:
    records[name]["launches"] += adm_counts[name]
    check(adm_counts[name] > 0, f"admission: kernel {name} was never launched")
emit("admission", card=smi, policy=ADMISSION, tied_select_cases_equal=tied_cases,
     parity=parity_out, contended=contended, uncontended=uncontended,
     method="wall clock (perf_counter) around each blocking drain; decisions/s over the "
            "drains' total; waits are sim-time (drain - arrival), f32",
     launches=adm_counts, launches_implied=adm_implied,
     seconds=time.perf_counter() - t_adm)

# ---------------------------------------------------------------------------
# 5d. relocation: hot-zone evacuation, zone storms, churn regimes
# ---------------------------------------------------------------------------
t_reloc = time.perf_counter()
reloc_counts = {key: 0 for key in ADM_KERNELS}
reloc_implied = {key: 0 for key in ADM_KERNELS}
reloc_calls = []     # every relocate_many call of the phase: inputs, outputs, seconds
rank_s = []          # every victim ranking's seconds
real_rank, real_many = soa_mod._relocation_victims, soa_mod.relocate_many


def timed_rank(*args, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = real_rank(*args, **kw)            # returns host arrays: synchronised
    rank_s.append(time.perf_counter() - t)
    return out


def timed_many(state_, *args, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    state_, out = real_many(state_, *args, **kw)     # returns CPU tensors
    reloc_calls.append(dict(args=[np.array(a_) for a_ in args], out=out,
                            seconds=time.perf_counter() - t))
    return state_, out


soa_mod._relocation_victims, soa_mod.relocate_many = timed_rank, timed_many


def reloc_absorb(fleet_, d0_, f0_, c0_, what):
    """``adm_absorb`` into this phase's counts; the padding rows of the
    relocate_many calls since ``c0_`` are decisions too (each fits
    nowhere), which the fleet does not count."""
    pad_ = sum(len(c_["args"][2]) - int(c_["args"][2].sum()) for c_ in reloc_calls[c0_:])
    adm_absorb(fleet_, d0_, f0_, what, extra=pad_, phase="relocation",
               into=(reloc_counts, reloc_implied))


# the victim ranking on the card against the CPU from the same state, 65,536
# hosts x 8 slots in 4 zones: every slot started a whole number of minutes
# ago and checkpointed since, a tenth dead, a quarter on a 1,800 s period;
# then heavily tied: every slot started and checkpointed at one instant, one
# size, the default period
rng = np.random.default_rng(13)
packed_, _ = fleets.packed_arrays(N_HOSTS, 8, seed=3)
packed_.update(host_zone=(np.arange(N_HOSTS) // (N_HOSTS // 4)).astype(np.int32),
               zone_term=np.zeros(4, np.float32), zone_up=np.zeros(4, np.float32),
               inst_valid=rng.random((N_HOSTS, 8)) < 0.9,
               inst_ckpt=(packed_["inst_start"] + rng.integers(0, 60, (N_HOSTS, 8)) * 60.0
                          ).astype(np.float32),
               inst_period=np.where(rng.random((N_HOSTS, 8)) < 0.25, 1800.0, -1.0
                                    ).astype(np.float32))
tied_ = dict(packed_, inst_start=np.full((N_HOSTS, 8), fleets.NOW - 3600.0, np.float32),
             inst_ckpt=np.full((N_HOSTS, 8), fleets.NOW - 3600.0, np.float32),
             inst_res=np.broadcast_to(np.asarray(medium.vec, np.float32), (N_HOSTS, 8, 3)).copy(),
             inst_period=np.full((N_HOSTS, 8), -1.0, np.float32),
             inst_valid=rng.random((N_HOSTS, 8)) < 0.8)
ranking = {}
for case_, arr_ in (("packed", packed_), ("tied", tied_)):
    gst_, cst_ = (fleet_state_from_numpy(arr_, device=dv_) for dv_ in (DEV, "cpu"))
    for zone_ in (0, 3):
        now_ = fleets.NOW + 1800.0
        gl_ = soa_mod.relocation_loss(gst_, zone_, now_, 3600.0).cpu()
        cl_ = soa_mod.relocation_loss(cst_, zone_, now_, 3600.0)
        check(torch.equal(gl_.view(torch.int32), cl_.view(torch.int32)),
              f"relocation: {case_} zone {zone_}: the loss differs on the card")
        for budget_ in (64, N_HOSTS * 8):
            got_ = real_rank(gst_, zone_, now_, 3600.0, budget_)
            want_ = real_rank(cst_, zone_, now_, 3600.0, budget_)
            for g_, w_, what in zip(got_, want_, ("host", "slot", "valid")):
                check(np.array_equal(g_, w_), f"relocation: {case_} zone {zone_} budget "
                                              f"{budget_}: ranked {what} differs on the card")
    ranking[case_] = dict(
        losses=N_HOSTS * 8, zones_checked=[0, 3], budgets_checked=[64, N_HOSTS * 8],
        equal=True, card_ms_budget_64=median_ms(lambda: real_rank(gst_, 3, now_, 3600.0, 64)),
        cpu_ms_budget_64=p50_ms(lambda: real_rank(cst_, 3, now_, 3600.0, 64))[0])
del gst_, cst_, packed_, tied_


# parity: tests/test_relocation.py::_storm_sim's regime on 4,096 Table 1 nodes
# in 3 zones, each host holding 3 medium instances started before the run's
# clock, direct and streaming, on the card and on the CPU
reloc_parity = {}
for streaming_ in (False, True):
    mode_ = "streaming" if streaming_ else "direct"
    c0_ = len(reloc_calls)
    gs_, gm_, gsec_ = reloc_sim(DEV, streaming_, before_run=kernels.reset_launch_counts)
    reloc_absorb(gs_.fleet, 0, 0, c0_, f"parity at 4,096 hosts, streaming={streaming_}")
    cref = cpu_ref(f"reloc_{mode_}")
    same_view(reloc_view(gs_, gm_, streaming_), cref,
              f"relocation parity ({mode_}): the card against the CPU")
    rs_ = gs_.fleet.relocation
    check(gm_.relocations > 0 and gm_.storm_kills > 0 and rs_.pending == 0
          and rs_.attempted == rs_.relocated + rs_.failed + rs_.lost_victims + rs_.stale,
          f"relocation parity ({mode_}): the plane should move instances and balance its ledger")
    for new_ in gs_.fleet.relocated_ids.values():
        loc_ = gs_.fleet.locator.get(new_)
        check(loc_ is None or gs_.fleet.zones[loc_[0]] != "z2",
              f"relocation parity ({mode_}): a replacement landed in z2")
    gs_.fleet.sync_hosts()                       # Host.place re-checks capacity
    reloc_parity[mode_] = dict(
        hosts=4096, arrivals_per_s=RELOC_RATE, decisions=gs_.fleet.decisions,
        fallbacks=gs_.fleet.fallbacks, **{key: getattr(gm_, key) for key in counters},
        storms=gm_.storms, storm_kills=gm_.storm_kills, relocation=dataclasses.asdict(rs_),
        gpu_seconds=gsec_, cpu_seconds=cref["seconds"], identical=True)
    del gs_, gm_, cref

# full size: 65,536 Table 1 nodes in 4 zones of 16,384; z0-z2 hold 2 medium
# instances a host, z3 is saturated at 4 (half preemptible, drawn as phase 5
# draws them but started 1-29 minutes ago, see fleets.zoned_fleet); one storm
# of kill_frac 0.25 on z3 half an hour after the fleets' clock teaches its
# rate, then 8 relocation passes 60 s apart, once direct and once through
# the admission plane.  The first 6 passes are timed; the last 2 are traced
# in one session (CUDA activity only) for the device's busy share, their
# direct mode's snapshot copies (about 17 MB each) counted as busy.  A
# session's exit parses its events on the host (a session around each pass
# added about 5 s a pass on the H100's machine), so the trace stays short
T_STORM = fleets.NOW + 1800.0
PASSES, TRACED = 8, 2
full = {}
for mode_ in ("direct", "admission"):
    t_ = time.perf_counter()
    pol_ = SchedulerPolicy(**RELOC, relocate_budget=64, **(
        dict(queue_capacity=256, admit_batch=64, max_retries=4) if mode_ == "admission" else {}))
    rfleet = SoAFleet(fleets.zoned_fleet(N_HOSTS, (2, 2, 2, 4), seed=0),
                      device=DEV, policy=pol_)
    build_s_ = time.perf_counter() - t_
    n0_ = len(rfleet.instances)
    stormer = SoASimulator(rfleet, WorkloadSpec(flavors=list(fleets.SIZES.items())), seed=17)
    stormer.now = T_STORM
    t_ = time.perf_counter()
    kills_ = stormer._zone_storm("z3", 0.25)
    storm_s_ = time.perf_counter() - t_
    rate_z3 = rfleet.zone_rates()["z3"]
    check(rate_z3 > pol_.relocate_threshold,
          f"relocation: the storm taught z3 a rate of {rate_z3}, under the threshold")
    kernels.reset_launch_counts()
    d0, f0, c0, r0 = rfleet.decisions, rfleet.fallbacks, len(reloc_calls), len(rank_s)
    snaps = [clone_state(rfleet.state)] if mode_ == "direct" else []

    def one_pass(p_):
        """One relocation pass (and, through the admission plane, its
        drain_all): (seconds, (relocate seconds, drain seconds), moved)."""
        now_ = T_STORM + 60.0 * (p_ + 1)
        moved0_ = rfleet.relocation.relocated
        torch.cuda.synchronize()
        t_ = time.perf_counter()
        rfleet.relocate(now_)
        torch.cuda.synchronize()
        t1_ = time.perf_counter()
        if mode_ == "admission":
            rfleet.drain_all(now_)
            torch.cuda.synchronize()
        t2_ = time.perf_counter()
        if mode_ == "direct":
            snaps.append(clone_state(rfleet.state))
        return t2_ - t_, (t1_ - t_, t2_ - t1_), rfleet.relocation.relocated - moved0_

    timed_passes = [one_pass(p_) for p_ in range(PASSES - TRACED)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced_passes = [one_pass(p_) for p_ in range(PASSES - TRACED, PASSES)]
    busy_total = busy_us(prof)
    pass_s = [s_ for s_, _, _ in timed_passes]
    part_s = [b_ for _, b_, _ in timed_passes]
    reloc_absorb(rfleet, d0, f0, c0, f"{mode_} at 65,536 hosts")
    calls_ = reloc_calls[c0:]
    st_ = rfleet.relocation
    check(len(rank_s) - r0 == PASSES, f"relocation: {mode_}: {len(rank_s) - r0} rankings in "
                                      f"{PASSES} passes (only z3 should arm)")
    check(len(calls_) == (PASSES if mode_ == "direct" else 0),
          f"relocation: {mode_}: {len(calls_)} relocate_many calls in {PASSES} passes")
    check(st_.attempted == PASSES * 64 and st_.relocated >= 0.9 * st_.attempted,
          f"relocation: {mode_}: {st_.relocated} of {st_.attempted} attempts landed")
    check(st_.pending == 0 and st_.attempted == st_.relocated + st_.failed + st_.lost_victims
          + st_.stale, f"relocation: {mode_}: the ledger does not balance")
    check(len(rfleet.instances) + kills_ == n0_,
          f"relocation: {mode_}: {n0_} instances before, {len(rfleet.instances)} after, "
          f"{kills_} storm kills")
    for new_ in rfleet.relocated_ids.values():
        check(rfleet.zones[rfleet.locator[new_][0]] != "z3",
              f"relocation: {mode_}: replacement {new_} landed in z3")
    n_timed = PASSES - TRACED
    ranks_ms = [s_ * 1e3 for s_ in rank_s[r0:r0 + n_timed]]
    batch_ms = ([c_["seconds"] * 1e3 for c_ in calls_[:n_timed]] if mode_ == "direct"
                else [b_ * 1e3 for _, b_ in part_s])
    full[mode_] = dict(
        hosts=N_HOSTS, k=rfleet.k_slots, m=M, zones=4, fill_per_host=[2, 2, 2, 4],
        fleet_build_s=build_s_, instances_before=n0_, storm_kills=kills_, storm_seconds=storm_s_,
        z3_rate_after_storm=rate_z3, passes=PASSES, attempted=st_.attempted,
        moved=st_.relocated, failed=st_.failed, lost=st_.lost_victims, stale=st_.stale,
        pending=st_.pending, fallbacks=rfleet.fallbacks - f0,
        timed_passes=n_timed,
        relocations_per_s=sum(m_ for _, _, m_ in timed_passes) / sum(pass_s),
        pass_p50_ms=float(np.percentile(pass_s, 50)) * 1e3,
        pass_p99_ms=float(np.percentile(pass_s, 99)) * 1e3,
        ranking_p50_ms=float(np.percentile(ranks_ms, 50)),
        ranking_p99_ms=float(np.percentile(ranks_ms, 99)),
        **{("relocate_many" if mode_ == "direct" else "drain_all") + "_p50_ms":
           float(np.percentile(batch_ms, 50)),
           ("relocate_many" if mode_ == "direct" else "drain_all") + "_p99_ms":
           float(np.percentile(batch_ms, 99))},
        traced_passes=TRACED, traced_pass_ms=[s_ * 1e3 for s_, _, _ in traced_passes],
        device_busy_ms=busy_total / 1e3,
        device_busy_share=((busy_total / 1e6) / sum(s_ for s_, _, _ in traced_passes)
                           if busy_total else "not measured"))
    if mode_ == "direct":
        # every pass replayed from a clone of the state before it, victim by
        # victim: checkpoint, schedule_step with z3 excluded, then the
        # voluntary termination where the replacement landed
        t_ = time.perf_counter()
        for p_, c_ in enumerate(calls_):
            vh_, vs_, von_, res_, dom_, kind_, per_, price_, excl_, now_ = c_["args"]
            rep = clone_state(snaps[p_])
            res_t = torch.from_numpy(res_).to(DEV)
            outs_ = []
            for i in range(len(von_)):
                if von_[i]:
                    apply_checkpoint(rep, int(vh_[i]), int(vs_[i]), float(now_))
                rep, (h_, s_, ok_, _, fb_, mg_) = schedule_step(
                    rep, res_t[i], True, int(dom_[i]), float(now_), float(price_[i]),
                    policy=pol_, req_cost_kind=int(kind_[i]), req_period=float(per_[i]),
                    req_exclude_zone=int(excl_[i]))
                if von_[i] and bool(ok_):
                    apply_termination(rep, int(vh_[i]), np.arange(rfleet.k_slots) == vs_[i],
                                      now=float(now_), involuntary=False)
                outs_.append((h_, s_, ok_, fb_, mg_))
            for j_, what in enumerate(("host", "slot", "ok", "fell_back", "margin")):
                check(torch.equal(torch.stack([o_[j_] for o_ in outs_]).reshape(-1),
                                  c_["out"][j_].reshape(-1).to(outs_[0][j_].dtype)),
                      f"relocation replay: pass {p_}: {what} differs")
            for f in STATE_DTYPES:
                check(torch.equal(getattr(rep, f), getattr(snaps[p_ + 1], f)),
                      f"relocation replay: pass {p_}: state {f} differs")
        kernels.reset_launch_counts()      # the replay's launches are a check's
        full[mode_].update(replayed_passes=len(calls_), replay_seconds=time.perf_counter() - t_)
        del snaps, rep
    del rfleet, stormer

soa_mod._relocation_victims, soa_mod.relocate_many = real_rank, real_many
for name in records:
    records[name]["launches"] += reloc_counts[name]
    check(reloc_counts[name] > 0, f"relocation: kernel {name} was never launched")
emit("relocation", card=smi, policy=RELOC, ranking=ranking, parity=reloc_parity, full=full,
     method=f"wall clock (perf_counter, the card synchronised) around each pass, ranking and "
            f"relocate_many or drain_all, over the first {PASSES - TRACED} passes; busy share "
            f"over the last {TRACED}, traced in one session with CUDA activity only",
     launches=reloc_counts, launches_implied=reloc_implied,
     seconds=time.perf_counter() - t_reloc)
del reloc_calls

# ---------------------------------------------------------------------------
# 5e. scan: the trace-driven simulator
# ---------------------------------------------------------------------------
t_scan = time.perf_counter()
# the workload and policies: chip_smoke_cpu.SCAN_SPEC and SCAN_POLICY
scan_counts = {key: 0 for key in ADM_KERNELS}
scan_implied = {key: 0 for key in ADM_KERNELS}


def scan_absorb(decisions_, fallbacks_, what):
    """``adm_absorb`` into this phase's counts, for ``decisions_`` (all past
    256 hosts) and ``fallbacks_``."""
    adm_absorb(SimpleNamespace(decisions=decisions_, fallbacks=fallbacks_), 0, 0, what,
               phase="scan", into=(scan_counts, scan_implied))


def scan_same(a_, b_, what):
    """Two trajectories (``scan_view``s) equal: counters, outcomes, samples,
    the final state, and streaming the admission counters, waits and queue."""
    same_view(a_, b_, f"scan: {what}")


def replay_same(res_, sim_, what, skip=()):
    """A trajectory against ``run_trace`` on ``sim_``: the outcome rows, the
    counters, the final state (but ``skip``) and, streaming, the admission
    stats, queue and waits."""
    check(np.array_equal(np.stack([res_.host, res_.slot, res_.ok.astype(np.int64), res_.n_kill],
                                  axis=1), sim_.trace_outcomes),
          f"scan: {what}: simulate_scan and run_trace place differently")
    m_ = sim_.metrics
    check({key: getattr(m_, key) for key in res_.counters} == res_.counters,
          f"scan: {what}: run_trace's counters differ")
    ga_, gb_ = fleet_state_to_numpy(res_.state), fleet_state_to_numpy(sim_.fleet.state)
    for f in STATE_DTYPES:
        if f not in skip:
            check(np.array_equal(ga_[f], gb_[f]), f"scan: {what}: run_trace's final state {f} differs")
    front_ = sim_.fleet.admission
    if front_ is not None:
        st_ = front_.stats
        want_ = {key: getattr(st_, key) for key in res_.admission if key != "queue_depth"}
        check(dict(want_, queue_depth=front_.waiting) == res_.admission,
              f"scan: {what}: run_trace's admission stats differ")
        check(np.array_equal(np.sort(res_.wait_s[res_.wait_s >= 0]),
                             np.sort(np.asarray(st_.wait_s, np.float32))),
              f"scan: {what}: run_trace's waits differ")
        qa_, qb_ = queue_state_to_numpy(res_.queue), queue_state_to_numpy(front_.qstate)
        for f in QUEUE_DTYPES:
            check(np.array_equal(qa_[f], qb_[f]), f"scan: {what}: run_trace's final queue {f} differs")


def prefix(trace_, rows_):
    """The first ``rows_`` rows of a trace (a departure or checkpoint names
    an earlier row, so a prefix is a trace)."""
    return scan_sim.EventTrace(**{f.name: getattr(trace_, f.name)[:rows_]
                                  for f in dataclasses.fields(scan_sim.EventTrace)})


def timed_scan(*args, **kw):
    torch.cuda.synchronize()
    t_ = time.perf_counter()
    res_ = scan_sim.simulate_scan(*args, **kw)
    torch.cuda.synchronize()
    return res_, time.perf_counter() - t_


def timed_replay(sim_, trace_):
    d0_, f0_ = sim_.fleet.decisions, sim_.fleet.fallbacks
    torch.cuda.synchronize()
    t_ = time.perf_counter()
    sim_.run_trace(trace_)
    torch.cuda.synchronize()
    return time.perf_counter() - t_, sim_.fleet.decisions - d0_, sim_.fleet.fallbacks - f0_


# parity at 4,096 hosts, direct and streaming: simulate_scan on the card, on
# the CPU, and run_trace on the card
scan_parity = {}
for mode_, pol_ in SCAN_POLICY.items():
    tr_ = scan_trace(mode_)
    gsim_ = SoASimulator(zoned_hosts(4096), SCAN_SPEC, seed=7, policy=pol_, device=DEV)
    kernels.reset_launch_counts()
    card_, card_s_ = timed_scan(tr_, pol_, gsim_.fleet.state)
    scan_absorb(card_.decisions, card_.fallbacks, f"parity {mode_}: simulate_scan")
    rt_s_, rt_dec_, rt_fb_ = timed_replay(gsim_, tr_)
    scan_absorb(rt_dec_, rt_fb_, f"parity {mode_}: run_trace")
    cpu_ = cpu_ref(f"scan_{mode_}")
    cpu_s_ = cpu_["seconds"]
    scan_same(scan_view(card_), cpu_, f"parity {mode_}: card vs CPU")
    replay_same(card_, gsim_, f"parity {mode_}")
    check(card_.decisions >= 400 and card_.counters["storm_kills"] > 0,
          f"scan: parity {mode_}: {card_.decisions} decisions, "
          f"{card_.counters['storm_kills']} storm kills")
    scan_parity[mode_] = dict(hosts=4096, events=tr_.n_events, decisions=card_.decisions,
                              fallbacks=card_.fallbacks, counters=card_.counters,
                              admission=card_.admission, card_s=card_s_, cpu_s=cpu_s_,
                              run_trace_card_s=rt_s_, identical=True)
    del gsim_, card_, cpu_

# full size, 65,536 empty hosts, the same traces: both engines on the card,
# each decision timed (perf_counter around _step_core, which reads its
# result back), then a 200-row prefix traced for the busy share
real_step = scan_sim._step_core
step_s = []


def timed_step(*args, **kw):
    t_ = time.perf_counter()
    out_ = real_step(*args, **kw)
    step_s.append(time.perf_counter() - t_)
    return out_


scan_full = {}
for mode_, pol_ in SCAN_POLICY.items():
    tr_ = scan_trace(mode_)
    t_ = time.perf_counter()
    sim_ = SoASimulator(zoned_hosts(N_HOSTS), SCAN_SPEC, seed=7, policy=pol_, device=DEV)
    build_s_ = time.perf_counter() - t_
    pre_ = prefix(tr_, 200)
    scan_sim.simulate_scan(prefix(tr_, 40), pol_, sim_.fleet.state)   # warm-up
    kernels.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced_, window_s_ = timed_scan(pre_, pol_, sim_.fleet.state)
    busy_ = busy_us(prof)
    scan_absorb(traced_.decisions, traced_.fallbacks, f"{mode_} at 65,536 hosts: traced prefix")
    scan_sim._step_core, step_s[:] = timed_step, []
    try:
        res_, scan_wall_ = timed_scan(tr_, pol_, sim_.fleet.state)
    finally:
        scan_sim._step_core = real_step
    scan_absorb(res_.decisions, res_.fallbacks, f"{mode_} at 65,536 hosts: simulate_scan")
    rt_s_, rt_dec_, rt_fb_ = timed_replay(sim_, tr_)
    scan_absorb(rt_dec_, rt_fb_, f"{mode_} at 65,536 hosts: run_trace")
    check(rt_dec_ == res_.decisions, f"scan: {mode_} at 65,536 hosts: {rt_dec_} run_trace "
                                     f"decisions, {res_.decisions} in the scan")
    replay_same(res_, sim_, f"{mode_} at 65,536 hosts")
    scan_full[mode_] = dict(
        hosts=N_HOSTS, events=tr_.n_events, decisions=res_.decisions, fallbacks=res_.fallbacks,
        counters=res_.counters, admission=res_.admission, fleet_build_s=build_s_,
        simulate_scan_s=scan_wall_, events_per_s=tr_.n_events / scan_wall_,
        decisions_per_s=res_.decisions / scan_wall_,
        decision_p50_ms=float(np.percentile(step_s, 50)) * 1e3,
        decision_p99_ms=float(np.percentile(step_s, 99)) * 1e3,
        run_trace_s=rt_s_, run_trace_events_per_s=tr_.n_events / rt_s_,
        traced_rows=pre_.n_events, traced_decisions=traced_.decisions,
        traced_window_ms=window_s_ * 1e3, device_busy_ms=busy_ / 1e3,
        device_busy_share=(busy_ / 1e6) / window_s_ if busy_ else "not measured",
        identical=True)
    del sim_, res_, traced_

# contended: phase 5's saturated fleet (the same draws) in 3 zones, direct,
# the trace cut to 1,600 s (its storm at 800 s, the failure at 640 s) and
# put on the fleet's clock, live normal resources from its normal instances;
# both engines on the card.  The storm's uptime sum passes 2^24 here, so
# zone_up is compared by its gap, every other column bit for bit
scan_contended = {}
for mode_, pol_ in (("direct", SCAN_POLICY["direct"]),):
    tr_ = on_clock(scan_trace(mode_, SCAN_S / 2))
    hosts_ = saturated_zoned(N_HOSTS, 0)
    t_ = time.perf_counter()
    sim_ = SoASimulator(hosts_, SCAN_SPEC, seed=7, policy=pol_, device=DEV)
    build_s_ = time.perf_counter() - t_
    nres_ = np.zeros((N_HOSTS, 3), np.float32)
    for iid_, (h_, slot_) in sim_.fleet.locator.items():
        if slot_ is None:
            nres_[h_] += sim_.fleet.instances[iid_].resources.vec32
    kernels.reset_launch_counts()
    res_, scan_wall_ = timed_scan(tr_, pol_, sim_.fleet.state, normal_res=nres_)
    scan_absorb(res_.decisions, res_.fallbacks, f"contended {mode_}: simulate_scan")
    rt_s_, rt_dec_, rt_fb_ = timed_replay(sim_, tr_)
    scan_absorb(rt_dec_, rt_fb_, f"contended {mode_}: run_trace")
    replay_same(res_, sim_, f"contended {mode_}", skip=("zone_up",))
    up_a_, up_b_ = res_.state.zone_up.cpu().numpy(), sim_.fleet.state.zone_up.cpu().numpy()
    check(res_.counters["storm_kills"] > 10_000 and res_.counters["preemptions"] > 0,
          f"scan: contended {mode_}: {res_.counters}")
    scan_contended[mode_] = dict(
        hosts=N_HOSTS, events=tr_.n_events, decisions=res_.decisions, fallbacks=res_.fallbacks,
        counters=res_.counters, admission=res_.admission, fleet_build_s=build_s_,
        simulate_scan_s=scan_wall_, events_per_s=tr_.n_events / scan_wall_,
        decisions_per_s=res_.decisions / scan_wall_, run_trace_s=rt_s_,
        run_trace_events_per_s=tr_.n_events / rt_s_,
        zone_up_relative_gap=float(np.max(np.abs(up_a_ - up_b_) / np.maximum(up_b_, 1.0))),
        identical_outcomes=True)
    del sim_, res_, hosts_

# ensembles at 1,024 hosts: 8 seeds of 1,200 s on empty hosts (a quarter
# of the lanes against their padded single runs), the multiplier axis on
# saturated hosts, where the rows move placements (each lane on the card
# against the same lane on the CPU), and 8 admission-knob rows drawn as
# _bench_scan_stream's, on empty hosts.  Each lane's decisions run one after
# another, so a lane costs about 1 s on the H100's host: 8 lanes of each axis
# keep the axes and their checks inside the script's time limit
SEED_LANES, KNOB_LANES = 8, 8
ens_state = SoAFleet(zoned_hosts(1024), device=DEV).state
ens_traces = [scan_trace("direct", SCAN_ENS_S, seed=s_, fail=False, ckpt=0, zone=s_ % 3)
              for s_ in range(SEED_LANES)]
kernels.reset_launch_counts()
t_ = time.perf_counter()
lanes_ = scan_sim.simulate_ensemble(ens_traces, SCAN_POLICY["direct"], ens_state)
torch.cuda.synchronize()
seeds_s_ = time.perf_counter() - t_
scan_absorb(sum(l_.decisions for l_ in lanes_), sum(l_.fallbacks for l_ in lanes_),
            f"ensemble of {SEED_LANES} seeds")
emax_ = max(t_.n_events for t_ in ens_traces)
for i_ in range(0, SEED_LANES, 4):
    tr_, lane_ = ens_traces[i_], lanes_[i_]
    single_ = scan_sim.simulate_scan(tr_.padded(emax_), SCAN_POLICY["direct"], ens_state)
    e_ = tr_.n_events
    single_ = dataclasses.replace(single_, host=single_.host[:e_], slot=single_.slot[:e_],
                                  ok=single_.ok[:e_], n_kill=single_.n_kill[:e_])
    scan_same(scan_view(lane_), scan_view(single_), f"seed lane {i_} against its padded single run")
kernels.reset_launch_counts()                    # the singles' launches are a check's
mtrace_ = mult_trace()
msat_ = mult_state(DEV)
t_ = time.perf_counter()
mlanes_ = scan_sim.simulate_ensemble([mtrace_], SCAN_POLICY["direct"], msat_, mults=MULT_ROWS)
torch.cuda.synchronize()
mult_s_ = time.perf_counter() - t_
scan_absorb(sum(l_.decisions for l_ in mlanes_), sum(l_.fallbacks for l_ in mlanes_),
            "multiplier lanes")
clanes_ = cpu_ref("scan_mult")["lanes"]
check(len(clanes_) == len(mlanes_), "scan: multiplier lanes differ in number on the CPU")
for i_, (g_, c_) in enumerate(zip(mlanes_, clanes_)):
    scan_same(scan_view(g_), c_, f"multiplier lane {i_} {MULT_ROWS[i_].tolist()}: card vs CPU")
rng_ = np.random.default_rng(42)
KNOB_ROWS = np.column_stack([
    rng_.uniform(0.0, 0.05, KNOB_LANES), rng_.uniform(30.0, 300.0, KNOB_LANES),
    np.where(rng_.random(KNOB_LANES) < 0.5, np.inf,
             rng_.uniform(0.005, 0.5, KNOB_LANES))]).astype(np.float32)
ktrace_ = scan_trace("streaming", SCAN_ENS_S, seed=3, fail=False, ckpt=0)
t_ = time.perf_counter()
klanes_ = scan_sim.simulate_ensemble([ktrace_], SCAN_POLICY["streaming"], ens_state,
                                     knobs=KNOB_ROWS)
torch.cuda.synchronize()
knob_s_ = time.perf_counter() - t_
scan_absorb(sum(l_.decisions for l_ in klanes_), sum(l_.fallbacks for l_ in klanes_),
            "knob lanes")
for i_, l_ in enumerate(klanes_):
    a_ = l_.admission
    check(a_["arrivals"] == a_["admitted"] + a_["rejected_overflow"] + a_["rejected_retry"]
          + a_["queue_depth"], f"scan: knob lane {i_}: admission does not balance")
scan_ensemble = dict(
    hosts=1024, seeds=dict(lanes=SEED_LANES, rows_padded=emax_, seconds=seeds_s_,
                           trajectories_per_s=SEED_LANES / seeds_s_,
                           decisions=sum(l_.decisions for l_ in lanes_),
                           lanes_equal_to_their_padded_single=list(range(0, SEED_LANES, 4))),
    multipliers=dict(rows=MULT_ROWS.tolist(), fleet="saturated, seed 1, 3 zones",
                     seconds=mult_s_, preemptions=[l_.counters["preemptions"] for l_ in mlanes_],
                     trajectories_per_s=len(MULT_ROWS) / mult_s_,
                     placed=[l_.counters["placed_normal"] + l_.counters["placed_preemptible"]
                             for l_ in mlanes_],
                     distinct_outcomes=len({l_.host.tobytes() for l_ in mlanes_}),
                     card_equals_cpu=True),
    knobs=dict(lanes=KNOB_LANES, seed=42, seconds=knob_s_, trajectories_per_s=KNOB_LANES / knob_s_,
               admitted=[l_.admission["admitted"] for l_ in klanes_],
               degraded=sum(l_.admission["degraded"] for l_ in klanes_)))
del ens_state, msat_, lanes_, mlanes_, clanes_, klanes_
for name in records:
    records[name]["launches"] += scan_counts[name]
    check(scan_counts[name] > 0, f"scan: kernel {name} was never launched")
emit("scan", card=smi, workload="benchmarks/bench_screen.py::_bench_scan (streaming: "
     "_bench_scan_stream's policy)", policies={k_: dataclasses.asdict(p_) for k_, p_ in
                                              SCAN_POLICY.items()},
     parity=scan_parity, full=scan_full, contended=scan_contended, ensemble=scan_ensemble,
     method="wall clock (perf_counter, the card synchronised) around each run; a decision "
            "timed around _step_core (it reads its result back); busy share over a 200-row "
            "prefix traced with CUDA activity only",
     launches=scan_counts, launches_implied=scan_implied,
     seconds=time.perf_counter() - t_scan)

# ---------------------------------------------------------------------------
# 5f. sharded: the fleet split host-major across a mesh of four shards
# ---------------------------------------------------------------------------
t_shard = time.perf_counter()
S_SHARDS = 4
card_mesh = fleet_mesh(devices=[DEV] * S_SHARDS)     # four shards on the one card
SH_KERNELS = ("sched_screen_consts", "sched_screen_topm", "sched_screen", "sched_weigh",
              "sched_weigh_gathered")


def shard_absorb(decisions_, fallbacks_, shards_, what, into):
    """The launches since the last reset against what ``decisions_`` and
    ``fallbacks_`` on ``shards_`` shards imply: a decision launches each
    screen pass once a shard and one gathered weigh, a fallback one full
    weigh a shard (``shards_=None``: the unsharded path, one fused screen
    of two passes)."""
    counts_ = kernels.launch_counts()
    kernels.reset_launch_counts()
    s_ = shards_ or 1
    want_ = dict(sched_screen_consts=s_ * decisions_, sched_screen_topm=s_ * decisions_,
                 sched_screen=0 if shards_ else 2 * decisions_,
                 sched_weigh=decisions_ + s_ * fallbacks_, sched_weigh_gathered=decisions_)
    for key, v_ in want_.items():
        check(counts_[key] == v_, f"sharded: {what}: {key} launched {counts_[key]} times, "
                                  f"the path implies {v_}")
        into[0][key] += counts_[key]
        into[1][key] += v_


# the merge at fleet scale: phase 3's 2^20 packed, nearly tied hosts in 4
# shards; each shard's forwarded (scores, idx) and the merged constants
# against the plain route on the card, the merged constants against the
# fleet-wide fold, the merge against the unsharded kernel screen
packed, preq = fleets.packed_arrays(N_BIG, k, seed=0)
packed["inst_cost"] = (fleets.NOW - packed["inst_start"]).astype(np.float32)
big = tuple(torch.from_numpy(np.ascontiguousarray(packed[f])).to(DEV) for f in (
    "free_f", "free_n", "schedulable", "domain", "slow", "inst_res", "inst_cost",
    "inst_valid"))
big_req = torch.from_numpy(preq).to(DEV)
del packed
t_big = N_BIG // S_SHARDS
big_shards = tsched._split_shards(card_mesh, big + (None, None), big_req)
big_kn = tsched._knobs(policy, N_BIG, False, False, None, None)
screen_args = (big_shards, DEV, False, -1, big_kn, True, None, M + 1)
all_s, all_i, merged = tsched._sharded_screen(*screen_args)
local_p = [kernels.sched_screen_consts_plain(*sh[:8], big_req, False, -1, mult, True)
           for sh in big_shards]
stack_p = torch.stack(local_p)
merged_p = torch.stack([stack_p[:, 0::2].amin(0), stack_p[:, 1::2].amax(0)], dim=1).reshape(-1)
same(merged, merged_p, "sharded 2^20 merged consts", "sched_screen_consts")
fleet_consts = kernels.sched_screen_consts_plain(*big, big_req, False, -1, mult, True)
check(torch.equal(merged.view(torch.int32), fleet_consts.view(torch.int32)),
      "sharded 2^20: merged constants are not the fleet-wide fold")
for s_, sh in enumerate(big_shards):
    sc_p, ix_p = kernels.sched_screen_topm_plain(*sh[:8], big_req, False, -1, merged_p, mult,
                                                 True, M + 1)
    part = slice(s_ * (M + 1), (s_ + 1) * (M + 1))
    same(all_s[part], sc_p, f"sharded 2^20 shard {s_} scores", "sched_screen_topm")
    same(all_i[part], ix_p + s_ * t_big, f"sharded 2^20 shard {s_} idx", "sched_screen_topm")
cand_, u_, ju_ = merge_shortlists(all_s, all_i, M)
top_s_, top_i_, _ = kernels.sched_screen(*big, big_req, False, -1, mult, True, M + 1)
check(torch.equal(cand_, top_i_[:M]) and torch.equal(u_.view(torch.int32),
                                                     top_s_[M].view(torch.int32))
      and int(ju_) == int(top_i_[M]),
      "sharded 2^20: the merge differs from the unsharded kernel screen")
sharded_screen_ms = device_ms(lambda: tsched._sharded_screen(*screen_args), reps=10)
merge_ms = device_ms(lambda: merge_shortlists(all_s, all_i, M), reps=10)
unsharded_screen_ms = device_ms(lambda: kernels.sched_screen(*big, big_req, False, -1, mult,
                                                             True, M + 1), reps=10)
merge_check = dict(hosts=N_BIG, shards=S_SHARDS, m=M, exact=True,
                   distinct_forwarded_scores=len(set(all_s.tolist())),
                   sharded_screen_device_ms=sharded_screen_ms, merge_device_ms=merge_ms,
                   unsharded_screen_device_ms=unsharded_screen_ms)
del big, big_req, big_shards, all_s, all_i, local_p, stack_p, top_s_, top_i_

# the main path sharded: phase 5's 65,536 saturated Table 1 hosts, one fleet
# sharded across the mesh and one not, fed the same 512 decisions in batches
# of 64 (the last two traced for the busy share) and 128 singles, half
# normal; every decision's outputs recorded where SoAFleet calls the path
hosts_5f = fleets.saturated_fleet(N_HOSTS, seed=0)      # both fleets read, neither changes it
t_ = time.perf_counter()
plain_f = SoAFleet(hosts_5f, device=DEV)
plain_build_s = time.perf_counter() - t_
t_ = time.perf_counter()
shard_f = SoAFleet(hosts_5f, device=DEV, policy=SchedulerPolicy(mesh=card_mesh))
shard_build_s = time.perf_counter() - t_
check(shard_f.state.mesh is card_mesh and shard_f.state.n_hosts == N_HOSTS,
      "sharded: the fleet is not 4 shards of 16,384 hosts")
del hosts_5f
rng = np.random.default_rng(57)
clock_5f = [fleets.NOW]


def items_5f(b, tag):
    out_ = []
    for i in range(b):
        clock_5f[0] += float(rng.integers(1, 20))
        out_.append((Request(id=f"{tag}{i}", resources=sizes[int(rng.integers(0, 3))],
                             preemptible=bool(i % 2)), clock_5f[0], 1.0))
    return out_


warm_5f = items_5f(16, "w")
batches_5f = [items_5f(64, f"sb{j}-") for j in range(8)]
singles_5f = items_5f(128, "ss")
OUTS = {}
real_many, real_step = soa_mod.schedule_many, soa_mod.schedule_step


def recorded(real, into):
    def call(*args, **kw):
        st_, out_ = real(*args, **kw)
        into.append(out_)
        return st_, out_
    return call


sh_counts = {key: 0 for key in SH_KERNELS}
sh_implied = {key: 0 for key in SH_KERNELS}
plain_counts = {key: 0 for key in SH_KERNELS}
plain_implied = {key: 0 for key in SH_KERNELS}
runs_5f = {}
for name_, fleet_, shards_, into_ in (("sharded", shard_f, S_SHARDS, (sh_counts, sh_implied)),
                                      ("unsharded", plain_f, None, (plain_counts, plain_implied))):
    outs_ = OUTS[name_] = []
    soa_mod.schedule_many = recorded(real_many, outs_)
    soa_mod.schedule_step = recorded(real_step, outs_)
    try:
        fleet_.schedule_batch(warm_5f)
        outs_.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        d0_, f0_ = fleet_.decisions, fleet_.fallbacks
        batch_s_, single_s_ = [], []
        for items_ in batches_5f[:6]:
            t_ = time.perf_counter()
            fleet_.schedule_batch(items_)
            batch_s_.append(time.perf_counter() - t_)
        for item_ in singles_5f:
            t_ = time.perf_counter()
            fleet_.schedule_request(*item_)
            single_s_.append(time.perf_counter() - t_)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof_:
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            for items_ in batches_5f[6:]:
                fleet_.schedule_batch(items_)
            torch.cuda.synchronize()
            window_s_ = time.perf_counter() - t_
    finally:
        soa_mod.schedule_many, soa_mod.schedule_step = real_many, real_step
    dec_, fb_ = fleet_.decisions - d0_, fleet_.fallbacks - f0_
    check(dec_ == 640, f"sharded: {name_}: {dec_} decisions, not 640")
    shard_absorb(dec_, fb_, shards_, name_, into_)
    busy_ = busy_us(prof_)
    runs_5f[name_] = dict(
        decisions=dec_, fallbacks=fb_, build_seconds=shard_build_s if shards_ else plain_build_s,
        batch_decisions_per_s=6 * 64 / sum(batch_s_),
        single_p50_ms=float(np.percentile(single_s_, 50)) * 1e3,
        single_p99_ms=float(np.percentile(single_s_, 99)) * 1e3,
        peak_device_mib=torch.cuda.max_memory_allocated() / 2**20,
        traced_window_ms=window_s_ * 1e3, traced_decisions=128, device_busy_ms=busy_ / 1e3,
        device_busy_share=(busy_ / 1e6) / window_s_ if busy_ else "not measured")
FIELDS_5F = ("host_idx", "slot", "ok", "kill", "fell_back", "margin")
check(len(OUTS["sharded"]) == len(OUTS["unsharded"]) == 8 + 128, "sharded: calls differ")
for j_, (a_, b_) in enumerate(zip(OUTS["sharded"], OUTS["unsharded"])):
    for f_, x_, y_ in zip(FIELDS_5F, a_, b_):
        x_, y_ = (x_.view(torch.int32), y_.view(torch.int32)) if f_ == "margin" else (x_, y_)
        check(torch.equal(x_, y_), f"sharded: call {j_}: {f_} differs from the unsharded fleet's")
check(shard_f.locator == plain_f.locator and shard_f.slot_ids == plain_f.slot_ids
      and [i.id for i in shard_f.preempted] == [i.id for i in plain_f.preempted],
      "sharded: the fleets' mirrors differ")
sh_arr, pl_arr = fleet_state_to_numpy(shard_f.state), fleet_state_to_numpy(plain_f.state)
for f in STATE_DTYPES:
    check(np.array_equal(sh_arr[f], pl_arr[f]), f"sharded: final state {f} differs")
sharded_preemptions = len(shard_f.preempted)
del plain_f, shard_f, sh_arr, pl_arr, OUTS


# a ragged fleet: the simulator at 4,099 hosts (padded to 4,100), sharded on
# the card, unsharded on the card and sharded on the CPU, the same seed
def ragged_same(a_, b_, what):
    same_view(ragged_view(*a_[:2]), b_ if isinstance(b_, dict) else ragged_view(*b_[:2]),
              f"sharded: ragged {what}")


kernels.reset_launch_counts()
rag_card = ragged_sim(DEV, card_mesh)
check(rag_card[0].fleet.state.n_hosts == 4100, "sharded: 4,099 hosts not padded to 4,100")
shard_absorb(rag_card[0].fleet.decisions, rag_card[0].fleet.fallbacks, S_SHARDS,
             "ragged simulator", (sh_counts, sh_implied))
rag_plain = ragged_sim(DEV, None)
rag_cpu = cpu_ref("ragged")
kernels.reset_launch_counts()
ragged_same(rag_card, rag_plain, "sharded card against unsharded card")
ragged_same(rag_card, rag_cpu, "sharded card against sharded CPU")
ragged = dict(hosts=4099, padded=4100, decisions=rag_card[0].fleet.decisions,
              fallbacks=rag_card[0].fleet.fallbacks, preemptions=rag_card[1].preemptions,
              sharded_card_seconds=rag_card[2], unsharded_card_seconds=rag_plain[2],
              sharded_cpu_seconds=rag_cpu["seconds"], identical=True)
del rag_plain, rag_cpu
cpu_proc.wait()
check(cpu_proc.returncode == 0, f"chip_smoke_cpu.py exited {cpu_proc.returncode}")
emit("cpu_refs", method="chip_smoke_cpu.py's CPU runs in a process of their own from the "
     "script's start; seconds this process waited for each", waited_s=CPU_WAITED)


# the fallback on shards: test_sharded_parity.py::test_sharded_fallback_parity's
# fixture, host A's loose bound winning a 1-candidate shortlist
def fallback_fixture(mesh_):
    arrays_ = dict(free_f=np.zeros((2, 2), np.float32), free_n=np.full((2, 2), 4.0, np.float32),
                   schedulable=np.ones((2,), bool), domain=np.zeros((2,), np.int32),
                   slow=np.ones((2,), np.float32),
                   inst_res=np.array([[[4, 0], [0, 4], [4, 4]], [[4, 4], [0, 0], [0, 0]]],
                                     np.float32),
                   inst_cost=np.array([[10, 10, 50], [15, 0, 0]], np.float32),
                   inst_valid=np.array([[1, 1, 1], [1, 0, 0]], bool))
    n_pad = padded_hosts(2, mesh_.size, m_keep=2)
    arrays_ = {f: np.concatenate([v_, np.zeros((n_pad - 2,) + v_.shape[1:], v_.dtype)])
               for f, v_ in arrays_.items()}
    state_ = host_state_from_numpy(arrays_, mesh=mesh_)
    kernels.reset_launch_counts()
    got_ = tsched._rebuild_decision(state_, np.asarray([4.0, 4.0], np.float32), False, -1,
                                    SchedulerPolicy(shortlist=1, mesh=mesh_), -1)
    check(got_[0] == 1 and got_[2] and got_[3],
          f"sharded: fallback fixture: {got_} (want host 1, ok, fell back)")
    counts_ = kernels.launch_counts()
    check(counts_["sched_weigh"] == 1 + mesh_.size and counts_["sched_screen_topm"] == mesh_.size,
          f"sharded: fallback fixture launches {counts_}")
    return got_


fallback = dict(card=fallback_fixture(card_mesh))
distinct = {}
if torch.cuda.device_count() > 1:
    # the same over the distinct devices: shards on every visible card
    all_mesh = fleet_mesh()
    fallback["distinct_devices"] = fallback_fixture(all_mesh)
    rag_all = ragged_sim(all_mesh.lead, all_mesh)
    ragged_same(rag_all, rag_card, f"{all_mesh.size} devices against 4 shards on one card")
    distinct = dict(devices=[str(d_) for d_ in all_mesh.devices], ragged_identical=True,
                    ragged_seconds=rag_all[2])
    del rag_all
kernels.reset_launch_counts()
del rag_card
for name in records:
    records[name]["launches"] += sh_counts[name]
for name in ("sched_screen_consts", "sched_screen_topm", "sched_weigh"):
    check(sh_counts[name] > 0, f"sharded: kernel {name} was never launched")
emit("sharded", card=smi, device_count=torch.cuda.device_count(), shards=S_SHARDS,
     mesh=[str(d_) for d_ in card_mesh.devices], merge_2_20=merge_check,
     main_path=dict(hosts=N_HOSTS, m=M, preemptions=sharded_preemptions,
                    identical_decisions_and_state=True, **runs_5f),
     ragged=ragged, fallback_fixture=fallback, distinct_devices=distinct or "one device visible",
     method="wall clock per batch of 64 and per single decision (perf_counter; a decision "
            "reads its result back); busy share over the last 2 batches traced with CUDA "
            "activity only; device ms by the trace",
     launches=sh_counts, launches_implied=sh_implied, unsharded_launches=plain_counts,
     unsharded_launches_implied=plain_implied, seconds=time.perf_counter() - t_shard)

# ---------------------------------------------------------------------------
# 6. model kernels against their plain versions
# ---------------------------------------------------------------------------
#: tolerances (|kernel - plain| <= tol + tol * |plain|), with their reasons:
#: a bf16 output may round one bf16 ulp apart (2e-2, as the JAX package's
#: kernel tests, tests/test_kernels.py:40); an f32 output and the f32 lse
#: differ by summation order only (flash 2e-5, lse 1e-4, RMSNorm 1e-5).
OUT_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
LSE_TOL = 1e-4
#: and o scaled to the tensor, ||kernel - plain|| / ||plain||: o's RMS is
#: about sqrt(e / S), near the elementwise floor at S >= 1,024, so a lost key
#: tile could hide under it; bf16 outputs rounded from f32 values that differ
#: in summation order are at most one ulp (2^-8 relative) apart, so 1e-2 (as
#: the backward's BWD_REL); f32, 1e-5
OUT_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
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
    ("qwen2-1.5b train", 2, 4096, 12, 2, 128, BF16, True),
    ("gemma-2b", 1, 512, 8, 1, 256, BF16, True),
    ("full", 2, 512, 12, 2, 128, BF16, False),
    ("ragged S=1000", 2, 1000, 12, 2, 128, BF16, True),
    ("f32 S=77", 2, 77, 4, 2, 64, F32, True),
    # the f32 route at every shape its paths run, and ragged and full
    ("f32 qwen2-1.5b", 4, 1024, 12, 2, 128, F32, True),
    ("f32 qwen2-1.5b train", 2, 4096, 12, 2, 128, F32, True),
    ("f32 reduced qwen2-1.5b (phase 10)", 4, 128, 4, 2, 32, F32, True),
    ("f32 gemma-2b", 1, 512, 8, 1, 256, F32, True),
    ("f32 ragged S=1000", 2, 1000, 12, 2, 128, F32, True),
    ("f32 full", 2, 512, 12, 2, 128, F32, False),
    # phase 8b's models: moonshot-v1-16b-a3b (16 heads, no grouping) and
    # arctic-480b (56 heads on 8, a group of 7)
    ("moonshot-v1-16b-a3b", 4, 1024, 16, 16, 128, BF16, True),
    ("arctic-480b", 2, 512, 56, 8, 128, BF16, True),
]
#: the kernel each type routes to: bf16 the tensor cores, f32 the CUDA cores
#: (head_dim 112's instantiations count under their own key)
FWD_ROUTE = {BF16: "flash_attention", F32: "flash_attention_f32"}


def flash_vs_plain(name, b_, s_, h_, g_, hd_, dt, causal):
    """The forward on random inputs against its plain version (the route's
    launch, both tolerances) and a second call's bits: a row of the
    phase's line."""
    route = FWD_ROUTE[dt] + ("_hd112" if hd_ == 112 else "")
    qkv = [torch.randn((b_, s_, n_, hd_), generator=gen, device=DEV).to(dt) for n_ in (h_, g_, g_)]
    kernels.reset_launch_counts()
    o, lse = kernels.flash_attention(*qkv, causal=causal)
    check(kernels.launch_counts()[route] == 1, f"flash {name}: not the {route} route")
    po, plse = kernels.flash_attention_plain(*qkv, causal=causal)
    check(o.dtype == dt and o.shape == po.shape, f"flash {name} o: type or shape")
    o64, po64 = o.double(), po.double()
    o_rel = float(torch.linalg.vector_norm(o64 - po64) / torch.linalg.vector_norm(po64))
    check(o_rel <= OUT_REL[dt], f"flash {name} o: relative gap {o_rel} beyond {OUT_REL[dt]}")
    row = dict(
        route=route,
        o_gap=within(o, po, OUT_TOL[dt], f"flash {name} o", route),
        o_tol=OUT_TOL[dt], o_rel_gap=o_rel, o_rel_tol=OUT_REL[dt],
        o_rms_plain=float(torch.sqrt(torch.mean(po64 * po64))),
        lse_gap=within(lse, plse, LSE_TOL, f"flash {name} lse", route),
        lse_tol=LSE_TOL)
    # no atomics: a second call gives the same bits
    o2, lse2 = kernels.flash_attention(*qkv, causal=causal)
    bits = torch.int16 if dt == BF16 else torch.int32
    check(torch.equal(o.view(bits), o2.view(bits)) and torch.equal(lse.view(torch.int32), lse2.view(torch.int32)),
          f"flash {name}: two calls differ")
    row["two_calls_bitwise_equal"] = True
    return row


flash_rows = {}
for name, b_, s_, h_, g_, hd_, dt, causal in flash_cases:
    flash_rows[name] = flash_vs_plain(name, b_, s_, h_, g_, hd_, dt, causal)
rms_rows = {}
for name, rows_, d_, dt, wdt, off in (
        ("prefill bf16", 4096, 1536, BF16, BF16, 0), ("prefill f32", 4096, 1536, F32, F32, 0),
        ("decode bf16", 8, 1536, BF16, BF16, 0), ("train bf16", 8192, 1536, BF16, BF16, 0),
        ("x bf16, w f32", 4096, 1536, BF16, F32, 0), ("x f32, w bf16", 64, 2048, F32, BF16, 0),
        ("odd width 1001, bf16", 64, 1001, BF16, BF16, 0),
        ("moonshot-v1-16b-a3b 2,048 wide, bf16", 4096, 2048, BF16, BF16, 0),
        ("arctic-480b 7,168 wide, bf16", 1024, 7168, BF16, BF16, 0),
        ("rows one element past 16 bytes, bf16", 37, 1536, BF16, BF16, 1)):
    x = torch.randn((rows_ * d_ + off,), generator=gen, device=DEV).to(dt)[off:].view(rows_, d_)
    w = (0.1 * torch.randn((d_,), generator=gen, device=DEV)).to(wdt)
    got = kernels.rmsnorm(x, w, 1e-6)
    rms_rows[name] = dict(gap=within(got, kernels.rmsnorm_plain(x, w, 1e-6), RMS_TOL[dt],
                                     f"rmsnorm {name}", "rmsnorm"), tol=RMS_TOL[dt])
    bits = torch.int16 if dt == BF16 else torch.int32
    check(torch.equal(got.view(bits), kernels.rmsnorm(x, w, 1e-6).view(bits)),
          f"rmsnorm {name}: two calls differ")
    rms_rows[name]["two_calls_bitwise_equal"] = True
del got
emit("model_kernels_vs_plain", flash_attention=flash_rows, rmsnorm=rms_rows,
     tolerance="|kernel - plain| <= tol * (1 + |plain|): bf16 outputs 2e-2 (one bf16 ulp, "
               "tests/test_kernels.py:40), f32 by summation order; ||o - plain|| / ||plain|| "
               "<= o_rel_tol: bf16 1e-2, f32 1e-5")

# times at the main path's shapes: the qwen2-1.5b prefill (4 x 1,024 tokens)
q, k, v = (torch.randn((4, 1024, n_, 128), generator=gen, device=DEV).to(BF16) for n_ in (12, 2, 2))
qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
pairs = 4 * 12 * 1024 * 1025 // 2                  # (query, key) pairs the causal mask keeps
work = (2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * 4 * 12 * 1024, 4 * 128 * pairs, BF16_FLOPS)
record("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
       "src/repro/kernels/flash_attention.py:52",
       device_ms(lambda: kernels.flash_attention(q, k, v, causal=True)),
       device_ms(lambda: kernels.flash_attention_plain(q, k, v, causal=True)), *work,
       library_ms=library_time("forward bf16, 4 x 1,024", lambda: F.scaled_dot_product_attention(
           qt, kt, vt, is_causal=True, enable_gqa=True), bound_of(*work)[0]))
# the f32 route (CUDA cores, full f32) at the same shape and at phase 11's
# f32 first step's (2 x 4,096): its bound is the f32 rate, 67 TFLOP/s; the
# library's f32 attention runs with TF32 off.  ms is the kernel's own span
# (the call also lays q, k, v out by head), beside its launch timed by CUDA
# events
F32_FWD = {"fwd": ("flash_fwd_f32", "flash_attention_fwd_f32_launch")}
f32_fwd_times = {}
for b_, s_ in ((4, 1024), (2, 4096)):
    q, k, v = (torch.randn((b_, s_, n_, 128), generator=gen, device=DEV) for n_ in (12, 2, 2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    work = (4 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * b_ * 12 * s_,
            4 * 128 * b_ * 12 * s_ * (s_ + 1) // 2)
    bound = bound_of(*work)[0]
    call = lambda: kernels.flash_attention(q, k, v, causal=True)  # noqa: E731
    row = dict(ms=kernel_ms(call, F32_FWD)["fwd"],
               events_ms=launch_event_ms(call, {"fwd": F32_FWD["fwd"][1]}, reps=10)["fwd"],
               plain_ms=device_ms(lambda: kernels.flash_attention_plain(q, k, v, causal=True), reps=10),
               library_ms=library_time(f"forward f32, {b_} x {s_:,}", lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True), bound, reps=10),
               bound_ms=bound)
    f32_fwd_times[f"B={b_}, S={s_:,}, H=12, G=2, hd=128, causal"] = row
    if s_ == 1024:
        record("flash_attention_f32", "src/repro_torch/kernels/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:52", row["ms"], row["plain_ms"], *work,
               library_ms=row["library_ms"])
x = torch.randn((4096, 1536), generator=gen, device=DEV).to(BF16)
w = (0.1 * torch.randn((1536,), generator=gen, device=DEV)).to(BF16)
w1 = 1.0 + w
record("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:18",
       device_ms(lambda: kernels.rmsnorm(x, w, 1e-6)),
       device_ms(lambda: kernels.rmsnorm_plain(x, w, 1e-6)),
       2 * 2 * 4096 * 1536 + 2 * 1536, 4 * 4096 * 1536,
       library_ms=device_ms(lambda: F.rms_norm(x, (1536,), weight=w1, eps=1e-6)))
FLUSH = torch.empty((64 << 20,), dtype=torch.uint8, device=DEV)


def cold_ms(fn, reps: int = 25) -> float:
    """``device_ms`` of ``fn`` with the L2 flushed before each call: 64 MiB
    (more than the 50 MB L2) are written between calls, and the spans of
    that fill are left out, so ``fn`` reads its inputs from HBM."""
    def step():
        FLUSH.fill_(1)
        fn()
    spans = [sp for sp in traced_spans(step, reps, 3) if "FillFunctor" not in sp[2]]
    if spans and len(spans) % reps:             # a one-off span: the mean
        return sum(b_ - a for a, b_, _ in spans) / reps / 1e3
    if spans:
        per = len(spans) // reps
        return float(np.median([sum(b_ - a for a, b_, _ in spans[i * per:(i + 1) * per])
                                for i in range(reps)])) / 1e3
    EVENT_TIMED.append(f"chip_smoke.py:{fn.__code__.co_firstlineno} (L2 flushed)")
    times = []
    for _ in range(reps):
        FLUSH.fill_(1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# RMSNorm at the paths' shapes, bf16: decode (8 rows), prefill (4 x 1,024)
# and a training microbatch (2 x 4,096), warm and with the L2 flushed, and
# F.rms_norm beside each
rms_shapes = {}
for rows_ in (8, 4096, 8192):
    xs = x if rows_ == 4096 else torch.randn((rows_, 1536), generator=gen, device=DEV).to(BF16)
    rms_shapes[f"{rows_}x1536"] = dict(
        ms=device_ms(lambda: kernels.rmsnorm(xs, w, 1e-6)),
        library_ms=device_ms(lambda: F.rms_norm(xs, (1536,), weight=w1, eps=1e-6)),
        ms_l2_flushed=cold_ms(lambda: kernels.rmsnorm(xs, w, 1e-6)),
        library_ms_l2_flushed=cold_ms(lambda: F.rms_norm(xs, (1536,), weight=w1, eps=1e-6)),
        plain_ms=device_ms(lambda: kernels.rmsnorm_plain(xs, w, 1e-6)),
        bound_ms=(2 * 2 * rows_ * 1536 + 2 * 1536) / HBM_BPS * 1e3)
del FLUSH
emit("model_kernel_times", card=smi,
     method="device time per call (trace), median of 25; the f32 forward: median of 10, ms its "
            "kernel's span, events_ms its launch by CUDA events; "
            "library_ms by the trace (by CUDA events where the trace's lies under the bound)",
     launch_floor_ms=device_ms(lambda: one.add_(1)), rmsnorm_by_shape=rms_shapes,
     flash_attention_f32_by_shape=f32_fwd_times,
     **{r: {key: records[r][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in ("flash_attention", "flash_attention_f32", "rmsnorm")})
del q, k, v, qt, kt, vt, x, w, w1, xs
# the flash forward and RMSNorm at phase 8b's prefill shapes, beside their
# plain versions and the library's calls: moonshot-v1-16b-a3b (4 x 1,024,
# 16 heads on 16; 4,096 rows of 2,048) and arctic-480b (2 x 512, 56 heads on
# 8; 1,024 rows of 7,168)
moe_shapes = {}
for what, b_, s_, h_, g_, rows_, d_ in (("moonshot-v1-16b-a3b", 4, 1024, 16, 16, 4096, 2048),
                                        ("arctic-480b", 2, 512, 56, 8, 1024, 7168)):
    q, k, v = (torch.randn((b_, s_, n_, 128), generator=gen, device=DEV).to(BF16) for n_ in (h_, g_, g_))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    work = (2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * b_ * h_ * s_,
            4 * 128 * b_ * h_ * s_ * (s_ + 1) // 2, BF16_FLOPS)
    x = torch.randn((rows_, d_), generator=gen, device=DEV).to(BF16)
    w = (0.1 * torch.randn((d_,), generator=gen, device=DEV)).to(BF16)
    w1 = 1.0 + w
    moe_shapes[what] = dict(
        flash_attention=dict(
            ms=device_ms(lambda: kernels.flash_attention(q, k, v, causal=True)),
            plain_ms=device_ms(lambda: kernels.flash_attention_plain(q, k, v, causal=True), reps=10),
            library_ms=library_time(f"forward bf16, {what}", lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), bound_of(*work)[0]),
            bound_ms=bound_of(*work)[0], bound_by=bound_of(*work)[1]),
        rmsnorm=dict(ms=device_ms(lambda: kernels.rmsnorm(x, w, 1e-5)),
                     plain_ms=device_ms(lambda: kernels.rmsnorm_plain(x, w, 1e-5)),
                     library_ms=device_ms(lambda: F.rms_norm(x, (d_,), weight=w1, eps=1e-5)),
                     bound_ms=(2 * 2 * rows_ * d_ + 2 * d_) / HBM_BPS * 1e3))
emit("model_kernel_times_moe_shapes", card=smi, method="as model_kernel_times", **moe_shapes)
del q, k, v, qt, kt, vt, x, w, w1

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
parity_ok = bool(torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4))
parity_why = ""
if not parity_ok:
    # which side moved: each forward again, and both with reference attention
    # (the failure stands whatever these say; they only go into its message)
    rref = dataclasses.replace(rcfg, attention_impl="reference")
    at = np.unravel_index(int((lg.double().cpu() - lc.double()).abs().argmax()), lc.shape)
    lg2 = tm.forward_logits(rcfg, gpu_params, {"tokens": toks.to(DEV)}, last_only=False)
    lc2 = tm.forward_logits(rcfg, cpu_params, {"tokens": toks}, last_only=False)
    parity_why = json.dumps(dict(
        at=[int(i) for i in at], card_again_vs_card=max_gap(lg2, lg),
        cpu_again_vs_cpu=max_gap(lc2, lc), card_again_vs_cpu_again=max_gap(lg2, lc2),
        reference_attention_card_vs_cpu=max_gap(
            tm.forward_logits(rref, gpu_params, {"tokens": toks.to(DEV)}, last_only=False),
            tm.forward_logits(rref, cpu_params, {"tokens": toks}, last_only=False)),
        allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        fp32_precision=str(getattr(torch.backends.cuda.matmul, "fp32_precision", None)),
        cpu_threads=torch.get_num_threads(),
        env={key: val for key, val in os.environ.items() if key.startswith(
            ("TORCH_", "PYTORCH_", "NVIDIA_TF32", "CUBLAS", "OMP_", "MKL_", "ONEDNN_", "DNNL_"))}))
    print(f"model parity diagnosis: {parity_why}", file=sys.stderr, flush=True)
check(parity_ok, f"model parity: forward_logits on the card vs the CPU, max gap {parity_gap} "
                 f"(f32 tol 1e-4) {parity_why}")
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
impl_cfg = {impl: dataclasses.replace(cfg, attention_impl=impl) for impl in ("flash", "reference", "blocked")}
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
# attention scores are large and softmax is near one-hot; blocked attention
# (the flash algorithm in plain PyTorch, scores in f32) is held to the same
# bound
for impl in ("flash", "blocked"):
    for stat in ("max", "mean"):
        check(gaps[impl][stat] <= 1.25 * gaps["reference"][stat],
              f"serve: {impl} logits {stat} gap to f32 {gaps[impl][stat]} exceeds 1.25x the "
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
# 8b. moe: the mixture-of-experts family (moonshot-v1-16b-a3b, arctic-480b)
# ---------------------------------------------------------------------------
# (the engines' timing wrappers close over their engines: the collector,
# not the reference count, frees the engines and the weights they hold)
del params, first, second, pc, st, lgt, nxt, wave, prof, toks
gc.collect()
torch.cuda.empty_cache()
t_moe = time.perf_counter()


def dense_moe_reference(x, p, cfg_):
    """``tests/test_moe.py::dense_reference`` in PyTorch: every expert on
    every token, the top k combined (ties to the lower expert, as
    ``lax.top_k``)."""
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax((xf @ p.router).float(), dim=-1)
    top_e = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :cfg_.top_k]
    top_p = torch.gather(probs, 1, top_e)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    act = F.silu(torch.matmul(xf, p.wg)) * torch.matmul(xf, p.wu)          # (E, T, F)
    out_all = torch.matmul(act, p.wd)                                     # (E, T, D)
    rows_ = torch.arange(xf.shape[0], device=x.device)
    y = torch.zeros_like(xf)
    for j in range(cfg_.top_k):
        y = y + out_all[top_e[:, j], rows_] * top_p[:, j, None].to(x.dtype)
    return y.reshape(x.shape)


def routing_same(got, want, what):
    """Every layer's ``top_e`` and kept mask identical; a difference fails
    with the token's gap between its k-th and (k+1)-th probability."""
    check(len(got) == len(want), f"{what}: {len(got)} MoE calls against {len(want)}")
    for i, (g_, w_) in enumerate(zip(got, want)):
        for key in ("top_e", "keep"):
            a_, b_ = g_[key].cpu(), w_[key]
            if not torch.equal(a_, b_):
                tok = int(torch.nonzero((a_ != b_).reshape(a_.shape[0], -1).any(1))[0])
                kk = a_.shape[1]
                gaps_ = {side: float(sp[kk - 1] - sp[kk]) for side, sp in (
                    ("card", torch.sort(g_["probs"][tok].cpu(), descending=True).values),
                    ("cpu", torch.sort(w_["probs"][tok], descending=True).values))}
                check(False, f"{what}: call {i} {key} differs at token {tok}: card {a_[tok].tolist()}, "
                             f"CPU {b_[tok].tolist()}; top-k probability gap {gaps_}")


def routing_flips(tops):
    """Per MoE call, the share of tokens whose experts differ between flash
    and reference attention."""
    return [float((a_ != b_).any(-1).float().mean()) for a_, b_ in zip(tops["flash"], tops["reference"])]


# reduced moonshot in f32, the same weights on the card and on the CPU, as
# phase 7: identical routing, forward_logits within 1e-4, identical tokens
free_gib("reduced moonshot-v1-16b-a3b")
mrcfg = dataclasses.replace(reduced(get_config("moonshot-v1-16b-a3b")), attention_impl="flash")
cpu_m = tm.init_params(mrcfg, torch.Generator().manual_seed(13), device="cpu")
gpu_m = tm.Model(mrcfg, device="meta")
gpu_m.load_state_dict({key: t.to(DEV) for key, t in cpu_m.state_dict().items()}, assign=True)
mtoks = torch.from_numpy(np.random.default_rng(14).integers(2, mrcfg.vocab_size, (3, 200)))
kernels.reset_launch_counts()
with tmoe.capture_routing() as r_card:
    lg = tm.forward_logits(mrcfg, gpu_m, {"tokens": mtoks.to(DEV)}, last_only=False)
with tmoe.capture_routing() as r_cpu:
    lc = tm.forward_logits(mrcfg, cpu_m, {"tokens": mtoks}, last_only=False)
routing_same(r_card, r_cpu, "moe parity forward_logits")
mparity_gap = max_gap(lg, lc)
# f32 cannot hold this network to 1e-4: an f64 evaluation of the same
# weights on the CPU puts the CPU's own f32 logits up to about 2e-3 from the
# exact ones (reduced qwen2-1.5b's, phase 7: 9e-5), the random experts
# (std 1/sqrt(L) = 0.5 at d = 128) amplifying rounding.  So the card is held
# to the exact forward instead: its largest and its norm gap to the f64
# logits at most 3x the CPU's (an NVIDIA H100 80GB HBM3 at 700 W read 1.55x
# and 1.34x; a card path that computed anything else reads orders beyond)
c64 = dataclasses.replace(mrcfg, dtype="float64", attention_impl="reference")
p64 = tm.Model(c64, device="meta")
p64.load_state_dict({key: t.double() for key, t in cpu_m.state_dict().items()}, assign=True)
l64 = tm.forward_logits(c64, p64, {"tokens": mtoks}, last_only=False)
to_exact = {side: dict(max=float((l_.cpu().double() - l64).abs().max()),
                       norm=float(torch.linalg.vector_norm(l_.cpu().double() - l64)))
            for side, l_ in (("card", lg), ("cpu", lc))}
check(all(to_exact["card"][m_] <= 3 * to_exact["cpu"][m_] for m_ in ("max", "norm")),
      f"moe parity: forward_logits on the card vs the f64 forward {to_exact['card']}, beyond 3x "
      f"the CPU's f32 {to_exact['cpu']} (card vs CPU max gap {mparity_gap})")
del p64, l64
mdropped = float(1 - torch.cat([r_["keep"].reshape(-1) for r_ in r_cpu]).float().mean())
rng = np.random.default_rng(15)
mreqs = [(f"r{i}", rng.integers(2, mrcfg.vocab_size, int(rng.integers(3, 40))), 12) for i in range(5)]
mserved = []
for params_ in (gpu_m, cpu_m):
    eng = ServingEngine(mrcfg, params_, ServeConfig(max_batch=3, max_len=64))
    for rid, prompt, max_new in mreqs:
        eng.submit(rid, prompt, max_new=max_new)
    with tmoe.capture_routing() as r_eng:
        mserved.append((eng.run_until_drained(), eng.steps_executed))
    mserved[-1] += (r_eng,)
routing_same(mserved[0][2], mserved[1][2], "moe parity engine")
check(mserved[0][:2] == mserved[1][:2], "moe parity: the engines' completed tokens or steps differ")
mrcounts = kernels.launch_counts()           # the card's forward and engine: the f32 route
for name in ("flash_attention_f32", "rmsnorm"):
    check(mrcounts[name] > 0, f"moe parity: kernel {name} was never launched")
    records[name]["launches"] += mrcounts[name]
emit("moe_parity", config="moonshot-v1-16b-a3b reduced (4 layers, d=128, 8 experts top-2, "
     "capacity factor 1.25, f32), flash attention",
     forward_logits_max_gap=mparity_gap, gap_to_f64_forward=to_exact,
     bound="the card's max and norm gap to the f64 forward <= 3x the CPU's", routing_identical=True,
     moe_calls=len(r_cpu), choices_dropped_share=mdropped, requests=len(mreqs),
     steps_executed=mserved[0][1], engine_moe_calls=len(mserved[0][2]), completed_identical=True,
     launches={name: mrcounts[name] for name in ("flash_attention_f32", "rmsnorm")})
del cpu_m, gpu_m, lg, lc, r_card, r_cpu, mserved, eng

# one full-width moonshot-v1-16b-a3b MoE layer in f32 against the dense
# reference, 512 tokens at capacity factor 16 (cap 768: nothing drops).
# Stated bound, f32, the same products summed in another order (TF32 off):
# ||y - ref|| / ||ref|| <= 1e-5 and |y - ref| <= 1e-4 (|ref| + RMS(ref)), each
# output a sum of products about its RMS (131) in size (an NVIDIA H100 80GB
# HBM3 at 700 W read 5.0e-8 and 1.22e-4 at most)
MOE_F32_TOL = dict(rel=1e-5, elem=1e-4)
free_gib("one moonshot-v1-16b-a3b MoE layer, f32")
fcfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), capacity_factor=16.0)
lgen = torch.Generator(device=DEV).manual_seed(16)
layer = tm.ParamGroup(tmoe.moe_defs(fcfg), DEV, F32)
with torch.no_grad():
    for name, d_ in tmoe.moe_defs(fcfg).items():
        getattr(layer, name).copy_(init_leaf(d_, lgen, DEV, F32, fan_in=fcfg.n_layers))
    xm = torch.randn((1, 512, fcfg.d_model), generator=lgen, device=DEV)
    with tmoe.capture_routing() as r_layer:
        ym, auxm = tmoe.moe_ffn(xm, layer, fcfg)
    ym2, _ = tmoe.moe_ffn(xm, layer, fcfg)
    check(bool(r_layer[0]["keep"].all()), "moe layer: a choice dropped at capacity factor 16")
    check(torch.equal(ym.view(torch.int32), ym2.view(torch.int32)), "moe layer: two calls differ")
    refm = dense_moe_reference(xm, layer, fcfg)
    y64, r64 = ym.double(), refm.double()
    layer_gap = dict(max=float((y64 - r64).abs().max()),
                     rel=float(torch.linalg.vector_norm(y64 - r64) / torch.linalg.vector_norm(r64)),
                     ref_rms=float(torch.sqrt(torch.mean(r64 * r64))))
    check(bool(torch.isfinite(ym).all()), "moe layer: non-finite output")
    check(layer_gap["rel"] <= MOE_F32_TOL["rel"]
          and bool(((y64 - r64).abs() <= MOE_F32_TOL["elem"] * (r64.abs() + layer_gap["ref_rms"])).all()),
          f"moe layer: beyond {MOE_F32_TOL} of the dense reference: {layer_gap}")
    with tmoe.capture_routing() as r_cf:
        tmoe.moe_ffn(xm, layer, get_config("moonshot-v1-16b-a3b"))
    layer_dropped = float(1 - r_cf[0]["keep"].float().mean())
emit("moe_layer", config="moonshot-v1-16b-a3b, one MoE layer at full width (d=2,048, 64 experts "
     "top-6, d_ff 1,408), f32, weights by the init's distributions (seed 16)",
     tokens=512, capacity_factor=16.0, gap_to_dense_reference=layer_gap, tolerance=MOE_F32_TOL,
     two_calls_bitwise_equal=True, aux_loss=float(auxm),
     at_config_capacity_factor_1_25=dict(capacity=tmoe.capacity(512, get_config("moonshot-v1-16b-a3b")),
                                         choices_dropped_share=layer_dropped))
del layer, xm, ym, ym2, refm, y64, r64, r_layer, r_cf

# full-width moonshot-v1-16b-a3b, all 48 layers, bf16 parameters (the f32
# master copy would be about 112 GB), drawn on the card
free_gib("moonshot-v1-16b-a3b, 48 layers, bf16")
mcfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), params_dtype="bfloat16")
t0 = time.perf_counter()
mparams = tm.init_params(mcfg, torch.Generator(device=DEV).manual_seed(17), device=DEV)
torch.cuda.synchronize()
minit_s = time.perf_counter() - t0
mcount = sum(p_.numel() for p_ in mparams.parameters())
check(mcount == 48 * 570_560_512 + 2 * 163_840 * 2048 + 2048, f"moe: moonshot has {mcount} parameters")
mtoks = torch.from_numpy(np.random.default_rng(18).integers(2, mcfg.vocab_size, (4, 1024))).to(DEV)
torch.cuda.reset_peak_memory_stats()
kernels.reset_launch_counts()
mouts, mfwd_s, mtops = forwards(mcfg, mparams, mtoks)
mfwd_counts = kernels.launch_counts()
L_M = mcfg.n_layers
# the warm-ups and the two forwards: each 2 norms a layer and the final one;
# flash twice (its warm-up and its forward)
check(mfwd_counts["flash_attention"] == 2 * L_M,
      f"moe: moonshot forward_logits launched flash {mfwd_counts['flash_attention']} times, "
      f"the path implies {2 * L_M}")
check(mfwd_counts["rmsnorm"] == 4 * (2 * L_M + 1),
      f"moe: moonshot forward_logits launched RMSNorm {mfwd_counts['rmsnorm']} times")
# at 48 layers the two bf16 paths decorrelate: they round the attention
# differently (flash keeps the scores in f32), the bf16 router turns a
# rounding step into other experts for a token near a tie (the share of
# tokens whose experts differ, by layer, is printed), and these random
# weights (std 1/sqrt(L)) amplify it layer on layer; no elementwise bound
# holds there, so the gap is printed and the bound is held at depth 4 below
mgap = logit_gap(mouts["flash"], mouts["reference"])
mflips = routing_flips(mtops)
del mouts, mtops
# serving: batch 8, max_len 1,024, 8 requests preempted halfway and drained
# by a second engine, against one uninterrupted engine.  At capacity factor
# 16 nothing drops, so a token's experts do not depend on the requests
# batched with it (the second engine batches the re-queued requests in
# another order); then the config's 1.25, uninterrupted, as served
MOE_NEW, MOE_PREEMPT = 32, 16          # new tokens a request; decode steps before the preemption
engine_rng = np.random.default_rng(19)
mprompts = [engine_rng.integers(2, mcfg.vocab_size, int(n_)) for n_ in engine_rng.integers(64, 513, 8)]
mscfg = ServeConfig(max_batch=8, max_len=1024)
ncfg = dataclasses.replace(mcfg, capacity_factor=16.0)


def serve_all(cfg_, preempt_after=None):
    """8 requests through one engine, or two across a preemption; the calls
    go into ``prefill_s`` / ``decode_s``."""
    eng1 = timed(ServingEngine(cfg_, mparams, mscfg), preempt_after)
    for i, prompt in enumerate(mprompts):
        eng1.submit(f"req{i}", prompt, max_new=MOE_NEW)
    eng1.run_until_drained()
    if preempt_after is None:
        return dict(eng1.completed), eng1, None, []
    requeued_ = [r.rid for r in eng1.queue]
    eng2 = timed(ServingEngine(cfg_, mparams, mscfg))
    eng2.queue = eng1.queue
    eng2.run_until_drained()
    return {**eng1.completed, **eng2.completed}, eng1, eng2, requeued_


prefill_s, decode_s = [], []
mdone, mfirst, msecond, mrequeued = serve_all(ncfg, MOE_PREEMPT)
pair_calls = (len(prefill_s), len(decode_s))
m_pre, m_dec = list(prefill_s), [t_ for t_, _ in decode_s]
mwhole = serve_all(ncfg)[0]
check(mfirst.steps_executed == MOE_PREEMPT, f"moe serve: preempted after {mfirst.steps_executed} steps")
check(len(mrequeued) > 0, "moe serve: the preemption re-queued nothing")
check(sorted(mdone) == sorted(f"req{i}" for i in range(8)), f"moe serve: completed {sorted(mdone)}")
check(mdone == mwhole, "moe serve: the preempted and resumed engines' tokens differ from an "
                       "uninterrupted engine's")
for rid, out in mdone.items():
    check(1 <= len(out) <= MOE_NEW and all(0 <= t_ < mcfg.vocab_size for t_ in out),
          f"moe serve: {rid} returned {len(out)} tokens or an id outside the vocabulary")
prefill_s, decode_s = [], []
with tmoe.capture_routing() as r_serve:
    serve_all(mcfg)
c_pre, c_dec = list(prefill_s), [t_ for t_, _ in decode_s]
serve_dropped = {kind_: float(1 - torch.cat([r_["keep"].reshape(-1) for r_ in r_serve
                                             if (r_["keep"].shape[0] > 8) == (kind_ == "prefill")])
                              .float().mean()) for kind_ in ("prefill", "decode")}
del r_serve
torch.cuda.synchronize()
mcounts = kernels.launch_counts()
n_calls = pair_calls[0] + pair_calls[1] + 2 * len(prefill_s) + 2 * len(decode_s)
mpeak_gib = torch.cuda.max_memory_allocated() / 2**30
mimplied = dict(flash_attention=2 * L_M, rmsnorm=(2 * L_M + 1) * (4 + n_calls))
for name, n_ in mimplied.items():
    check(mcounts[name] == n_, f"moe: {mcounts[name]} launches of {name}, the path implies {n_}")
    records[name]["launches"] += mcounts[name]

# a traced decode window at the config's capacity factor: 8 steps on a cache
# primed with the first 64 tokens of every prompt
mpc = tm._cast(mparams, mcfg)
wave = torch.from_numpy(np.stack([p_[:64] for p_ in mprompts])).to(DEV)
lgt, st = tm.prefill(mcfg, mpc, wave, 1024)
nxt = torch.argmax(lgt[:, -1, :], -1)[:, None]
torch.cuda.synchronize()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(8):
        lgt, st = tm.decode_step(mcfg, mpc, nxt, st)
        nxt = torch.argmax(lgt[:, -1, :], -1)[:, None]
        nxt[:, 0].tolist()
    torch.cuda.synchronize()
    mwindow_s = time.perf_counter() - t0
mbusy = busy_us(prof)
del lgt, st, nxt, wave, prof
# the stated bound at depth 4: the first 4 layers of these weights (shared,
# not copied) in bf16 with flash and with reference attention, against the
# same 4 layers in f32 (an f32 copy of their weights, 11.8 GB)
m4cfg = dataclasses.replace(mcfg, n_layers=min(4, L_M))
m4 = tm.Model(m4cfg, device="meta")
m4.load_state_dict({key: t for key, t in mparams.state_dict().items()
                    if not key.startswith("layers.") or int(key.split(".")[1]) < m4cfg.n_layers},
                   assign=True)
m4outs, _, m4tops = forwards(m4cfg, m4, mtoks)
m32 = tm.Model(m4cfg, device="meta")
m32.load_state_dict({key: t.float() for key, t in m4.state_dict().items()}, assign=True)
m4truth = tm.forward_logits(dataclasses.replace(m4cfg, dtype="float32", params_dtype="float32"), m32,
                            {"tokens": mtoks}, last_only=False)
m4gaps = against_f32(m4outs, m4truth, "moonshot, first 4 layers")
m4gaps["flash_vs_reference"] = logit_gap(m4outs["flash"], m4outs["reference"])
m4flips = routing_flips(m4tops)
del m4, m32, m4outs, m4tops, m4truth


def serve_figures(pre, dec):
    return dict(prefill_tokens_per_s=sum(n_ for _, n_ in pre) / sum(t_ for t_, _ in pre),
                prefill_calls=len(pre), decode_steps=len(dec),
                decode_p50_ms=float(np.median(dec)) * 1e3, decode_p99_ms=float(np.percentile(dec, 99)) * 1e3)


emit("moe_serve", card=smi,
     config="moonshot-v1-16b-a3b full width: 48 layers, d=2,048, 16/16 heads, hd=128, 64 experts "
            "top-6, d_ff 1,408, vocab 163,840; bf16 parameters drawn on the card (seed 17), bf16 compute",
     params=mcount, init_seconds=minit_s,
     forward_logits_tokens=4 * 1024, forward_logits_seconds=mfwd_s,
     forward_logits_tokens_per_s={impl: 4 * 1024 / s_ for impl, s_ in mfwd_s.items()},
     flash_vs_reference=mgap, routing_flips_by_layer=mflips,
     first_4_layers=dict(gap_to_f32=m4gaps, routing_flips_by_layer=m4flips,
                         bound="flash's max and mean gap to the f32 forward <= 1.25x the reference's"),
     requests=8, prompt_lens=[len(p_) for p_ in mprompts], max_new=MOE_NEW,
     preempted_after_steps=MOE_PREEMPT, requeued=mrequeued, completed_by_first=sorted(mfirst.completed),
     completed_by_second=sorted(msecond.completed), identical_to_uninterrupted=True,
     capacity_factor_16_preempted_pair=serve_figures(m_pre, m_dec),
     capacity_factor_1_25_uninterrupted=dict(serve_figures(c_pre, c_dec),
                                             choices_dropped_share=serve_dropped),
     peak_device_gib=mpeak_gib, launches={name: mcounts[name] for name in mimplied},
     launches_implied=mimplied,
     traced_decode_window_ms=mwindow_s * 1e3, device_busy_ms=mbusy / 1e3,
     device_busy_share=(mbusy / 1e6) / mwindow_s if mbusy else "not measured (empty trace)")
del mparams, mpc, mfirst, msecond
gc.collect()
torch.cuda.empty_cache()

# arctic-480b at full width, cut to 1 layer, its own bf16 parameters
free_gib("arctic-480b, 1 layer, bf16")
acfg = dataclasses.replace(get_config("arctic-480b"), n_layers=1)
t0 = time.perf_counter()
aparams = tm.init_params(acfg, torch.Generator(device=DEV).manual_seed(20), device=DEV)
torch.cuda.synchronize()
ainit_s = time.perf_counter() - t0
acount = sum(p_.numel() for p_ in aparams.parameters())
atoks = torch.from_numpy(np.random.default_rng(21).integers(2, acfg.vocab_size, (2, 512))).to(DEV)
kernels.reset_launch_counts()
aouts, afwd_s, atops = forwards(acfg, aparams, atoks)
acounts = kernels.launch_counts()
check(acounts["flash_attention"] == 2 and acounts["rmsnorm"] == 4 * 3,
      f"moe: arctic forward_logits launched {acounts['flash_attention']} flash and "
      f"{acounts['rmsnorm']} RMSNorm, the path implies 2 and 12")
for name in ("flash_attention", "rmsnorm"):
    records[name]["launches"] += acounts[name]
aouts = {impl: o_.float() for impl, o_ in aouts.items()}
# its layer (128 experts top-2 beside the dense MLP) against the dense
# reference plus glu_mlp, 256 tokens at capacity factor 64 (cap 256: nothing
# drops), bf16 as served.  Stated bound: the same products rounded to bf16
# at other steps, one or two bf16 ulps of the element or of the outputs'
# RMS: ||y - ref|| / ||ref|| <= 1e-2 and |y - ref| <= 2e-2 (|ref| + RMS(ref))
# (an NVIDIA H100 80GB HBM3 at 700 W read both 0: the same products)
MOE_BF16_TOL = dict(rel=1e-2, elem=2e-2)
a64 = dataclasses.replace(acfg, capacity_factor=64.0)
lp = aparams.layers[0]
with torch.no_grad():
    xa = torch.randn((1, 256, acfg.d_model), generator=torch.Generator(device=DEV).manual_seed(22),
                     device=DEV).to(BF16)
    with tmoe.capture_routing() as r_a:
        ya, _ = tm._ffn(xa, lp, a64)
    ya2, _ = tm._ffn(xa, lp, a64)
    check(bool(r_a[0]["keep"].all()), "moe: arctic layer dropped a choice at capacity factor 64")
    check(torch.equal(ya.view(torch.int16), ya2.view(torch.int16)), "moe: arctic layer: two calls differ")
    refa = dense_moe_reference(xa, lp.moe, a64) + glu_mlp(xa, lp.dense_mlp, acfg.mlp_type)
    y64, r64 = ya.double(), refa.double()
    alayer_gap = dict(max=float((y64 - r64).abs().max()),
                      rel=float(torch.linalg.vector_norm(y64 - r64) / torch.linalg.vector_norm(r64)),
                      ref_rms=float(torch.sqrt(torch.mean(r64 * r64))))
    check(bool(torch.isfinite(ya).all()), "moe: arctic layer non-finite")
    check(alayer_gap["rel"] <= MOE_BF16_TOL["rel"]
          and bool(((y64 - r64).abs() <= MOE_BF16_TOL["elem"] * (r64.abs() + alayer_gap["ref_rms"])).all()),
          f"moe: arctic layer beyond {MOE_BF16_TOL} of the dense reference: {alayer_gap}")
# the f32 forward of the same layer: the weights cast to f32 one leaf at a
# time (56.3 GB; the bf16 copy goes as they are cast), against which flash
# and reference attention are held as at moonshot's depth 4
with torch.no_grad():
    for p_ in aparams.parameters():
        p_.data = p_.data.float()
atruth = tm.forward_logits(dataclasses.replace(acfg, dtype="float32", params_dtype="float32"), aparams,
                           {"tokens": atoks}, last_only=False)
agaps = against_f32(aouts, atruth, "arctic, 1 layer")
agaps["flash_vs_reference"] = logit_gap(aouts["flash"], aouts["reference"])
del aouts, atops, atruth
emit("moe_arctic", card=smi,
     config="arctic-480b full width cut to 1 layer: d=7,168, 56/8 heads, hd=128, 128 experts top-2 "
            "beside a dense SwiGLU MLP, d_ff 4,864, vocab 32,000; bf16 parameters (seed 20)",
     params=acount, init_seconds=ainit_s, forward_logits_tokens=2 * 512,
     forward_logits_seconds=afwd_s, gaps=agaps,
     bound="flash's max and mean gap to the f32 forward <= 1.25x the reference's",
     layer_tokens=256, layer_gap_to_dense_reference=alayer_gap, layer_tolerance=MOE_BF16_TOL,
     two_calls_bitwise_equal=True, launches={name: acounts[name] for name in ("flash_attention", "rmsnorm")})
del aparams, lp, xa, ya, ya2, refa, y64, r64, r_a
gc.collect()
torch.cuda.empty_cache()
emit("moe", seconds=time.perf_counter() - t_moe)

# ---------------------------------------------------------------------------
# 8c. hybrid: the Mamba2 hybrid (zamba2-7b) and xLSTM (xlstm-125m)
# ---------------------------------------------------------------------------
t_hyb = time.perf_counter()
ZAMBA, XLSTM = get_config("zamba2-7b"), get_config("xlstm-125m")


def rms_per_pass(cfg_):
    """RMSNorm launches of one forward or one decode step: Mamba 2 a layer
    (norm, gate norm) and the shared block 2 a group; mLSTM 2 a layer, sLSTM
    3; the final norm."""
    if cfg_.block_pattern == "zamba_hybrid":
        return 2 * cfg_.n_layers + 2 * (cfg_.n_layers // cfg_.shared_attn_every) + 1
    return sum(3 if i % cfg_.slstm_every == cfg_.slstm_every - 1 else 2
               for i in range(cfg_.n_layers)) + 1


def flash_per_forward(cfg_):
    """Flash forward launches of one ``forward_logits``: the shared block's,
    one a group (decode attends by reference attention)."""
    return cfg_.n_layers // cfg_.shared_attn_every if cfg_.block_pattern == "zamba_hybrid" else 0


def flash_key(cfg_):
    key = FWD_ROUTE[tm.torch_dtype(cfg_.dtype)]
    return key + "_hd112" if cfg_.resolved_head_dim == 112 else key


#: launches of kernels whose entry of the kernels line a later phase makes
#: (the backward's: phase 9), added to it at the end
LATER_LAUNCHES = {}


def count_launches(counts, implied, what):
    """Each kernel's launches equal to what the path implies, added to the
    kernels line."""
    for name, n_ in implied.items():
        check(counts[name] == n_, f"{what}: {counts[name]} launches of {name}, the path implies {n_}")
        if name in records:
            records[name]["launches"] += counts[name]
        else:
            LATER_LAUNCHES[name] = LATER_LAUNCHES.get(name, 0) + counts[name]


# the flash forward at zamba2-7b's head_dim 112 (the hd-128 tiling over rows
# zero padded past 112) against its plain version: the shared block's
# prefill shape (4 x 1,024, 32 heads, no grouping), ragged, full, and the f32
# route at S=77 and 1 x 1,024 (phase 6's tolerances and bits)
hd112_rows = {name: flash_vs_plain(name, *shape) for name, shape in (
    ("bf16 zamba2-7b prefill 4 x 1,024", (4, 1024, 32, 32, 112, BF16, True)),
    ("bf16 ragged S=1000", (2, 1000, 32, 32, 112, BF16, True)),
    ("bf16 full", (2, 512, 32, 32, 112, BF16, False)),
    ("f32 S=77", (2, 77, 32, 32, 112, F32, True)),
    ("f32 1 x 1,024", (1, 1024, 32, 32, 112, F32, True)))}
# phase 2 held every instantiation's SASS; these are the hd-112 ones
hd112_sass = {f: c for f, c in {**sass_counts, **f32_sass}.items() if "flash_fwd" in f and "Li112E" in f}
check(len(hd112_sass) == 2, f"hybrid: {len(hd112_sass)} hd-112 forward instantiations in the SASS")
for f, c in hd112_sass.items():
    check(c.get("HGMMA", 0) > 0 and c.get("UTMALDG", 0) > 0 if "wgmma" in f else
          c["HGMMA"] == 0 and c["HMMA"] == 0, f"hybrid: {f} has {c} in its SASS")
# times at the prefill shape: the kernel's own span (the call also lays q,
# k, v out by head) and the whole call, beside the plain version, the
# bound (4 * 112 flops a kept pair, or the bytes) and the library's
BF16_FWD = {"fwd": ("flash_fwd_wgmma", "flash_attention_fwd_bf16_launch")}
hd112_times = {}
for dt, b_, name in ((BF16, 4, "flash_attention_hd112"), (F32, 1, "flash_attention_f32_hd112")):
    q, k, v = (torch.randn((b_, 1024, 32, 112), generator=gen, device=DEV).to(dt) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    size = q.element_size()
    work = (size * (q.numel() * 2 + k.numel() + v.numel()) + 4 * b_ * 32 * 1024,
            4 * 112 * b_ * 32 * 1024 * 1025 // 2) + ((BF16_FLOPS,) if dt == BF16 else ())
    bound = bound_of(*work)[0]
    call = lambda: kernels.flash_attention(q, k, v, causal=True)  # noqa: E731
    spans = BF16_FWD if dt == BF16 else F32_FWD
    row = dict(ms=kernel_ms(call, spans)["fwd"],
               events_ms=launch_event_ms(call, {"fwd": spans["fwd"][1]}, reps=10)["fwd"],
               call_ms=device_ms(call),
               plain_ms=device_ms(lambda: kernels.flash_attention_plain(q, k, v, causal=True), reps=10),
               library_ms=library_time(f"forward {'bf16' if dt == BF16 else 'f32'} hd 112, {b_} x 1,024",
                                       lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                                       bound),
               bound_ms=bound)
    hd112_times[name] = row
    record(name, "src/repro_torch/kernels/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:52", row["ms"], row["plain_ms"], *work,
           library_ms=row["library_ms"])
del q, k, v, qt, kt, vt
# RMSNorm at the new widths (zamba2-7b's 3,584 and its gate norm's 7,168
# over d_inner; xlstm-125m's 768), prefill and decode rows, bf16: against
# the plain version and F.rms_norm (phase 6's tolerance), two calls the
# same bits, the times
hyb_rms = {}
for what, rows_, d_ in (("zamba2-7b prefill 4,096 x 3,584", 4096, 3584),
                        ("zamba2-7b decode 8 x 3,584", 8, 3584),
                        ("zamba2-7b gate norm 4,096 x 7,168", 4096, 7168),
                        ("xlstm-125m prefill 4,096 x 768", 4096, 768),
                        ("xlstm-125m decode 4 x 768", 4, 768)):
    x = torch.randn((rows_, d_), generator=gen, device=DEV).to(BF16)
    w = (0.1 * torch.randn((d_,), generator=gen, device=DEV)).to(BF16)
    w1 = 1.0 + w
    got = kernels.rmsnorm(x, w, 1e-5)
    hyb_rms[what] = dict(
        gap=within(got, kernels.rmsnorm_plain(x, w, 1e-5), RMS_TOL[BF16], f"rmsnorm {what}", "rmsnorm"),
        library_gap=max_gap(got, F.rms_norm(x, (d_,), weight=w1, eps=1e-5)), tol=RMS_TOL[BF16],
        ms=device_ms(lambda: kernels.rmsnorm(x, w, 1e-5)),
        plain_ms=device_ms(lambda: kernels.rmsnorm_plain(x, w, 1e-5)),
        library_ms=device_ms(lambda: F.rms_norm(x, (d_,), weight=w1, eps=1e-5)),
        bound_ms=(2 * 2 * rows_ * d_ + 2 * d_) / HBM_BPS * 1e3)
    check(hyb_rms[what]["library_gap"] <= RMS_TOL[BF16] * (1 + float(got.float().abs().max())),
          f"rmsnorm {what}: {hyb_rms[what]['library_gap']} from F.rms_norm")
    check(torch.equal(got.view(torch.int16), kernels.rmsnorm(x, w, 1e-5).view(torch.int16)),
          f"rmsnorm {what}: two calls differ")
del x, w, w1, got
emit("hybrid_kernels", card=smi, flash_attention_hd112=hd112_rows, sass_hd112=hd112_sass,
     times_hd112=hd112_times, rmsnorm=hyb_rms,
     method="as model_kernel_times; ms the kernel's span (trace), events_ms its launch by CUDA "
            "events, call_ms the whole call", tolerance="phase 6's")

# reduced zamba2-7b (8 layers at cadence 3: two groups and a tail of 2; once
# at head_dim 112) and reduced xlstm-125m, f32, flash: the weights and the
# CPU's forward from chip_smoke_cpu.py.  Stated bound, as phase 8b's: these
# random networks amplify f32 rounding (reduced zamba2's CPU logits lie
# about 2e-3 from an f64 forward of the same weights), so the card's max
# and norm gap to the f64 forward may be at most 3x the CPU's f32 gap (plus
# 1e-6); then 24 decode steps on the card against the card's own forward at
# tests/test_decode_consistency.py's bound (2e-2) with every argmax equal
hyb_parity = {}
for name, arch, over, seed in HYBRID_CASES:
    ref = cpu_ref(f"hybrid {name}")
    cfg_ = hybrid_config(arch, over)
    gp = tm.Model(cfg_, device="meta")
    gp.load_state_dict({key: torch.from_numpy(a_).to(DEV) for key, a_ in ref["state"].items()},
                       assign=True)
    toks_ = hybrid_tokens(cfg_, seed).to(DEV)
    kernels.reset_launch_counts()
    lg = tm.forward_logits(cfg_, gp, {"tokens": toks_}, last_only=False)
    exact = torch.from_numpy(ref["exact"])
    to_exact = {side: dict(max=float((l_.cpu().double() - exact).abs().max()),
                           norm=float(torch.linalg.vector_norm(l_.cpu().double() - exact)))
                for side, l_ in (("card", lg), ("cpu", torch.from_numpy(ref["logits"])))}
    check(all(to_exact["card"][m_] <= 3 * to_exact["cpu"][m_] + 1e-6 for m_ in ("max", "norm")),
          f"hybrid parity {name}: the card's forward_logits {to_exact['card']} from the f64 "
          f"forward, beyond 3x the CPU's f32 {to_exact['cpu']}")
    state_ = tm.init_decode_state(cfg_, toks_.shape[0], 25, dtype=F32, device=DEV)
    steps_ = []
    for t_ in range(24):
        l_, state_ = tm.decode_step(cfg_, gp, toks_[:, t_:t_ + 1], state_)
        steps_.append(l_[:, 0])
    dec = torch.stack(steps_, dim=1)
    fwd = lg[:, :24, : cfg_.vocab_size]
    check(bool(torch.allclose(dec, fwd, atol=2e-2, rtol=2e-2)) and torch.equal(dec.argmax(-1), fwd.argmax(-1)),
          f"hybrid parity {name}: decode against forward_logits {max_gap(dec, fwd)} (2e-2) or argmax")
    count_launches(kernels.launch_counts(), {
        flash_key(cfg_): flash_per_forward(cfg_),
        "rmsnorm": 25 * rms_per_pass(cfg_)}, f"hybrid parity {name}")
    hyb_parity[name] = dict(card_vs_cpu_max=max_gap(lg, torch.from_numpy(ref["logits"])),
                            gap_to_f64_forward=to_exact, decode_vs_forward_max=max_gap(dec, fwd),
                            cpu_forward_seconds=ref["seconds"])
    del gp, lg, dec, fwd, state_
emit("hybrid_parity", configs="zamba2-7b reduced (8 layers, d=128, shared cadence 3, hd 32 and 112), "
     "xlstm-125m reduced (4 layers, d=128), f32, flash; 3 x 192 tokens", cases=hyb_parity,
     bound="the card's max and norm gap to the f64 forward <= 3x the CPU's f32 (+1e-6); 24 decode "
           "steps against the card's forward within 2e-2, argmax equal")

# full-width zamba2-7b, all 81 layers (13 groups of 6, a tail of 3; the
# shared block at head_dim 112), bf16 parameters drawn on the card
free_gib("zamba2-7b, 81 layers, bf16", "hybrid_memory")
zcfg = dataclasses.replace(ZAMBA, params_dtype="bfloat16")
Z_GROUPS = zcfg.n_layers // zcfg.shared_attn_every
t0 = time.perf_counter()
zparams = tm.init_params(zcfg, torch.Generator(device=DEV).manual_seed(34), device=DEV)
torch.cuda.synchronize()
zinit_s = time.perf_counter() - t0
zcount = sum(p_.numel() for p_ in zparams.parameters())
check(zcount == 6_751_130_832, f"hybrid: zamba2-7b has {zcount} parameters")
ztoks = torch.from_numpy(np.random.default_rng(35).integers(2, zcfg.vocab_size, (4, 1024))).to(DEV)
torch.cuda.reset_peak_memory_stats()
kernels.reset_launch_counts()
zouts, zfwd_s, _ = forwards(zcfg, zparams, ztoks)
# the warm-ups and the two forwards: flash twice (its warm-up and forward)
count_launches(kernels.launch_counts(), {"flash_attention_hd112": 2 * Z_GROUPS,
                                         "rmsnorm": 4 * rms_per_pass(zcfg)}, "hybrid: zamba2-7b forward")
zgap = logit_gap(zouts["flash"], zouts["reference"])
del zouts
# the stated bound at two groups' depth (12 Mamba layers, the shared block
# twice): these layers' weights (shared, not copied) in bf16 with flash and
# with reference attention against an f32 copy of them, flash within 1.25x
# the reference's gap (phase 8's bound)
z2cfg = dataclasses.replace(zcfg, n_layers=2 * zcfg.shared_attn_every)
z2_state = {key: t for key, t in zparams.state_dict().items()
            if not key.startswith("mamba_") or key.startswith(("mamba_groups.0.", "mamba_groups.1."))}
z2 = tm.Model(z2cfg, device="meta")
z2.load_state_dict(z2_state, assign=True)
kernels.reset_launch_counts()
z2outs, _, _ = forwards(z2cfg, z2, ztoks)
z32cfg = dataclasses.replace(z2cfg, dtype="float32", params_dtype="float32")
z32 = tm.Model(z32cfg, device="meta")
z32.load_state_dict({key: t.float() for key, t in z2_state.items()}, assign=True)
z2truth = tm.forward_logits(z32cfg, z32, {"tokens": ztoks}, last_only=False)
count_launches(kernels.launch_counts(), {"flash_attention_hd112": 2 * 2,
                                         "rmsnorm": 5 * rms_per_pass(z2cfg)}, "hybrid: zamba2-7b at 2 groups")
z2gaps = against_f32(z2outs, z2truth, "zamba2-7b, first 2 groups")
z2gaps["flash_vs_reference"] = logit_gap(z2outs["flash"], z2outs["reference"])
del z2outs, z2truth
# serving by decode_step, as the JAX package serves these families: batch 8,
# a 64-token prompt fed token by token, then 32 greedy tokens, timed; each
# step's logits against forward_logits over the same 96 tokens at its
# position.  Stated bounds.  bf16: the decode path rounds at other places
# than the bf16 forward (an f32 conv window and SSD state, attention over
# the cache), so each may be as far from the f32 forward of the same
# weights as bf16 puts the forward: |decode - forward| <= 2.5x the
# forward's gap to the f32 forward (max and mean).  At 81 layers these
# random weights decorrelate every bf16 path from the f32 one (argmax
# agreement near chance), where that bound cannot tell a wrong decode from
# a right one, so it is held at two groups' depth on the same 96 tokens (a
# wrong state reads about 5x there) and the 81-layer bf16 gaps are printed.
# f32, 81 layers (an f32 copy of every layer, 27 GB), 16 steps: the chunked
# forward's cumulated decays (sums of dt * A over a chunk reach 1e4 with
# these weights) cost it f32 digits, so the f32 forward's own spread is
# measured, as its gap to the same forward in chunks of one token (the
# decode's recurrence written as the chunk math), and the decode held
# within 2.5x that spread (max and mean; a wrong state reads the logits'
# RMS, about 1)
ZP, ZN, ZB = 64, 32, 8
zprompt = torch.from_numpy(np.random.default_rng(36).integers(2, zcfg.vocab_size, (ZB, ZP))).to(DEV)
zstate = tm.init_decode_state(zcfg, ZB, ZP + ZN, dtype=BF16, device=DEV)
zseq, zdec, zstep_s = [zprompt[:, :1]], [], []
kernels.reset_launch_counts()
torch.cuda.synchronize()
for t_ in range(ZP + ZN):
    t0 = time.perf_counter()
    lgt, zstate = tm.decode_step(zcfg, zparams, zseq[-1], zstate)
    nxt = zprompt[:, t_ + 1:t_ + 2] if t_ + 1 < ZP else torch.argmax(lgt[:, -1], -1)[:, None]
    nxt[:, 0].tolist()
    zstep_s.append(time.perf_counter() - t0)
    zdec.append(lgt[:, 0].float())
    if t_ + 1 < ZP + ZN:
        zseq.append(nxt)
count_launches(kernels.launch_counts(), {"flash_attention_hd112": 0,
                                         "rmsnorm": (ZP + ZN) * rms_per_pass(zcfg)}, "hybrid: zamba2-7b decode")
zdec = torch.stack(zdec, dim=1)                                            # (8, 96, V)
zall = torch.cat(zseq, dim=1)
kernels.reset_launch_counts()
zfwd = tm.forward_logits(dataclasses.replace(zcfg, attention_impl="flash"), zparams,
                         {"tokens": zall}, last_only=False)[..., : zcfg.vocab_size]
z32full = tm.Model(dataclasses.replace(zcfg, dtype="float32", params_dtype="float32"), device="meta")
z32full.load_state_dict({key: t.float() for key, t in zparams.state_dict().items()}, assign=True)
ztruth = tm.forward_logits(dataclasses.replace(zcfg, dtype="float32", params_dtype="float32"), z32full,
                           {"tokens": zall}, last_only=False)[..., : zcfg.vocab_size]
count_launches(kernels.launch_counts(), {"flash_attention_hd112": Z_GROUPS,
                                         "rmsnorm": 2 * rms_per_pass(zcfg)}, "hybrid: zamba2-7b forward of 96")
zdec_gap, zfwd_truth = logit_gap(zdec, zfwd), logit_gap(zfwd, ztruth)
zdec_truth = logit_gap(zdec, ztruth)


def decode_run(cfg_, params_, toks_, dtype):
    """``decode_step`` over ``toks_`` from an empty state: the logits of
    every step (B, S, vocab_size) in f32."""
    st_, out_ = tm.init_decode_state(cfg_, toks_.shape[0], toks_.shape[1], dtype=dtype, device=DEV), []
    for t_ in range(toks_.shape[1]):
        l_, st_ = tm.decode_step(cfg_, params_, toks_[:, t_:t_ + 1], st_)
        out_.append(l_[:, 0].float())
    return torch.stack(out_, dim=1)


def decode_bound(dec, fwd, truth, what):
    """|decode - forward| within 2.5x the bf16 forward's gap to the f32
    forward (max and mean)."""
    gap_, ref_ = logit_gap(dec, fwd), logit_gap(fwd, truth)
    for stat in ("max", "mean"):
        check(gap_[stat] <= 2.5 * ref_[stat],
              f"{what}: decode against forward_logits, {stat} {gap_[stat]}, beyond 2.5x the "
              f"bf16 forward's gap to the f32 forward ({ref_[stat]})")
    return dict(vs_forward_logits=gap_, forward_vs_f32=ref_, decode_vs_f32=logit_gap(dec, truth))


# 81 layers in f32: 16 decode steps against the f32 forward
kernels.reset_launch_counts()
z32c = dataclasses.replace(zcfg, dtype="float32", params_dtype="float32")
zdec32 = decode_run(z32c, z32full, zall[:, :16], F32)
zfwd32, zfwd32_1 = (tm.forward_logits(dataclasses.replace(z32c, ssm_chunk=c_), z32full,
                                      {"tokens": zall[:, :16]}, last_only=False)[..., : zcfg.vocab_size]
                    for c_ in (16, 1))
zdepth81_f32 = dict(steps=16, vs_forward_logits=logit_gap(zdec32, zfwd32),
                    forward_spread=logit_gap(zfwd32_1, zfwd32), vs_forward_chunks_of_1=logit_gap(zdec32, zfwd32_1))
for stat in ("max", "mean"):
    check(zdepth81_f32["vs_forward_logits"][stat] <= 2.5 * zdepth81_f32["forward_spread"][stat],
          f"hybrid: zamba2-7b f32 decode against the f32 forward, {stat} {zdepth81_f32['vs_forward_logits']}, "
          f"beyond 2.5x the forward's spread {zdepth81_f32['forward_spread']}")
del z32full, zdec32, zfwd32, zfwd32_1
# two groups' depth in bf16 (z2 shares the weights; z32 their f32 copy)
z2dec = decode_run(z2cfg, z2, zall, BF16)
z2fwd = tm.forward_logits(dataclasses.replace(z2cfg, attention_impl="flash"), z2, {"tokens": zall},
                          last_only=False)[..., : zcfg.vocab_size]
z2truth96 = tm.forward_logits(z32cfg, z32, {"tokens": zall}, last_only=False)[..., : zcfg.vocab_size]
zdepth2 = decode_bound(z2dec, z2fwd, z2truth96, "hybrid: zamba2-7b at 2 groups")
count_launches(kernels.launch_counts(), {
    "flash_attention_hd112": 2,
    "rmsnorm": 18 * rms_per_pass(zcfg) + (ZP + ZN + 2) * rms_per_pass(z2cfg)}, "hybrid: zamba2-7b decode checks")
del z2, z32, z2_state, z2dec, z2fwd, z2truth96
zpeak_gib = torch.cuda.max_memory_allocated() / 2**30
# a traced decode window: 8 more steps past the 96 would overrun the cache,
# so 8 steps from a fresh state on the prompt's first 8 tokens
zstate = tm.init_decode_state(zcfg, ZB, 8, dtype=BF16, device=DEV)
kernels.reset_launch_counts()
torch.cuda.synchronize()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for t_ in range(8):
        lgt, zstate = tm.decode_step(zcfg, zparams, zprompt[:, t_:t_ + 1], zstate)
        torch.argmax(lgt[:, -1], -1).tolist()
    torch.cuda.synchronize()
    zwindow_s = time.perf_counter() - t0
zbusy = busy_us(prof)
count_launches(kernels.launch_counts(), {"rmsnorm": 8 * rms_per_pass(zcfg)}, "hybrid: traced decode")
del zdec, zfwd, ztruth, zall, zseq, zstate, lgt, prof
zsteps_ms = np.array(zstep_s) * 1e3
emit("hybrid_zamba", card=smi,
     config="zamba2-7b full width and depth: 81 Mamba2 layers (d=3,584, d_inner 7,168, 112 SSM heads "
            "of 64, state 64) in 13 groups of 6 and a tail of 3, ONE shared attention + MLP block "
            "(32/32 heads, hd=112, d_ff 14,336) after each group, vocab 32,000; bf16 parameters drawn "
            "on the card (seed 34), bf16 compute",
     params=zcount, param_gib_bf16=zcount * 2 / 2**30, init_seconds=zinit_s,
     forward_logits_tokens=4 * 1024, forward_logits_seconds=zfwd_s,
     forward_logits_tokens_per_s={impl: 4 * 1024 / s_ for impl, s_ in zfwd_s.items()},
     flash_vs_reference=zgap,
     first_2_groups=dict(gap_to_f32=z2gaps,
                         bound="flash's max and mean gap to the f32 forward <= 1.25x the reference's"),
     decode=dict(batch=ZB, prompt=ZP, new_tokens=ZN, steps=ZP + ZN,
                 depth_81_bf16_printed=dict(vs_forward_logits=zdec_gap, forward_vs_f32=zfwd_truth,
                                            decode_vs_f32=zdec_truth),
                 depth_81_f32=zdepth81_f32, depth_2_groups_bf16=zdepth2,
                 bound="at 2 groups, bf16: |decode - forward| <= 2.5x |forward - f32 forward|; at 81 "
                       "layers, f32: |decode - forward| <= 2.5x |forward - forward in chunks of 1| "
                       "(max, mean)",
                 step_p50_ms=float(np.median(zsteps_ms)), step_p99_ms=float(np.percentile(zsteps_ms, 99)),
                 tokens_per_s=ZB / float(np.median(zstep_s))),
     peak_device_gib=zpeak_gib, traced_decode_window_ms=zwindow_s * 1e3, device_busy_ms=zbusy / 1e3,
     device_busy_share=(zbusy / 1e6) / zwindow_s if zbusy else "not measured (empty trace)")
del zparams
gc.collect()
torch.cuda.empty_cache()

# full-width xlstm-125m (12 layers, sLSTM at 3, 7, 11), bf16 parameters:
# forward_logits on 4 x 1,024 tokens, then 32 decode steps of the same
# sequences against it at the bf16 bound stated for zamba2-7b, which holds
# here at full depth (the decode states are f32, so past the first sLSTM
# block the decode computes in f32, as the JAX package's does)
free_gib("xlstm-125m, 12 layers, bf16", "hybrid_memory")
xcfg = dataclasses.replace(XLSTM, params_dtype="bfloat16")
xparams = tm.init_params(xcfg, torch.Generator(device=DEV).manual_seed(37), device=DEV)
xcount = sum(p_.numel() for p_ in xparams.parameters())
check(xcount == 189_088_584, f"hybrid: xlstm-125m has {xcount} parameters")
xtoks = torch.from_numpy(np.random.default_rng(38).integers(2, xcfg.vocab_size, (4, 1024))).to(DEV)
kernels.reset_launch_counts()
tm.forward_logits(xcfg, xparams, {"tokens": xtoks})                       # warm-up
torch.cuda.synchronize()
t0 = time.perf_counter()
xfwd = tm.forward_logits(xcfg, xparams, {"tokens": xtoks}, last_only=False)[..., : xcfg.vocab_size]
torch.cuda.synchronize()
xfwd_s = time.perf_counter() - t0
check(bool(torch.isfinite(xfwd).all()), "hybrid: xlstm-125m logits not finite")
x32cfg = dataclasses.replace(xcfg, dtype="float32", params_dtype="float32")
x32 = tm.Model(x32cfg, device="meta")
x32.load_state_dict({key: t.float() for key, t in xparams.state_dict().items()}, assign=True)
xtruth = tm.forward_logits(x32cfg, x32, {"tokens": xtoks}, last_only=False)[:, :32, : xcfg.vocab_size]
del x32
XN = 32
xstate = tm.init_decode_state(xcfg, 4, XN, dtype=BF16, device=DEV)
xdec, xstep_s = [], []
for t_ in range(XN):
    t0 = time.perf_counter()
    lgt, xstate = tm.decode_step(xcfg, xparams, xtoks[:, t_:t_ + 1], xstate)
    torch.argmax(lgt[:, -1], -1).tolist()
    xstep_s.append(time.perf_counter() - t0)
    xdec.append(lgt[:, 0].float())
count_launches(kernels.launch_counts(), {"rmsnorm": (3 + XN) * rms_per_pass(xcfg)}, "hybrid: xlstm-125m")
xdec = torch.stack(xdec, dim=1)
xfwd32 = xfwd[:, :XN]
xgaps = decode_bound(xdec, xfwd32, xtruth, "hybrid: xlstm-125m")
xsteps_ms = np.array(xstep_s) * 1e3
emit("hybrid_xlstm", card=smi,
     config="xlstm-125m full width: 12 layers (mLSTM d_inner 1,536 over 4 heads of 384; sLSTM at 3, "
            "7, 11, 4 heads of 192, GeGLU 1,024), d=768, vocab 50,304; bf16 parameters (seed 37)",
     params=xcount, forward_logits_tokens=4 * 1024, forward_logits_seconds=xfwd_s,
     forward_logits_tokens_per_s=4 * 1024 / xfwd_s,
     decode=dict(batch=4, steps=XN, **xgaps,
                 bound="|decode - forward| <= 2.5x |forward - f32 forward| (max, mean)",
                 step_p50_ms=float(np.median(xsteps_ms)), step_p99_ms=float(np.percentile(xsteps_ms, 99)),
                 tokens_per_s=4 / float(np.median(xstep_s))))
del xparams, xfwd, xtruth, xdec, xfwd32, xstate, lgt
gc.collect()
torch.cuda.empty_cache()
emit("hybrid", seconds=time.perf_counter() - t_hyb)

# ---------------------------------------------------------------------------
# 8d. encdec: the encoder-decoder (seamless-m4t-medium) and the vision stub
# (internvl2-26b)
# ---------------------------------------------------------------------------
t_encdec = time.perf_counter()
SEAMLESS, INTERNVL = get_config("seamless-m4t-medium"), get_config("internvl2-26b")


def rms_per_forward(cfg_):
    """RMSNorm launches of one ``forward_logits``: 2 an encoder layer and the
    encoder's final norm, 3 a decoder layer with cross-attention, else 2,
    and the final norm."""
    if cfg_.encoder_decoder:
        return 2 * cfg_.n_encoder_layers + 1 + 3 * cfg_.n_layers + 1
    return 2 * cfg_.n_layers + 1


def rms_per_decode(cfg_):
    """RMSNorm launches of one ``decode_step`` (the decoder only)."""
    return (3 if cfg_.encoder_decoder else 2) * cfg_.n_layers + 1


def prime_cross(cfg_, params_, frames, state_):
    """Fill a decode state's cross caches from the encoder's output, as the
    JAX package's tests prime them (``_encoder_stack``, then each layer's
    ``encode_cross_kv``)."""
    pc_ = tm._cast(params_, cfg_)
    with torch.no_grad():
        enc_out = tm._encoder_stack(frames.to(tm.torch_dtype(cfg_.dtype)), pc_, cfg_)
        for i, lp_ in enumerate(pc_.layers):
            k_, v_ = encode_cross_kv(enc_out, lp_.cross, cfg_)
            state_.cross_k[i].copy_(k_)
            state_.cross_v[i].copy_(v_)
    return state_


def cut_depth(cfg_, params_, n_dec, n_enc=0):
    """The first ``n_dec`` decoder (and ``n_enc`` encoder) layers of a model,
    its weights shared, not copied."""
    c_ = dataclasses.replace(cfg_, n_layers=n_dec, n_encoder_layers=n_enc)
    keep = lambda key: ((not key.startswith(("layers.", "encoder.layers."))) or  # noqa: E731
                        (key.startswith("layers.") and int(key.split(".")[1]) < n_dec) or
                        (key.startswith("encoder.layers.") and int(key.split(".")[2]) < n_enc))
    m_ = tm.Model(c_, device="meta")
    m_.load_state_dict({key: t for key, t in params_.state_dict().items() if keep(key)}, assign=True)
    return c_, m_


# the flash forward at the new shapes against its plain version (phase 6's
# tolerances and bits): seamless's decoder (4 x 1,024, 16 heads on 16, hd
# 64), internvl2's prefix plus text (2 x 2,048, 48 on 8, hd 128), and the f32
# route at the reduced models' shapes (3 x 64, 4 on 4; 3 x 80, 4 on 2; hd 32)
encdec_rows = {name: flash_vs_plain(name, *shape) for name, shape in (
    ("bf16 seamless-m4t-medium 4 x 1,024, 16/16, hd 64", (4, 1024, 16, 16, 64, BF16, True)),
    ("bf16 internvl2-26b 2 x 2,048, 48/8, hd 128", (2, 2048, 48, 8, 128, BF16, True)),
    ("f32 reduced seamless-m4t-medium 3 x 64, 4/4, hd 32", (3, 64, 4, 4, 32, F32, True)),
    ("f32 reduced internvl2-26b 3 x 80, 4/2, hd 32", (3, 80, 4, 2, 32, F32, True)))}
# times: the kernel's own span (trace) and its launch by CUDA events, the
# whole call, the plain version, the library's call and the bound (bytes of
# q, k, v, o and lse; 4 hd flops a kept pair at the bf16 tensor-core rate)
encdec_times = {}
for what, b_, s_, h_, g_, hd_ in (("seamless-m4t-medium 4 x 1,024, 16/16, hd 64", 4, 1024, 16, 16, 64),
                                  ("internvl2-26b 2 x 2,048, 48/8, hd 128", 2, 2048, 48, 8, 128)):
    q, k, v = (torch.randn((b_, s_, n_, hd_), generator=gen, device=DEV).to(BF16) for n_ in (h_, g_, g_))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    work = (2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * b_ * h_ * s_,
            4 * hd_ * b_ * h_ * s_ * (s_ + 1) // 2, BF16_FLOPS)
    bound, by = bound_of(*work)
    call = lambda: kernels.flash_attention(q, k, v, causal=True)  # noqa: E731
    encdec_times[f"flash_attention {what}"] = dict(
        ms=kernel_ms(call, BF16_FWD)["fwd"],
        events_ms=launch_event_ms(call, {"fwd": BF16_FWD["fwd"][1]}, reps=10)["fwd"],
        call_ms=device_ms(call),
        plain_ms=device_ms(lambda: kernels.flash_attention_plain(q, k, v, causal=True), reps=10),
        library_ms=library_time(f"forward bf16, {what}", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), bound),
        bound_ms=bound, bound_by=by)
del q, k, v, qt, kt, vt
# RMSNorm at the new widths, 4,096 rows (a prefill's tokens), bf16: against
# its plain version and F.rms_norm, two calls the same bits, the times
for what, rows_, d_ in (("seamless-m4t-medium 4,096 x 1,024", 4096, 1024),
                        ("internvl2-26b 4,096 x 6,144", 4096, 6144)):
    x = torch.randn((rows_, d_), generator=gen, device=DEV).to(BF16)
    w = (0.1 * torch.randn((d_,), generator=gen, device=DEV)).to(BF16)
    w1 = 1.0 + w
    got = kernels.rmsnorm(x, w, 1e-5)
    row = dict(gap=within(got, kernels.rmsnorm_plain(x, w, 1e-5), RMS_TOL[BF16], f"rmsnorm {what}", "rmsnorm"),
               library_gap=max_gap(got, F.rms_norm(x, (d_,), weight=w1, eps=1e-5)), tol=RMS_TOL[BF16],
               ms=device_ms(lambda: kernels.rmsnorm(x, w, 1e-5)),
               plain_ms=device_ms(lambda: kernels.rmsnorm_plain(x, w, 1e-5)),
               library_ms=device_ms(lambda: F.rms_norm(x, (d_,), weight=w1, eps=1e-5)),
               bound_ms=(2 * 2 * rows_ * d_ + 2 * d_) / HBM_BPS * 1e3, bound_by="bytes")
    check(row["library_gap"] <= RMS_TOL[BF16] * (1 + float(got.float().abs().max())),
          f"rmsnorm {what}: {row['library_gap']} from F.rms_norm")
    check(torch.equal(got.view(torch.int16), kernels.rmsnorm(x, w, 1e-5).view(torch.int16)),
          f"rmsnorm {what}: two calls differ")
    encdec_times[f"rmsnorm {what}"] = row
del x, w, w1, got
emit("encdec_kernels", card=smi, flash_attention=encdec_rows, times=encdec_times,
     method="as model_kernel_times; ms the kernel's span (trace), events_ms its launch by CUDA "
            "events, call_ms the whole call", tolerance="phase 6's")

# reduced seamless-m4t-medium (4 decoder layers, 2 encoder layers) and
# internvl2-26b (4 layers, 16 patch positions), f32, flash: the weights, the
# inputs and the CPU's side from chip_smoke_cpu.py.  Phase 8c's bound: the
# card's max and norm gap to the f64 forward at most 3x the CPU's f32 (plus
# 1e-6); 24 decode steps against the card's own teacher-forced forward
# within 2e-2, every argmax equal (seamless over cross caches primed from
# its encoder; internvl2 text only, as the JAX package decodes it, against
# a forward with an empty patch prefix); then forward_train under remat
# "full" (phase 10's setting), its loss and gradient norm within phase 10's
# PARITY_TOL of the CPU's, and each gradient tensor's gap to the f64
# gradient at most 3x the CPU's (plus 1e-6 of its norm): these random
# networks (JAX's init, std 1/sqrt(L) in a stack) put the CPU's own f32
# gradients up to about 1e-2 from exact
encdec_parity = {}
for arch, seed in ENCDEC_CASES:
    ref = cpu_ref(f"encdec {arch}")
    cfg_ = encdec_config(arch)
    gp = tm.Model(cfg_, device="meta")
    gp.load_state_dict({key: torch.from_numpy(a_).to(DEV) for key, a_ in ref["state"].items()}, assign=True)
    batch_ = {key: t.to(DEV) for key, t in encdec_batch(cfg_, seed).items()}
    inputs_ = {key: t for key, t in batch_.items() if key != "labels"}
    toks_ = batch_["tokens"]
    kernels.reset_launch_counts()
    lg = tm.forward_logits(cfg_, gp, inputs_, last_only=False)
    exact = torch.from_numpy(ref["exact"])
    to_exact = {side: dict(max=float((l_.cpu().double() - exact).abs().max()),
                           norm=float(torch.linalg.vector_norm(l_.cpu().double() - exact)))
                for side, l_ in (("card", lg), ("cpu", torch.from_numpy(ref["logits"])))}
    check(all(to_exact["card"][m_] <= 3 * to_exact["cpu"][m_] + 1e-6 for m_ in ("max", "norm")),
          f"encdec parity {arch}: the card's forward_logits {to_exact['card']} from the f64 forward, "
          f"beyond 3x the CPU's f32 {to_exact['cpu']}")
    state_ = tm.init_decode_state(cfg_, toks_.shape[0], 25, dtype=F32, device=DEV,
                                  enc_len=ENCDEC_SHAPE[2])
    if cfg_.encoder_decoder:
        state_ = prime_cross(cfg_, gp, inputs_["frame_embeds"], state_)
        fwd = lg[:, :24, : cfg_.vocab_size]
    else:
        empty = inputs_["patch_embeds"][:, :0]
        fwd = tm.forward_logits(cfg_, gp, {"tokens": toks_, "patch_embeds": empty},
                                last_only=False)[:, :24, : cfg_.vocab_size]
    steps_ = []
    for t_ in range(24):
        l_, state_ = tm.decode_step(cfg_, gp, toks_[:, t_:t_ + 1], state_)
        steps_.append(l_[:, 0])
    dec = torch.stack(steps_, dim=1)
    check(bool(torch.allclose(dec, fwd, atol=2e-2, rtol=2e-2)) and torch.equal(dec.argmax(-1), fwd.argmax(-1)),
          f"encdec parity {arch}: decode against forward_logits {max_gap(dec, fwd)} (2e-2) or argmax")
    n_fwd = 1 if cfg_.encoder_decoder else 2
    count_launches(kernels.launch_counts(), {
        "flash_attention_f32": n_fwd * cfg_.n_layers,
        "rmsnorm": n_fwd * rms_per_forward(cfg_) + 24 * rms_per_decode(cfg_)
        + (2 * cfg_.n_encoder_layers + 1 if cfg_.encoder_decoder else 0)}, f"encdec parity {arch}")
    # forward_train: loss, gradient norm, gradients
    tcfg_ = encdec_config(arch, remat="full")
    kernels.reset_launch_counts()
    loss_, _ = tm.forward_train(tcfg_, gp, batch_)
    names_, leaves_ = zip(*gp.named_parameters())
    grads_ = torch.autograd.grad(loss_, leaves_)
    gnorm = float(torch.sqrt(sum(torch.sum(g_.double() ** 2) for g_ in grads_)))
    train_row = {"card": dict(loss=float(loss_.detach()), grad_norm=gnorm),
                 "cpu": dict(loss=ref["loss"], grad_norm=ref["grad_norm"]),
                 "f64": dict(loss=ref["loss64"], grad_norm=ref["grad_norm64"])}
    for key, tol in PARITY_TOL.items():
        a_, c_ = train_row["card"][key], train_row["cpu"][key]
        check(abs(a_ - c_) <= tol * (1 + abs(c_)),
              f"encdec parity {arch}: forward_train {key} card {a_} vs CPU {c_} (tol {tol})")
    worst = (0.0, None)
    for name_, g_ in zip(names_, grads_):
        g64 = torch.from_numpy(ref["grads64"][name_])
        card_gap = float(torch.linalg.vector_norm(g_.cpu().double() - g64))
        cpu_gap = float(torch.linalg.vector_norm(torch.from_numpy(ref["grads"][name_]).double() - g64))
        scale = float(torch.linalg.vector_norm(g64))
        check(card_gap <= 3 * cpu_gap + 1e-6 * scale,
              f"encdec parity {arch}: gradient {name_} {card_gap} from the f64 one, beyond 3x the "
              f"CPU's {cpu_gap} (+1e-6 of {scale})")
        if scale > 0 and card_gap / scale > worst[0]:
            worst = (card_gap / scale, name_)
    train_row["widest_gradient_rel_gap_to_f64"] = dict(tensor=worst[1], gap=worst[0])
    L_ = cfg_.n_layers
    count_launches(kernels.launch_counts(), {
        "flash_attention_f32": 2 * L_, "flash_attention_dq_f32": L_, "flash_attention_dkv_f32": L_,
        "flash_attention_dkv_reduce_f32": L_, "rmsnorm": 2 * rms_per_forward(cfg_)
        - (1 + (1 if cfg_.encoder_decoder else 0))}, f"encdec parity {arch} forward_train")
    encdec_parity[arch] = dict(card_vs_cpu_max=max_gap(lg, torch.from_numpy(ref["logits"])),
                               gap_to_f64_forward=to_exact, decode_vs_forward_max=max_gap(dec, fwd),
                               forward_train=train_row, cpu_forward_seconds=ref["seconds"])
    del gp, lg, dec, fwd, state_, grads_, loss_
emit("encdec_parity", configs="seamless-m4t-medium reduced (4 decoder + 2 encoder layers, d=128, "
     "4/4 heads, hd 32), internvl2-26b reduced (4 layers, d=128, 4/2 heads, hd 32, 16 patch "
     "positions); f32, flash; 3 x 64 tokens, 48 frame embeddings", cases=encdec_parity,
     bound="forward: the card's max and norm gap to the f64 forward <= 3x the CPU's f32 (+1e-6); 24 "
           "decode steps against the card's forward within 2e-2, argmax equal; forward_train (remat "
           "full): loss and gradient norm within PARITY_TOL of the CPU's, each gradient's gap to the "
           "f64 one <= 3x the CPU's (+1e-6 of its norm)", tolerance=PARITY_TOL)

# full-width seamless-m4t-medium, its own config (f32 parameters, bf16
# compute), flash: 4 x 1,024 frame embeddings and 4 x 1,024 text tokens
free_gib("seamless-m4t-medium, 12 + 12 layers, f32", "encdec_memory")
scfg = dataclasses.replace(SEAMLESS, attention_impl="flash")
t0 = time.perf_counter()
sparams = tm.init_params(scfg, torch.Generator(device=DEV).manual_seed(43), device=DEV)
torch.cuda.synchronize()
sinit_s = time.perf_counter() - t0
scount = sum(p_.numel() for p_ in sparams.parameters())
check(scount == 977_860_608, f"encdec: seamless-m4t-medium has {scount} parameters")
stoks = torch.from_numpy(np.random.default_rng(44).integers(2, scfg.vocab_size, (4, 1025))).to(DEV)
sframes = torch.randn((4, 1024, scfg.d_model), generator=torch.Generator(device=DEV).manual_seed(45),
                      device=DEV)
sin = {"frame_embeds": sframes}
torch.cuda.reset_peak_memory_stats()
kernels.reset_launch_counts()
souts, sfwd_s, _ = forwards(scfg, sparams, stoks[:, :-1], sin)
# the warm-ups and the two forwards: flash twice (its warm-up and forward),
# the encoder by reference attention (non-causal)
count_launches(kernels.launch_counts(), {"flash_attention": 2 * scfg.n_layers,
                                         "rmsnorm": 4 * rms_per_forward(scfg)}, "encdec: seamless forward")
sgap = logit_gap(souts["flash"], souts["reference"])
# (forward_train at full width and depth: phase 11c's training steps)
# the f32 forward of the same weights (f32 compute) at full depth, the bf16
# paths' gaps to it printed: these random weights (std 1/sqrt(12) in a
# stack) make each cross-attention nearly one-hot over the 1,024 frames, so
# a bf16 rounding picks other frames; on an H100 one decoder layer kept
# 57-63 % of the f32 forward's argmaxes, 1 + 1 layers 23 %, 4 + 4 layers 2 %
# and 12 + 12 none.  The stated bound is held at 1 encoder + 1 decoder
# layer: flash within 1.25x the reference attention's gap (phase 8's)
s32cfg = dataclasses.replace(scfg, dtype="float32")
kernels.reset_launch_counts()
struth = tm.forward_logits(s32cfg, sparams, {"tokens": stoks[:, :-1], **sin}, last_only=False)
sfull_gaps = {impl: logit_gap(o_, struth) for impl, o_ in souts.items()}
del souts, struth
s1cfg, s1 = cut_depth(scfg, sparams, 1, 1)
s1outs, _, _ = forwards(s1cfg, s1, stoks[:, :-1], sin)
s1truth = tm.forward_logits(dataclasses.replace(s1cfg, dtype="float32"), s1, {"tokens": stoks[:, :-1], **sin},
                            last_only=False)
s1gaps = against_f32(s1outs, s1truth, "seamless-m4t-medium, 1 + 1 layers")
s1gaps["flash_vs_reference"] = logit_gap(s1outs["flash"], s1outs["reference"])
del s1outs, s1truth
count_launches(kernels.launch_counts(), {
    "flash_attention": 2 * s1cfg.n_layers, "flash_attention_f32": scfg.n_layers + s1cfg.n_layers,
    "rmsnorm": rms_per_forward(scfg) + 5 * rms_per_forward(s1cfg)}, "encdec: seamless f32 forwards")


def encdec_decode(cfg_, params_, toks_, frames, dtype):
    """``decode_step`` over ``toks_`` from a state whose cross caches are
    primed from ``frames``: the logits of every step (B, S, vocab_size), f32."""
    st_ = prime_cross(cfg_, params_, frames, tm.init_decode_state(
        cfg_, toks_.shape[0], toks_.shape[1], dtype=dtype, device=DEV, enc_len=frames.shape[1]))
    out_ = []
    for t_ in range(toks_.shape[1]):
        l_, st_ = tm.decode_step(cfg_, params_, toks_[:, t_:t_ + 1], st_)
        out_.append(l_[:, 0].float())
    return torch.stack(out_, dim=1)


# served by decode_step: batch 4 over cross caches primed from the frames,
# the first text token then 32 greedy tokens, each step timed (bf16, full
# depth; its gaps to forward_logits over the fed tokens printed).  Held: the
# same tokens decoded in bf16 at 1 + 1 layers within 2.5x the bf16
# forward's gap to the f32 forward (8c's decode bound, max and mean), and in
# f32 at full depth against the f32 forward within 2e-2
# (tests/test_decode_consistency.py's bound), the argmax equal wherever the
# forward's top two logits lie more than 4e-2 apart (an H100 read 4.6e-3 at
# most, flash against reference attention in f32 8.9e-4)
SN = 32
kernels.reset_launch_counts()
sstate = prime_cross(scfg, sparams, sframes, tm.init_decode_state(scfg, 4, SN, dtype=BF16, device=DEV,
                                                                   enc_len=1024))
sseq, sdec, sstep_s = [stoks[:, :1]], [], []
spc = tm._cast(sparams, scfg)
torch.cuda.synchronize()
for t_ in range(SN):
    t0 = time.perf_counter()
    lgt, sstate = tm.decode_step(scfg, spc, sseq[-1], sstate)
    nxt = torch.argmax(lgt[:, -1], -1)[:, None]
    nxt[:, 0].tolist()
    sstep_s.append(time.perf_counter() - t0)
    sdec.append(lgt[:, 0].float())
    if t_ + 1 < SN:
        sseq.append(nxt)
count_launches(kernels.launch_counts(), {"flash_attention": 0, "rmsnorm": 2 * scfg.n_encoder_layers + 1
                                         + SN * rms_per_decode(scfg)}, "encdec: seamless decode")
kernels.reset_launch_counts()
sdec = torch.stack(sdec, dim=1)
sall = torch.cat(sseq, dim=1)
sfwd = tm.forward_logits(scfg, spc, {"tokens": sall, **sin}, last_only=False)[..., : scfg.vocab_size]
struth = tm.forward_logits(s32cfg, sparams, {"tokens": sall, **sin}, last_only=False)[..., : scfg.vocab_size]
sdec_full = dict(vs_forward_logits=logit_gap(sdec, sfwd), forward_vs_f32=logit_gap(sfwd, struth),
                 decode_vs_f32=logit_gap(sdec, struth))
del sfwd
s1truth = tm.forward_logits(dataclasses.replace(s1cfg, dtype="float32"), s1, {"tokens": sall, **sin},
                            last_only=False)[..., : scfg.vocab_size]
sdepth1 = decode_bound(encdec_decode(s1cfg, s1, sall, sframes, BF16),
                       tm.forward_logits(s1cfg, s1, {"tokens": sall, **sin}, last_only=False)[..., : scfg.vocab_size],
                       s1truth, "seamless-m4t-medium at 1 + 1 layers")
del s1, s1truth
s32dec = encdec_decode(s32cfg, sparams, sall, sframes, F32)
top2 = torch.topk(struth, 2, dim=-1).values
clear = (top2[..., 0] - top2[..., 1]) > 4e-2
sdepth_f32 = dict(vs_forward_logits=logit_gap(s32dec, struth), clear_positions=int(clear.sum()),
                  positions=int(clear.numel()))
check(bool(torch.allclose(s32dec, struth, atol=2e-2, rtol=2e-2))
      and torch.equal(s32dec.argmax(-1)[clear], struth.argmax(-1)[clear]),
      f"encdec: seamless f32 decode against the f32 forward {sdepth_f32} (2e-2) or an argmax")
del s32dec, top2, clear
speak_gib = torch.cuda.max_memory_allocated() / 2**30
# a traced decode window: 8 more steps from a fresh state over the same caches
sstate2 = tm.init_decode_state(scfg, 4, 8, dtype=BF16, device=DEV, enc_len=1024)
sstate2 = sstate2._replace(cross_k=sstate.cross_k, cross_v=sstate.cross_v)
torch.cuda.synchronize()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for t_ in range(8):
        lgt, sstate2 = tm.decode_step(scfg, spc, sall[:, t_:t_ + 1], sstate2)
        torch.argmax(lgt[:, -1], -1).tolist()
    torch.cuda.synchronize()
    swindow_s = time.perf_counter() - t0
sbusy = busy_us(prof)
count_launches(kernels.launch_counts(), {
    "flash_attention": scfg.n_layers + s1cfg.n_layers, "flash_attention_f32": scfg.n_layers + s1cfg.n_layers,
    "rmsnorm": 2 * rms_per_forward(scfg) + 2 * rms_per_forward(s1cfg)
    + (2 * s1cfg.n_encoder_layers + 1) + SN * rms_per_decode(s1cfg)
    + (2 * scfg.n_encoder_layers + 1) + (SN + 8) * rms_per_decode(scfg)},
    "encdec: seamless decode checks and window")
ssteps_ms = np.array(sstep_s) * 1e3
emit("encdec_seamless", card=smi,
     config="seamless-m4t-medium full width: 12 encoder + 12 decoder layers (cross-attention in "
            "each), d=1,024, 16/16 heads, hd=64, d_ff 4,096, vocab 256,206 (256,256 padded); f32 "
            "parameters (its config) drawn on the card (seed 43), bf16 compute, flash",
     params=scount, init_seconds=sinit_s, frame_embeds=[4, 1024], text_tokens=[4, 1024],
     forward_logits_seconds=sfwd_s,
     forward_logits_tokens_per_s={impl: 4 * 1024 / s_ for impl, s_ in sfwd_s.items()},
     flash_vs_reference=sgap, full_depth_gap_to_f32=sfull_gaps,
     depth_1_plus_1=dict(gap_to_f32=s1gaps,
                         bound="flash's max and mean gap to the f32 forward <= 1.25x the reference's"),
     decode=dict(batch=4, new_tokens=SN, enc_len=1024, depth_12_bf16_printed=sdec_full,
                 depth_1_plus_1_bf16=sdepth1, depth_12_f32=sdepth_f32,
                 bound="at 1 + 1 layers, bf16: |decode - forward| <= 2.5x |forward - f32 forward| (max, "
                       "mean); at full depth, f32: |decode - f32 forward| <= 2e-2 (1 + |forward|), the "
                       "argmax equal where the forward's top two lie 4e-2 apart",
                 step_p50_ms=float(np.median(ssteps_ms)), step_p99_ms=float(np.percentile(ssteps_ms, 99)),
                 tokens_per_s=4 / float(np.median(sstep_s))),
     peak_device_gib=speak_gib, traced_decode_window_ms=swindow_s * 1e3, device_busy_ms=sbusy / 1e3,
     device_busy_share=(sbusy / 1e6) / swindow_s if sbusy else "not measured (empty trace)")
del sparams, spc, sstate, sstate2, sdec, struth, sall, sseq, sframes, lgt, prof
gc.collect()
torch.cuda.empty_cache()

# full-width internvl2-26b, all 48 layers, bf16 parameters (the f32 copy
# would be 79.5 GB) drawn on the card, flash: 2 x (1,024 patch embeddings +
# 1,024 text tokens)
free_gib("internvl2-26b, 48 layers, bf16", "encdec_memory")
icfg = dataclasses.replace(INTERNVL, params_dtype="bfloat16", attention_impl="flash")
t0 = time.perf_counter()
iparams = tm.init_params(icfg, torch.Generator(device=DEV).manual_seed(46), device=DEV)
torch.cuda.synchronize()
iinit_s = time.perf_counter() - t0
icount = sum(p_.numel() for p_ in iparams.parameters())
check(icount == 19_862_722_560, f"encdec: internvl2-26b has {icount} parameters")
itoks = torch.from_numpy(np.random.default_rng(47).integers(2, icfg.vocab_size, (2, 1025))).to(DEV)
iin = {"patch_embeds": torch.randn((2, icfg.n_prefix_tokens, icfg.d_model), device=DEV,
                                   generator=torch.Generator(device=DEV).manual_seed(48))}
torch.cuda.reset_peak_memory_stats()
kernels.reset_launch_counts()
iouts, ifwd_s, _ = forwards(icfg, iparams, itoks[:, :-1], iin)
igap = logit_gap(iouts["flash"], iouts["reference"])
# (forward_train at full width: phase 11c's training steps)
count_launches(kernels.launch_counts(), {"flash_attention": 2 * icfg.n_layers,
                                         "rmsnorm": 4 * rms_per_forward(icfg)}, "encdec: internvl2 forward")
kernels.reset_launch_counts()
del iouts
# the stated bound at depth 4: those layers' weights (shared) in bf16 with
# flash and with reference attention against an f32 copy of them (6.2 GB
# of layers, 4.6 GB of embedding and head)
i4cfg, i4 = cut_depth(icfg, iparams, 4)
i4outs, _, _ = forwards(i4cfg, i4, itoks[:, :-1], iin)
i32cfg = dataclasses.replace(i4cfg, dtype="float32", params_dtype="float32")
i32 = tm.Model(i32cfg, device="meta")
i32.load_state_dict({key: t.float() for key, t in i4.state_dict().items()}, assign=True)
i4truth = tm.forward_logits(i32cfg, i32, {"tokens": itoks[:, :-1], **iin}, last_only=False)
i4gaps = against_f32(i4outs, i4truth, "internvl2-26b, first 4 layers")
i4gaps["flash_vs_reference"] = logit_gap(i4outs["flash"], i4outs["reference"])
del i4, i32, i4outs, i4truth
count_launches(kernels.launch_counts(), {"flash_attention": 2 * i4cfg.n_layers,
                                         "flash_attention_f32": i4cfg.n_layers,
                                         "rmsnorm": 5 * rms_per_forward(i4cfg)}, "encdec: internvl2 at depth 4")
# the serving engine, the vision stub served as text only (as the JAX
# package serves it): 8 requests of 64-512 prompt tokens, 32 new tokens
# each, batch 8
irng = np.random.default_rng(49)
iprompts = [irng.integers(2, icfg.vocab_size, int(n_)) for n_ in irng.integers(64, 513, 8)]
prefill_s, decode_s = [], []
kernels.reset_launch_counts()
ieng = timed(ServingEngine(icfg, iparams, ServeConfig(max_batch=8, max_len=1024)))
for i, prompt in enumerate(iprompts):
    ieng.submit(f"req{i}", prompt, max_new=32)
idone = ieng.run_until_drained()
check(sorted(idone) == sorted(f"req{i}" for i in range(8)), f"encdec serve: completed {sorted(idone)}")
for rid, out in idone.items():
    check(1 <= len(out) <= 32 and all(0 <= t_ < icfg.vocab_size for t_ in out),
          f"encdec serve: {rid} returned {len(out)} tokens or an id outside the vocabulary")
count_launches(kernels.launch_counts(), {"flash_attention": 0,
                                         "rmsnorm": rms_per_forward(icfg) * (len(prefill_s) + len(decode_s))},
               "encdec: internvl2 engine")
ipre, idec = list(prefill_s), [t_ for t_, _ in decode_s]
kernels.reset_launch_counts()
ipeak_gib = torch.cuda.max_memory_allocated() / 2**30
# a traced decode window: 8 steps on a cache primed with each prompt's
# first 64 tokens
wave = torch.from_numpy(np.stack([p_[:64] for p_ in iprompts])).to(DEV)
lgt, st = tm.prefill(icfg, iparams, wave, 128)
nxt = torch.argmax(lgt[:, -1, :], -1)[:, None]
torch.cuda.synchronize()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(8):
        lgt, st = tm.decode_step(icfg, iparams, nxt, st)
        nxt = torch.argmax(lgt[:, -1, :], -1)[:, None]
        nxt[:, 0].tolist()
    torch.cuda.synchronize()
    iwindow_s = time.perf_counter() - t0
ibusy = busy_us(prof)
count_launches(kernels.launch_counts(), {"flash_attention": 0, "rmsnorm": 9 * rms_per_forward(icfg)},
               "encdec: internvl2 traced window")
emit("encdec_internvl2", card=smi,
     config="internvl2-26b full width: 48 layers, d=6,144, 48/8 heads, hd=128, d_ff 16,384, vocab "
            "92,553 (92,672 padded), 1,024 patch positions (the vision frontend a stub); bf16 "
            "parameters drawn on the card (seed 46), bf16 compute, flash",
     params=icount, param_gib_bf16=icount * 2 / 2**30, init_seconds=iinit_s,
     patch_embeds=[2, 1024], text_tokens=[2, 1024], forward_logits_seconds=ifwd_s,
     forward_logits_tokens_per_s={impl: 2 * 2048 / s_ for impl, s_ in ifwd_s.items()},
     flash_vs_reference=igap,
     first_4_layers=dict(gap_to_f32=i4gaps,
                         bound="flash's max and mean gap to the f32 forward <= 1.25x the reference's"),
     serve=dict(requests=8, prompt_lens=[len(p_) for p_ in iprompts], max_new=32,
                tokens_returned=sum(len(o_) for o_ in idone.values()), **serve_figures(ipre, idec)),
     peak_device_gib=ipeak_gib, traced_decode_window_ms=iwindow_s * 1e3, device_busy_ms=ibusy / 1e3,
     device_busy_share=(ibusy / 1e6) / iwindow_s if ibusy else "not measured (empty trace)")
del iparams, ieng, lgt, st, nxt, wave, prof
gc.collect()
torch.cuda.empty_cache()
emit("encdec", seconds=time.perf_counter() - t_encdec)

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


#: the head layouts phase 11c trains at full width: seamless-m4t-medium's
#: decoder (hd 64, 16 on 16), moonshot-v1-16b-a3b (hd 128, 16 on 16),
#: arctic-480b (56 on 8: the reduction over groups of 7) and internvl2-26b
#: (48 on 8, patches and text); B, S, H, G, hd
TRAIN_LAYOUTS = {
    "seamless-m4t-medium train 4 x 1,024, 16/16, hd 64": (4, 1024, 16, 16, 64),
    "moonshot-v1-16b-a3b train 4 x 1,024, 16/16, hd 128": (4, 1024, 16, 16, 128),
    "arctic-480b train 4 x 1,024, 56/8, hd 128": (4, 1024, 56, 8, 128),
    "internvl2-26b train 2 x 2,048, 48/8, hd 128": (2, 2048, 48, 8, 128)}
bwd_cases = [  # name, B, S, H, G, hd, dtype, causal
    ("qwen2-1.5b train", 2, 4096, 12, 2, 128, BF16, True),
    ("gemma-2b", 1, 1024, 8, 1, 256, BF16, True),
    ("ragged S=1000", 2, 1000, 12, 2, 128, BF16, True),
    ("full", 2, 512, 12, 2, 128, BF16, False),
    ("f32 S=77", 2, 77, 4, 2, 64, F32, True),
    ("f32 1x2048", 1, 2048, 12, 2, 128, F32, True),
    ("f32 gemma-2b", 1, 1024, 8, 1, 256, F32, True),
    # head_dim 112 (the hd-128 tiling over rows zero padded past 112):
    # zamba2-7b's shared block in training (32 heads, no grouping), ragged,
    # full, and the f32 route at S=77 and 1 x 1,024
    ("hd 112 zamba2-7b train 4 x 1,024", 4, 1024, 32, 32, 112, BF16, True),
    ("hd 112 ragged S=1000", 2, 1000, 32, 32, 112, BF16, True),
    ("hd 112 full", 2, 512, 32, 32, 112, BF16, False),
    ("hd 112 f32 S=77", 2, 77, 32, 32, 112, F32, True),
    ("hd 112 f32 1 x 1,024", 1, 1024, 32, 32, 112, F32, True),
] + [(name, *shape, BF16, True) for name, shape in TRAIN_LAYOUTS.items()]
#: the dq and dk/dv kernels (and the reduction over grouped heads) each type
#: routes to: bf16 the tensor cores, f32 the CUDA cores; dq's and dk/dv's
#: hd-112 instantiations count under their own keys (``bwd_route``)
DQ_ROUTE = {BF16: "flash_attention_dq", F32: "flash_attention_dq_f32"}
DKV_ROUTE = {BF16: ("flash_attention_dkv", "flash_attention_dkv_reduce"),
             F32: ("flash_attention_dkv_f32", "flash_attention_dkv_reduce_f32")}


def bwd_route(dt, hd_):
    """(dq, dk/dv, reduction) counters of the backward of type ``dt`` at
    head_dim ``hd_``."""
    tag = "_hd112" if hd_ == 112 else ""
    return (DQ_ROUTE[dt] + tag, DKV_ROUTE[dt][0] + tag, DKV_ROUTE[dt][1])


BWD_KEYS = sorted({key for t_ in (BF16, F32) for hd_ in (112, 128) for key in bwd_route(t_, hd_)})
bwd_rows = {}
for name, b_, s_, h_, g_, hd_, dt, causal in bwd_cases:
    q, k, v, do = (torch.randn((b_, s_, n_, hd_), generator=gen, device=DEV).to(dt)
                   for n_ in (h_, g_, g_, h_))
    o, lse = kernels.flash_attention_plain(q, k, v, causal=causal)
    kernels.reset_launch_counts()
    got = kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    counts = kernels.launch_counts()
    route = bwd_route(dt, hd_)
    check(all(counts[key] == (1 if key in route else 0) for key in BWD_KEYS),
          f"backward {name}: not the route {route}: {[(key, counts[key]) for key in BWD_KEYS]}")
    want = kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    row = {}
    # no atomics: a second call gives the same bits
    again = kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    bits = torch.int16 if dt == BF16 else torch.int32
    check(all(torch.equal(a_.view(bits), b_.view(bits)) for a_, b_ in zip(got, again)),
          f"backward {name}: two calls differ")
    row["two_calls_bitwise_equal"] = True
    del again
    for grad, kname, g_k, g_p in zip(("dq", "dk", "dv"), route[:1] + route[1:2] * 2, got, want):
        check(g_k.dtype == dt and g_k.shape == g_p.shape, f"backward {name} {grad}: type or shape")
        gap = within(g_k, g_p, BWD_TOL[dt], f"backward {name} {grad}", kname)
        k64, p64 = g_k.double(), g_p.double()
        rms = float(torch.sqrt(torch.mean(p64 * p64)))
        rel = float(torch.linalg.vector_norm(k64 - p64) / torch.linalg.vector_norm(p64))
        check(rel <= BWD_REL[dt], f"backward {name} {grad}: relative gap {rel} beyond {BWD_REL[dt]}")
        row[grad] = dict(max_gap=gap, rel_gap=rel, rms_plain=rms)
        del k64, p64
    bwd_rows[name] = dict(row, tol=BWD_TOL[dt], rel_tol=BWD_REL[dt])
    if name in TRAIN_LAYOUTS:
        # the reduction exactly its plain version on partials of this shape
        parts = [torch.randn((b_ * h_, s_, hd_), generator=gen, device=DEV) for _ in range(2)]
        for a_, p_, what in zip(kernels.flash_attention_dkv_reduce(*parts, b_ * g_),
                                kernels.flash_attention_dkv_reduce_plain(*parts, b_ * g_), ("dk", "dv")):
            same(a_, p_, f"dk/dv reduction {name} {what}", "flash_attention_dkv_reduce")
        bwd_rows[name]["reduction_bitwise_equal"] = True
        del parts
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
# the reduction against its plain version (the same sums in the same
# order: exactly equal) on partials of the training shape
parts = [torch.randn((B_T * 12, S_T, 128), generator=gen, device=DEV) for _ in range(2)]
red = kernels.flash_attention_dkv_reduce(*parts, B_T * 2)
red_p = kernels.flash_attention_dkv_reduce_plain(*parts, B_T * 2)
for a_, b_, what in zip(red, red_p, ("dk", "dv")):
    same(a_, b_, f"dk/dv reduction {what}", "flash_attention_dkv_reduce")
# the kernel's own spans (one run read a per-call median below the bytes
# bound from the whole trace): kernel_ms matches it by name
red_ms = kernel_ms(lambda: kernels.flash_attention_dkv_reduce(*parts, B_T * 2),
                   {"reduce": ("dkv_reduce", "flash_attention_dkv_reduce_launch")})["reduce"]
red_pms = device_ms(lambda: kernels.flash_attention_dkv_reduce_plain(*parts, B_T * 2), reps=10)
# the library's call for the same sums: torch.sum over the group axis of
# each partial (two calls, dk and dv; their f32 results, no cast to bf16),
# by the trace and by CUDA events
red_lib_ms = library_time(
    "dk/dv reduction, 2 x 4,096 (two torch.sum over the group axis)",
    lambda: [p_.view(B_T * 2, 6, S_T, 128).sum(1) for p_ in parts],
    bound_of(2 * 4 * B_T * 12 * S_T * 128 + 2 * 4 * B_T * 2 * S_T * 128,
             2 * B_T * 10 * S_T * 128)[0], reps=10)
del parts, red, red_p
BWD_NAMES = {"dq": ("flash_bwd_dq_wgmma", "flash_attention_dq_bf16_launch"),
             "dkv": ("dkv_wgmma", "flash_attention_dkv_bf16_launch")}
bwd_ms = kernel_ms(lambda: kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=True), BWD_NAMES)
bwd_plain_ms = device_ms(lambda: kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True),
                         reps=10)
qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
sdpa_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
dot = do.transpose(1, 2)
pairs_t = B_T * 12 * S_T * (S_T + 1) // 2          # (query, key) pairs the causal mask keeps
io_q = 2 * B_T * S_T * 12 * 128                     # bytes of one bf16 (B,S,H,hd) tensor
io_kv = 2 * B_T * S_T * 2 * 128
rows_f32 = 4 * B_T * 12 * S_T                       # bytes of lse or delta
# the library's whole backward: S, dP, dV, dK and dQ, 10*hd flops a kept
# pair; q, k, v, o, do and lse in, dq, dk, dv out
lib_bwd_ms = library_time(
    "backward bf16, 2 x 4,096 (dq, dk, dv)",
    lambda: torch.autograd.grad(sdpa_o, (qt, kt, vt), dot, retain_graph=True),
    bound_of(4 * io_q + 4 * io_kv + rows_f32, 10 * 128 * pairs_t, BF16_FLOPS)[0], reps=10)
record("flash_attention_dq", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
       "src/repro/kernels/flash_attention.py:152", bwd_ms["dq"], bwd_plain_ms,
       2 * io_q + 2 * io_kv + 2 * rows_f32 + io_q, 6 * 128 * pairs_t, flops=BF16_FLOPS,
       library_ms=lib_bwd_ms)
record("flash_attention_dkv", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
       "src/repro/kernels/flash_attention.py:191", bwd_ms["dkv"], bwd_plain_ms,
       2 * io_q + 2 * io_kv + 2 * rows_f32 + 2 * io_kv, 8 * 128 * pairs_t, flops=BF16_FLOPS,
       library_ms=lib_bwd_ms)
# the reduction: f32 partials of 12 heads in, bf16 dk and dv of 2 heads
# out; the library's two torch.sum calls do the sums (and leave them f32)
record("flash_attention_dkv_reduce", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
       "src/repro/kernels/flash_attention.py:191", red_ms, red_pms,
       2 * 4 * B_T * 12 * S_T * 128 + 2 * io_kv, 2 * B_T * 12 * S_T * 128,
       library_ms=red_lib_ms)
# the same launches timed by CUDA events, kernel_ms's fallback, so that
# path runs on every card and its reading stands beside the trace's
bwd_event_ms = launch_event_ms(lambda: kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=True),
                               {key: sym for key, (_, sym) in BWD_NAMES.items()}, reps=10)
fwd_t_ms = device_ms(lambda: kernels.flash_attention_fwd(q, k, v, causal=True), reps=10)
fwd_t_lib_ms = library_time(
    "forward bf16, 2 x 4,096", lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                      enable_gqa=True),
    bound_of(2 * io_q + 2 * io_kv + rows_f32, 4 * 128 * pairs_t, BF16_FLOPS)[0], reps=10)
emit("train_kernel_times", card=smi, shape="B=2, S=4,096, H=12, G=2, hd=128, bf16, causal",
     method="device time per call (trace), median of 10; plain_ms and library_ms compute "
            "dq, dk and dv together (the plain backward; the backward of "
            "scaled_dot_product_attention through torch.autograd.grad)",
     **{r: {key: records[r][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in ("flash_attention_dq", "flash_attention_dkv", "flash_attention_dkv_reduce")},
     event_timed_ms=bwd_event_ms, forward_ms_at_this_shape=fwd_t_ms,
     forward_library_ms_at_this_shape=fwd_t_lib_ms,
     forward_bound_ms=4 * 128 * pairs_t / BF16_FLOPS * 1e3)
del q, k, v, do, o, lse, qt, kt, vt, sdpa_o, dot

# the same readings at phase 11c's training layouts: each kernel's span
# (trace) and its launch by CUDA events, the plain backward and the
# library's (dq, dk and dv together), the reduction's plain version and two
# torch.sum, each beside its bound (bytes or operations at the bf16 rate)
layout_times = {}
for name, (b_, s_, h_, g_, hd_) in TRAIN_LAYOUTS.items():
    q, k, v, do = (torch.randn((b_, s_, n_, hd_), generator=gen, device=DEV).to(BF16)
                   for n_ in (h_, g_, g_, h_))
    o, lse = kernels.flash_attention_fwd(q, k, v, causal=True)
    call = lambda: kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=True)  # noqa: E731
    ms = kernel_ms(call, dict(BWD_NAMES, reduce=("dkv_reduce", "flash_attention_dkv_reduce_launch")))
    ev_ms = launch_event_ms(call, {key: sym for key, (_, sym) in BWD_NAMES.items()}, reps=10)
    plain_ms = device_ms(lambda: kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True),
                         reps=5, warmup=1)
    pairs = b_ * h_ * s_ * (s_ + 1) // 2
    io_q, io_kv, rows_b = 2 * b_ * s_ * h_ * hd_, 2 * b_ * s_ * g_ * hd_, 4 * b_ * h_ * s_
    work = {"dq": (2 * io_q + 2 * io_kv + 2 * rows_b + io_q, 6 * hd_ * pairs, BF16_FLOPS),
            "dkv": (2 * io_q + 2 * io_kv + 2 * rows_b + 2 * io_kv, 8 * hd_ * pairs, BF16_FLOPS),
            "reduce": (2 * 4 * b_ * h_ * s_ * hd_ + 2 * io_kv, 2 * b_ * h_ * s_ * hd_, None)}
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    sdpa_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_ms = library_time(f"backward bf16, {name} (dq, dk, dv)",
                          lambda: torch.autograd.grad(sdpa_o, (qt, kt, vt), do.transpose(1, 2),
                                                      retain_graph=True),
                          bound_of(4 * io_q + 4 * io_kv + rows_b, 10 * hd_ * pairs, BF16_FLOPS)[0],
                          reps=10)
    parts = [torch.randn((b_ * h_, s_, hd_), generator=gen, device=DEV) for _ in range(2)]
    red_plain_ms = device_ms(lambda: kernels.flash_attention_dkv_reduce_plain(*parts, b_ * g_), reps=10)
    red_lib_ms = library_time(
        f"dk/dv reduction, {name} (two torch.sum over the group axis)",
        lambda: [p_.view(b_ * g_, h_ // g_, s_, hd_).sum(1) for p_ in parts],
        bound_of(*work["reduce"][:2])[0], reps=10)
    layout_times[name] = {key: dict(ms=ms[key], events_ms=ev_ms.get(key),
                                    bound_ms=bound_of(*work[key])[0], bound_by=bound_of(*work[key])[1])
                          for key in work}
    layout_times[name].update(plain_ms_dq_dk_dv=plain_ms, library_ms_dq_dk_dv=lib_ms,
                              reduce_plain_ms=red_plain_ms, reduce_library_ms=red_lib_ms)
    del q, k, v, do, o, lse, qt, kt, vt, sdpa_o, parts
emit("train_kernel_times_layouts", card=smi,
     method="ms: the kernel's span (trace), median of 10; events_ms: its launch by CUDA events; "
            "plain_ms and library_ms compute dq, dk and dv together (library: the backward of "
            "scaled_dot_product_attention, by the trace unless under its bound; both readings in "
            "the library_readings line)", **layout_times)
torch.cuda.empty_cache()

# the f32 route (CUDA cores, full f32; bound by the f32 rate): dq, dk/dv
# and its reduction at 1 x 2,048 (the kernels line's shape) and at 2 x 4,096
# (phase 11's f32 first step), each against one library call for the same
# function, the backward of scaled_dot_product_attention with TF32 off
F32_BWD_NAMES = {"dq": ("flash_bwd_dq_f32", "flash_attention_dq_f32_launch"),
                 "dkv": ("flash_bwd_dkv_f32", "flash_attention_dkv_f32_launch"),
                 "reduce": ("dkv_reduce_f32", "flash_attention_dkv_reduce_f32_launch")}
F32_BWD = {"dq": "flash_attention_dq_f32", "dkv": "flash_attention_dkv_f32",
           "reduce": "flash_attention_dkv_reduce_f32"}
F32_SHAPES = ((1, 2048, 12, 2, 128), (2, 4096, 12, 2, 128),
              # phase 10's: one step of reduced qwen2-1.5b, 4 x 128 tokens
              (4, 128, rcfg.n_heads, rcfg.n_kv_heads, rcfg.head_dim))
f32_times = {}
for b_, s_, h_, g_, hd_ in F32_SHAPES:
    q, k, v, do = (torch.randn((b_, s_, n_, hd_), generator=gen, device=DEV) for n_ in (h_, g_, g_, h_))
    o, lse = kernels.flash_attention_fwd(q, k, v, causal=True)
    reps_ = 5 if s_ > 2048 else 10
    ms = kernel_ms(lambda: kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=True), F32_BWD_NAMES,
                   reps=reps_)
    plain_ms = device_ms(lambda: kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True),
                         reps=reps_)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    sdpa_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    pairs_ = b_ * h_ * s_ * (s_ + 1) // 2           # (query, key) pairs the causal mask keeps
    head = 4 * b_ * s_ * hd_                         # bytes of one head's f32 (S, hd) rows, per batch
    rows_ = 2 * 4 * b_ * h_ * s_                     # lse and delta
    lib_ms = library_time(
        f"backward f32, {b_} x {s_:,} (dq, dk, dv)",
        lambda: torch.autograd.grad(sdpa_o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
        bound_of(head * (3 * h_ + 2 * g_ + h_ + 2 * g_) + rows_ // 2, 10 * hd_ * pairs_)[0], reps=reps_)
    # the reduction alone, on the plain dk/dv partials of these inputs,
    # against its plain version (the same sums in the same order: exactly
    # equal), beside two torch.sum calls (dk and dv) over the same partials
    parts = kernels.flash_attention_dkv_partials_plain(q, k, v, o, lse, do, causal=True)
    red = kernels.flash_attention_dkv_reduce(*parts, b_ * g_, F32)
    for a_, w_, what in zip(red, kernels.flash_attention_dkv_reduce_plain(*parts, b_ * g_, F32), ("dk", "dv")):
        same(a_, w_, f"f32 dk/dv reduction {what} at {b_} x {s_}", "flash_attention_dkv_reduce_f32")
    red_pms = device_ms(lambda: kernels.flash_attention_dkv_reduce_plain(*parts, b_ * g_, F32), reps=reps_)
    sum_ms = device_ms(lambda: [p_.view(b_ * g_, h_ // g_, s_, hd_).sum(1) for p_ in parts], reps=reps_)
    bound = {  # (bytes, operations): each input read once, each output written once
        "dq": (head * (3 * h_ + 2 * g_) + rows_, 6 * hd_ * pairs_),
        "dkv": (head * (2 * h_ + 2 * g_ + 2 * h_) + rows_, 8 * hd_ * pairs_),
        "reduce": (head * (2 * h_ + 2 * g_), 2 * b_ * (h_ - g_) * s_ * hd_)}
    row = {}
    for key, (bytes_, ops_) in bound.items():
        t_bytes, t_ops = bytes_ / HBM_BPS * 1e3, ops_ / FP32_FLOPS * 1e3
        row[key] = dict(ms=ms[key], bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations")
    f32_times[f"B={b_}, S={s_}, H={h_}, G={g_}, hd={hd_}"] = dict(
        row, plain_ms_dq_dk_dv=plain_ms, library_ms_dq_dk_dv=lib_ms, reduce_plain_ms=red_pms,
        reduce_library_two_torch_sum_ms=sum_ms, dq_dkv_reduce_ms=ms["dq"] + ms["dkv"] + ms["reduce"])
    if s_ == 2048:                                   # the kernels line
        for key, name in F32_BWD.items():
            record(name, "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention.py:" + ("152" if key == "dq" else "191"),
                   ms[key], red_pms if key == "reduce" else plain_ms, *bound[key],
                   library_ms=None if key == "reduce" else lib_ms)
    del q, k, v, do, o, lse, qt, kt, vt, sdpa_o, parts, red
emit("train_kernel_times_f32", card=smi,
     method="device time per call (trace), median of 10 calls (5 at 2 x 4,096); plain_ms and "
            "library_ms compute dq, dk and dv together (the plain backward; the backward of "
            "scaled_dot_product_attention, TF32 off); the reduction's own plain version, and two "
            "torch.sum calls (dk, dv) over the same partials",
     **f32_times)
torch.cuda.empty_cache()

# head_dim 112 at zamba2-7b's training shape (bf16, 4 x 1,024, H = G = 32,
# causal) and on the f32 route at 1 x 1,024: dq and dk/dv by their spans
# (trace) and launches (CUDA events), the plain backward, the library's
# backward (scaled_dot_product_attention through autograd, by the trace and
# by CUDA events), each kernel's bound; the reduction (a cast at H = G)
# against its plain version, exactly, and timed.  Phase 2's SASS and ptxas
# readings of the hd-112 instantiations stand beside them
hd112_bwd_times = {}
for dt, b_, route_name in ((BF16, 4, "bf16"), (F32, 1, "f32")):
    q, k, v, do = (torch.randn((b_, 1024, 32, 112), generator=gen, device=DEV).to(dt) for _ in range(4))
    o, lse = kernels.flash_attention_fwd(q, k, v, causal=True)
    names = BWD_NAMES if dt == BF16 else F32_BWD_NAMES
    call = lambda: kernels.flash_attention_bwd(q, k, v, o, lse, do, causal=True)  # noqa: E731
    ms = kernel_ms(call, {key: names[key] for key in ("dq", "dkv")})
    ev_ms = launch_event_ms(call, {key: names[key][1] for key in ("dq", "dkv")}, reps=10)
    plain_ms = device_ms(lambda: kernels.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True),
                         reps=10)
    parts = kernels.flash_attention_dkv_partials_plain(q, k, v, o, lse, do, causal=True)
    red = kernels.flash_attention_dkv_reduce(*parts, b_ * 32, dt)
    for a_, w_, what in zip(red, kernels.flash_attention_dkv_reduce_plain(*parts, b_ * 32, dt), ("dk", "dv")):
        same(a_, w_, f"hd 112 {route_name} dk/dv reduction {what}", DKV_ROUTE[dt][1])
    red_ms = device_ms(lambda: kernels.flash_attention_dkv_reduce(*parts, b_ * 32, dt), reps=10)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    sdpa_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    pairs_ = b_ * 32 * 1024 * 1025 // 2             # (query, key) pairs the causal mask keeps
    size = q.element_size()
    io_ = size * q.numel()                          # one (B, S, 32, 112) tensor
    rows_ = 2 * 4 * b_ * 32 * 1024                  # lse and delta
    peak = BF16_FLOPS if dt == BF16 else None
    lib_ms = library_time(
        f"backward {route_name} hd 112, {b_} x 1,024 (dq, dk, dv)",
        lambda: torch.autograd.grad(sdpa_o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
        bound_of(8 * io_ + rows_ // 2, 10 * 112 * pairs_, peak)[0], reps=10)
    # (bytes, operations): dq reads q, k, v, dO, lse, delta and writes dq;
    # dk/dv reads the same and writes the two f32 partials; the reduction
    # reads the partials and writes dk, dv
    work = {"dq": (5 * io_ + rows_, 6 * 112 * pairs_),
            "dkv": (4 * io_ + rows_ + 2 * 4 * q.numel(), 8 * 112 * pairs_),
            "reduce": (2 * 4 * q.numel() + 2 * io_, 0)}
    row = {key: dict(ms=(ms[key] if key in ms else red_ms),
                     events_ms=ev_ms.get(key), bound_ms=bound_of(*work[key], peak)[0],
                     bound_by=bound_of(*work[key], peak)[1]) for key in work}
    hd112_bwd_times[f"{route_name}, B={b_}, S=1,024, H=G=32, hd=112, causal"] = dict(
        row, plain_ms_dq_dk_dv=plain_ms, library_ms_dq_dk_dv=lib_ms)
    for key, name in (("dq", bwd_route(dt, 112)[0]), ("dkv", bwd_route(dt, 112)[1])):
        record(name, "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
               "src/repro/kernels/flash_attention.py:" + ("152" if key == "dq" else "191"),
               ms[key], plain_ms, *work[key], flops=peak, library_ms=lib_ms)
    del q, k, v, do, o, lse, qt, kt, vt, sdpa_o, parts, red
emit("train_kernel_times_hd112", card=smi, sass_ptxas=bwd_hd112_sass,
     method="ms: the kernel's span (trace), median of 10; events_ms: its launch by CUDA events; "
            "plain_ms and library_ms compute dq, dk and dv together", **hd112_bwd_times)
torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# 10. training parity: reduced qwen2-1.5b, the card against the CPU, f32
# ---------------------------------------------------------------------------
pcfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")), attention_impl="flash", remat="full")
psettings = TrainSettings(total_steps=50, warmup_steps=2, learning_rate=1e-3)
pdata = SyntheticLMDataset(DataConfig(vocab_size=pcfg.vocab_size, seq_len=128, global_batch=4,
                                      seed=8))
#: (PARITY_TOL, defined with the model phases' helpers, holds the losses
#: and gradient norms here)
#: the card's update of each step against the CPU's from the same state,
#: ||d_card - d_cpu|| / ||d_cpu|| over each tensor's change d, the largest
#: over tensors, a few times what an H100 reads (params 1.6e-3, mu 6.6e-4,
#: nu 1.6e-3, with either attention): mu and nu follow the gradient; a
#: parameter's first AdamW moves are +-lr whatever its gradient's size, so
#: elements whose gradient is within rounding of 0 may move 2 lr apart.  An
#: update the card got wrong (not applied, no bias correction) reads 1 or
#: more.
UPDATE_TOL = {"params": 1e-2, "mu": 3e-3, "nu": 5e-3}


def card_vs_cpu(impl, remat="full", steps=3):
    """``steps`` ``make_train_step`` steps of reduced qwen2-1.5b with ``impl``
    attention and ``remat`` on the card and on the CPU, each from the CPU's
    state: per step the two sides' loss and gradient norm, and the largest
    relative gap of the card's update of params, mu and nu against the
    CPU's."""
    cfg_ = dataclasses.replace(pcfg, attention_impl=impl, remat=remat)
    cpu_params = tm.init_params(cfg_, torch.Generator().manual_seed(8), device="cpu")
    gpu_params = tm.Model(cfg_, device="meta")
    gpu_params.load_state_dict({key: t.to(DEV, copy=True) for key, t in cpu_params.state_dict().items()},
                               assign=True)
    step_fn = make_train_step(cfg_, psettings)
    states = {"gpu": (gpu_params, adamw_init(dict(gpu_params.named_parameters()))),
              "cpu": (cpu_params, adamw_init(dict(cpu_params.named_parameters())))}
    rows = []
    for i in range(steps):
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


t_parity = time.perf_counter()
kernels.reset_launch_counts()
parity = {impl: card_vs_cpu(impl) for impl in ("flash", "reference")}
# one step each under remat="dots" (flash) and under blocked attention
parity["flash, remat dots"] = card_vs_cpu("flash", remat="dots", steps=1)
parity["blocked"] = card_vs_cpu("blocked", steps=1)
emit("train_parity_steps", config="qwen2-1.5b reduced (4 layers, d=128, f32), remat full unless named",
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
counts = kernels.launch_counts()          # the f32 flash routes of this path
F32_FLASH = ("flash_attention_f32", "flash_attention_dq_f32", "flash_attention_dkv_f32",
             "flash_attention_dkv_reduce_f32")
BF16_FLASH = ("flash_attention", "flash_attention_dq", "flash_attention_dkv", "flash_attention_dkv_reduce")
for name in F32_FLASH:
    records[name]["launches"] += counts[name]
    check(counts[name] > 0, f"train parity: kernel {name} was never launched")
for name in BF16_FLASH:
    check(counts[name] == 0, f"train parity: f32 launched the bf16 kernel {name} {counts[name]} times")
want_st, got_st = state_tensors(ref_t.params, ref_t.opt_state), state_tensors(res_t.params, res_t.opt_state)
check(sorted(want_st) == sorted(got_st), "train parity: state names differ")
unequal = [key for key in want_st if not torch.equal(want_st[key], got_st[key])]
check(not unequal, f"train parity: resumed state differs from the uninterrupted run at {unequal[:5]}")
emit("train_parity", config="qwen2-1.5b reduced (4 layers, d=128, f32), flash, remat full",
     resume=dict(uninterrupted_steps=8, preempted_after=4, tensors=len(want_st),
                 bitwise_equal=True, final_loss=ref_t.history[-1]["loss"]),
     seconds=time.perf_counter() - t_parity,
     launches={name: counts[name] for name in F32_FLASH})
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
kernels.reset_launch_counts()
t0 = time.perf_counter()
f32_pair = flash_and_reference(dataclasses.replace(tcfg_, dtype="float32"), 1, "f32")
f32_first_s = time.perf_counter() - t0
# the f32 first step runs the f32 flash route: per layer the forward once and
# again in the backward (remat), the backward kernels once; the kernels line
# counts these launches beside phase 10's
f32_counts = kernels.launch_counts()
want_f32 = dict(zip(F32_FLASH, (2 * tcfg_.n_layers,) + (tcfg_.n_layers,) * 3))
for name, n_ in want_f32.items():
    check(f32_counts[name] == n_, f"train: the f32 first step launched {name} {f32_counts[name]} times, "
                                  f"the path implies {n_}")
    records[name]["launches"] += f32_counts[name]
for name in BF16_FLASH:
    check(f32_counts[name] == 0, f"train: the f32 first step launched the bf16 kernel {name}")
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
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
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
                   flash_attention_dkv=STEPS * N_MB * L_, flash_attention_dkv_reduce=STEPS * N_MB * L_,
                   rmsnorm=STEPS * N_MB * (2 * 2 * L_ + 1))
for name, n_ in want_counts.items():
    records[name]["launches"] += counts[name]
    check(counts[name] == n_, f"train: {counts[name]} launches of {name}, the path implies {n_}")
for name in F32_FLASH:
    check(counts[name] == 0, f"train: bf16 launched the f32 kernel {name} {counts[name]} times")
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
     f32_first_microbatch_seconds=f32_first_s,
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
           else "flash_bwd_dkv_reduce" if "flash_bwd_dkv_reduce" in name
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
     f32_first_step_launches={name: f32_counts[name] for name in F32_FLASH},
     traced_step_s=traced_s, device_busy_s=busy / 1e6,
     device_busy_share=(busy / 1e6) / traced_s if busy else "not measured (empty trace)",
     device_ms_per_step_by_class={key: v_ / 1e3 for key, v_ in sorted(by_class.items())})
# one more step under remat="full" and one under "dots" on the trained
# weights and state, each with its peak memory alone: "dots" keeps the
# products without batch dimensions (q, k, v, o, gate, up, down: 23,040
# bf16 values a token a layer, about 9.8 GiB a microbatch of 2 x 4,096)
remat_steps = {}
for remat in ("full", "dots"):
    step_fn = make_train_step(dataclasses.replace(tcfg_, remat=remat), tsettings)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    second_t.params, second_t.opt_state, met_ = step_fn(second_t.params, second_t.opt_state,
                                                        tdata.batch_at(STEPS + len(remat_steps)))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    remat_steps[remat] = dict(step_seconds=time.perf_counter() - t0,
                              peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
                              resident_before_gib=base_gib, loss=float(met_["loss"]),
                              grad_norm=float(met_["grad_norm"]),
                              launches={name: counts[name] for name in want_counts})
    check(np.isfinite(remat_steps[remat]["loss"]) and np.isfinite(remat_steps[remat]["grad_norm"]),
          f"train: the remat={remat} step's loss or gradient norm is not finite")
    # per step the path's launches, as above: the forward recomputes in the
    # backward under either policy (the flash and RMSNorm functions are not
    # products without batch dimensions)
    for name, n_ in want_counts.items():
        check(counts[name] == n_ // STEPS, f"train: remat={remat} step launched {name} {counts[name]} "
                                           f"times, the path implies {n_ // STEPS}")
        records[name]["launches"] += counts[name]
emit("train_remat", card=smi, batch=f"{GB} x {SEQ} tokens, {N_MB} microbatches", steps=remat_steps)
del second_t
shutil.rmtree(ttmp, ignore_errors=True)

# ---------------------------------------------------------------------------
# 11b. hybrid_train: the Mamba2 hybrid (zamba2-7b) and xLSTM (xlstm-125m) trained
# ---------------------------------------------------------------------------
t_htrain = time.perf_counter()
gc.collect()
torch.cuda.empty_cache()
#: a parameter whose gradient is zero in exact arithmetic holds f32 rounding
#: noise (xlstm-125m's sLSTM input-gate bias: its stabilized exponential
#: gate cancels a shift of the bias).  Both optimizers move it by
#: normalized noise, so its card and CPU moves may differ by twice the
#: largest move one element can take, 2 lr sqrt(size) (Adafactor's RMS
#: clip; AdamW's first moves are +-lr); such a tensor (the CPU's second
#: moment under NOISE² everywhere) is held to that, the card's second
#: moment to NOISE² too, and every other tensor to HYBRID_UPDATE_TOL
NOISE = 1e-8
#: the card's update of each step against the CPU's (phase 10's measure),
#: with bounds set by phase 10's rule, a few times what an H100 reads: the
#: hybrid's AdamW updates read over phase 10's bounds (params 1.73e-2 at the
#: embedding, whose rows seen for the first time move by about +-lr
#: whatever their gradients' size, so an element within rounding of 0 moves
#: 2 lr apart; mu 3.03e-3 at a Mamba layer's dt_bias, nu 6.23e-3 at its
#: a_log, whose gradients sum long chains of decays); an update the card got
#: wrong reads 1 or more.  Losses and gradient norms keep PARITY_TOL
HYBRID_UPDATE_TOL = {"params": 5e-2, "mu": 1e-2, "nu": 2e-2}


def train_implied(cfg_, steps_):
    """Each kernel's launches in ``steps_`` train steps of one microbatch: per
    group of the hybrid under remat "full" the shared block's flash forward
    twice (the forward, then its recomputation in the backward) and the
    backward kernels once; RMSNorm 2 a Mamba layer (norm, gate norm) and 2
    a shared block, twice in the groups, once in the tail, and the final
    norm (its backward is plain PyTorch); xLSTM's blocks are not
    rematerialized (as in the JAX package): one pass of ``rms_per_pass``.
    A stack of attention layers (phase 11c) under remat "full": a layer's
    flash forward twice and the backward kernels once (the encoder's and
    the cross-attention run reference attention), its RMSNorms twice (2 a
    layer, 3 a decoder layer with cross-attention), the final norms once."""
    if cfg_.block_pattern == "attention":
        assert cfg_.remat == "full"
        L_ = cfg_.n_layers
        dq, dkv, red = bwd_route(tm.torch_dtype(cfg_.dtype), cfg_.resolved_head_dim)
        finals = 2 if cfg_.encoder_decoder else 1
        return {flash_key(cfg_): steps_ * 2 * L_, dq: steps_ * L_, dkv: steps_ * L_,
                red: steps_ * L_, "rmsnorm": steps_ * (2 * rms_per_forward(cfg_) - finals)}
    if cfg_.block_pattern != "zamba_hybrid":
        return {"rmsnorm": steps_ * rms_per_pass(cfg_)}
    groups, tail = divmod(cfg_.n_layers, cfg_.shared_attn_every)
    assert cfg_.remat == "full"
    dt = tm.torch_dtype(cfg_.dtype)
    dq, dkv, red = bwd_route(dt, cfg_.resolved_head_dim)
    return {flash_key(cfg_): steps_ * 2 * groups, dq: steps_ * groups, dkv: steps_ * groups,
            red: steps_ * groups,
            "rmsnorm": steps_ * (2 * (2 * groups * cfg_.shared_attn_every + 2 * groups) + 2 * tail + 1)}


def by_class(prof):
    """Device microseconds of a trace by kernel class: the flash kernels,
    RMSNorm, cuBLAS's products, and every other op."""
    out = {}
    for a, b_, name in device_spans(prof):
        key = ("flash_fwd" if "flash_fwd" in name else "flash_bwd_dq" if "flash_bwd_dq" in name
               else "flash_bwd_dkv_reduce" if "flash_bwd_dkv_reduce" in name
               else "flash_bwd_dkv" if "flash_bwd_dkv" in name else "rmsnorm" if "rmsnorm" in name
               else "gemm" if any(t in name for t in ("gemm", "nvjet", "sm90", "cutlass", "Kernel2"))
               else "other ops")
        out[key] = out.get(key, 0.0) + (b_ - a)
    return out


def load_state(params_, opt_state_, arrays):
    """Copy ``state_tensors``-named numpy arrays into a model and its
    optimizer state on the card."""
    with torch.no_grad():
        for key, t in state_tensors(params_, opt_state_).items():
            t.copy_(torch.from_numpy(arrays[key]))


def parity_train(what, cfg_, ref, batch_at, update_tol):
    """``make_train_step`` steps of a reduced model under ``cfg_.optimizer``
    on the card, each from the CPU's state before that step (``ref``:
    chip_smoke_cpu.py's run), against the CPU's step: loss and gradient norm
    within phase 10's PARITY_TOL, the update of params, mu and nu within
    ``update_tol`` (relative, per tensor), noise tensors as above.  Returns
    each step's row."""
    gp = tm.Model(cfg_, device=DEV)
    opt_ = make_optimizer(cfg_.optimizer, weight_decay=HYBRID_TRAIN["settings"].weight_decay)
    gs = opt_.init(dict(gp.named_parameters()))
    step_fn = make_train_step(cfg_, HYBRID_TRAIN["settings"], opt_)
    rows = []
    for i, (before, after, met_cpu) in enumerate(zip(ref["states"], ref["states"][1:], ref["metrics"])):
        load_state(gp, gs, before)
        gp, gs, met = step_fn(gp, gs, batch_at(i))
        got = {key: t.detach().cpu().double() for key, t in state_tensors(gp, gs).items()}
        check(int(got["opt.step"]) == int(after["opt.step"]) == i + 1, f"{what}: step count")
        lr_ = float(met["lr"])
        noise = {key.split(".", 2)[2].rsplit(".", 1)[0] if key.endswith((".row", ".col"))
                 else key.split(".", 2)[2] for key, a_ in after.items()
                 if key.startswith("opt.nu.") and float(np.max(a_)) < NOISE ** 2}
        row = {"card": {key: float(met[key]) for key in PARITY_TOL}, "cpu": met_cpu,
               "update_rel_gap": dict.fromkeys(("params", "mu", "nu"), 0.0),
               "widest": dict.fromkeys(("params", "mu", "nu"), None), "noise": sorted(noise)}
        for key, old in before.items():
            if key == "opt.step":
                continue
            grp = "params" if key.startswith("params.") else key.split(".")[1]
            leaf = key.split(".", 1)[1] if grp == "params" else key.split(".", 2)[2]
            d_cpu = torch.from_numpy(after[key]).double() - torch.from_numpy(old).double()
            d_gpu = got[key] - torch.from_numpy(old).double()
            if any(leaf == n_ or leaf.startswith(n_ + ".") for n_ in noise):
                # mu, where kept, is (1 - b1) x the noise itself
                ok = (float((d_gpu - d_cpu).abs().max()) <= 2 * lr_ * math.sqrt(old.size) + 1e-6
                      if grp == "params" else grp == "mu" or float(got[key].max()) < NOISE ** 2)
                check(ok, f"{what}: step {i} noise tensor {key} beyond its bound")
                continue
            diff = float(torch.linalg.vector_norm(d_gpu - d_cpu))
            ref_n = float(torch.linalg.vector_norm(d_cpu))
            gap = diff / ref_n if ref_n > 0 else (0.0 if diff == 0 else math.inf)
            if gap > row["update_rel_gap"][grp]:
                row["update_rel_gap"][grp], row["widest"][grp] = gap, key
        for key, tol in PARITY_TOL.items():
            a_, c_ = row["card"][key], met_cpu[key]
            # with the f64 value of the same step (phase 11c's models, whose
            # random f32 gradients lie up to 1e-2 from it: 8d's finding), a
            # card further from the CPU than PARITY_TOL is held to 3x the
            # CPU's own gap to f64 (8d's rule)
            e_ = met_cpu.get(key + "64")
            bound = tol * (1 + abs(c_)) if e_ is None else max(tol * (1 + abs(c_)), 3 * abs(c_ - e_))
            check(abs(a_ - c_) <= bound,
                  f"{what}: step {i} {key} card {a_} vs CPU {c_} (tol {tol}"
                  + ("" if e_ is None else f"; f64 {e_}, bound {bound}") + ")")
        for grp, tol in update_tol.items():
            check(row["update_rel_gap"][grp] <= tol,
                  f"{what}: step {i} the card's {grp} update "
                  f"{row['update_rel_gap'][grp]} from the CPU's at {row['widest'][grp]} (tol {tol})")
        rows.append(row)
    return rows


# reduced zamba2-7b (hd 32 and 112) and xlstm-125m, f32, flash, remat full,
# under Adafactor and AdamW: 3 steps on the card, each from the CPU's state
# before that step (chip_smoke_cpu.py's run), against the CPU's step
htrain_rows = {}
kernels.reset_launch_counts()
htrain_implied = {}
for name, arch, over, seed in HYBRID_CASES:
    for opt_name in HYBRID_TRAIN["optimizers"]:
        ref = cpu_ref(f"hybrid train {name} {opt_name}")
        cfg_ = hybrid_train_config(arch, over, opt_name)
        rows = parity_train(f"hybrid train {name} {opt_name}", cfg_, ref,
                            hybrid_train_data(cfg_, seed).batch_at, HYBRID_UPDATE_TOL)
        for key, n_ in train_implied(cfg_, len(rows)).items():
            htrain_implied[key] = htrain_implied.get(key, 0) + n_
        htrain_rows[f"{name} {opt_name}"] = dict(steps=rows, cpu_seconds=ref["seconds"])
count_launches(kernels.launch_counts(), htrain_implied, "hybrid train parity")
emit("hybrid_train_parity", configs="zamba2-7b reduced (8 layers, d=128, cadence 3, hd 32 and 112), "
     "xlstm-125m reduced (4 layers, d=128); f32, flash, remat full; 3 steps of 4 x 64 tokens, each "
     "from the CPU's state", tolerance=PARITY_TOL, update_tolerance=HYBRID_UPDATE_TOL,
     noise_bound="a tensor whose CPU second moment is under 1e-16 everywhere: its move within "
                 "2 lr sqrt(size) of the CPU's, its second moment under 1e-16",
     launches=htrain_implied, **htrain_rows)

# preemption: a Trainer on reduced zamba2-7b at head_dim 112 under Adafactor,
# 4 steps, against one preempted after 2 and resumed by a fresh Trainer; the
# two end bitwise equal (the stacks' factor pairs go through the checkpoint)
htmp = tempfile.mkdtemp(prefix="chip_smoke_hybrid_")
hcfg = hybrid_train_config("zamba2-7b", {"head_dim": 112}, "adafactor")


def hybrid_trainer(sub):
    return Trainer(hcfg, HYBRID_TRAIN["settings"],
                   TrainerConfig(ckpt_dir=os.path.join(htmp, sub), ckpt_every=1000, log_every=1,
                                 seed=37),
                   data=hybrid_train_data(hcfg, 37), device=DEV)


kernels.reset_launch_counts()
href = hybrid_trainer("ref")
href.run(4)
hpre = hybrid_trainer("pre")
hpre.run(2)
check(hpre.on_preempt(now=0.0, deadline=60.0) is PreemptAck.DRAINED, "hybrid train: drain not DRAINED")
hres = hybrid_trainer("pre")
hres.init_or_restore()
check(hres.step == 2, f"hybrid train: resumed at step {hres.step}")
hres.run(until_step=4)
count_launches(kernels.launch_counts(), train_implied(hcfg, 8), "hybrid train resume")
hwant, hgot = state_tensors(href.params, href.opt_state), state_tensors(hres.params, hres.opt_state)
check(sorted(hwant) == sorted(hgot) and "opt.nu.mamba_groups.in_proj.row" in hwant,
      "hybrid train: state names differ, or no stacked factors")
unequal = [key for key in hwant if not torch.equal(hwant[key], hgot[key])]
check(not unequal, f"hybrid train: resumed state differs from the uninterrupted run at {unequal[:5]}")
emit("hybrid_train_resume", config="zamba2-7b reduced, hd 112, f32, flash, Adafactor",
     uninterrupted_steps=4, preempted_after=2, tensors=len(hwant), bitwise_equal=True,
     losses=[h_["loss"] for h_ in href.history])
del href, hpre, hres, hwant, hgot
shutil.rmtree(htmp, ignore_errors=True)

# full-width zamba2-7b trained, cut to 39 of 81 layers (6 of its 13 groups
# of 6 and the tail of 3; 3.48 B parameters: phase 11c's room in the
# script's time, and the traced step's trace halved): bf16 parameters drawn
# on the card, Adafactor, flash attention, remat "full", 4 x 1,024 tokens a
# step in one microbatch
gc.collect()
torch.cuda.empty_cache()
free_gib("zamba2-7b training, 39 layers, bf16, Adafactor", "hybrid_train_memory")
ztcfg = dataclasses.replace(ZAMBA, n_layers=39, params_dtype="bfloat16", optimizer="adafactor",
                            attention_impl="flash")
check(ztcfg.remat == "full", "hybrid train: zamba2-7b is expected with full remat")
ZT_GROUPS = ztcfg.n_layers // ztcfg.shared_attn_every
ztsettings = TrainSettings(learning_rate=3e-4, warmup_steps=2, total_steps=1000)
ztdata = SyntheticLMDataset(DataConfig(vocab_size=ztcfg.vocab_size, seq_len=1024, global_batch=4, seed=38))
t0 = time.perf_counter()
ztp = tm.init_params(ztcfg, torch.Generator(device=DEV).manual_seed(38), device=DEV)
ztopt = make_optimizer("adafactor", weight_decay=ztsettings.weight_decay)
zts = ztopt.init(dict(ztp.named_parameters()))
torch.cuda.synchronize()
ztinit_s = time.perf_counter() - t0
ztcount = sum(p_.numel() for p_ in ztp.parameters())
check(ztcount == 3_476_052_144, f"hybrid train: zamba2-7b at 39 layers has {ztcount} parameters")
factor_gib = sum(x.numel() * 4 for t in zts.nu.values() for x in (t if isinstance(t, tuple) else (t,))) / 2**30
param_gib = 2 * ztcount / 2**30
# the peak reckoned: parameters, their gradients and the clip's copy of them
# (the gradients freed once the clip returns), then the deltas beside the
# clipped gradients; the factors; one group's activations recomputed in the
# backward (6 Mamba layers: the chunks' (B, Q, Q, H) f32 tensors and the
# projections, about 1.3 GiB a layer at 4 x 1,024) and a few entries' f32
# temporaries of the optimizer
reckoned_gib = 3 * param_gib + factor_gib + 6 * 1.3 + 1.0
emit("hybrid_train_memory", resident_gib=torch.cuda.memory_allocated() / 2**30, parameters=ztcount,
     parameters_gib=param_gib, factors_gib=factor_gib, reckoned_peak_gib=reckoned_gib,
     free_gib=torch.cuda.mem_get_info()[0] / 2**30)
# the first step's loss and gradient norm with reference attention on the
# batch of the first step (the flash step's own come from the train step
# below); both finite, their gaps printed (with these random weights the
# two bf16 paths decorrelate with depth: phase 8c's 81-layer forwards)
zb0 = {key: torch.from_numpy(val).to(DEV) for key, val in ztdata.batch_at(0).items()}
zref_cfg = dataclasses.replace(ztcfg, attention_impl="reference")
zloss, _ = tm.forward_train(zref_cfg, ztp, zb0)
zgrads = torch.autograd.grad(zloss, list(ztp.parameters()))
zref = (float(zloss.detach()), float(torch.sqrt(sum(torch.sum(torch.square(g_.float())) for g_ in zgrads))))
del zloss, zgrads
torch.cuda.empty_cache()
zstep = make_train_step(ztcfg, ztsettings, ztopt)
torch.cuda.reset_peak_memory_stats()
kernels.reset_launch_counts()
zstep_s, zhist = [], []
for i in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ztp, zts, met = zstep(ztp, zts, ztdata.batch_at(i))
    torch.cuda.synchronize()
    zstep_s.append(time.perf_counter() - t0)
    zhist.append({key: float(met[key]) for key in ("loss", "grad_norm", "lr")})
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ztp, zts, met = zstep(ztp, zts, ztdata.batch_at(3))
    torch.cuda.synchronize()
    ztraced_s = time.perf_counter() - t0
zhist.append({key: float(met[key]) for key in ("loss", "grad_norm", "lr")})
zpeak_gib = torch.cuda.max_memory_allocated() / 2**30
ztrain_counts = kernels.launch_counts()
count_launches(ztrain_counts, train_implied(ztcfg, 4), "hybrid train: zamba2-7b")
for h_ in zhist:
    check(np.isfinite(h_["loss"]) and np.isfinite(h_["grad_norm"]), f"hybrid train: zamba2-7b step {h_}")
check(all(np.isfinite(zref)), f"hybrid train: zamba2-7b reference first step {zref}")
zbusy = busy_us(prof)
zby_class = by_class(prof)
del prof
ztokens = 4 * 1024
zflops = ztokens * (6 * ztcount + 6 * ZT_GROUPS * ztcfg.n_heads * ztcfg.resolved_head_dim * 1024)
zp50 = float(np.median(zstep_s))
emit("hybrid_train", config="zamba2-7b full width, 39 of 81 layers: 39 Mamba2 layers, d=3584, the "
     "shared attention block every 6 (32 heads, hd 112); bf16 parameters (seed 38), Adafactor, "
     "flash attention, remat full", cuts=["39 of 81 layers (6 of 13 groups and the tail)"], card=smi,
     batch="4 x 1,024 tokens a step, one microbatch",
     init_seconds=ztinit_s, first_step={"flash": zhist[0]["loss"], "flash_grad_norm": zhist[0]["grad_norm"],
                                        "reference": zref[0], "reference_grad_norm": zref[1],
                                        "loss_rel_gap": abs(zhist[0]["loss"] - zref[0]) / abs(zref[0]),
                                        "grad_norm_rel_gap": abs(zhist[0]["grad_norm"] - zref[1]) / zref[1]},
     step_seconds=zstep_s, step_p50_s=zp50, tokens_per_s=ztokens / zp50, model_flops_per_step=zflops,
     mfu_vs_989_tflops=zflops / zp50 / BF16_FLOPS, peak_device_gib=zpeak_gib,
     reckoned_peak_gib=reckoned_gib, history=zhist, traced_step_s=ztraced_s,
     device_busy_s=zbusy / 1e6,
     device_busy_share=(zbusy / 1e6) / ztraced_s if zbusy else "not measured (empty trace)",
     device_ms_per_step_by_class={key: v_ / 1e3 for key, v_ in sorted(zby_class.items())},
     launches={key: ztrain_counts[key] for key in train_implied(ztcfg, 4)},
     launches_implied=train_implied(ztcfg, 4))
del ztp, zts, zb0, zstep, ztopt
gc.collect()
torch.cuda.empty_cache()

# full-width xlstm-125m under its own config (f32 parameters, AdamW, no
# attention): two steps at 4 x 256 tokens (cut from 1,024: the sLSTM's
# loop over tokens takes most of a step's time)
xtcfg = XLSTM
xtdata = SyntheticLMDataset(DataConfig(vocab_size=xtcfg.vocab_size, seq_len=256, global_batch=4, seed=39))
xtp = tm.init_params(xtcfg, torch.Generator(device=DEV).manual_seed(39), device=DEV)
xtopt = make_optimizer(xtcfg.optimizer, weight_decay=ztsettings.weight_decay)
xts = xtopt.init(dict(xtp.named_parameters()))
xstep = make_train_step(xtcfg, ztsettings, xtopt)
kernels.reset_launch_counts()
torch.cuda.reset_peak_memory_stats()
xstep_s, xhist = [], []
for i in range(2):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xtp, xts, met = xstep(xtp, xts, xtdata.batch_at(i))
    torch.cuda.synchronize()
    xstep_s.append(time.perf_counter() - t0)
    xhist.append({key: float(met[key]) for key in ("loss", "grad_norm", "lr")})
    check(np.isfinite(xhist[-1]["loss"]) and np.isfinite(xhist[-1]["grad_norm"]),
          f"hybrid train: xlstm-125m step {xhist[-1]}")
count_launches(kernels.launch_counts(), train_implied(xtcfg, 2), "hybrid train: xlstm-125m")
emit("hybrid_train_xlstm", config="xlstm-125m full width: 12 blocks (sLSTM every 4th), d=768, "
     f"{xtcfg.params_dtype} parameters, {xtcfg.optimizer}, remat {xtcfg.remat} (the blocks are "
     "not rematerialized, as in the JAX package)", card=smi, batch="4 x 256 tokens a step",
     cuts=["256 of 1,024 tokens a sequence"],
     parameters=sum(p_.numel() for p_ in xtp.parameters()), step_seconds=xstep_s,
     tokens_per_s=4 * 256 / float(np.median(xstep_s)), history=xhist,
     peak_device_gib=torch.cuda.max_memory_allocated() / 2**30)
del xtp, xts, xstep, xtopt
gc.collect()
torch.cuda.empty_cache()
emit("hybrid_train_phase", seconds=time.perf_counter() - t_htrain)

# ---------------------------------------------------------------------------
# 11c. train_full: the mixture-of-experts (moonshot-v1-16b-a3b, arctic-480b),
# the encoder-decoder (seamless-m4t-medium) and the vision stub
# (internvl2-26b) trained
# ---------------------------------------------------------------------------
t_ctrain = time.perf_counter()
gc.collect()
torch.cuda.empty_cache()
#: the card's update of each step against the CPU's (phase 10's measure),
#: with bounds set by phase 10's rule, a few times what an H100 reads:
#: params 6.1e-2 (reduced seamless-m4t-medium under Adafactor, at an
#: encoder layer's attn_norm: the update is g / sqrt(vhat), and these random
#: networks put the CPU's own f32 gradients up to 6e-3 from f64), mu 5.7e-3,
#: nu 1.2e-2; an update the card got wrong reads 1 or more.  Losses and
#: gradient norms as 11b, with f64 beside them (``parity_train``)
TRAIN_UPDATE_TOL = {"params": 2e-1, "mu": 2e-2, "nu": 4e-2}

# reduced moonshot-v1-16b-a3b, arctic-480b, seamless-m4t-medium and
# internvl2-26b, f32, flash, remat full, under Adafactor and AdamW: 3 steps
# on the card, each from the CPU's state before it (chip_smoke_cpu.py),
# against the CPU's step, as 11b holds the hybrid
ctrain_rows, ctrain_implied = {}, {}
kernels.reset_launch_counts()
for arch, seed in TRAIN_CASES:
    for opt_name in HYBRID_TRAIN["optimizers"]:
        what = f"train {arch} {opt_name}"
        ref = cpu_ref(what)
        cfg_ = train_config(arch, opt_name)
        t0 = time.perf_counter()
        rows = parity_train(what, cfg_, ref, train_batch_at(cfg_, seed), TRAIN_UPDATE_TOL)
        for key, n_ in train_implied(cfg_, len(rows)).items():
            ctrain_implied[key] = ctrain_implied.get(key, 0) + n_
        ctrain_rows[what] = dict(steps=rows, cpu_seconds=ref["seconds"],
                                 card_seconds=time.perf_counter() - t0)
count_launches(kernels.launch_counts(), ctrain_implied, "train_full parity")
emit("train_full_parity", configs="reduced moonshot-v1-16b-a3b and arctic-480b (4 layers, d=128, 8 "
     "experts top-2), seamless-m4t-medium (4 + 2 layers), internvl2-26b (4 layers, 16 patch "
     "positions); f32, flash, remat full; 3 steps of 4 x 64 tokens (with 48 frame or 16 patch "
     "embeddings), each from the CPU's state", tolerance=PARITY_TOL,
     update_tolerance=TRAIN_UPDATE_TOL, launches=ctrain_implied, **ctrain_rows)

# preemption: a Trainer on reduced moonshot-v1-16b-a3b under AdamW, 4 steps,
# against one preempted after 2 and resumed by a fresh Trainer; bitwise equal
ctmp = tempfile.mkdtemp(prefix="chip_smoke_moe_train_")
mcfg = train_config("moonshot-v1-16b-a3b", "adamw")


def moe_trainer(sub):
    return Trainer(mcfg, HYBRID_TRAIN["settings"],
                   TrainerConfig(ckpt_dir=os.path.join(ctmp, sub), ckpt_every=1000, log_every=1,
                                 seed=55),
                   data=hybrid_train_data(mcfg, 55), device=DEV)


kernels.reset_launch_counts()
mref = moe_trainer("ref")
mref.run(4)
mpre = moe_trainer("pre")
mpre.run(2)
check(mpre.on_preempt(now=0.0, deadline=60.0) is PreemptAck.DRAINED, "train_full: drain not DRAINED")
mres = moe_trainer("pre")
mres.init_or_restore()
check(mres.step == 2, f"train_full: resumed at step {mres.step}")
mres.run(until_step=4)
count_launches(kernels.launch_counts(), train_implied(mcfg, 8), "train_full resume")
mwant, mgot = state_tensors(mref.params, mref.opt_state), state_tensors(mres.params, mres.opt_state)
check(sorted(mwant) == sorted(mgot) and "opt.mu.layers.0.moe.wg" in mwant,
      "train_full: state names differ, or no expert moments")
unequal = [key for key in mwant if not torch.equal(mwant[key], mgot[key])]
check(not unequal, f"train_full: resumed state differs from the uninterrupted run at {unequal[:5]}")
emit("train_full_resume", config="moonshot-v1-16b-a3b reduced, f32, flash, AdamW",
     uninterrupted_steps=4, preempted_after=2, tensors=len(mwant), bitwise_equal=True,
     losses=[h_["loss"] for h_ in mref.history])
del mref, mpre, mres, mwant, mgot
shutil.rmtree(ctmp, ignore_errors=True)

FULL_SETTINGS = TrainSettings(learning_rate=3e-4, warmup_steps=2, total_steps=1000)


def lm_batches(cfg_, b_, s_, seed, embeds=0):
    """Step i's batch on the card: ``b_`` x ``s_`` tokens of the synthetic
    stream and, with ``embeds``, that many frame (encoder-decoder) or patch
    (vision stub) embeddings a row, N(0, 1) f32, drawn on the card from the
    seed and i."""
    data_ = SyntheticLMDataset(DataConfig(vocab_size=cfg_.vocab_size, seq_len=s_, global_batch=b_,
                                          seed=seed))

    def batch_at(i):
        out = {key: torch.from_numpy(val).to(DEV) for key, val in data_.batch_at(i).items()}
        if embeds:
            key = "frame_embeds" if cfg_.encoder_decoder else "patch_embeds"
            out[key] = torch.randn((b_, embeds, cfg_.d_model), device=DEV,
                                   generator=torch.Generator(device=DEV).manual_seed(1000 * seed + i))
        return out
    return batch_at


def state_fingerprint(params_, opt_state_):
    """A checksum of the bits of every tensor of the state (parameters,
    moments, factors): the sum over its elements of their bits as integers
    times (index mod 8,191 + 1), in int64, in slices of 2^26 elements."""
    sums = {}
    for key, t in state_tensors(params_, opt_state_).items():
        flat = t.detach().reshape(-1)
        flat = flat.view(torch.int16 if flat.element_size() == 2 else torch.int32)
        acc = torch.zeros((), dtype=torch.int64, device=flat.device)
        for a in range(0, flat.numel(), 1 << 26):
            x = flat[a:a + (1 << 26)].to(torch.int64)
            acc += torch.sum(x * (torch.arange(a, a + x.numel(), device=flat.device) % 8191 + 1))
        sums[key] = acc
    return dict(zip(sums, torch.stack(list(sums.values())).tolist()))


def reckon_gib(cfg_, tokens):
    """The step's peak reckoned from the shapes (a model on the meta device):
    what the card holds already, the parameters and the optimizer state,
    and the larger of two moments: the update (all the gradients, in the
    parameters' type, and the optimizer's temporaries: AdamW's five f32
    copies of its largest leaf, Adafactor's three of the largest leaf it
    takes whole and four slices) and the backward through the logits (the
    head's gradient, the logits in f32 four times: cast, log-softmax and
    their gradients, and 1 GiB for a layer's recomputation)."""
    meta = tm.Model(cfg_, device="meta", dtype=tm.torch_dtype(cfg_.params_dtype))
    named = dict(meta.named_parameters())
    p_bytes = sum(t.numel() * t.element_size() for t in named.values())
    if cfg_.optimizer == "adamw":
        state_bytes, opt_tmp = 8 * sum(t.numel() for t in named.values()), \
            5 * 4 * max(t.numel() for t in named.values())
    else:
        state_bytes = sum(x.numel() * 4 for t in make_optimizer("adafactor").init(named).nu.values()
                          for x in (t if isinstance(t, tuple) else (t,)))
        whole = [t.numel() for t in named.values() if t.dim() <= 2]
        opt_tmp = 3 * 4 * max(whole) + 4 * optim_mod.SLICE_BYTES
    head = named["embed" if cfg_.tie_embeddings else "lm_head"]
    back_tmp = head.numel() * head.element_size() + 4 * 4 * tokens * cfg_.vocab_padded + 2**30
    held = torch.cuda.memory_allocated()
    parts = dict(held_gib=held / 2**30, parameters_gib=p_bytes / 2**30,
                 gradients_gib=p_bytes / 2**30, optimizer_state_gib=state_bytes / 2**30,
                 optimizer_transient_gib=opt_tmp / 2**30, backward_transient_gib=back_tmp / 2**30)
    return (held + p_bytes + state_bytes + max(p_bytes + opt_tmp, back_tmp)) / 2**30, parts


def model_flops(cfg_, n_active, tokens, s_):
    """A step's model flops: 6 N T over the active parameters, and 6 H hd S
    T a causal attention layer (12 a non-causal one: the encoder's and the
    cross-attention)."""
    hd_, h_ = cfg_.resolved_head_dim, cfg_.n_heads
    full = cfg_.n_layers + cfg_.n_encoder_layers if cfg_.encoder_decoder else 0
    return 6 * n_active * tokens + (6 * cfg_.n_layers + 12 * full) * h_ * hd_ * s_ * tokens


def full_train(phase, cfg_, seed, batch_at, tokens, s_, cuts, repeat=False):
    """One model trained at full width on the card by ``make_train_step``
    under its ``cfg_.optimizer``: the free memory and the reckoned peak
    before the parameters are drawn (on the card, from ``seed``); the first
    step's loss and gradient norm with reference attention on step 0's
    batch; three timed steps and a fourth traced (step time, tokens/s, MFU,
    peak memory, busy share, device ms by class), each kernel's launches
    against the path; with ``repeat``, the parameters drawn again and step 0
    taken again from the same state, every tensor's bits (parameters,
    moments, factors) equal to the first time's.  Emits one line."""
    gc.collect()
    torch.cuda.empty_cache()
    reckoned, parts = reckon_gib(cfg_, tokens)
    emit("train_full_memory", model=cfg_.name, free_gib=torch.cuda.mem_get_info()[0] / 2**30,
         reckoned_peak_gib=reckoned, **parts)
    opt_ = make_optimizer(cfg_.optimizer, weight_decay=FULL_SETTINGS.weight_decay)

    def init():
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        p_ = tm.init_params(cfg_, torch.Generator(device=DEV).manual_seed(seed), device=DEV)
        st__ = opt_.init(dict(p_.named_parameters()))
        torch.cuda.synchronize()
        return p_, st__, time.perf_counter() - t0_

    prm, st_, init_s = init()
    count = sum(p_.numel() for p_ in prm.parameters())
    active = count - (cfg_.n_layers * (cfg_.n_experts - cfg_.top_k) * 3 * cfg_.d_model * cfg_.d_ff
                      if cfg_.is_moe else 0)
    b0 = batch_at(0)
    rloss, _ = tm.forward_train(dataclasses.replace(cfg_, attention_impl="reference"), prm, b0)
    rgrads = torch.autograd.grad(rloss, list(prm.parameters()))
    # the global norm as the step takes it (a large leaf in slices)
    rfirst = (float(rloss.detach()), float(optim_mod.global_norm(dict(enumerate(rgrads)))))
    del rloss, rgrads, b0
    torch.cuda.empty_cache()
    step = make_train_step(cfg_, FULL_SETTINGS, opt_)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, hist, fp0 = [], [], None
    for i in range(3):
        batch_ = batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prm, st_, met = step(prm, st_, batch_)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        hist.append({key: float(met[key]) for key in ("loss", "grad_norm", "lr", "aux_loss")})
        if i == 0 and repeat:
            fp0 = state_fingerprint(prm, st_)
    batch_ = batch_at(3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prm, st_, met = step(prm, st_, batch_)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    hist.append({key: float(met[key]) for key in ("loss", "grad_norm", "lr", "aux_loss")})
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = kernels.launch_counts()
    implied = train_implied(cfg_, 4)
    count_launches(counts, implied, f"train_full: {cfg_.name}")
    for h_ in hist:
        check(np.isfinite(h_["loss"]) and np.isfinite(h_["grad_norm"]), f"train_full: {cfg_.name} step {h_}")
    check(all(np.isfinite(rfirst)), f"train_full: {cfg_.name} reference first step {rfirst}")
    check((hist[0]["aux_loss"] > 0) == cfg_.is_moe, f"train_full: {cfg_.name} aux loss {hist[0]}")
    busy = busy_us(prof)
    classes = by_class(prof)
    del prof, batch_
    same_bits = None
    if repeat:
        del prm, st_, met
        gc.collect()
        torch.cuda.empty_cache()
        prm, st_, _ = init()
        kernels.reset_launch_counts()
        prm, st_, _ = step(prm, st_, batch_at(0))
        count_launches(kernels.launch_counts(), train_implied(cfg_, 1), f"train_full: {cfg_.name} again")
        fp1 = state_fingerprint(prm, st_)
        differ = [key for key in fp0 if fp0[key] != fp1[key]]
        check(sorted(fp0) == sorted(fp1) and not differ,
              f"train_full: {cfg_.name} step 0 taken twice from the same state differs at {differ[:8]}")
        same_bits = dict(tensors=len(fp0), bitwise_equal=True)
    del prm, st_
    gc.collect()
    torch.cuda.empty_cache()
    flops = model_flops(cfg_, active, tokens, s_)
    p50 = float(np.median(times))
    emit(phase, model=cfg_.name, cuts=cuts, card=smi,
         config=f"{cfg_.name}: {cfg_.n_layers} layers"
                + (f" + {cfg_.n_encoder_layers} encoder layers" if cfg_.encoder_decoder else "")
                + f", d={cfg_.d_model}, {cfg_.n_heads}/{cfg_.n_kv_heads} heads, hd "
                  f"{cfg_.resolved_head_dim}, d_ff {cfg_.d_ff}"
                + (f", {cfg_.n_experts} experts top-{cfg_.top_k}, capacity factor {cfg_.capacity_factor}"
                   if cfg_.is_moe else "")
                + f"; {cfg_.params_dtype} parameters (seed {seed}), {cfg_.dtype} compute, "
                  f"{cfg_.optimizer}, flash, remat {cfg_.remat}",
         batch=f"{tokens} tokens a step, one microbatch", parameters=count, active_parameters=active,
         init_seconds=init_s,
         first_step={"flash": hist[0]["loss"], "flash_grad_norm": hist[0]["grad_norm"],
                     "reference": rfirst[0], "reference_grad_norm": rfirst[1],
                     "loss_rel_gap": abs(hist[0]["loss"] - rfirst[0]) / abs(rfirst[0]),
                     "grad_norm_rel_gap": abs(hist[0]["grad_norm"] - rfirst[1]) / rfirst[1]},
         step_seconds=times, step_p50_s=p50, tokens_per_s=tokens / p50, model_flops_per_step=flops,
         mfu_vs_989_tflops=flops / p50 / BF16_FLOPS, peak_device_gib=peak, reckoned_peak_gib=reckoned,
         history=hist, traced_step_s=traced_s, device_busy_s=busy / 1e6,
         device_busy_share=(busy / 1e6) / traced_s if busy else "not measured (empty trace)",
         device_ms_per_step_by_class={key: v_ / 1e3 for key, v_ in sorted(classes.items())},
         launches={key: counts[key] for key in implied}, launches_implied=implied,
         repeated_step_from_the_same_state=same_bits)
    return peak, reckoned


MOONSHOT, ARCTIC = get_config("moonshot-v1-16b-a3b"), get_config("arctic-480b")
# moonshot-v1-16b-a3b at full width under its own AdamW (f32 moments),
# bf16 parameters (as phase 8b), 8 of 48 layers (6 if the reckoning leaves
# under 8 GiB free): 4 x 1,024 tokens a step
total_gib = torch.cuda.mem_get_info()[1] / 2**30
mt_layers = next(n_ for n_ in (8, 6) if total_gib - reckon_gib(dataclasses.replace(
    MOONSHOT, n_layers=n_, params_dtype="bfloat16"), 4096)[0] >= 8 or n_ == 6)
mtcfg = dataclasses.replace(MOONSHOT, n_layers=mt_layers, params_dtype="bfloat16", attention_impl="flash")
full_train("train_full_moonshot", mtcfg, 56, lm_batches(mtcfg, 4, 1024, 56), 4096, 1024,
           cuts=[f"{mt_layers} of 48 layers", "bf16 parameters (f32: 2x the memory)"], repeat=True)
# arctic-480b at full width, 1 of 35 layers (as phase 8b serves it), its own
# bf16 parameters and Adafactor; its peak held to the reckoning plus 10 %
atcfg = dataclasses.replace(ARCTIC, n_layers=1, attention_impl="flash")
apeak, areckoned = full_train("train_full_arctic", atcfg, 57, lm_batches(atcfg, 4, 1024, 57), 4096, 1024,
                              cuts=["1 of 35 layers"], repeat=True)
check(apeak <= 1.1 * areckoned, f"train_full: arctic-480b's peak {apeak} GiB beyond its reckoning "
                                f"{areckoned} GiB plus 10 %")
# seamless-m4t-medium at full width and depth under its own config (f32
# parameters, AdamW, bf16 compute): 4 x 1,024 frame embeddings and tokens
stcfg = dataclasses.replace(SEAMLESS, attention_impl="flash")
full_train("train_full_seamless", stcfg, 58, lm_batches(stcfg, 4, 1024, 58, embeds=1024), 4096, 1024,
           cuts=[])
# internvl2-26b at full width: bf16 parameters (as 8d), Adafactor (AdamW's
# state alone would be 159 GB), 32 of 48 layers; 2 x (1,024 patch
# embeddings + 1,024 tokens)
itcfg = dataclasses.replace(INTERNVL, n_layers=32, params_dtype="bfloat16", optimizer="adafactor",
                            attention_impl="flash")
full_train("train_full_internvl2", itcfg, 59, lm_batches(itcfg, 2, 1024, 59, embeds=1024), 4096, 2048,
           cuts=["32 of 48 layers", "bf16 parameters", "Adafactor (AdamW's state: 159 GB)"])
emit("train_full_phase", seconds=time.perf_counter() - t_ctrain)

# ---------------------------------------------------------------------------
# 12. the kernels line, the card, the result
# ---------------------------------------------------------------------------
emit("timing", profiler_empty_timed_by_cuda_events=EVENT_TIMED)
# every library reading of a flash kernel's function by both methods; a
# reading under its bound cannot be right (no failure: a note for the record)
emit("library_readings", card=smi, readings=LIBRARY_READINGS,
     under_bound={what: [m_ for m_ in ("trace_ms", "events_ms") if r_[m_] < r_["bound_ms"]]
                  for what, r_ in LIBRARY_READINGS.items()
                  if min(r_["trace_ms"], r_["events_ms"]) < r_["bound_ms"]})
for name, n_ in LATER_LAUNCHES.items():
    records[name]["launches"] += n_
print(json.dumps({"kernels": list(records.values())}))
print(smi)
print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
