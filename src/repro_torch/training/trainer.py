"""Trainer: the runnable job that the cluster scheduler places and preempts
(port of ``repro.training.trainer``).

Implements the ``PreemptibleJob`` protocol (core/preemption.py): on a
PREEMPT signal it drains the in-flight step, writes a checkpoint inside the
notice window, and can later resume, possibly elsewhere, bit-exactly
(parameters, optimizer state, data cursor).  The trainer runs on the card
unless it is given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from ..checkpoint import Checkpointer
from ..configs.base import ModelConfig
from ..core.preemption import PreemptAck
from ..core.torch_scheduler import resolve_device
from ..data.pipeline import DataConfig, SyntheticLMDataset
from ..models.model import Model, init_params, torch_dtype
from ..optim.optimizers import OptState, make_optimizer
from .train_step import TrainSettings, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0


def state_tensors(params: Model, opt_state: OptState) -> Dict[str, torch.Tensor]:
    """Parameters and optimizer state as one flat dict of tensors, the
    checkpoint's payload: ``params.<name>``, ``opt.step``, ``opt.mu.<name>``,
    ``opt.nu.<name>`` (an Adafactor factor pair as ``.row`` / ``.col``)."""
    out = {f"params.{n}": p for n, p in params.named_parameters()}
    out["opt.step"] = opt_state.step
    for n, t in (opt_state.mu or {}).items():
        out[f"opt.mu.{n}"] = t
    for n, t in opt_state.nu.items():
        if isinstance(t, tuple):
            out[f"opt.nu.{n}.row"], out[f"opt.nu.{n}.col"] = t
        else:
            out[f"opt.nu.{n}"] = t
    return out


class Trainer:
    """Single-process trainer on one device."""

    def __init__(self, cfg: ModelConfig, settings: TrainSettings, tcfg: TrainerConfig,
                 data: Optional[SyntheticLMDataset] = None, job_id: str = "job0",
                 device=None):
        self.cfg = cfg
        self.settings = settings
        self.tcfg = tcfg
        self.job_id = job_id
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(cfg.optimizer, weight_decay=settings.weight_decay)
        self.ckpt = Checkpointer(tcfg.ckpt_dir)
        self.data = data or SyntheticLMDataset(
            DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=8, seed=tcfg.seed))
        self._step_fn = make_train_step(cfg, settings, self.optimizer)
        self.params: Optional[Model] = None
        self.opt_state: Optional[OptState] = None
        self.step = 0
        self.history: list = []
        self._preempted = False

    # -- lifecycle ------------------------------------------------------------
    def init_or_restore(self) -> None:
        latest = self.ckpt.latest_step()
        if latest is None:
            # the port's own draw: a generator on the trainer's device, seeded
            # by tcfg.seed (not JAX's values; the same distributions)
            gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
            self.params = init_params(self.cfg, gen, device=self.device)
            self.opt_state = self.optimizer.init(dict(self.params.named_parameters()))
            self.step = 0
        else:
            # uninitialized tensors of the right shapes, filled in place
            self.params = Model(self.cfg, device=self.device,
                                dtype=torch_dtype(self.cfg.params_dtype))
            self.opt_state = self.optimizer.init(dict(self.params.named_parameters()))
            _, meta = self.ckpt.restore(state_tensors(self.params, self.opt_state))
            self.step = meta.step

    def run(self, n_steps: Optional[int] = None,
            until_step: Optional[int] = None) -> Dict[str, float]:
        if self.params is None:
            self.init_or_restore()
        target = until_step if until_step is not None else self.step + (n_steps or 0)
        last: Dict[str, float] = {}
        while self.step < target and not self._preempted:
            batch = self.data.batch_at(self.step)
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or self.step == target:
                last = {k: float(v) for k, v in metrics.items()}
                self.history.append({"step": self.step, **last})
            if self.step % self.tcfg.ckpt_every == 0:
                self.save_checkpoint()
        return last

    def save_checkpoint(self, blocking: bool = False) -> None:
        self.ckpt.save(self.step, state_tensors(self.params, self.opt_state),
                       extra={"job_id": self.job_id}, blocking=blocking)

    # -- PreemptibleJob protocol -------------------------------------------------
    def on_preempt(self, now: float, deadline: float) -> PreemptAck:
        """Drain + checkpoint; DRAINED if the checkpoint is durable within
        the notice window (``deadline - now`` seconds), else HARD_KILLED."""
        self._preempted = True
        t0 = time.monotonic()
        self.save_checkpoint(blocking=True)
        return (PreemptAck.DRAINED if time.monotonic() - t0 <= max(0.0, deadline - now)
                else PreemptAck.HARD_KILLED)

    def resume_marker(self) -> int:
        return self.step
