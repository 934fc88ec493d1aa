"""Batched serving engine: wave batching over prefill and decode steps,
preemption-aware (port of ``repro.serving.engine``).

A *wave* admits up to ``max_batch`` queued requests, pads their prompts on
the left to a common length with token 0 (the model attends to the pads, as
in the JAX package), primes the KV cache with one prefill call, then decodes
the whole wave together with greedy argmax.  On a PREEMPT signal the engine
finishes the in-flight decode step, re-queues the unfinished requests, and
acks DRAINED: serving replicas are stateless, so the scheduler's
RecomputeCost treats them as free to evacuate.

The engine runs where its parameters live; it casts them to the compute
dtype once, where the JAX package casts inside every jitted step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.preemption import PreemptAck
from ..models.model import Model, _cast, check_prefill, decode_step, prefill


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 256
    eos_id: int = 1


@dataclasses.dataclass
class RequestState:
    rid: str
    prompt: np.ndarray
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)


class ServingEngine:
    job_id = "serve"

    def __init__(self, cfg: ModelConfig, params: Model, scfg: ServeConfig):
        check_prefill(cfg)
        self.cfg = cfg
        self.scfg = scfg
        self.params = params
        self._params_c = _cast(params, cfg)
        self.device = params.embed.device
        self._decode = lambda p, t, s: decode_step(cfg, p, t, s)
        self._prefill = lambda p, toks: prefill(cfg, p, toks, scfg.max_len)
        self.queue: List[RequestState] = []
        self.completed: Dict[str, List[int]] = {}
        self._preempted = False
        self.steps_executed = 0

    # -- client API -------------------------------------------------------------
    def submit(self, rid: str, prompt: np.ndarray, max_new: int = 32) -> None:
        self.queue.append(RequestState(rid=rid, prompt=prompt, max_new=max_new))

    def run_until_drained(self) -> Dict[str, List[int]]:
        while self.queue and not self._preempted:
            self._run_wave()
        return self.completed

    # -- engine internals ----------------------------------------------------------
    def _run_wave(self) -> None:
        wave = [self.queue.pop(0) for _ in range(min(self.scfg.max_batch, len(self.queue)))]
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((len(wave), plen), np.int64)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt  # right-aligned padding
        logits, state = self._prefill(self._params_c, torch.from_numpy(toks).to(self.device))
        nxt = torch.argmax(logits[:, -1, :], -1)[:, None]
        for i, v in enumerate(nxt[:, 0].tolist()):
            wave[i].out.append(int(v))

        done = [False] * len(wave)
        max_new = max(r.max_new for r in wave)
        budget = min(max_new, self.scfg.max_len - plen)
        for _ in range(budget - 1):
            if all(done):
                break
            logits, state = self._decode(self._params_c, nxt, state)
            self.steps_executed += 1
            nxt = torch.argmax(logits[:, -1, :], -1)[:, None]
            vals = nxt[:, 0].tolist()
            for i, r in enumerate(wave):
                if done[i]:
                    continue
                r.out.append(int(vals[i]))
                if int(vals[i]) == self.scfg.eos_id or len(r.out) >= r.max_new:
                    done[i] = True
            if self._preempted:
                break

        for i, r in enumerate(wave):
            if done[i] or len(r.out) >= r.max_new or not self._preempted:
                self.completed[r.rid] = list(r.out)
            else:  # preempted mid-wave: re-queue from scratch
                r.out.clear()
                self.queue.insert(0, r)

    # -- PreemptibleJob protocol ------------------------------------------------
    def on_preempt(self, now: float, deadline: float) -> PreemptAck:
        self._preempted = True
        return PreemptAck.DRAINED
