"""Deterministic synthetic LM data pipeline (a copy of
``repro.data.pipeline``, which is numpy; ``make_batch_specs``, the JAX dry
run's stand-ins, is left out: ROADMAP §1 item 17).

Production shape: an infinite, *seekable* stream — ``state = (seed, step)``
is the entire cursor, so a preempted job that restores ``step`` from its
checkpoint resumes on exactly the token stream it would have seen (tested in
tests/test_torch_training.py).  Host-side numpy generation, double-buffered
prefetch thread, per-shard slicing for multi-host feeds.

The token distribution is a order-0 Markov chain with a learnable structure
(deterministic per position block), so small models actually reduce loss —
giving the example scripts a real training signal.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    #: this host's shard of the global batch (host_id, n_hosts)
    host_shard: Tuple[int, int] = (0, 1)


class SyntheticLMDataset:
    """Infinite deterministic stream of (tokens, labels) batches."""

    def __init__(self, cfg: DataConfig, prefetch: int = 2):
        self.cfg = cfg
        host, n_hosts = cfg.host_shard
        assert cfg.global_batch % n_hosts == 0
        self.local_batch = cfg.global_batch // n_hosts
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._step = 0

    # -- deterministic batch at an arbitrary step ------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        host, _ = cfg.host_shard
        rng = np.random.default_rng((cfg.seed, step, host))
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab_size
        # Markov-ish stream: next token = (a*tok + drift) % V with noise.
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        drift = rng.integers(1, 7)
        noise = rng.random((b, s)) < 0.1
        rand = rng.integers(0, v, (b, s))
        for t in range(s):
            nxt = (toks[:, t] * 31 + drift) % v
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # -- prefetching iterator ----------------------------------------------------
    def start(self, from_step: int = 0) -> None:
        self._step = from_step
        self._stop.clear()

        def worker():
            step = from_step
            while not self._stop.is_set():
                batch = self.batch_at(step)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __next__(self) -> Tuple[int, Dict[str, np.ndarray]]:
        if self._thread is None:
            batch = self.batch_at(self._step)
            self._step += 1
            return self._step - 1, batch
        return self._q.get()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        while not self._q.empty():
            self._q.get_nowait()
