"""Training step factory: microbatched gradient accumulation, global-norm
clip, optional int8 gradient compression, optimizer update (port of
``repro.training.train_step``).

``make_train_step`` returns ``train_step(params, opt_state, batch)`` →
``(params, opt_state, metrics)``, as in the JAX package.  ``params`` is a
``Model``; the step updates its parameters and the optimizer's moments in
place under ``torch.no_grad()`` (the JAX package donates them to jit) and
returns the same objects: the clip scales the gradients in place and
``Optimizer.apply`` adds each delta as it is made, so no tree of scaled
gradients or of deltas is held (the bits of the JAX package's formulas).
The batch may hold numpy arrays or tensors; it moves to the parameters'
device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.model import Model, forward_train, torch_dtype
from ..optim.optimizers import (
    Optimizer,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
)


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    microbatches: int = 1
    #: dtype of the accumulated gradient over microbatches
    accum_dtype: str = "float32"
    #: simulated int8 compression of the gradient (the cross-pod wire format)
    grad_compression: str = "none"  # none | int8
    weight_decay: float = 0.1


def _compress_int8(g: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 quantize → dequantize of a gradient."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(g.dtype) * scale


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, torch.Tensor) else v)
            .to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, settings: TrainSettings,
                    optimizer: Optional[Optimizer] = None) -> Callable:
    optimizer = optimizer or make_optimizer(cfg.optimizer, weight_decay=settings.weight_decay)
    schedule = cosine_schedule(settings.learning_rate, settings.warmup_steps,
                               settings.total_steps)
    n_mb = settings.microbatches
    accum_dtype = torch_dtype(settings.accum_dtype)

    def grads_of(params: Model, batch):
        loss, metrics = forward_train(cfg, params, batch)
        names, leaves = zip(*params.named_parameters())
        return loss.detach(), metrics, dict(zip(names, torch.autograd.grad(loss, leaves)))

    def train_step(params: Model, opt_state, batch):
        batch = _to_device(batch, params.embed.device)
        if n_mb == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            rows = next(iter(batch.values())).shape[0] // n_mb
            acc = {n: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                   for n, p in params.named_parameters()}
            losses, ms = [], []
            for i in range(n_mb):
                one = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                loss_i, m_i, g = grads_of(params, one)
                for n, a in acc.items():
                    a += g[n].to(accum_dtype)
                del g
                losses.append(loss_i)
                ms.append(m_i)
            # the mean in place (the bits of ``a / n_mb``)
            grads = {n: a.div_(n_mb).to(torch.float32) for n, a in acc.items()}
            del acc
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms])) for k in ms[0]}
        if settings.grad_compression == "int8":
            grads = {n: _compress_int8(g) for n, g in grads.items()}
        # the clip scales the gradients in place, and the optimizer adds
        # each delta to its parameter as it makes it: beside the parameters
        # and their gradients a step holds only one leaf's (or one slice's)
        # temporaries
        grads, gnorm = clip_by_global_norm(grads, settings.clip_norm)
        lr = schedule(opt_state.step)
        with torch.no_grad():
            opt_state = optimizer.apply(grads, opt_state, dict(params.named_parameters()), lr)
        del grads
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def eval_step(params: Model, batch):
        _, metrics = forward_train(cfg, params, _to_device(batch, params.embed.device))
        return metrics

    return eval_step
