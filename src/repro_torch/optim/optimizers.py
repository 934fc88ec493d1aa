"""Optimizers on dicts of tensors keyed by parameter name: AdamW (default)
and Adafactor (factored second moment).  Port of ``repro.optim.optimizers``.

Each function takes and returns the JAX package's quantities: ``update``
returns the parameter deltas and the new ``OptState``.  Differences:

* AdamW updates its moments ``mu`` and ``nu`` in place (the returned state
  holds the same tensors), where the JAX package returns new trees; the
  arithmetic is the same, operation for operation, so the values are too.
* The JAX package stacks the L decoder layers into one leaf; here each
  layer's tensor is its own entry.  AdamW is elementwise, so that changes
  nothing; Adafactor factors and clips each entry alone, so on a stacked
  model its per-layer statistics differ from the JAX package's (no config
  of the ported families uses it; ROADMAP §1 item 12).
* ``state_specs`` (shardings) has no counterpart on one card.

Scalars that JAX computes in f32 (``b1 ** step``, the learning rate, the
Adafactor decay) are f32 tensors here as well.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

Tree = Dict[str, torch.Tensor]
F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor               # () int32
    mu: Optional[Tree]               # AdamW: first moment | Adafactor: None
    #: AdamW: second moment | Adafactor: (row, col) factors or a full moment
    nu: Dict[str, Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Tree], OptState]
    update: Callable[[Tree, OptState, Tree, torch.Tensor], Tuple[Tree, OptState]]


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32))) for x in tree.values()))


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g * scale for k, g in tree.items()}, norm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(F32)
        warm = base_lr * torch.clamp(step / max(1, warmup), max=1.0)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)

    return lr


def _step0(tree: Tree) -> torch.Tensor:
    device = next(iter(tree.values())).device if tree else None
    return torch.zeros((), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params: Tree) -> OptState:
    zeros = lambda: {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                     for k, p in params.items()}
    return OptState(step=_step0(params), mu=zeros(), nu=zeros())


@torch.no_grad()
def adamw_update(grads: Tree, state: OptState, params: Tree, lr: torch.Tensor,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Tree, OptState]:
    step = state.step + 1
    stepf = step.to(F32)
    bc1 = 1 - torch.tensor(b1, dtype=F32, device=stepf.device) ** stepf
    bc2 = 1 - torch.tensor(b2, dtype=F32, device=stepf.device) ** stepf
    delta = {}
    for k, g in grads.items():
        g = g.to(F32)
        m, v, p = state.mu[k], state.nu[k], params[k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        update = update + weight_decay * p.to(F32)
        delta[k] = (-lr * update).to(p.dtype)
    return delta, OptState(step=step, mu=state.mu, nu=state.nu)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; no first moment)
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params: Tree) -> OptState:
    def nu_init(p):
        if _factored(p.shape):
            return (torch.zeros(p.shape[:-1], dtype=F32, device=p.device),
                    torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32, device=p.device))
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    return OptState(step=_step0(params), mu=None, nu={k: nu_init(p) for k, p in params.items()})


@torch.no_grad()
def adafactor_update(grads: Tree, state: OptState, params: Tree, lr: torch.Tensor,
                     decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
                     weight_decay: float = 0.0) -> Tuple[Tree, OptState]:
    step = state.step + 1
    beta = 1.0 - (step.to(F32) + 1.0) ** (-decay)
    delta, new_nu = {}, {}
    for k, g in grads.items():
        g = g.to(F32)
        p, nu = params[k], state.nu[k]
        g2 = torch.square(g) + eps
        if _factored(g.shape):
            row, col = nu
            row = beta * row + (1 - beta) * torch.mean(g2, dim=-1)
            col = beta * col + (1 - beta) * torch.mean(g2, dim=-2)
            row_mean = torch.mean(row, dim=-1, keepdim=True)
            vhat = (row / row_mean)[..., None] * col[..., None, :]
            new_nu[k] = (row, col)
        else:
            vhat = beta * nu + (1 - beta) * g2
            new_nu[k] = vhat
        update = g * torch.rsqrt(vhat + eps)
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-12)
        update = update / torch.clamp(rms / clip_threshold, min=1.0)
        if weight_decay:
            update = update + weight_decay * p.to(F32)
        delta[k] = (-lr * update).to(p.dtype)
    return delta, OptState(step=step, mu=None, nu=new_nu)


@torch.no_grad()
def apply_updates(params: Tree, delta: Tree) -> Tree:
    """``p + d`` in p's type, in place (the JAX package returns a new tree)."""
    for k, p in params.items():
        p.add_(delta[k].to(p.dtype))
    return params


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return Optimizer("adamw", adamw_init, functools.partial(adamw_update, **kw))
    if name == "adafactor":
        return Optimizer("adafactor", adafactor_init, functools.partial(adafactor_update, **kw))
    raise ValueError(name)
