"""Optimizers on dicts of tensors keyed by parameter name: AdamW (default)
and Adafactor (factored second moment).  Port of ``repro.optim.optimizers``.

Each function takes and returns the JAX package's quantities: ``update``
returns the parameter deltas and the new ``OptState``.  Differences:

* AdamW updates its moments ``mu`` and ``nu`` in place (the returned state
  holds the same tensors), where the JAX package returns new trees; the
  arithmetic is the same, operation for operation, so the values are too.
* The JAX package stacks the L decoder layers into one leaf; here each
  layer's tensor is its own entry (``layers.<i>.<rest>``).  AdamW is
  elementwise, so that changes nothing.  Adafactor is not: it groups the
  entries of every ``<rest>`` and runs on their ``(L, ...)`` stack in layer
  order, so its factors (keyed ``layers.<rest>``), its row mean and its RMS
  clip are the JAX leaf's, and a ``(L, d)`` stack is factored; the deltas
  come back per layer.
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


def _stacks(tree: Tree) -> Tuple[Dict[str, torch.Tensor], Dict[str, list]]:
    """``(plain, groups)``: the entries without the ``layers.`` prefix, and
    the layer entries grouped by ``layers.<rest>``, each group a list of
    ``(i, name)`` in layer order."""
    plain, groups = {}, {}
    for k, t in tree.items():
        if k.startswith("layers."):
            _, i, rest = k.split(".", 2)
            groups.setdefault(f"layers.{rest}", []).append((int(i), k))
        else:
            plain[k] = t
    for key, items in groups.items():
        items.sort()
        if [i for i, _ in items] != list(range(len(items))):
            raise ValueError(f"{key}: layers {[i for i, _ in items]} are not 0..L-1")
    return plain, groups


def _nu_zeros(shape, device):
    if _factored(shape):
        return (torch.zeros(shape[:-1], dtype=F32, device=device),
                torch.zeros(shape[:-2] + shape[-1:], dtype=F32, device=device))
    return torch.zeros(shape, dtype=F32, device=device)


def adafactor_init(params: Tree) -> OptState:
    plain, groups = _stacks(params)
    nu = {k: _nu_zeros(tuple(p.shape), p.device) for k, p in plain.items()}
    for key, items in groups.items():
        p = params[items[0][1]]
        nu[key] = _nu_zeros((len(items),) + tuple(p.shape), p.device)
    return OptState(step=_step0(params), mu=None, nu=nu)


def _adafactor_leaf(g, nu, beta, eps, clip_threshold):
    """The JAX package's ``upd`` on one leaf (f32 ``g``): the new second
    moment and the clipped update."""
    g2 = torch.square(g) + eps
    if _factored(g.shape):
        row, col = nu
        row = beta * row + (1 - beta) * torch.mean(g2, dim=-1)
        col = beta * col + (1 - beta) * torch.mean(g2, dim=-2)
        row_mean = torch.mean(row, dim=-1, keepdim=True)
        vhat = (row / row_mean)[..., None] * col[..., None, :]
        new_nu = (row, col)
    else:
        vhat = beta * nu + (1 - beta) * g2
        new_nu = vhat
    update = g * torch.rsqrt(vhat + eps)
    rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-12)
    return new_nu, update / torch.clamp(rms / clip_threshold, min=1.0)


@torch.no_grad()
def adafactor_update(grads: Tree, state: OptState, params: Tree, lr: torch.Tensor,
                     decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
                     weight_decay: float = 0.0) -> Tuple[Tree, OptState]:
    step = state.step + 1
    beta = 1.0 - (step.to(F32) + 1.0) ** (-decay)
    plain, groups = _stacks(grads)
    delta, new_nu = {}, {}
    for k, g in plain.items():
        new_nu[k], update = _adafactor_leaf(g.to(F32), state.nu[k], beta, eps, clip_threshold)
        if weight_decay:
            update = update + weight_decay * params[k].to(F32)
        delta[k] = (-lr * update).to(params[k].dtype)
    for key, items in groups.items():
        g = torch.stack([grads[name].to(F32) for _, name in items])
        new_nu[key], update = _adafactor_leaf(g, state.nu[key], beta, eps, clip_threshold)
        del g
        for i, name in items:
            p = params[name]
            u = update[i] + weight_decay * p.to(F32) if weight_decay else update[i]
            delta[name] = (-lr * u).to(p.dtype)
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
