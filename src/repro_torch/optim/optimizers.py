"""Optimizers on dicts of tensors keyed by parameter name: AdamW (default)
and Adafactor (factored second moment).  Port of ``repro.optim.optimizers``.

Each function takes and returns the JAX package's quantities: ``update``
returns the parameter deltas and the new ``OptState``.  Differences:

* AdamW updates its moments ``mu`` and ``nu`` in place (the returned state
  holds the same tensors), where the JAX package returns new trees; the
  arithmetic is the same, operation for operation, so the values are too.
* The JAX package stacks scanned layers into one leaf; here each layer's
  tensor is its own entry: ``layers.<i>.<rest>`` for the (L, ...) stack,
  ``encoder.layers.<i>.<rest>`` for the encoder-decoder's encoder,
  ``mamba_groups.<g>.<i>.<rest>`` for the hybrid's (groups, every, ...)
  and ``mamba_tail.<i>.<rest>`` for its (tail, ...); xLSTM's
  ``layers.mlstm_<i>.*`` are whole leaves in the JAX tree too
  (``models.model.STACK_DEPTH`` names the stacks; a name that is neither
  raises).  AdamW is elementwise, so that changes nothing.  Adafactor is
  not: it keys its factors by the stacked leaf (``layers.<rest>``,
  ``encoder.layers.<rest>``, ``mamba_groups.<rest>``), factors over the stacked leaf's last two axes
  (so a ``(L, d)`` norm stack is factored, and a ``(groups, every, d)`` one
  over ``(every, d)`` in each group) and clips by the RMS of the whole
  stacked leaf's update.  Entries of two or more axes run entry by entry in
  two passes, so that no f32 temporary spans a stack (zamba2-7b's
  ``in_proj`` stack is 4.07e9 values); the deltas come back per entry.
* ``state_specs`` (shardings) has no counterpart on one card.

Scalars that JAX computes in f32 (``b1 ** step``, the learning rate, the
Adafactor decay) are f32 tensors here as well.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..models.model import STACK_DEPTH, stack_prefix

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


def _place(name: str):
    """``(stack key, index)`` of an entry of a stacked JAX leaf
    (``layers.<i>.<rest>`` → ``("layers.<rest>", (i,))``,
    ``encoder.layers.<i>.<rest>`` → ``("encoder.layers.<rest>", (i,))``,
    ``mamba_groups.<g>.<i>.<rest>`` → ``("mamba_groups.<rest>", (g, i))``;
    the stack's prefix matched by ``stack_prefix``, the longest first), or
    None for a leaf the JAX tree keeps whole (``embed``, ``shared.*``,
    ``encoder.final_norm``, xLSTM's ``layers.mlstm_<i>.*``: no part of the
    name is an integer)."""
    prefix = stack_prefix(name, STACK_DEPTH)
    if prefix is not None:
        parts = name[len(prefix) + 1:].split(".")
        depth = STACK_DEPTH[prefix]
        index, rest = parts[:depth], parts[depth:]
        if rest and all(p.isdigit() for p in index) and not any(p.isdigit() for p in rest):
            return ".".join((prefix, *rest)), tuple(map(int, index))
    if not any(p.isdigit() for p in name.split(".")):
        return None
    raise ValueError(f"adafactor: {name} is neither a whole leaf nor an entry of a stack "
                     f"{sorted(STACK_DEPTH)} (depths {STACK_DEPTH})")


def _stacks(tree: Tree) -> Tuple[Dict[str, torch.Tensor], Dict[str, list]]:
    """``(plain, groups)``: the entries the JAX tree keeps as whole leaves,
    and the entries of its stacked leaves grouped by stack key, each group a
    list of ``(index, name)`` in the stack's order (row-major)."""
    plain, groups = {}, {}
    for k, t in tree.items():
        placed = _place(k)
        if placed is None:
            plain[k] = t
        else:
            groups.setdefault(placed[0], []).append((placed[1], k))
    for key, items in groups.items():
        items.sort()
        if [i for i, _ in items] != list(itertools.product(*map(range, _lead(items)))):
            raise ValueError(f"{key}: stack indices {[i for i, _ in items]} are not a full grid")
    return plain, groups


def _lead(items) -> Tuple[int, ...]:
    """The stack's leading shape, from its sorted ``(index, name)`` list."""
    return tuple(n + 1 for n in items[-1][0])


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
        nu[key] = _nu_zeros(_lead(items) + tuple(p.shape), p.device)
    return OptState(step=_step0(params), mu=None, nu=nu)


def _vhat(row, col):
    row_mean = torch.mean(row, dim=-1, keepdim=True)
    return (row / row_mean)[..., None] * col[..., None, :]


def _adafactor_leaf(g, nu, beta, eps, clip_threshold):
    """The JAX package's ``upd`` on one leaf (f32 ``g``): the new second
    moment and the clipped update."""
    g2 = torch.square(g) + eps
    if _factored(g.shape):
        row, col = nu
        row = beta * row + (1 - beta) * torch.mean(g2, dim=-1)
        col = beta * col + (1 - beta) * torch.mean(g2, dim=-2)
        vhat = _vhat(row, col)
        new_nu = (row, col)
    else:
        vhat = beta * nu + (1 - beta) * g2
        new_nu = vhat
    update = g * torch.rsqrt(vhat + eps)
    rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-12)
    return new_nu, update / torch.clamp(rms / clip_threshold, min=1.0)


def _adafactor_stack(grads: Tree, items, nu, beta, eps, clip_threshold):
    """``_adafactor_leaf`` on a stacked leaf whose entries are at least 2-D,
    entry by entry, so that no f32 tensor spans the stack: an entry's factors
    (the means over its last axis and over its second-to-last, and the row
    factor's mean) are its own, and only the clip's mean of ``update²``
    spans the stack.  Pass 1 updates each entry's factors and adds up its
    sum of ``update²`` in f32; pass 2 yields ``(name, clipped update)`` for
    each entry in turn, the update recomputed from the new factors.  The
    arithmetic is the stacked leaf's, operation for operation, but for the
    order of that one cross-stack sum.  Returns the new ``(row, col)`` and
    pass 2."""
    row, col = nu
    new_row, new_col = torch.empty_like(row), torch.empty_like(col)
    ssq = torch.zeros((), dtype=F32, device=row.device)
    numel = 0
    for idx, name in items:
        g = grads[name].to(F32)
        g2 = torch.square(g) + eps
        new_row[idx] = beta * row[idx] + (1 - beta) * torch.mean(g2, dim=-1)
        new_col[idx] = beta * col[idx] + (1 - beta) * torch.mean(g2, dim=-2)
        del g2
        ssq += torch.sum(torch.square(g * torch.rsqrt(_vhat(new_row[idx], new_col[idx]) + eps)))
        numel += g.numel()
    rms = torch.sqrt(ssq / numel + 1e-12)
    clip = torch.clamp(rms / clip_threshold, min=1.0)

    def updates():
        for idx, name in items:
            g = grads[name].to(F32)
            yield name, g * torch.rsqrt(_vhat(new_row[idx], new_col[idx]) + eps) / clip

    return (new_row, new_col), updates()


@torch.no_grad()
def adafactor_update(grads: Tree, state: OptState, params: Tree, lr: torch.Tensor,
                     decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
                     weight_decay: float = 0.0) -> Tuple[Tree, OptState]:
    step = state.step + 1
    beta = 1.0 - (step.to(F32) + 1.0) ** (-decay)
    plain, groups = _stacks(grads)
    delta, new_nu = {}, {}

    def put(name, update):
        p = params[name]
        if weight_decay:
            update = update + weight_decay * p.to(F32)
        delta[name] = (-lr * update).to(p.dtype)

    for k, g in plain.items():
        new_nu[k], update = _adafactor_leaf(g.to(F32), state.nu[k], beta, eps, clip_threshold)
        put(k, update)
    for key, items in groups.items():
        if _factored(grads[items[0][1]].shape):
            new_nu[key], updates = _adafactor_stack(grads, items, state.nu[key], beta, eps,
                                                    clip_threshold)
            for name, update in updates:
                put(name, update)
            continue
        # entries of fewer than 2 axes: factored (or not) across the stack,
        # as the JAX leaf is; the stack holds a vector or scalar a layer
        g = torch.stack([grads[name].to(F32) for _, name in items]).reshape(
            _lead(items) + tuple(grads[items[0][1]].shape))
        new_nu[key], update = _adafactor_leaf(g, state.nu[key], beta, eps, clip_threshold)
        for idx, name in items:
            put(name, update[idx])
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
