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
* A step's memory: ``clip_by_global_norm`` scales the gradients in place,
  and ``Optimizer.apply`` (``adamw_apply``, ``adafactor_apply``) adds each
  delta to its parameter as soon as it is made, so that no tree of deltas
  is held; ``update`` returns the deltas as the JAX package does.  The
  bits are the same either way.  A leaf of more than ``SLICE_BYTES`` in
  f32 is taken in slices along its leading axes by the global norm (the
  order of its one f32 sum of squares changes) and, as a stack's entry,
  by Adafactor (its factors are per slice; the order of the clip's sum of
  ``update²`` changes), so that no f32 temporary is larger than a slice.

Scalars that JAX computes in f32 (``b1 ** step``, the learning rate, the
Adafactor decay) are f32 tensors here as well.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Tuple, Union

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
    #: the deltas as a tree and the new state (the JAX package's ``update``)
    update: Callable[[Tree, OptState, Tree, torch.Tensor], Tuple[Tree, OptState]]
    #: the same deltas added to the parameters in place as each is made;
    #: returns the new state
    apply: Callable[[Tree, OptState, Tree, torch.Tensor], OptState]


#: the f32 bytes of one slice of a large leaf: no f32 temporary of the
#: global norm or of Adafactor's update of a stack entry is larger
#: (arctic-480b's expert stacks hold 4.46e9 values a layer, 17.8 GB in f32)
SLICE_BYTES = 1 << 28


def _rows_per_slice(shape) -> int:
    """Rows of the leading axis a slice of a ``shape`` leaf takes: as many
    as ``SLICE_BYTES`` of f32 hold, at least 1."""
    return max(1, SLICE_BYTES // (4 * math.prod(shape[1:])))


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ x² in f32; a leaf over ``SLICE_BYTES`` in f32 summed slice by
    slice along its leading axis."""
    if x.dim() == 0 or 4 * x.numel() <= SLICE_BYTES:
        return torch.sum(torch.square(x.to(F32)))
    parts = (torch.sum(torch.square(part.to(F32)))
             for part in torch.split(x, _rows_per_slice(x.shape)))
    return functools.reduce(torch.add, parts)


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(_square_sum(x) for x in tree.values()))


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """The gradients scaled in place (``g.mul_(scale)``: the bits of
    ``g * scale``) and their global norm; returns ``tree`` itself."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in tree.values():
        g.mul_(scale)
    return tree, norm


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


#: where an update's deltas go: ``put(name, part, delta)``, ``delta`` of
#: parameter ``name`` whole (``part`` None) or of the slice ``part`` of its
#: leading axes (``_part``)
Put = Callable[[str, Optional[slice], torch.Tensor], None]


def _part(t: torch.Tensor, part: Optional[slice]) -> torch.Tensor:
    """``t`` whole, or the slice ``part`` of its leading axes flattened (a
    view of ``t``: its last two axes kept)."""
    return t if part is None else t.view(-1, *t.shape[-2:])[part]


def _collect(delta: Tree, params: Tree) -> Put:
    """A ``Put`` that builds the tree of deltas."""
    def put(name, part, d):
        if part is None:
            delta[name] = d
        else:
            if name not in delta:
                delta[name] = torch.empty_like(params[name])
            _part(delta[name], part).copy_(d)
    return put


def _adder(params: Tree) -> Put:
    """A ``Put`` that adds each delta to its parameter as it comes
    (``apply_updates``'s ``p + d`` in p's type, one leaf or slice at a time)."""
    def put(name, part, d):
        _part(params[name], part).add_(d)
    return put


def _adamw(grads: Tree, state: OptState, params: Tree, lr: torch.Tensor, put: Put,
           b1: float, b2: float, eps: float, weight_decay: float) -> OptState:
    step = state.step + 1
    stepf = step.to(F32)
    bc1 = 1 - torch.tensor(b1, dtype=F32, device=stepf.device) ** stepf
    bc2 = 1 - torch.tensor(b2, dtype=F32, device=stepf.device) ** stepf
    for k, g in grads.items():
        g = g.to(F32)
        m, v, p = state.mu[k], state.nu[k], params[k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        update = update + weight_decay * p.to(F32)
        put(k, None, (-lr * update).to(p.dtype))
    return OptState(step=step, mu=state.mu, nu=state.nu)


@torch.no_grad()
def adamw_update(grads: Tree, state: OptState, params: Tree, lr: torch.Tensor,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Tree, OptState]:
    delta = {}
    state = _adamw(grads, state, params, lr, _collect(delta, params), b1, b2, eps, weight_decay)
    return delta, state


@torch.no_grad()
def adamw_apply(grads: Tree, state: OptState, params: Tree, lr: torch.Tensor,
                b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                weight_decay: float = 0.1) -> OptState:
    """``adamw_update`` with each delta added to its parameter as made."""
    return _adamw(grads, state, params, lr, _adder(params), b1, b2, eps, weight_decay)


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
    moment and the clipped update.  Temporaries are updated in place where
    that gives the same bits (``r.mul_(g)`` for ``g * r``), so that at most
    three tensors of the leaf's size are alive at once beside ``g``."""
    g2 = torch.square(g).add_(eps)
    if _factored(g.shape):
        row, col = nu
        row = beta * row + (1 - beta) * torch.mean(g2, dim=-1)
        col = beta * col + (1 - beta) * torch.mean(g2, dim=-2)
        del g2
        update = _vhat(row, col).add_(eps).rsqrt_().mul_(g)
        new_nu = (row, col)
    else:
        vhat = beta * nu + (1 - beta) * g2
        del g2
        update = torch.rsqrt(vhat + eps).mul_(g)
        new_nu = vhat
    rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-12)
    return new_nu, update.div_(torch.clamp(rms / clip_threshold, min=1.0))


def _entry_slices(shape):
    """The slices along an entry's leading axes, flattened (``_part``), that
    ``_adafactor_stack`` takes in turn: each at most ``SLICE_BYTES`` of f32
    but one (d, f) matrix at least."""
    lead = math.prod(shape[:-2])
    n = _rows_per_slice((lead,) + tuple(shape[-2:]))
    return [slice(a, a + n) for a in range(0, lead, n)]


def _adafactor_stack(grads: Tree, items, nu, beta, eps, clip_threshold):
    """``_adafactor_leaf`` on a stacked leaf whose entries are at least 2-D,
    entry by entry and, within an entry, slice by slice along its leading
    axes (an (E, d, f) expert stack in slices of experts), so that no f32
    tensor is larger than ``SLICE_BYTES`` or one (d, f) matrix: a matrix's
    factors (the means over its last axis and over its second-to-last, and
    the row factor's mean) are its own, and only the clip's mean of
    ``update²`` spans the stack.  Pass 1 updates each slice's factors and
    adds up its sum of ``update²`` in f32; pass 2 yields ``(name, part,
    clipped update)`` for each slice in turn (``part`` None for a 2-D
    entry), the update recomputed from the new factors.  The arithmetic is
    the stacked leaf's, operation for operation, but for the order of that
    one cross-stack sum.  Returns the new ``(row, col)`` and pass 2."""
    row, col = nu
    new_row, new_col = torch.empty_like(row), torch.empty_like(col)
    ssq = torch.zeros((), dtype=F32, device=row.device)
    numel = 0

    def slices() -> Iterator:
        """(name, part, g, old row, old col, new row, new col) of each slice:
        a 2-D entry whole (``part`` None), a larger one by ``_part``."""
        for idx, name in items:
            g = grads[name]
            factors = (row[idx], col[idx], new_row[idx], new_col[idx])
            if g.dim() == 2:
                yield (name, None, g) + factors
                continue
            g3 = g.reshape(-1, *g.shape[-2:])
            factors = tuple(t.view(-1, t.shape[-1]) for t in factors)
            for part in _entry_slices(g.shape):
                yield (name, part, g3[part]) + tuple(t[part] for t in factors)

    for _, _, g, r0, c0, r1, c1 in slices():
        g = g.to(F32)
        g2 = torch.square(g) + eps
        r1.copy_(beta * r0 + (1 - beta) * torch.mean(g2, dim=-1))
        c1.copy_(beta * c0 + (1 - beta) * torch.mean(g2, dim=-2))
        del g2
        ssq += torch.sum(torch.square(g * torch.rsqrt(_vhat(r1, c1) + eps)))
        numel += g.numel()
    rms = torch.sqrt(ssq / numel + 1e-12)
    clip = torch.clamp(rms / clip_threshold, min=1.0)

    def updates():
        for name, part, g, _, _, r1, c1 in slices():
            g = g.to(F32)
            yield name, part, g * torch.rsqrt(_vhat(r1, c1) + eps) / clip

    return (new_row, new_col), updates()


def _adafactor(grads: Tree, state: OptState, params: Tree, lr: torch.Tensor, put: Put,
               decay: float, eps: float, clip_threshold: float,
               weight_decay: float) -> OptState:
    step = state.step + 1
    beta = 1.0 - (step.to(F32) + 1.0) ** (-decay)
    plain, groups = _stacks(grads)
    new_nu = {}

    def put_update(name, part, update):
        """``-lr (update + weight_decay p)`` in p's type, in place on the
        fresh ``update`` (the bits of the out-of-place formula)."""
        p = _part(params[name], part)
        if weight_decay:
            update.add_(p.to(F32, copy=True).mul_(weight_decay))
        put(name, part, update.mul_(-lr).to(p.dtype))

    for k, g in plain.items():
        new_nu[k], update = _adafactor_leaf(g.to(F32), state.nu[k], beta, eps, clip_threshold)
        put_update(k, None, update)
        del update
    for key, items in groups.items():
        if _factored(grads[items[0][1]].shape):
            new_nu[key], updates = _adafactor_stack(grads, items, state.nu[key], beta, eps,
                                                    clip_threshold)
            for name, part, update in updates:
                put_update(name, part, update)
            continue
        # entries of fewer than 2 axes: factored (or not) across the stack,
        # as the JAX leaf is; the stack holds a vector or scalar a layer
        g = torch.stack([grads[name].to(F32) for _, name in items]).reshape(
            _lead(items) + tuple(grads[items[0][1]].shape))
        new_nu[key], update = _adafactor_leaf(g, state.nu[key], beta, eps, clip_threshold)
        for idx, name in items:
            put_update(name, None, update[idx])
    return OptState(step=step, mu=None, nu=new_nu)


@torch.no_grad()
def adafactor_update(grads: Tree, state: OptState, params: Tree, lr: torch.Tensor,
                     decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
                     weight_decay: float = 0.0) -> Tuple[Tree, OptState]:
    delta = {}
    state = _adafactor(grads, state, params, lr, _collect(delta, params), decay, eps,
                       clip_threshold, weight_decay)
    return delta, state


@torch.no_grad()
def adafactor_apply(grads: Tree, state: OptState, params: Tree, lr: torch.Tensor,
                    decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
                    weight_decay: float = 0.0) -> OptState:
    """``adafactor_update`` with each delta (of a leaf, or of a slice of a
    stack's entry) added to its parameter as made."""
    return _adafactor(grads, state, params, lr, _adder(params), decay, eps, clip_threshold,
                      weight_decay)


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
        return Optimizer("adamw", adamw_init, functools.partial(adamw_update, **kw),
                         functools.partial(adamw_apply, **kw))
    if name == "adafactor":
        return Optimizer("adafactor", adafactor_init, functools.partial(adafactor_update, **kw),
                         functools.partial(adafactor_apply, **kw))
    raise ValueError(name)
