"""The JAX package's parameter tree and optimizer state (as numpy) to the
port's modules and dicts, and back.

The JAX tree nests dicts and stacks scanned layers on leading axes
(``layers/attn/wq`` is (L, d, H*hd), an expert leaf ``layers/moe/wg`` (L, E,
d, F); the encoder-decoder's ``encoder/layers/attn/wq`` (L_enc, d, H*hd)
beside its unstacked ``encoder/final_norm``; the hybrid's
``mamba_groups/in_proj`` (groups, every, d, ·) and ``mamba_tail/in_proj``
(tail, d, ·)); the port keeps one module per layer (``layers.<i>.attn.wq``
is (d, H*hd), ``layers.<i>.moe.wg`` (E, d, F), ``encoder.layers.<i>.attn.wq``,
``mamba_groups.<g>.<i>.in_proj``, ``mamba_tail.<i>.in_proj``) and keys
AdamW's moments by the same names (``model.stacks`` says which subtrees
are stacked, ``model.stack_prefix`` finds a name's; xLSTM's unrolled
``layers.mlstm_<i>`` are not).  Adafactor's second moment stays stacked in
the port too (its ``(row, col)`` factors belong to the whole stacked
leaf), keyed by the JAX leaf's name: ``layers.<rest>``,
``encoder.layers.<rest>``, ``mamba_groups.<rest>``, ``mamba_tail.<rest>``,
and xLSTM's ``layers.mlstm_<i>.<rest>`` as they are.  Every direction
copies the values exactly.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.torch_scheduler import resolve_device
from ..optim.optimizers import OptState
from .model import Model, _leaves, stack_prefix, stacks


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch.from_numpy
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _flat_from_tree(cfg: ModelConfig, tree: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A JAX tree (numpy leaves, stacked layers) as tensors keyed by the
    port's parameter names."""
    flat, stacked = {}, stacks(cfg)
    for name, a in _leaves(tree):
        prefix = stack_prefix(name, stacked)
        if prefix is None:
            flat[name] = _to_tensor(a, device)
            continue
        rest = name[len(prefix) + 1:]
        lead = stacked[prefix][0]
        if np.shape(a)[:len(lead)] != lead:
            raise ValueError(f"{name}: stacked {np.shape(a)[:len(lead)]}, config has {lead}")
        for index in np.ndindex(*lead):
            key = ".".join((prefix, *map(str, index), rest))
            flat[key] = _to_tensor(np.asarray(a)[index], device)
    return flat


def _nu_from_tree(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """Adafactor's second-moment tree as the port keeps it: one entry per
    JAX leaf (stacks kept whole), a ``(row, col)`` pair where factored."""
    return {name: tuple(_to_tensor(x, device) for x in a) if isinstance(a, tuple)
            else _to_tensor(a, device) for name, a in _leaves(tree)}


def _numpy(t: torch.Tensor) -> np.ndarray:
    arr = t.detach().cpu()
    return arr.float().numpy() if arr.dtype == torch.bfloat16 else arr.numpy()


def _put(tree: Dict[str, Any], name: str, value) -> None:
    node = tree
    *path, leaf = name.split(".")
    for key in path:
        node = node.setdefault(key, {})
    node[leaf] = value


def _tree_from_flat(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Tensors keyed by the port's parameter names as a JAX tree: numpy
    leaves, layers stacked (every numeric part of a name is a stack index:
    ``mamba_groups.<g>.<i>.<rest>`` stacks to (groups, every, ...))."""
    tree: Dict[str, Any] = {}
    stacked: Dict[str, list] = {}
    for name, t in flat.items():
        parts = name.split(".")
        index = tuple(int(p) for p in parts if p.isdigit())
        if index:
            key = ".".join(p for p in parts if not p.isdigit())
            stacked.setdefault(key, []).append((index, _numpy(t)))
        else:
            _put(tree, name, _numpy(t))
    for key, items in stacked.items():
        items.sort(key=lambda x: x[0])
        lead = tuple(n + 1 for n in items[-1][0])
        if [i for i, _ in items] != list(np.ndindex(*lead)):
            raise ValueError(f"{key}: stack indices {[i for i, _ in items]} are not a full grid")
        arr = np.stack([a for _, a in items])
        _put(tree, key, arr.reshape(lead + arr.shape[1:]))
    return tree


def _nu_to_tree(nu: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``_nu_from_tree``: numpy leaves, pairs kept."""
    tree: Dict[str, Any] = {}
    for name, t in nu.items():
        _put(tree, name, tuple(_numpy(x) for x in t) if isinstance(t, tuple) else _numpy(t))
    return tree


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], device=None) -> Model:
    """The JAX parameter tree (numpy leaves, stacked layers) as a ``Model``."""
    device = resolve_device(device)
    model = Model(cfg, device="meta")
    model.load_state_dict(_flat_from_tree(cfg, tree, device), assign=True, strict=True)
    return model


def params_to_numpy(params: Model) -> Dict[str, Any]:
    """A ``Model`` as the JAX parameter tree: numpy leaves, layers stacked."""
    return _tree_from_flat(params.state_dict())


def opt_state_from_numpy(cfg: ModelConfig, state, device=None) -> OptState:
    """The JAX package's ``OptState`` (numpy leaves) as the port's: AdamW's
    ``mu`` and ``nu`` trees shaped like the parameters, split per layer;
    Adafactor's (``mu`` None) ``nu`` with its ``(row, col)`` pairs, stacked
    as in the JAX package."""
    device = resolve_device(device)
    step, mu, nu = state
    step = torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device)
    if mu is None:
        stacked = stacks(cfg)
        for name, a in _leaves(nu):
            lead = stacked.get(stack_prefix(name, stacked), ((),))[0]
            n = np.shape(a[0] if isinstance(a, tuple) else a)[:len(lead)]
            if n != lead:
                raise ValueError(f"{name}: stacked {n}, config has {lead}")
        return OptState(step=step, mu=None, nu=_nu_from_tree(nu, device))
    return OptState(step=step, mu=_flat_from_tree(cfg, mu, device),
                    nu=_flat_from_tree(cfg, nu, device))


def opt_state_to_numpy(state: OptState) -> OptState:
    """The port's ``OptState`` with the JAX package's leaves: an int32 numpy
    step and numpy trees with stacked layers, Adafactor's factor pairs as
    tuples (``repro.optim.OptState(*opt_state_to_numpy(s))`` rebuilds the
    JAX container)."""
    step = np.asarray(int(state.step), dtype=np.int32)
    if state.mu is None:
        return OptState(step=step, mu=None, nu=_nu_to_tree(state.nu))
    return OptState(step=step, mu=_tree_from_flat(state.mu), nu=_tree_from_flat(state.nu))
