"""The JAX package's parameter tree and AdamW state (as numpy) to the port's
modules and dicts, and back.

The JAX tree nests dicts and stacks the L decoder layers on a leading axis
(``layers/attn/wq`` is (L, d, H*hd)); the port keeps one module per layer
(``layers.<i>.attn.wq`` is (d, H*hd)) and keys optimizer moments by the
same names.  Every direction copies the values exactly.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.torch_scheduler import resolve_device
from ..optim.optimizers import OptState
from .model import Model, _leaves


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch.from_numpy
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _flat_from_tree(cfg: ModelConfig, tree: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A JAX tree (numpy leaves, stacked layers) as tensors keyed by the
    port's parameter names."""
    flat = {}
    for name, a in _leaves(tree):
        if isinstance(a, tuple):
            raise NotImplementedError(
                f"{name}: factored (Adafactor) moments do not carry across: the JAX package "
                "factors the stacked (L, ...) leaf, the port each layer's tensor (ROADMAP §1 "
                "item 12)")
        if name.startswith("layers."):
            if np.shape(a)[0] != cfg.n_layers:
                raise ValueError(f"{name}: {np.shape(a)[0]} stacked layers, config has "
                                 f"{cfg.n_layers}")
            for i in range(cfg.n_layers):
                flat[f"layers.{i}.{name[7:]}"] = _to_tensor(np.asarray(a)[i], device)
        else:
            flat[name] = _to_tensor(a, device)
    return flat


def _tree_from_flat(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Tensors keyed by the port's parameter names as a JAX tree: numpy
    leaves, layers stacked."""
    tree: Dict[str, Any] = {}
    stacks: Dict[str, list] = {}

    def put(name, value):
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value

    for name, t in flat.items():
        arr = t.detach().cpu()
        arr = arr.float().numpy() if arr.dtype == torch.bfloat16 else arr.numpy()
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            stacks.setdefault(rest, []).append((int(i), arr))
        else:
            put(name, arr)
    for rest, items in stacks.items():
        put(f"layers.{rest}", np.stack([a for _, a in sorted(items, key=lambda x: x[0])]))
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
    """The JAX package's AdamW ``OptState`` (``step``, ``mu`` and ``nu``
    trees shaped like the parameters, numpy leaves) as the port's."""
    device = resolve_device(device)
    step, mu, nu = state
    return OptState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
                    mu=_flat_from_tree(cfg, mu, device), nu=_flat_from_tree(cfg, nu, device))


def opt_state_to_numpy(state: OptState) -> OptState:
    """The port's AdamW ``OptState`` with the JAX package's leaves: an int32
    numpy step and numpy trees with stacked layers (``repro.optim.OptState(
    *opt_state_to_numpy(s))`` rebuilds the JAX container)."""
    if not isinstance(next(iter(state.nu.values())), torch.Tensor) or state.mu is None:
        raise NotImplementedError("opt_state_to_numpy carries AdamW state only "
                                  "(ROADMAP §1 item 12)")
    return OptState(step=np.asarray(int(state.step), dtype=np.int32),
                    mu=_tree_from_flat(state.mu), nu=_tree_from_flat(state.nu))
