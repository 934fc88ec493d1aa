"""The JAX package's parameter tree (as numpy) to the port's modules and back.

The JAX tree nests dicts and stacks the L decoder layers on a leading axis
(``layers/attn/wq`` is (L, d, H*hd)); the port keeps one module per layer
(``layers.<i>.attn.wq`` is (d, H*hd)).  Both directions copy the values
exactly.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.torch_scheduler import resolve_device
from .model import Model, _leaves


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch.from_numpy
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], device=None) -> Model:
    """The JAX parameter tree (numpy leaves, stacked layers) as a ``Model``."""
    device = resolve_device(device)
    state = {}
    for name, a in _leaves(tree):
        if name.startswith("layers."):
            if np.shape(a)[0] != cfg.n_layers:
                raise ValueError(f"{name}: {np.shape(a)[0]} stacked layers, config has "
                                 f"{cfg.n_layers}")
            for i in range(cfg.n_layers):
                state[f"layers.{i}.{name[7:]}"] = _to_tensor(np.asarray(a)[i], device)
        else:
            state[name] = _to_tensor(a, device)
    model = Model(cfg, device="meta")
    model.load_state_dict(state, assign=True, strict=True)
    return model


def params_to_numpy(params: Model) -> Dict[str, Any]:
    """A ``Model`` as the JAX parameter tree: numpy leaves, layers stacked."""
    tree: Dict[str, Any] = {}
    stacks: Dict[str, list] = {}

    def put(name, value):
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value

    for name, t in params.state_dict().items():
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
