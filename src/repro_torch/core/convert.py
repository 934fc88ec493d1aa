"""Carry a fleet state across: numpy arrays ↔ ``SoAFleetState`` tensors.

The arrays use the JAX package's field names and dtypes, so a reference
state turned into numpy (``np.asarray`` on each field) feeds the port, and a
port state read back compares field for field.  The round trip is exact for
every dtype (bool, int32, float32).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .torch_scheduler import STATE_DTYPES, SoAFleetState, resolve_device

_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}


def fleet_state_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> SoAFleetState:
    """Build a ``SoAFleetState`` on ``device`` (``None`` = the card) from one
    numpy array per field.  Raises on a missing field or a value the field's
    dtype cannot hold exactly."""
    dev = resolve_device(device)
    missing = set(STATE_DTYPES) - set(arrays)
    if missing:
        raise ValueError(f"fleet_state_from_numpy: missing fields {sorted(missing)}")
    fields = {}
    for name, dtype in STATE_DTYPES.items():
        src = np.asarray(arrays[name])
        arr = np.ascontiguousarray(src, dtype=_NP_DTYPES[dtype])
        if not np.array_equal(arr, src):
            raise ValueError(f"fleet_state_from_numpy: {name} does not fit {dtype}")
        fields[name] = torch.from_numpy(arr.copy()).to(dev)
    return SoAFleetState(**fields)


def fleet_state_to_numpy(state: SoAFleetState) -> Dict[str, np.ndarray]:
    """One numpy array per field, under the JAX package's field names."""
    return {name: getattr(state, name).cpu().numpy() for name in STATE_DTYPES}
