"""Carry a fleet state across: numpy arrays ↔ the port's state tensors.

The arrays use the JAX package's field names and dtypes, so a reference
state turned into numpy (``np.asarray`` on each field) feeds the port, and a
port state read back compares field for field.  Three states cross:
``SoAFleetState`` (the persistent path, ``fleet_state_*``),
``SoAHostState`` (the rebuild-per-call path, ``host_state_*``, whose
``churn`` and ``host_zone`` columns may be absent) and
``AdmissionQueueState`` (the admission plane's wait queue,
``queue_state_*``).  The round trip is exact for every dtype (bool, int32,
float32).

With ``mesh=`` the first two build a sharded state
(``fleet_sharding.shard_fleet_state``): the JAX package's padded state
turned into numpy feeds the port's sharded path, and ``*_to_numpy`` reads a
sharded state back whole (``ShardedState.gather``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .admission import QUEUE_DTYPES, AdmissionQueueState
from .fleet_sharding import FleetMesh, ShardedState, shard_fleet_state
from .torch_scheduler import (
    HOST_STATE_DTYPES,
    HOST_STATE_OPTIONAL,
    STATE_DTYPES,
    SoAFleetState,
    SoAHostState,
    resolve_device,
)

_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}


def _field(where: str, name: str, src, dtype: torch.dtype, dev) -> torch.Tensor:
    src = np.asarray(src)
    arr = np.array(src, dtype=_NP_DTYPES[dtype])   # a C-contiguous copy, 0-d kept
    if not np.array_equal(arr, src):
        raise ValueError(f"{where}: {name} does not fit {dtype}")
    return torch.from_numpy(arr).to(dev)


def _placed(state, mesh: Optional[FleetMesh]):
    return state if mesh is None else shard_fleet_state(state, mesh)


def _whole(state):
    return state.gather() if isinstance(state, ShardedState) else state


def fleet_state_from_numpy(arrays: Dict[str, np.ndarray], device=None,
                           mesh: Optional[FleetMesh] = None):
    """Build a ``SoAFleetState`` on ``device`` (``None`` = the card, or the
    mesh's lead device) from one numpy array per field, sharded across
    ``mesh`` when it is given (the row count must divide by its size).
    Raises on a missing field or a value the field's dtype cannot hold
    exactly."""
    dev = resolve_device(mesh.lead if mesh is not None and device is None else device)
    missing = set(STATE_DTYPES) - set(arrays)
    if missing:
        raise ValueError(f"fleet_state_from_numpy: missing fields {sorted(missing)}")
    return _placed(SoAFleetState(**{
        name: _field("fleet_state_from_numpy", name, arrays[name], dtype, dev)
        for name, dtype in STATE_DTYPES.items()}), mesh)


def fleet_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """One numpy array per field, under the JAX package's field names (a
    sharded state read back whole)."""
    state = _whole(state)
    return {name: getattr(state, name).cpu().numpy() for name in STATE_DTYPES}


def host_state_from_numpy(arrays: Dict[str, np.ndarray], device=None,
                          mesh: Optional[FleetMesh] = None):
    """Build a ``SoAHostState`` on ``device`` (``None`` = the card, or the
    mesh's lead device) from one numpy array per field, sharded across
    ``mesh`` when it is given; ``churn`` and ``host_zone`` may be missing or
    None.  Raises on a missing required field or a value the field's dtype
    cannot hold exactly."""
    dev = resolve_device(mesh.lead if mesh is not None and device is None else device)
    missing = set(HOST_STATE_DTYPES) - set(HOST_STATE_OPTIONAL) - set(arrays)
    if missing:
        raise ValueError(f"host_state_from_numpy: missing fields {sorted(missing)}")
    return _placed(SoAHostState(**{
        name: _field("host_state_from_numpy", name, arrays[name], dtype, dev)
        for name, dtype in HOST_STATE_DTYPES.items()
        if arrays.get(name) is not None}), mesh)


def host_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """One numpy array per field that the state holds (``churn`` and
    ``host_zone`` only when present), under the JAX package's field names
    (a sharded state read back whole)."""
    state = _whole(state)
    return {name: getattr(state, name).cpu().numpy() for name in HOST_STATE_DTYPES
            if getattr(state, name) is not None}


def queue_state_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> AdmissionQueueState:
    """Build an ``AdmissionQueueState`` on ``device`` (``None`` = the card)
    from one numpy array per field (``next_seq`` 0-d).  Raises on a missing
    field or a value the field's dtype cannot hold exactly."""
    dev = resolve_device(device)
    missing = set(QUEUE_DTYPES) - set(arrays)
    if missing:
        raise ValueError(f"queue_state_from_numpy: missing fields {sorted(missing)}")
    return AdmissionQueueState(**{
        name: _field("queue_state_from_numpy", name, arrays[name], dtype, dev)
        for name, dtype in QUEUE_DTYPES.items()})


def queue_state_to_numpy(q: AdmissionQueueState) -> Dict[str, np.ndarray]:
    """One numpy array per field, under the JAX package's field names."""
    return {name: getattr(q, name).cpu().numpy() for name in QUEUE_DTYPES}
