"""Device-sharded fleet state: the mesh, host-major padding and placement,
and the cross-shard shortlist merge (port of ``repro.core.fleet_sharding``).

The stage-1 screen reads every host.  The sharded path splits the per-host
rows *host-major* into one block a shard, each block on its own device for
the life of the fleet, and runs the screen kernels on each block
(``torch_scheduler._sharded_screen``).  Only two things cross shards:

* the 10 normalization scalars (``ScreenConsts``), merged with ``amin`` /
  ``amax``: min and max do not reassociate, so the merged constants are
  bitwise the fleet-wide folds;
* each shard's top-(M+1) by ``omega_ub``, with global host indices, merged
  by ``merge_shortlists`` in ``lax.top_k``'s order (score descending, ties
  to the lowest index).

Everything after the merge (the M candidate rows gathered from their
owning shards, stage 2, the admissibility check) runs on the lead device,
``mesh.devices[0]``, so sharded decisions are the unsharded ones bit for
bit.

One controller process drives every shard, as the JAX package's
``shard_map`` inside one jitted decision does: a ``FleetMesh`` is a tuple
of ``torch.device``s, the host-side mirror (``SoAFleet``'s slot map, the
locator) exists once, and each shard's launches are queued on its device's
current stream before anything is read back.  A mesh may name one device
several times: ``fleet_mesh(devices=["cpu"] * 4)`` runs four shards on the
CPU (the counterpart of the JAX package's
``--xla_force_host_platform_device_count``), ``fleet_mesh(devices=["cuda:0"]
* 4)`` four on one card.

Padding: every shard holds the same number of hosts, at least ``M + 1``
(its top-M and a witness).  ``padded_hosts`` gives the padded row count and
``pad_fleet_state`` appends all-zero rows: ``schedulable`` and
``inst_valid`` False, so padding hosts are invalid everywhere, score
``NEG_INF`` and, with the highest indices, lose every tie to a real host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from .screen_math import POS_INF
from .torch_scheduler import (
    HOST_STATE_DTYPES,
    STATE_DTYPES,
    SoAFleetState,
    SoAHostState,
    resolve_device,
)

#: name of the mesh's one axis (the host partition)
HOST_AXIS = "hosts"

#: state fields indexed by zone, not by host: never padded, held once on the
#: lead device.  Matched by NAME: the zone count may equal the host count.
ZONE_FIELDS = frozenset({"zone_term", "zone_up"})

_INT32_MAX = 2**31 - 1


def canonical_device(device) -> torch.device:
    """``device`` validated (a CUDA device must exist), with a CUDA index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """A 1-D mesh of shards, one device each (a device may repeat).
    Frozen and hashable, so it can ride on a ``SchedulerPolicy``."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a FleetMesh needs at least one device")
        object.__setattr__(self, "devices", tuple(canonical_device(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (HOST_AXIS,)

    @property
    def lead(self) -> torch.device:
        """Where the merge, stage 2 and the zone accumulators live."""
        return self.devices[0]


def fleet_mesh(
    n_shards: Optional[int] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> FleetMesh:
    """A 1-D mesh for host-major fleet sharding.

    ``devices`` defaults to every visible CUDA device, and raises when there
    is none (a mesh never drops to the CPU unasked); pass
    ``devices=["cpu"] * 4`` for four shards on the CPU or ``["cuda:0"] * 4``
    for four on one card.  ``n_shards`` takes the first that many."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fleet_mesh(): no CUDA device is visible; pass devices= "
                "(for instance devices=['cpu'] * 4) to shard on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_shards is not None:
        if n_shards > len(devices):
            raise ValueError(f"n_shards={n_shards} > {len(devices)} visible devices")
        devices = devices[:n_shards]
    return FleetMesh(tuple(devices))


def padded_hosts_for(n_hosts: int, policy) -> int:
    """``padded_hosts`` with the shard count and the largest shortlist read
    off a policy (``policy.mesh`` must be set): what ``SoAFleet`` pads a
    sharded fleet to at build."""
    if policy.mesh is None:
        raise ValueError("padded_hosts_for needs a policy with mesh set")
    return padded_hosts(n_hosts, policy.mesh.size, m_keep=policy.max_shortlist() + 1)


def padded_hosts(n_hosts: int, n_shards: int, m_keep: int = 65) -> int:
    """Smallest row count that splits into ``n_shards`` equal blocks of at
    least ``m_keep`` (= M + 1) hosts each."""
    per_shard = max(math.ceil(n_hosts / n_shards), m_keep)
    return n_shards * per_shard


def pad_fleet_state(state, n_padded: int):
    """Append all-zero host rows to every per-host field of an unsharded
    ``SoAFleetState`` or ``SoAHostState`` up to ``n_padded`` rows (a new
    state; ``state`` is left as it is).  The zone accumulators
    (``ZONE_FIELDS``) pass through unpadded.  Returns ``state`` itself when
    it already has at least ``n_padded`` rows."""
    n = state.free_f.shape[0]
    if n_padded <= n:
        return state
    updates = {}
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        if x is None or f.name in ZONE_FIELDS:
            continue
        pad = torch.zeros((n_padded - n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        updates[f.name] = torch.cat([x, pad])
    return dataclasses.replace(state, **updates)


@dataclasses.dataclass(frozen=True)
class ShardedState:
    """A ``SoAFleetState`` or ``SoAHostState`` split host-major across a
    mesh: ``blocks[s]`` holds hosts ``s·T .. (s+1)·T - 1`` on
    ``mesh.devices[s]``, with the unsharded class's fields and dtypes.  The
    blocks of a fleet state share one ``zone_term`` / ``zone_up`` pair on
    the lead device.  The transitions update the blocks in place."""

    blocks: Tuple[Union[SoAFleetState, SoAHostState], ...]
    mesh: FleetMesh

    @property
    def shard_hosts(self) -> int:
        """T, the hosts of each block."""
        return self.blocks[0].free_f.shape[0]

    @property
    def n_hosts(self) -> int:
        return self.shard_hosts * len(self.blocks)

    @property
    def k_slots(self) -> int:
        return self.blocks[0].inst_res.shape[1]

    @property
    def device(self) -> torch.device:
        return self.mesh.lead

    @property
    def zone_term(self) -> torch.Tensor:
        return self.blocks[0].zone_term

    @property
    def zone_up(self) -> torch.Tensor:
        return self.blocks[0].zone_up

    def locate(self, host_idx: int):
        """``(block, row in the block)`` of global host ``host_idx``."""
        s, local = divmod(int(host_idx), self.shard_hosts)
        return self.blocks[s], local

    def field(self, name: str) -> torch.Tensor:
        """One per-host field of the whole fleet, on the lead device."""
        return torch.cat([getattr(b, name).to(self.device) for b in self.blocks])

    def gather(self):
        """The unsharded state on the lead device (a copy): what
        ``np.asarray`` of a sharded array is in the JAX package."""
        first = self.blocks[0]
        fields = {}
        for f in dataclasses.fields(first):
            if getattr(first, f.name) is None:
                fields[f.name] = None
            elif f.name in ZONE_FIELDS:
                fields[f.name] = getattr(first, f.name).clone()
            else:
                fields[f.name] = self.field(f.name)
        return type(first)(**fields)


def shard_fleet_state(state, mesh: FleetMesh) -> ShardedState:
    """Split an unsharded ``SoAFleetState`` or ``SoAHostState`` host-major
    across ``mesh``: each block a copy on its device, the zone accumulators
    one copy on the lead device.  The row count must already divide by the
    mesh size (``pad_fleet_state(state, padded_hosts(...))``)."""
    if not isinstance(mesh, FleetMesh):
        raise TypeError("shard_fleet_state: mesh must be a FleetMesh (see fleet_mesh)")
    if not isinstance(state, (SoAFleetState, SoAHostState)):
        raise TypeError(f"shard_fleet_state: cannot shard a {type(state).__name__}")
    n = state.free_f.shape[0]
    if n % mesh.size:
        raise ValueError(
            f"fleet size {n} does not divide across {mesh.size} shards; "
            "pad with pad_fleet_state(state, padded_hosts(...)) first"
        )
    t = n // mesh.size
    zones = {f: getattr(state, f).to(mesh.lead).clone() for f in ZONE_FIELDS
             if hasattr(state, f)}
    dtypes = STATE_DTYPES if isinstance(state, SoAFleetState) else HOST_STATE_DTYPES
    blocks = []
    for s, dev in enumerate(mesh.devices):
        fields = {}
        for name in dtypes:
            x = getattr(state, name)
            if name in zones:
                fields[name] = zones[name]
            elif x is not None:
                fields[name] = x[s * t:(s + 1) * t].to(dev).clone()
            else:
                fields[name] = None
        blocks.append(type(state)(**fields))
    return ShardedState(tuple(blocks), mesh)


def _sort_key(neg: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One int64 key per ``(neg, idx)`` pair whose ascending order is
    ``lax.sort((neg, idx), num_keys=2)``'s: the float's bits made
    order-preserving (``-0.0`` folded into ``+0.0``, as ``lax.sort``
    compares them equal) in the high 32 bits, the index in the low."""
    bits = (neg + 0.0).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    return ordered * (1 << 32) + idx.long()


def _sort_pairs(neg: torch.Tensor, idx: torch.Tensor):
    order = torch.sort(_sort_key(neg, idx), stable=True).indices
    return neg[order], idx[order]


def merge_shortlists(
    scores: torch.Tensor,  # (S·(M+1),) each shard's top-M and witness omega_ub
    idxs: torch.Tensor,    # (S·(M+1),) their GLOBAL host indices
    m_cand: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge the shards' forwarded candidates into the global top-M and the
    admissibility witness: ``(cand (M,) int32, u, j_u)``, ``cand`` in
    ``lax.top_k``'s order (score descending, ties to the lowest index) and
    ``(u, j_u)`` the best remaining candidate.

    The reference's two ``lax.sort`` passes, each one stable sort of an
    int64 key (``torch.topk`` keeps no tie order).  Between them duplicate
    hosts (adjacent after the first sort) get the key ``+POS_INF`` and the
    index int32-max, which sorts them behind every real entry: ``+POS_INF``
    equals a real ``NEG_INF`` score's ``-NEG_INF``, and the index breaks
    that tie.  Sorting moves values and never recombines them, so ``u``
    holds a shard's score bit for bit."""
    neg = -scores
    idx = idxs.to(torch.int32)
    neg_s, idx_s = _sort_pairs(neg, idx)
    dup = torch.cat([torch.zeros((1,), dtype=torch.bool, device=idx_s.device),
                     idx_s[1:] == idx_s[:-1]])
    neg_s = torch.where(dup, POS_INF, neg_s)
    idx_s = torch.where(dup, _INT32_MAX, idx_s)
    neg_s, idx_s = _sort_pairs(neg_s, idx_s)
    return idx_s[:m_cand], -neg_s[m_cand], idx_s[m_cand]
