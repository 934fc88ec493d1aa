"""Seeded fleet builders shared by the tests and ``chip_smoke.py`` (ports of
``benchmarks/common.py``'s fleets and ``bench_fig2_latency._packed_state``).

* ``empty_fleet`` — the paper's Table 1 nodes with nothing placed;
* ``saturated_fleet`` — the paper's §4.4.1 saturated geometry: 8-vcpu nodes
  each holding 4 medium instances, about half of them preemptible, with
  integer-minute start times;
* ``zoned_fleet`` — the same draws in failure zones, each zone filled to
  its own count of instances a host (the relocation plane's fleet);
* ``packed_arrays`` — double-size nodes whose K slots all hold small
  preemptible instances, built directly as state arrays (a python-``Host``
  build of 10^5 hosts would dwarf the measurement).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .types import VM_SPEC, Host, Instance

SIZES = {
    "small": VM_SPEC.make(vcpus=1, ram_mb=2000, disk_gb=20),
    "medium": VM_SPEC.make(vcpus=2, ram_mb=4000, disk_gb=40),
    "large": VM_SPEC.make(vcpus=4, ram_mb=8000, disk_gb=80),
}
#: paper Table 1 nodes (disk non-binding)
NODE_CAP = VM_SPEC.make(vcpus=8, ram_mb=16000, disk_gb=10_000)
#: double-size nodes for the K > 8 oversubscription sweep
BIG_NODE_CAP = VM_SPEC.make(vcpus=16, ram_mb=32000, disk_gb=10_000)
#: the fleets' reference clock (start times lie before it)
NOW = 1_000_000.0


def empty_fleet(n: int) -> List[Host]:
    return [Host(name=f"h{i}", capacity=NODE_CAP) for i in range(n)]


def saturated_fleet(n: int, seed: int = 0, preemptible_frac: float = 0.5,
                    k_max: int = 4) -> List[Host]:
    """Hosts filled with medium instances, mixed normal/preemptible, integer
    run-time minutes (paper §4.4.1 conditions); the same draws as the JAX
    package's ``benchmarks/common.py::saturated_fleet``."""
    rng = np.random.default_rng(seed)
    hosts = []
    iid = 0
    for i in range(n):
        h = Host(name=f"h{i}", capacity=NODE_CAP)
        n_pre = 0
        for _ in range(4):  # 4 medium slots per node
            pre = bool(rng.random() < preemptible_frac) and n_pre < k_max
            n_pre += int(pre)
            h.place(Instance(
                id=f"x{iid}", resources=SIZES["medium"], preemptible=pre,
                host=h.name, start_time=NOW - float(rng.integers(10, 500)) * 60.0,
            ))
            iid += 1
        if n_pre == 0:  # guarantee evacuability somewhere
            inst = next(iter(h.instances.values()))
            inst.preemptible = True
        hosts.append(h)
    return hosts


def zoned_fleet(n: int, per_host: Sequence[int], seed: int = 0,
                now: float = NOW) -> List[Host]:
    """Table 1 nodes in ``len(per_host)`` zones of ``n // len(per_host)``
    consecutive hosts (``z0``, ``z1``, ...); each host of zone z holds
    ``per_host[z]`` medium instances, drawn as ``saturated_fleet`` draws them
    (half preemptible, at least one a host) but started 1 to 29 minutes
    before ``now``: a storm then teaches its zone a churn rate of about
    1 / (mean age) = 4e-4 (10 to 499 minutes would give 6e-5, under the
    relocation plane's usual threshold of 1e-4)."""
    rng = np.random.default_rng(seed)
    size = n // len(per_host)
    hosts = []
    iid = 0
    for i in range(n):
        z = min(i // size, len(per_host) - 1)
        h = Host(name=f"h{i}", capacity=NODE_CAP, zone=f"z{z}")
        n_pre = 0
        for _ in range(per_host[z]):
            pre = bool(rng.random() < 0.5)
            n_pre += int(pre)
            h.place(Instance(
                id=f"x{iid}", resources=SIZES["medium"], preemptible=pre,
                host=h.name, start_time=now - float(rng.integers(1, 30)) * 60.0,
            ))
            iid += 1
        if n_pre == 0 and h.instances:
            next(iter(h.instances.values())).preemptible = True
        hosts.append(h)
    return hosts


def packed_arrays(n: int, k: int, seed: int = 0) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """``SoAFleetState`` fields as numpy arrays for N double-size nodes with
    k small preemptible slots each, and a request sized so that every
    decision evacuates exactly 2 of the k slots."""
    cap = np.asarray(BIG_NODE_CAP.vec, np.float32)
    small = np.asarray(SIZES["small"].vec, np.float32)
    rng = np.random.default_rng(seed)
    free_f = np.broadcast_to(cap - k * small, (n, 3)).copy()
    arrays = dict(
        free_f=free_f,
        free_n=np.broadcast_to(cap, (n, 3)).copy(),
        schedulable=np.ones((n,), bool),
        domain=np.zeros((n,), np.int32),
        slow=np.ones((n,), np.float32),
        inst_res=np.broadcast_to(small, (n, k, 3)).copy(),
        inst_start=(NOW - rng.integers(10, 500, (n, k)).astype(np.float32) * 60.0
                    ).astype(np.float32),
        inst_price=np.ones((n, k), np.float32),
        inst_ckpt=np.zeros((n, k), np.float32),
        inst_cost_kind=np.full((n, k), -1, np.int32),
        inst_period=np.full((n, k), -1.0, np.float32),
        inst_valid=np.ones((n, k), bool),
        host_zone=np.zeros((n,), np.int32),
        zone_term=np.zeros((1,), np.float32),
        zone_up=np.zeros((1,), np.float32),
    )
    free_vcpus = int(cap[0]) - k * int(small[0])
    req = VM_SPEC.make(
        vcpus=free_vcpus + 2 * int(small[0]),
        ram_mb=int(free_f[0, 1]) + 2 * int(small[1]),
        disk_gb=40,
    )
    return arrays, np.asarray(req.vec, np.float32)


def weigh_arrays(n: int, k: int, d: int, seed: int = 0) -> Tuple[np.ndarray, ...]:
    """Seeded inputs of the stage-2 enumeration (``sched_weigh``) off the
    integer grid: ``(free_f (n,d), inst_res (n,k,d), inst_cost (n,k),
    inst_valid (n,k), req (d,))``.  Fractional resources and costs; every
    other host's costs on a 0.5 grid (exact ties); on every fifth host with
    k >= 3 slot 0 costs exactly TIE_EPS (f32) more than slots 1 and 2
    together; a third of the slots invalid, and every 17th host none valid."""
    rng = np.random.default_rng(seed)
    cost = (rng.random((n, k)) * 3600).astype(np.float32)
    cost[::2] = np.round(cost[::2] / 300) * np.float32(0.5)
    if k >= 3:
        cost[::5, 0] = cost[::5, 1] + cost[::5, 2] + np.float32(1e-3)
    valid = rng.random((n, k)) < 0.67
    valid[::17] = False
    return ((rng.random((n, d)) * 8).astype(np.float32),
            (rng.random((n, k, d)) * 4).astype(np.float32), cost, valid,
            (rng.random(d) * 10 + 2).astype(np.float32))
