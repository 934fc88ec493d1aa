"""Fleet construction helpers (copy of ``repro.core.cluster.make_uniform_fleet``).

The JAX package's ``Cluster`` state machine drives the python reference
scheduler, which this port does not carry; only the fleet builder is needed.
"""
from __future__ import annotations

from typing import List

from .types import Host, Resources


def make_uniform_fleet(
    n_hosts: int,
    capacity: Resources,
    domain_size: int = 0,
    name_prefix: str = "host",
) -> List[Host]:
    """Build a uniform fleet; ``domain_size`` groups hosts into ICI domains."""
    hosts = []
    for i in range(n_hosts):
        dom = f"dom{i // domain_size}" if domain_size else "d0"
        hosts.append(Host(name=f"{name_prefix}-{i}", capacity=capacity, domain=dom))
    return hosts
