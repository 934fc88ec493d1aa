"""Modular host filters (phase 1 of the paper's Alg. 2).

A filter sees the *view-appropriate* free resources: for a normal request the
scheduler passes ``h_n`` (free_normal), for a preemptible request ``h_f``
(free_full) — that single switch is the paper's core trick, removing the
retry cycle.

A verbatim copy of ``repro.core.filters`` (pure python), kept in the PyTorch
port so that it never imports the JAX package.
"""
from __future__ import annotations

import abc
from typing import List, Sequence

from .types import Host, Request, Resources


class Filter(abc.ABC):
    """Boolean predicate over (host, request, view-free-resources)."""

    name: str = "filter"

    @abc.abstractmethod
    def host_passes(self, host: Host, req: Request, free: Resources) -> bool:
        ...


class SchedulableFilter(Filter):
    """Drops hosts that are draining / failed (fault-tolerance hook)."""

    name = "schedulable"

    def host_passes(self, host: Host, req: Request, free: Resources) -> bool:
        return host.schedulable


class ResourceFilter(Filter):
    """The paper's RAM/CPU fit filter, generalized to the resource vector."""

    name = "resource_fit"

    def host_passes(self, host: Host, req: Request, free: Resources) -> bool:
        return req.resources.fits_in(free)


class DomainFilter(Filter):
    """TPU adaptation: jobs pinned to an ICI domain only match hosts in it."""

    name = "domain"

    def host_passes(self, host: Host, req: Request, free: Resources) -> bool:
        return req.domain is None or host.domain == req.domain


class AntiAffinityFilter(Filter):
    """Rejects hosts already running an instance of the same user when the
    request carries ``anti_affinity=True`` (paper §2.1 'direct user input')."""

    name = "anti_affinity"

    def host_passes(self, host: Host, req: Request, free: Resources) -> bool:
        if not req.metadata.get("anti_affinity"):
            return True
        return all(i.user != req.user for i in host.instances.values())


DEFAULT_FILTERS: Sequence[Filter] = (
    SchedulableFilter(),
    DomainFilter(),
    AntiAffinityFilter(),
    ResourceFilter(),
)


def run_filters(
    filters: Sequence[Filter], host: Host, req: Request, free: Resources
) -> bool:
    return all(f.host_passes(host, req, free) for f in filters)
