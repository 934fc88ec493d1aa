"""Select-and-terminate (paper Alg. 5): pick the cost-minimal feasible subset
of preemptible instances on a host.

Feasibility note (fidelity): the paper's *pseudocode* tests
``sum(instances.resources) > req.resources`` — ignoring the host's existing
free resources and using a strict inequality.  Its *evaluation* (Table 6:
terminating only BP3, a small instance, to admit a medium request on a host
with one small slot already free) shows the implementation actually tests

    free_full + sum(freed) >= req.resources        (component-wise)

which is what we implement.  See DESIGN.md §Paper-fidelity.

Complexity: exact enumeration is O(2^K) over the K preemptible instances on
one host.  K is small in practice (the paper's testbed: ≤4); we enumerate
exactly up to ``exact_k`` and fall back to a greedy + prune heuristic above
it.  The rebuild-per-call scheduler (``core.torch_scheduler``) evaluates all
2^K masks in one kernel launch.

A copy of ``repro.core.select_terminate`` (numpy only), kept in
the PyTorch port so that it never imports the JAX package; the same inputs
give the same plan, slot order (instance ids as strings) included.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .cost import CostFunction
from .types import (
    EMPTY_PLAN,
    INFEASIBLE_PLAN,
    Host,
    Instance,
    Request,
    TerminationPlan,
)

DEFAULT_EXACT_K = 16


def best_plan(
    host: Host,
    req: Request,
    cost_fn: CostFunction,
    now: float,
    exact_k: int = DEFAULT_EXACT_K,
) -> TerminationPlan:
    """Return the cost-minimal feasible termination plan for ``req`` on
    ``host`` (EMPTY_PLAN when no termination is needed)."""
    free = host.free_full
    if req.resources.fits_in(free):
        return EMPTY_PLAN

    preemptible = sorted(host.preemptible_instances(), key=lambda i: i.id)
    if not preemptible:
        return INFEASIBLE_PLAN

    deficit = req.resources - free  # what termination must cover (>= 0 dims matter)
    need = np.maximum(deficit.vec, 0.0)

    if len(preemptible) <= exact_k:
        return _exact(preemptible, need, cost_fn, now)
    return _greedy(preemptible, need, cost_fn, now)


def _exact(
    insts: Sequence[Instance],
    need: np.ndarray,
    cost_fn: CostFunction,
    now: float,
) -> TerminationPlan:
    k = len(insts)
    res = np.stack([i.resources.vec for i in insts])  # (K, D)
    best_cost = float("inf")
    best_mask = None
    best_size = k + 1
    # Enumerate all non-empty subsets; vectorize the feasibility test in
    # blocks to keep this fast for K up to 16 (65536 subsets).
    masks = np.arange(1, 1 << k, dtype=np.uint32)
    bits = ((masks[:, None] >> np.arange(k)[None, :]) & 1).astype(np.float64)  # (M, K)
    freed = bits @ res  # (M, D)
    feasible = np.all(freed >= need[None, :] - 1e-9, axis=1)
    for m in np.nonzero(feasible)[0]:
        sel = [insts[j] for j in range(k) if bits[m, j]]
        c = cost_fn.cost(sel, now)
        size = len(sel)
        if c < best_cost - 1e-12 or (abs(c - best_cost) <= 1e-12 and size < best_size):
            best_cost, best_mask, best_size = c, m, size
    if best_mask is None:
        return INFEASIBLE_PLAN
    chosen = tuple(insts[j] for j in range(k) if bits[best_mask, j])
    return TerminationPlan(instances=chosen, cost=best_cost, feasible=True)


def _greedy(
    insts: Sequence[Instance],
    need: np.ndarray,
    cost_fn: CostFunction,
    now: float,
) -> TerminationPlan:
    """Greedy fallback: repeatedly take the instance with the lowest
    cost-per-unit-of-deficit-covered, then prune redundant members."""
    remaining = list(insts)
    chosen: List[Instance] = []
    deficit = need.copy()
    while np.any(deficit > 1e-9):
        if not remaining:
            return INFEASIBLE_PLAN

        def score(i: Instance) -> float:
            covered = float(np.sum(np.minimum(i.resources.vec, deficit)))
            c = cost_fn.cost([i], now)
            return c / covered if covered > 1e-9 else float("inf")

        remaining.sort(key=score)
        nxt = remaining.pop(0)
        if not np.any(np.minimum(nxt.resources.vec, deficit) > 1e-9):
            continue  # covers nothing useful
        chosen.append(nxt)
        deficit = np.maximum(deficit - nxt.resources.vec, 0.0)

    # prune: drop members whose removal keeps the plan feasible (cheapest-first)
    chosen.sort(key=lambda i: -cost_fn.cost([i], now))
    pruned = list(chosen)
    for cand in list(pruned):
        rest = [i for i in pruned if i is not cand]
        freed = np.sum([i.resources.vec for i in rest], axis=0) if rest else 0.0
        if rest and np.all(freed >= need - 1e-9):
            pruned = rest
    return TerminationPlan(
        instances=tuple(sorted(pruned, key=lambda i: i.id)),
        cost=cost_fn.cost(pruned, now),
        feasible=True,
    )


def plan_for_host(
    host: Host,
    req: Request,
    cost_fn: CostFunction,
    now: float,
    cache: Optional[dict] = None,
    exact_k: int = DEFAULT_EXACT_K,
) -> TerminationPlan:
    """Memoized ``best_plan`` — the weighing phase and the terminate phase of
    one scheduling call share plans (single-pass efficiency; see DESIGN.md)."""
    if cache is None:
        return best_plan(host, req, cost_fn, now, exact_k)
    key = (host.name, req.id)
    if key not in cache:
        cache[key] = best_plan(host, req, cost_fn, now, exact_k)
    return cache[key]
