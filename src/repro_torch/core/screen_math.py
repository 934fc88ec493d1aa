"""Stage-1 screen and bounds math, in PyTorch (port of ``repro.core.screen_math``).

The same functions, the same argument layout (slot-major rows: ``res_rows[i]``
is ``(D, X)`` and ``cost_rows[i]`` is ``(X,)`` for X hosts) and the same float
operations in the same order as the JAX module, so that on integer-valued
inputs every output is bitwise equal to the jitted reference.  The CUDA
kernels in ``repro_torch.kernels`` repeat these operations per host.

**Fused multiply-adds.**  Jitted XLA on the CPU contracts ``a*b + c`` into one
fused multiply-add (FMA, a single rounding), and eager PyTorch does not.  Where
the reference contracts, this module calls :func:`fma` (``torch.addcmul``,
which rounds once on the CPU and on the card), and the kernels call
``__fmaf_rn``; everything else in the kernels is compiled with
``--fmad=false``.  Which operand XLA fuses follows from its simplifier (a
multiplier of 1 or -1 is no product) and LLVM's contraction order (the left
operand of an add is fused first).  ``tests/test_torch_screen_math.py`` pins
every site against the jitted reference on non-integer inputs.

**Traced multipliers.**  The JAX package's ensemble and ``simulate_scan(mult=)``
pass the weigher multipliers into the decision as jit arguments, while the
policy's own multipliers stay compile-time *gates*: which terms exist, which
constants fold, and the bound's side.  XLA then cannot drop a product by 1 or
factor out a shared power of two, so it rounds elsewhere.  ``consts_of``,
``base_terms`` and ``omega_of`` take ``gates`` (``gate``) for that program:
the multipliers are the row's values, the gates the policy's; ``gates=None``
is the static program.  See :func:`_traced_chain` for where it rounds.
"""
from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

NEG_INF = -1e30
POS_INF = 1e30
#: resource-comparison slack (integer-valued resources make it inert).
EPS = 1e-6
#: degenerate-span guard for the [0, 1] weight normalizations.
NORM_EPS = 1e-12
#: Termination-cost tie-break epsilon of the Alg. 5 enumeration: subsets
#: whose cost is within TIE_EPS of the optimum count as tied and resolve by
#: (fewer instances, lower mask index).  One constant shared by the kernels
#: and the plain versions.
TIE_EPS = 1e-3
#: number of packed ``ScreenConsts`` scalars.
N_CONSTS = 10
#: uptime floor of the churn rate ẑ = T / max(U, CHURN_EPS).
CHURN_EPS = 1e-6


def fma(a, b, c) -> torch.Tensor:
    """``a*b + c`` with one rounding (``torch.addcmul`` fuses on CPU and
    CUDA; pinned against a correctly rounded reference by the tests)."""
    if not isinstance(c, torch.Tensor):
        ref = a if isinstance(a, torch.Tensor) else b
        c = torch.full_like(ref, c)
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=c.dtype, device=c.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=c.dtype, device=c.device)
    return torch.addcmul(c, a, b)


@functools.lru_cache(maxsize=None)
def oem_pairs(n: int) -> Tuple[Tuple[int, int], ...]:
    """Compare-exchange pairs of Batcher's odd-even mergesort for n lanes."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


def sort_rows(
    rows: Sequence[torch.Tensor], descending: bool = False
) -> List[torch.Tensor]:
    """Sort K row tensors elementwise with Batcher's network."""
    rows = list(rows)
    for i, j in oem_pairs(len(rows)):
        lo = torch.minimum(rows[i], rows[j])
        hi = torch.maximum(rows[i], rows[j])
        rows[i], rows[j] = (hi, lo) if descending else (lo, hi)
    return rows


def total_rows(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sequential sum of row tensors (one canonical add order)."""
    tot = rows[0]
    for row in rows[1:]:
        tot = tot + row
    return tot


def screen_bounds_rows(
    need: torch.Tensor,
    res_rows: Sequence[torch.Tensor],
    cost_rows: Sequence[torch.Tensor],
    total_cost: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage-1 per-host screening terms ``(feasible, overcommitted, cost_lb,
    cost_ub)``, each (X,); see ``repro.core.screen_math.screen_bounds_rows``
    for the semantics of each term."""
    k = len(res_rows)
    res_desc = sort_rows(res_rows, descending=True)
    lacking = torch.zeros(need.shape, dtype=torch.int32, device=need.device)
    prefix = torch.zeros_like(need)
    for row in res_desc:
        prefix = prefix + row
        lacking = lacking + (prefix < need - EPS).to(torch.int32)
    feasible = torch.all(prefix >= need - EPS, dim=0)
    overcommitted = torch.any(need > EPS, dim=0)
    m_d = torch.where(need > EPS, lacking + 1, 0)
    m_star = torch.clamp(torch.amax(m_d, dim=0), max=k)
    cost_asc = sort_rows(cost_rows)
    lb = torch.zeros_like(cost_asc[0])
    for i, row in enumerate(cost_asc):
        lb = lb + torch.where(i < m_star, row, 0.0)
    cost_lb = torch.where(overcommitted, lb, 0.0)
    cost_ub = torch.where(overcommitted, total_cost, 0.0)
    return feasible, overcommitted, cost_lb, cost_ub


class ScreenConsts(NamedTuple):
    """Global normalization constants of one decision (f32 scalars):
    the termination-cost envelope and the min/max of the four raw weigher
    terms.  Terms whose multiplier is 0 keep the fold identities."""

    c_lo: torch.Tensor
    c_hi: torch.Tensor
    over_lo: torch.Tensor
    over_hi: torch.Tensor
    pack_lo: torch.Tensor
    pack_hi: torch.Tensor
    strag_lo: torch.Tensor
    strag_hi: torch.Tensor
    churn_lo: torch.Tensor = POS_INF
    churn_hi: torch.Tensor = NEG_INF

    def pack(self) -> torch.Tensor:
        dev = self.c_lo.device if isinstance(self.c_lo, torch.Tensor) else None
        return torch.stack([
            torch.as_tensor(x, dtype=torch.float32, device=dev) for x in self
        ])

    @classmethod
    def unpack(cls, arr: torch.Tensor) -> "ScreenConsts":
        return cls(*(arr[i] for i in range(N_CONSTS)))


def churn_of(
    zone_term: torch.Tensor, zone_up: torch.Tensor, host_zone: torch.Tensor
) -> torch.Tensor:
    """Per-host learned churn rate ẑ = T/max(U, ε), gathered by zone id."""
    rate = zone_term / torch.clamp(zone_up, min=CHURN_EPS)
    return rate[host_zone.long()]


def churn_stats(zone_term: torch.Tensor, zone_up: torch.Tensor) -> torch.Tensor:
    """(Z+1,): the per-zone rates followed by the fleet-wide rate."""
    rate = zone_term / torch.clamp(zone_up, min=CHURN_EPS)
    fleet = torch.sum(zone_term) / torch.clamp(torch.sum(zone_up), min=CHURN_EPS)
    return torch.cat([rate, fleet[None]])


def raw_base_terms(
    free_f_sum: torch.Tensor,
    slow: torch.Tensor,
    overcommitted: torch.Tensor,
    churn: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Raw weigher terms ``(over_raw, pack_raw, strag_raw[, churn_raw])``."""
    over_raw = torch.where(overcommitted, -1.0, 0.0).to(free_f_sum.dtype)
    out = (over_raw, -free_f_sum, -slow)
    if churn is None:
        return out
    return out + (-churn,)


def _m_churn(multipliers) -> float:
    """5th (churn) multiplier of a 4- or 5-tuple; 0 when absent."""
    return multipliers[4] if len(multipliers) > 4 else 0.0


def consts_of(
    multipliers: Tuple[float, ...],
    valid: torch.Tensor,
    cost_lb: torch.Tensor,
    cost_ub: torch.Tensor,
    over_raw: torch.Tensor,
    pack_raw: torch.Tensor,
    strag_raw: torch.Tensor,
    churn_raw: Optional[torch.Tensor] = None,
    gates: Optional[Tuple[float, ...]] = None,
) -> ScreenConsts:
    """Fold the per-host terms into ``ScreenConsts`` (min/max folds are
    order-free, so every fold order gives the same constants).  A weigher's
    pair folds when its gate (``gates``, else its multiplier) is not 0."""
    g = multipliers if gates is None else gates
    m_over, _, m_pack, m_strag = g[:4]
    m_churn = _m_churn(g)
    dev = valid.device
    pos = torch.tensor(POS_INF, dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    def lo_of(w):
        return torch.amin(torch.where(valid, w, pos))

    def hi_of(w):
        return torch.amax(torch.where(valid, w, neg))

    def fold(w, on):
        if not on or w is None:
            return pos, neg
        return lo_of(w), hi_of(w)

    return ScreenConsts(
        lo_of(cost_lb), hi_of(cost_ub),
        *fold(over_raw, m_over), *fold(pack_raw, m_pack),
        *fold(strag_raw, m_strag), *fold(churn_raw, m_churn),
    )


def norm01(w: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """OpenStack weight normalization against fixed global constants."""
    span = hi - lo
    good = span > NORM_EPS
    return torch.where(good, (w - lo) / torch.where(good, span, 1.0), 0.0)


def inv_span(c_lo: torch.Tensor, c_hi: torch.Tensor) -> torch.Tensor:
    """1/(c_hi - c_lo) with the degenerate-span guard (0 disables the term)."""
    span = c_hi - c_lo
    good = span > NORM_EPS
    return torch.where(good, 1.0 / torch.where(good, span, 1.0), 0.0)


def _is_pow2(m: float) -> bool:
    """``m`` is a positive power of two other than 1 (an exact product)."""
    mant, _ = math.frexp(m)
    return m > 0.0 and m != 1.0 and mant == 0.5


def _base_chain(multipliers, norms, m_term=0.0):
    """Sum the enabled weigher terms ``m * norm`` in the fixed order (over,
    pack, straggler, churn), rounding where jitted XLA rounds.

    Measured on the reference (tests/test_torch_screen_math.py, reading the
    optimized HLO and the LLVM IR of the jitted pipeline): a multiplier of 1
    or -1 is no product, and the overcommit term (a 0/1 select) is never
    fused around.  At most the chain's first add is contracted:

    * two terms: around the first term's product (unless it is the
      overcommit term), else around the second term's;
    * three terms: around the first term's product (unless it is the
      overcommit term), else around the second term's product only when
      the first or the third multiplier is exactly 1;
    * four terms: nowhere.

    Every later add rounds on its own.  When every term shares one positive
    power-of-two multiplier, XLA factors it out of the sum (exact, so base
    is unchanged), and the termination-cost add then fuses that product
    instead of its own, except for a termination multiplier of -1, or a
    positive one other than 1 on a two-term chain.  A shared negative power
    of two does the same only on a three-term chain with a negative
    termination multiplier other than -1.

    Returns ``(base, pending)``: ``pending`` is an unrounded product
    ``(m, x)`` equal to ``base`` that the termination-cost add fuses (see
    :func:`omega_of`), or None."""
    terms = [(i, m, x) for i, (m, x) in enumerate(zip(multipliers, norms))
             if m and x is not None]
    if not terms:
        return None, None

    def value(m, x):
        return x if m == 1.0 else (-x if m == -1.0 else m * x)

    i0, m0, x0 = terms[0]
    base = value(m0, x0)
    if len(terms) == 1:
        return base, ((m0, x0) if m0 not in (1.0, -1.0) else None)
    _, m1, x1 = terms[1]
    p0 = m0 not in (1.0, -1.0) and i0 != 0
    p1 = m1 not in (1.0, -1.0)
    if p0:
        base = fma(m0, x0, value(m1, x1))
    elif p1 and (len(terms) == 2 or (len(terms) == 3 and 1.0 in (m0, terms[2][1]))):
        base = fma(m1, x1, base)
    else:
        base = base + value(m1, x1)
    for _, m, x in terms[2:]:
        base = base + value(m, x)
    if len({m for _, m, _ in terms}) == 1 and (
            (_is_pow2(m0) and not (m_term == -1.0 or (
                len(terms) == 2 and m_term > 0.0 and m_term != 1.0)))
            or (_is_pow2(-m0) and len(terms) == 3 and m_term < 0.0 and m_term != -1.0)):
        return base, (1.0, base)
    return base, None


def _traced_chain(multipliers, norms):
    """The weigher sum of the traced-multiplier program: the enabled terms
    ``m * norm`` in the fixed order (over, pack, straggler, churn), every
    product a real one, rounding where jitted XLA rounds when the
    multipliers are jit arguments.

    Measured on the reference (tests/test_torch_screen_math.py, non-integer
    inputs): the first add fuses around the left product, or around the
    right one when the left is the overcommit term; every later add fuses
    around its own product.  (The overcommit norm is 0 or 1, so its product
    is exact.)  Past a few hundred hosts XLA's CPU backend splits the loop,
    and on a chain of three or four terms led by the overcommit term the
    split loop rounds otherwise at most positions: ROADMAP.md, fault (k).

    Returns ``(base, pending)`` as :func:`_base_chain`: a single term's
    product stays unrounded for the termination-cost add to fuse."""
    terms = [(i, m, x) for i, (m, x) in enumerate(zip(multipliers, norms))
             if x is not None]
    if not terms:
        return None, None
    i0, m0, x0 = terms[0]
    if len(terms) == 1:
        return m0 * x0, (m0, x0)
    _, m1, x1 = terms[1]
    base = fma(m1, x1, m0 * x0) if i0 == 0 else fma(m0, x0, m1 * x1)
    for _, m, x in terms[2:]:
        base = fma(m, x, base)
    return base, None


def base_from_consts(
    multipliers: Tuple[float, ...],
    over_raw: torch.Tensor,
    pack_raw: torch.Tensor,
    strag_raw: torch.Tensor,
    consts: ScreenConsts,
    churn_raw: Optional[torch.Tensor] = None,
    gates: Optional[Tuple[float, ...]] = None,
) -> torch.Tensor:
    """Enumeration-free weigher terms, summed in the one fixed order every
    path shares; the churn term is added last."""
    return base_terms(multipliers, over_raw, pack_raw, strag_raw, consts,
                      churn_raw, gates=gates)[0]


def base_terms(multipliers, over_raw, pack_raw, strag_raw, consts,
               churn_raw=None, gates=None):
    """``base_from_consts`` plus the pending product :func:`omega_of`
    fuses (see :func:`_base_chain`; with ``gates``, the traced program's
    :func:`_traced_chain`)."""
    g = multipliers if gates is None else gates
    m_over, _, m_pack, m_strag = multipliers[:4]
    m_churn = _m_churn(multipliers)
    norms = (
        norm01(over_raw, consts.over_lo, consts.over_hi) if g[0] else None,
        norm01(pack_raw, consts.pack_lo, consts.pack_hi) if g[2] else None,
        norm01(strag_raw, consts.strag_lo, consts.strag_hi) if g[3] else None,
        (norm01(churn_raw, consts.churn_lo, consts.churn_hi)
         if _m_churn(g) and churn_raw is not None else None),
    )
    if gates is None:
        base, pending = _base_chain((m_over, m_pack, m_strag, m_churn), norms,
                                    multipliers[1])
    else:
        base, pending = _traced_chain((m_over, m_pack, m_strag, m_churn), norms)
    if base is None:
        base = torch.zeros_like(over_raw)
    return base, pending


def omega_of(
    best_cost: torch.Tensor,
    base: torch.Tensor,
    valid: torch.Tensor,
    consts: ScreenConsts,
    ispan: torch.Tensor,
    m_term: float,
    pending=None,
    gate: Optional[float] = None,
) -> torch.Tensor:
    """Total weigher score: base terms plus the termination-cost weigher
    normalized with the bound-derived constants; invalid hosts score
    ``NEG_INF``.  ``pending`` (from :func:`base_terms`) is base's unrounded
    single product: the reference then fuses it into this add; otherwise it
    fuses the termination term's product into the rounded base.

    ``gate`` (the policy's termination multiplier) marks the traced
    program, where ``m_term`` is the row's value: the term is added when
    the gate is not 0, ``m_term * (x * ispan)`` rounded once more, and the
    add fuses the pending product, else the term's own."""
    w = base
    if gate is not None:
        if gate:
            term = (consts.c_hi - torch.clamp(best_cost, max=POS_INF)) * ispan
            if pending is not None:
                w = fma(pending[0], pending[1], m_term * term)
            else:
                w = fma(m_term, term, base)
        return torch.where(valid, w, NEG_INF)
    if m_term:
        x = consts.c_hi - torch.clamp(best_cost, max=POS_INF)
        if pending is not None:
            term = x * ispan if m_term == 1.0 else (
                -(x * ispan) if m_term == -1.0 else m_term * (x * ispan))
            w = fma(pending[0], pending[1], term)
        elif m_term == 1.0:
            w = fma(x, ispan, base)
        elif m_term == -1.0:
            w = fma(-x, ispan, base)
        else:
            w = fma(m_term, x * ispan, base)
    return torch.where(valid, w, NEG_INF)


def slot_cost_by_kind(
    kind_eff: torch.Tensor,
    start: torch.Tensor,
    price: torch.Tensor,
    ckpt: torch.Tensor,
    res0: torch.Tensor,
    now,
    period,
) -> torch.Tensor:
    """Heterogeneous per-slot termination cost: a branchless select among
    the four kinds by the slot's kind id (0=period, 1=count, 2=revenue,
    3=recompute), each branch the verbatim single-kind formula."""
    part = floor_mod(now - start, period)
    cost = part
    cost = torch.where(kind_eff == 1, torch.ones_like(start), cost)
    cost = torch.where(kind_eff == 2, part / period * price, cost)
    lost = torch.clamp(now - ckpt, min=0.0) * torch.clamp(res0, min=1.0)
    return torch.where(kind_eff == 3, lost, cost)


def floor_mod(x: torch.Tensor, period) -> torch.Tensor:
    """``x % period`` for non-negative x via floor, with the correction step
    that folds the result back into [0, p) (see the JAX module)."""
    if not isinstance(period, torch.Tensor):
        period = torch.tensor(period, dtype=x.dtype, device=x.device)
    r = fma(-torch.floor(x * (1.0 / period)), period, x)
    return torch.where(r < 0, r + period, torch.where(r >= period, r - period, r))


def screen_terms(
    free_f: torch.Tensor,
    inst_res: torch.Tensor,
    inst_cost: torch.Tensor,
    inst_valid: torch.Tensor,
    req_res: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-major adapter over :func:`screen_bounds_rows` (the port of
    ``jax_scheduler.screen_terms``): ``(feasible, overcommitted, cost_lb,
    cost_ub)``, each (N,)."""
    k = inst_res.shape[1]
    need = (req_res[None, :] - free_f).T
    res_rows = [
        torch.where(inst_valid[:, i, None], inst_res[:, i, :], 0.0).T
        for i in range(k)
    ]
    cost_rows = [
        torch.where(inst_valid[:, i], inst_cost[:, i], POS_INF) for i in range(k)
    ]
    total = total_rows(
        [torch.where(inst_valid[:, i], inst_cost[:, i], 0.0) for i in range(k)]
    )
    return screen_bounds_rows(need, res_rows, cost_rows, total)


def stage1_rows(
    free_f: torch.Tensor,
    free_n: torch.Tensor,
    schedulable: torch.Tensor,
    domain: torch.Tensor,
    slow: torch.Tensor,
    inst_res: torch.Tensor,
    inst_cost: torch.Tensor,
    inst_valid: torch.Tensor,
    req_res: torch.Tensor,
    req_preemptible: bool,
    req_domain: int,
    require_free_slot: bool,
    churn: Optional[torch.Tensor] = None,
    churn_threshold: Optional[float] = None,
    host_zone: Optional[torch.Tensor] = None,
    exclude_zone: Optional[int] = None,
):
    """Stage-1 screen assembly on row-major host tensors (the port of
    ``jax_scheduler._stage1_rows``): the dual-view fit mask, the shared
    bounds, and the raw weigher terms.  The request fields are python
    scalars.  Returns ``(valid, cost_lb, cost_ub, raw)``; ``raw`` grows a
    4th entry when a churn column is given."""
    view = free_f if req_preemptible else free_n
    fits = torch.all(view >= req_res[None, :] - EPS, dim=-1) & schedulable
    if req_domain >= 0:
        fits = fits & (domain == req_domain)
    if exclude_zone is not None and host_zone is not None and exclude_zone >= 0:
        fits = fits & (host_zone != exclude_zone)
    if churn_threshold is not None and churn is not None and req_preemptible:
        fits = fits & (churn <= torch.tensor(
            churn_threshold, dtype=torch.float32, device=churn.device))
    if require_free_slot and req_preemptible:
        fits = fits & torch.any(~inst_valid, dim=-1)
    feas, overcommitted, cost_lb, cost_ub = screen_terms(
        free_f, inst_res, inst_cost, inst_valid, req_res
    )
    if req_preemptible:
        # Preemptible requests never terminate others: zero cost everywhere.
        cost_lb = torch.zeros_like(cost_lb)
        cost_ub = torch.zeros_like(cost_ub)
        feas = fits
    valid = fits & feas
    free_sum = total_rows([free_f[:, j] for j in range(free_f.shape[1])])
    raw = raw_base_terms(free_sum, slow, overcommitted, churn)
    return valid, cost_lb, cost_ub, raw
