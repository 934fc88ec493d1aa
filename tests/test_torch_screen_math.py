"""The port's ``repro_torch.core.screen_math`` against the jitted JAX
reference (``repro.core.screen_math``), function by function.

Inputs come from seeded numpy and go to both sides.  On integer-valued inputs
(the paper regime) every output must be bitwise equal.  The fused
multiply-add probe feeds non-integer inputs and multipliers that are not
powers of two: it finds which ``a*b + c`` sites the jitted reference
contracts into one rounding (the port fuses exactly those) and pins the port
bitwise there too.
"""
from __future__ import annotations

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_scheduler as jref
from repro.core import screen_math as ref
from repro_torch.core import screen_math as port

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=what)


def _rows(rng, n, k, d=3):
    need = rng.integers(-4, 12, (d, n)).astype(np.float32)
    res = [rng.integers(0, 5, (d, n)).astype(np.float32) for _ in range(k)]
    valid = rng.random((k, n)) < 0.7
    cost = [(rng.integers(0, 60, (n,)) * 60).astype(np.float32) for _ in range(k)]
    res = [np.where(v[None], r, 0.0).astype(np.float32) for r, v in zip(res, valid)]
    cost_rows = [np.where(v, c, ref.POS_INF).astype(np.float32) for c, v in zip(cost, valid)]
    total = np.sum([np.where(v, c, 0.0) for c, v in zip(cost, valid)], axis=0).astype(np.float32)
    return need, res, cost_rows, total


def test_constants_match():
    for name in ("NEG_INF", "POS_INF", "EPS", "NORM_EPS", "TIE_EPS", "N_CONSTS",
                 "CHURN_EPS"):
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8, 12, 16])
def test_oem_pairs_and_sort_rows(k):
    assert port.oem_pairs(k) == ref.oem_pairs(k)
    rng = np.random.default_rng(k)
    rows = [rng.integers(0, 9, (2, 50)).astype(np.float32) for _ in range(k)]
    for desc in (False, True):
        want = jax.jit(lambda r: ref.sort_rows(r, descending=desc))(rows)
        got = port.sort_rows([_t(r) for r in rows], descending=desc)
        for g, w in zip(got, want):
            _eq(g, w)
    _eq(port.total_rows([_t(r) for r in rows]), jax.jit(ref.total_rows)(rows))


@pytest.mark.parametrize("k", [1, 4, 8, 12])
def test_screen_bounds_rows(k):
    rng = np.random.default_rng(100 + k)
    need, res, cost, total = _rows(rng, 300, k)
    want = jax.jit(ref.screen_bounds_rows)(need, res, cost, total)
    got = port.screen_bounds_rows(_t(need), [_t(r) for r in res],
                                  [_t(c) for c in cost], _t(total))
    for g, w, name in zip(got, want, ("feasible", "over", "lb", "ub")):
        _eq(g, w, name)


def _raw(rng, n, churn=True):
    valid = rng.random(n) < 0.8
    lb = (rng.integers(0, 60, n) * 60).astype(np.float32)
    ub = lb + (rng.integers(0, 60, n) * 60).astype(np.float32)
    over = rng.random(n) < 0.5
    free_sum = rng.integers(0, 30, n).astype(np.float32)
    slow = rng.integers(1, 5, n).astype(np.float32)
    ch = (rng.integers(0, 8, n) / 8.0).astype(np.float32) if churn else None
    return valid, lb, ub, over, free_sum, slow, ch


@pytest.mark.parametrize("mult", [(1.0, 1.0, 0.0, 0.0), (1.0, 2.0, 0.5, 0.25),
                                  (1.0, 1.0, 0.5, 0.25, 2.0), (0.0, 1.0, 0.0, 0.0),
                                  (1.0, -1.0, 0.0, 0.5)])
def test_consts_base_omega(mult):
    """raw_base_terms → consts_of → norm01/inv_span → base_from_consts →
    omega_of, jitted as one program (as every decision path runs them)."""
    rng = np.random.default_rng(7)
    valid, lb, ub, over, free_sum, slow, ch = _raw(rng, 400, churn=len(mult) > 4)

    def run_ref(valid, lb, ub, over, free_sum, slow, ch):
        raw = ref.raw_base_terms(free_sum, slow, over, ch)
        c = ref.consts_of(mult, valid, lb, ub, *raw)
        base = ref.base_from_consts(mult, raw[0], raw[1], raw[2], c,
                                    churn_raw=raw[3] if len(raw) > 3 else None)
        ispan = ref.inv_span(c.c_lo, c.c_hi)
        opt = lb if mult[1] >= 0 else ub
        return c.pack(), base, ref.omega_of(opt, base, valid, c, ispan, mult[1])

    want = jax.jit(run_ref)(valid, lb, ub, over, free_sum, slow, ch)
    raw = port.raw_base_terms(_t(free_sum), _t(slow), _t(over),
                              None if ch is None else _t(ch))
    c = port.consts_of(mult, _t(valid), _t(lb), _t(ub), *raw)
    base, pending = port.base_terms(mult, raw[0], raw[1], raw[2], c,
                                    raw[3] if len(raw) > 3 else None)
    _eq(port.base_from_consts(mult, raw[0], raw[1], raw[2], c,
                              churn_raw=raw[3] if len(raw) > 3 else None), base)
    ispan = port.inv_span(c.c_lo, c.c_hi)
    omega = port.omega_of(_t(lb) if mult[1] >= 0 else _t(ub), base, _t(valid),
                          c, ispan, mult[1], pending=pending)
    _eq(c.pack(), want[0], "consts")
    _eq(base, want[1], "base")
    _eq(omega, want[2], "omega")
    _eq(port.ScreenConsts.unpack(c.pack()).pack(), want[0], "pack/unpack")


def test_churn_of_and_stats():
    rng = np.random.default_rng(11)
    term = rng.integers(0, 9, 6).astype(np.float32)
    up = (rng.random(6) * 1e4).astype(np.float32)
    up[2] = 0.0
    zone = rng.integers(0, 6, 200).astype(np.int32)
    _eq(port.churn_of(_t(term), _t(up), _t(zone)), jax.jit(ref.churn_of)(term, up, zone))
    _eq(port.churn_stats(_t(term), _t(up)), jax.jit(ref.churn_stats)(term, up))


@pytest.mark.parametrize("kind_table", [0, 1, 2, 3, -1])
def test_slot_cost_by_kind(kind_table):
    """Integer-minute starts and checkpoints, every kind and a mixed column."""
    rng = np.random.default_rng(20 + kind_table)
    n, k = 100, 8
    now = np.float32(500_000.0)
    start = (now - rng.integers(10, 500, (n, k)) * 60.0).astype(np.float32)
    price = rng.integers(1, 5, (n, k)).astype(np.float32)
    ckpt = (start + rng.integers(0, 100, (n, k)) * 60.0).astype(np.float32)
    res0 = rng.integers(0, 5, (n, k)).astype(np.float32)
    kind = (rng.integers(0, 4, (n, k)) if kind_table < 0
            else np.full((n, k), kind_table)).astype(np.int32)
    period = np.float32(3600.0)
    want = jax.jit(ref.slot_cost_by_kind)(kind, start, price, ckpt, res0, now, period)
    got = port.slot_cost_by_kind(_t(kind), _t(start), _t(price), _t(ckpt),
                                 _t(res0), float(now), float(period))
    _eq(got, want)


def test_screen_terms_and_stage1_rows():
    rng = np.random.default_rng(5)
    n, k = 300, 8
    a = dict(
        free_f=rng.integers(0, 9, (n, 3)).astype(np.float32),
        free_n=rng.integers(2, 12, (n, 3)).astype(np.float32),
        schedulable=rng.random(n) < 0.9,
        domain=rng.integers(0, 3, n).astype(np.int32),
        slow=rng.integers(1, 5, n).astype(np.float32),
        inst_res=rng.integers(0, 5, (n, k, 3)).astype(np.float32),
        inst_cost=(rng.integers(0, 60, (n, k)) * 60).astype(np.float32),
        inst_valid=rng.random((n, k)) < 0.7,
    )
    churn = (rng.integers(0, 8, n) / 8.0).astype(np.float32)
    zone = rng.integers(0, 4, n).astype(np.int32)
    req = rng.integers(2, 12, 3).astype(np.float32)
    fields = list(a.values())
    want = jax.jit(jref.screen_terms)(a["free_f"], a["inst_res"], a["inst_cost"],
                                      a["inst_valid"], req)
    got = port.screen_terms(_t(a["free_f"]), _t(a["inst_res"]), _t(a["inst_cost"]),
                            _t(a["inst_valid"]), _t(req))
    for g, w in zip(got, want):
        _eq(g, w)
    for pre in (False, True):
        for dom, excl, thr in ((-1, None, None), (1, 2, 0.5), (-1, 0, 0.0)):
            def run(*xs):
                return jref._stage1_rows(
                    *xs[:8], xs[8], jnp.asarray(pre), jnp.asarray(dom, jnp.int32),
                    True, churn=xs[9], churn_threshold=thr, host_zone=xs[10],
                    exclude_zone=None if excl is None else jnp.asarray(excl, jnp.int32))
            w = jax.jit(run)(*fields, req, churn, zone)
            g = port.stage1_rows(*[_t(f) for f in fields], _t(req), pre, dom, True,
                                 churn=_t(churn), churn_threshold=thr,
                                 host_zone=_t(zone), exclude_zone=excl)
            for gi, wi in zip(g[:3], w[:3]):
                _eq(gi, wi)
            for gi, wi in zip(g[3], w[3]):
                _eq(gi, wi)


# ---------------------------------------------------------------------------
# Fused multiply-add probe (non-integer inputs)
# ---------------------------------------------------------------------------


def _correct_fma(a, b, c):
    """Correctly rounded f32 fma: exact product in f64, the sum rounded to
    odd in f64, then to f32 (53 >= 24 + 2 bits makes this exact)."""
    a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    odd = (s.view(np.int64) & 1) == 1
    s = np.where((err != 0) & ~odd, np.nextafter(s, s + err), s)
    return s.astype(np.float32)


@pytest.mark.parametrize("n", [1, 7, 16, 33, 1000])
def test_fma_helper_rounds_once(n):
    rng = np.random.default_rng(n)
    a, b, c = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    _eq(port.fma(_t(a), _t(b), _t(c)), _correct_fma(a, b, c))
    _eq(port.fma(float(a[0]), _t(b), _t(c)), _correct_fma(a[0], b, c))


def _unfused_chain(mult, n0, n2, n3):
    """base + m*x summed with a rounding after every product (eager)."""
    base = np.zeros_like(n0)
    for m, x in zip((mult[0], mult[2], mult[3]), (n0, n2, n3)):
        if m:
            base = (base + np.float32(m) * x).astype(np.float32)
    return base


#: (multipliers, whether an eager evaluation differs from the reference)
FMA_CASES = [
    ((1.0, 1.0, 0.0, 0.0), True),      # the default policy: omega fuses
    ((0.3, 0.7, 1.3, 0.9), True),
    ((1.0, 0.3, 0.7, 0.0), True),
    ((-1.0, 1.0, 0.3, 0.0), True),
    ((0.0, 0.7, 1.3, 0.9), True),      # first add fuses the left product
    ((1.0, 0.7, 1.3, 0.9), True),      # first add fuses the right product
    ((0.3, -1.0, 0.0, 0.0), False),    # exact product: fusion invisible
    ((0.0, 0.7, 0.3, 0.0), True),      # single product fused into omega
]


@pytest.mark.parametrize("mult,visible", FMA_CASES)
def test_fma_sites_base_and_omega(mult, visible):
    """Non-integer raw terms and costs: the port's base/omega equal the
    jitted reference bitwise, while an eager (unfused) evaluation does not —
    the reference contracts these sites."""
    rng = np.random.default_rng(3)
    n = 4000
    valid = rng.random(n) < 0.9
    lb = (rng.random(n) * 3000).astype(np.float32)
    over = rng.random(n) < 0.5
    free_sum = (rng.random(n) * 24).astype(np.float32)
    slow = (1 + rng.random(n) * 3).astype(np.float32)

    def run_ref(valid, lb, over, free_sum, slow):
        raw = ref.raw_base_terms(free_sum, slow, over)
        c = ref.consts_of(mult, valid, lb, lb, *raw)
        base = ref.base_from_consts(mult, raw[0], raw[1], raw[2], c)
        ispan = ref.inv_span(c.c_lo, c.c_hi)
        return base, ref.omega_of(lb, base, valid, c, ispan, mult[1])

    base_w, omega_w = (np.asarray(x) for x in jax.jit(run_ref)(valid, lb, over, free_sum, slow))
    raw = port.raw_base_terms(_t(free_sum), _t(slow), _t(over))
    c = port.consts_of(mult, _t(valid), _t(lb), _t(lb), *raw)
    base, pending = port.base_terms(mult, raw[0], raw[1], raw[2], c)
    omega = port.omega_of(_t(lb), base, _t(valid), c, port.inv_span(c.c_lo, c.c_hi),
                          mult[1], pending=pending)
    _eq(base, base_w, "base")
    _eq(omega, omega_w, "omega")
    # the eager (unfused) evaluation differs somewhere: the sites are real
    norms = [port.norm01(r, lo, hi).numpy() for r, lo, hi in
             zip(raw, (c.over_lo, c.pack_lo, c.strag_lo), (c.over_hi, c.pack_hi, c.strag_hi))]
    base_u = _unfused_chain(mult, *norms)
    ispan = port.inv_span(c.c_lo, c.c_hi).numpy()
    term = (c.c_hi.numpy() - np.minimum(lb, np.float32(ref.POS_INF))) * ispan
    omega_u = np.where(valid, base_u + np.float32(mult[1]) * term, np.float32(ref.NEG_INF))
    fused_anywhere = (not np.array_equal(base_u, base_w)) or \
        (not np.array_equal(omega_u, omega_w))
    assert fused_anywhere == visible


@pytest.mark.parametrize("period", [3600.0, 1000.3, 37.7])
def test_fma_site_floor_mod_and_revenue(period):
    """``x - floor(x/p)*p``: contracted by the reference; with a period whose
    multiples are not exact in f32 the eager form differs, the port does
    not.  The revenue branch (``part/p*price``) carries the same site."""
    rng = np.random.default_rng(int(period))
    n = 5000
    now = np.float32(123_456.789)
    start = (now - rng.random((n,)) * 9e4).astype(np.float32)
    price = (1 + rng.random(n) * 3).astype(np.float32)
    kind = np.full((n,), 2, np.int32)
    p = np.float32(period)
    want = np.asarray(jax.jit(ref.floor_mod)(now - start, p))
    _eq(port.floor_mod(_t(now - start), float(p)), want)
    x = now - start
    f = np.floor(x * (np.float32(1.0) / p)).astype(np.float32)
    eager = (x - f * p).astype(np.float32)
    eager = np.where(eager < 0, eager + p, np.where(eager >= p, eager - p, eager))
    if period != 3600.0:
        assert not np.array_equal(eager, want)
    rev_w = jax.jit(ref.slot_cost_by_kind)(kind, start, price, start, price, now, p)
    rev_g = port.slot_cost_by_kind(_t(kind), _t(start), _t(price), _t(start),
                                   _t(price), float(now), float(p))
    _eq(rev_g, rev_w, "revenue")


#: every weigher configuration the JAX package's tests and benchmarks run,
#: then vectors that mix exact multipliers (±1, powers of two) with inexact
#: ones, each of which an earlier rule rounded differently from XLA
REPO_POLICIES = [
    (1.0, 1.0, 0.0, 0.0), (1.0, 2.0, 0.0, 0.0), (1.0, 2.0, 0.5, 0.25),
    (0.0, 1.0, 0.0, 0.0), (1.0, -1.0, 0.0, 0.5), (1.0, 1.0, 0.5, 0.25, 2.0),
    (1.0, 1.0, 0.05, 0.0, 2.0),
    (2.0, 1.0, 0.7, 1.0), (-1.0, 0.0, -1.7, 2.0), (1.0, 0.7, 0.7, 0.3, 1.3),
    (0.0, 0.0, -1.0, -1.2, -1.0), (2.0, 1.0, 2.0, 2.0), (-2.0, -1.7, -2.0, -2.0, 0.0),
    (-0.5, -0.7, 0.0, -0.5, -0.5),
]


def _random_multipliers(seed):
    """A 4- or 5-term weigher vector (every term on) whose entries are
    neither 0, ±1 nor a power of two, with random signs."""
    rng = np.random.default_rng(1000 + seed)
    size = 4 + seed % 2
    mags = rng.uniform(0.05, 3.0, size)
    while np.any(np.isclose(np.log2(mags), np.round(np.log2(mags)))):
        mags = rng.uniform(0.05, 3.0, size)
    return tuple(float(np.float32(m)) for m in mags * rng.choice([-1.0, 1.0], size))


#: the values a mixed vector draws from: 0, ±1, powers of two, inexact
MIXED_VALUES = (0.0, 1.0, -1.0, 2.0, -2.0, 0.5, -0.5, 0.25, 4.0,
                0.7, -1.7, 1.3, 0.3, -1.2, 2.6)


def _mixed_multipliers(seed):
    """A seeded 4- or 5-term weigher vector mixing zeros, ±1, powers of two
    and inexact multipliers."""
    rng = np.random.default_rng(2000 + seed)
    return tuple(float(rng.choice(MIXED_VALUES)) for _ in range(4 + seed % 2))


#: powers of two beyond 4 and below 0.25 (and a negative one) in the shapes
#: the rule tells apart: shared by every term, by the base terms only, beside
#: ±1 and inexact multipliers, and as the termination multiplier
FAR_POW2 = [
    tpl(v) for v in (8.0, 16.0, 0.125, -8.0) for tpl in (
        lambda v: (1.0, 1.0, v, v), lambda v: (v, 1.0, v, v), lambda v: (v, v, v, v),
        lambda v: (1.0, v, 0.5, 0.25), lambda v: (v, -1.0, v, 0.0, v),
        lambda v: (-v, -1.7, -v, -v, 0.0), lambda v: (v, 0.7, 0.0, v, 1.3),
        lambda v: (0.0, v, v, v, v))
]


@pytest.mark.parametrize("mult", REPO_POLICIES + [_random_multipliers(s) for s in range(12)]
                         + [_mixed_multipliers(s) for s in range(48)] + FAR_POW2)
def test_repo_policies_on_non_integer_inputs(mult):
    """consts → base → omega as one jitted program, on fractional inputs:
    bitwise equal for every policy the repo uses, for a seeded sweep of
    4- and 5-term vectors of multipliers that are not powers of two, and for
    a seeded sweep of vectors that mix those with 0, ±1 and powers of two.
    ``base`` is an output of the program too, as in the decision pipeline,
    which gathers it for stage 2; XLA contracts differently when base is
    fused into omega alone, so the port mirrors the pipeline's form."""
    rng = np.random.default_rng(17)
    n = 3000
    valid = rng.random(n) < 0.9
    lb = (rng.random(n) * 3000).astype(np.float32)
    over = rng.random(n) < 0.5
    free_sum = (rng.random(n) * 24).astype(np.float32)
    slow = (1 + rng.random(n) * 3).astype(np.float32)
    ch = (rng.random(n) * 2).astype(np.float32)

    def run_ref(valid, lb, over, free_sum, slow, ch):
        raw = ref.raw_base_terms(free_sum, slow, over, ch)
        c = ref.consts_of(mult, valid, lb, lb, *raw)
        base = ref.base_from_consts(mult, raw[0], raw[1], raw[2], c, churn_raw=raw[3])
        return base, ref.omega_of(lb, base, valid, c, ref.inv_span(c.c_lo, c.c_hi),
                                  mult[1])

    want_base, want = jax.jit(run_ref)(valid, lb, over, free_sum, slow, ch)
    raw = port.raw_base_terms(_t(free_sum), _t(slow), _t(over), _t(ch))
    c = port.consts_of(mult, _t(valid), _t(lb), _t(lb), *raw)
    base, pending = port.base_terms(mult, raw[0], raw[1], raw[2], c, raw[3])
    got = port.omega_of(_t(lb), base, _t(valid), c, port.inv_span(c.c_lo, c.c_hi),
                        mult[1], pending=pending)
    _eq(base, want_base)
    _eq(got, want)


# ---------------------------------------------------------------------------
# The traced-multiplier program (the ensemble's multiplier axis)
# ---------------------------------------------------------------------------


def _gate_patterns():
    """Every static multiplier pattern: each weigher on or off, the
    termination term on with either sign."""
    out = []
    for g in itertools.product((0.0, 1.0), repeat=5):
        for sign in ((1.0, -1.0) if g[1] else (1.0,)):
            gates = (g[0], g[1] * sign) + g[2:]
            if any(gates):
                out.append(gates)
    return out


def _traced_rows(gates, seed):
    """Rows of values under ``gates``: inexact with random signs (the
    termination term keeps its gate's sign), the shared power of two 2,
    the value 1 (no product in the static program), zeros under every
    gate, and a mix of 0, ±1, powers of two and inexact values."""
    rng = np.random.default_rng(3000 + seed)
    g = np.asarray(gates, np.float32)
    sign = np.where(np.arange(5) == 1, np.sign(g), rng.choice([-1.0, 1.0], 5))
    inexact = np.where(g != 0, rng.uniform(0.05, 3.0, 5) * sign, 0.0)
    mixed = np.where(g != 0, np.abs(rng.choice(MIXED_VALUES, 5)) * sign, 0.0)
    return [r.astype(np.float32) for r in (inexact, 2.0 * np.abs(g) * np.sign(g),
                                           np.sign(g), 0.0 * g, mixed)]


@functools.lru_cache(maxsize=None)
def _traced_ref(gates):
    """consts → base → omega jitted with the multipliers as an argument and
    the gates static (the reference's ensemble program)."""
    def run(valid, lb, ub, over, free_sum, slow, ch, mv):
        mult = tuple(mv[i] for i in range(len(gates)))
        raw = ref.raw_base_terms(free_sum, slow, over, ch)
        c = ref.consts_of(gates, valid, lb, ub, *raw)
        base = ref.base_from_consts(mult, raw[0], raw[1], raw[2], c, churn_raw=raw[3],
                                    gates=gates)
        opt = lb if gates[1] >= 0 else ub
        return c.pack(), base, ref.omega_of(opt, base, valid, c, ref.inv_span(c.c_lo, c.c_hi),
                                            mult[1], gate=gates[1])
    return jax.jit(run)


def _traced_port(gates, row, valid, lb, ub, over, free_sum, slow, ch):
    mult = tuple(float(v) for v in row)
    raw = port.raw_base_terms(_t(free_sum), _t(slow), _t(over), _t(ch))
    c = port.consts_of(mult, _t(valid), _t(lb), _t(ub), *raw, gates=gates)
    base, pending = port.base_terms(mult, raw[0], raw[1], raw[2], c, raw[3], gates=gates)
    opt = _t(lb) if gates[1] >= 0 else _t(ub)
    omega = port.omega_of(opt, base, _t(valid), c, port.inv_span(c.c_lo, c.c_hi), mult[1],
                          pending=pending, gate=gates[1])
    return c.pack(), base, omega


def _fractional(n, seed=17):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.9
    lb = (rng.random(n) * 3000).astype(np.float32)
    ub = (lb + rng.random(n) * 900).astype(np.float32)
    over = rng.random(n) < 0.5
    free_sum = (rng.random(n) * 24).astype(np.float32)
    slow = (1 + rng.random(n) * 3).astype(np.float32)
    ch = (rng.random(n) * 2).astype(np.float32)
    return valid, lb, ub, over, free_sum, slow, ch


@pytest.mark.parametrize("gates", _gate_patterns())
def test_traced_multipliers_on_non_integer_inputs(gates):
    """The traced program bit for bit: the constants, base and omega of the
    port's ``gates`` mode equal the jitted reference's with the multipliers
    passed as a jit argument, for every gate pattern and inexact, power-of-
    two, unit, zero and mixed rows.  512 hosts: past a few hundred XLA's CPU
    backend splits the loop, and a chain of three or four weighers led by
    the overcommit term then rounds otherwise (ROADMAP.md, fault (k))."""
    inputs = _fractional(512)
    fn = _traced_ref(gates)
    for i, row in enumerate(_traced_rows(gates, len(_gate_patterns()))):
        want = fn(*inputs, row)
        got = _traced_port(gates, row, *inputs)
        for g, w, what in zip(got, want, ("consts", "base", "omega")):
            _eq(g, w, f"row {i} {row.tolist()}: {what}")


@pytest.mark.parametrize("gates,row", [
    ((1.0, 1.0, 0.0, 0.0), (1.0, 1.0, 0.0, 0.0)),      # the default policy's own row
    ((1.0, 1.0, 0.0, 0.0), (1.0, 0.7, 0.0, 0.0)),
    ((1.0, 1.0, 0.5, 0.25), (1.0, 1.0, 0.5, 0.25)),
    ((0.0, 1.0, 0.7, 1.3), (0.0, 1.0, 0.7, 1.3)),
])
def test_traced_rounding_differs_from_the_static_program(gates, row):
    """The same values as the policy's own static multipliers round
    otherwise: the traced mode is not the static program relabelled.
    (Rows of powers of two, such as the reference's (4, 0.25) and (0.5,
    2), make every product exact, and the two programs then agree.)"""
    valid, lb, ub, over, free_sum, slow, ch = _fractional(512)
    ch = None
    raw = port.raw_base_terms(_t(free_sum), _t(slow), _t(over))
    static = tuple(float(v) for v in row)
    c = port.consts_of(static, _t(valid), _t(lb), _t(lb), *raw)
    base, pending = port.base_terms(static, raw[0], raw[1], raw[2], c)
    omega_s = port.omega_of(_t(lb), base, _t(valid), c, port.inv_span(c.c_lo, c.c_hi),
                            static[1], pending=pending)
    c_t = port.consts_of(static, _t(valid), _t(lb), _t(lb), *raw, gates=gates)
    base_t, pending_t = port.base_terms(static, raw[0], raw[1], raw[2], c_t, gates=gates)
    omega_t = port.omega_of(_t(lb), base_t, _t(valid), c_t, port.inv_span(c_t.c_lo, c_t.c_hi),
                            static[1], pending=pending_t, gate=gates[1])
    assert not torch.equal(omega_s, omega_t)
