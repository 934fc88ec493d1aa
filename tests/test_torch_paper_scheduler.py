"""The port's copy of the paper's schedulers (``core.filters``,
``core.weighers``, ``core.select_terminate``, ``core.scheduler``) and of
``core.cluster.Cluster``, against the paper's own oracles and the JAX
package's python schedulers.

Mirrors ``test_paper_fidelity.py``, ``test_scheduler_correctness.py``
(Tables 3-6, ``TestClusterApply``) and ``test_scheduler_properties.py``;
each case also builds the JAX package's hosts from the same tuples and
requires its scheduler to make the same choice.  The property tests are
derandomized with no example database, so a run neither draws nor replays
a new example.  ``test_stream_through_cluster_matches_jax`` runs a seeded
stream of 200 requests through each package's ``Cluster`` with each of the
three schedulers (the same tie-break seed): the same host, plan ids and
cost at every step.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import cluster as jcluster  # noqa: E402
from repro.core import cost as jcost  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.core import weighers as jweigh  # noqa: E402
from repro.core.select_terminate import best_plan as jbest  # noqa: E402
from repro_torch.core import cluster as tcluster  # noqa: E402
from repro_torch.core import cost as tcost  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.core import weighers as tweigh  # noqa: E402
from repro_torch.core.select_terminate import best_plan  # noqa: E402

NOW = 1_000_000.0
SIZE_VECS = {"small": (1, 2000, 20), "medium": (2, 4000, 40), "large": (4, 8000, 80)}
FLAVORS = list(SIZE_VECS)
#: Table 1 nodes, disk non-binding (as test_scheduler_correctness.py)
NODE = (8, 16000, 10_000)
#: the property tests' nodes (as test_scheduler_properties.py)
PROP_NODE = (8, 16000, 160)
PROPS = settings(max_examples=60, deadline=None, derandomize=True, database=None)


def res(types, vec):
    return types.Resources(types.VM_SPEC, np.asarray(vec, np.float64))


def build(types, spec, cap=NODE):
    """Hosts from ``[(name, [(id, flavor, minutes, preemptible), ...])]``."""
    hosts = []
    for name, insts in spec:
        h = types.Host(name=name, capacity=res(types, cap))
        for iid, fl, minutes, pre in insts:
            h.place(types.Instance(id=iid, resources=res(types, SIZE_VECS[fl]),
                                   preemptible=pre, host=name,
                                   start_time=NOW - minutes * 60.0))
        hosts.append(h)
    return hosts


def request(types, flavor, pre=False, rid="new"):
    return types.Request(id=rid, resources=res(types, SIZE_VECS[flavor]), preemptible=pre)


def same_result(a, b):
    assert (a.ok, a.host, a.plan.ids, a.plan.cost, a.passes) == \
        (b.ok, b.host, b.plan.ids, b.plan.cost, b.passes)


# ---------------------------------------------------------------------------
# Tables 3-6 (the paper's correctness evaluation, §4.4)
# ---------------------------------------------------------------------------

TABLES = {
    "table3": ([
        ("host-A", [("A1", "medium", 272, False), ("A2", "medium", 172, False),
                    ("AP1", "medium", 96, True), ("AP2", "medium", 207, True)]),
        ("host-B", [("B1", "medium", 136, False), ("B2", "medium", 200, False),
                    ("BP1", "medium", 71, True), ("BP2", "medium", 91, True)]),
        ("host-C", [("C1", "medium", 97, False), ("C2", "medium", 275, False),
                    ("CP1", "medium", 210, True), ("CP2", "medium", 215, True)]),
        ("host-D", [("D1", "medium", 16, False), ("DP1", "medium", 85, True),
                    ("DP2", "medium", 199, True), ("DP3", "medium", 152, True)]),
    ], "medium", "host-B", {"BP1"}, 11),
    "table4": ([
        ("host-A", [("AP1", "medium", 247, True), ("AP2", "medium", 463, True),
                    ("AP3", "medium", 403, True), ("AP4", "medium", 410, True)]),
        ("host-B", [("B1", "medium", 388, False), ("B2", "medium", 103, False),
                    ("BP1", "medium", 344, True), ("BP2", "medium", 476, True)]),
        ("host-C", [("C1", "medium", 481, False), ("C2", "medium", 177, False),
                    ("CP1", "medium", 181, True), ("CP2", "medium", 160, True)]),
        ("host-D", [("D1", "medium", 173, False), ("DP1", "medium", 384, True),
                    ("DP2", "medium", 168, True), ("DP3", "medium", 232, True)]),
    ], "medium", "host-C", {"CP1"}, 1),
    "table5": ([
        ("host-A", [("AP1", "large", 298, True), ("AP2", "medium", 278, True),
                    ("AP3", "small", 190, True), ("AP4", "small", 187, True)]),
        ("host-B", [("B1", "large", 494, False), ("BP1", "large", 178, True)]),
        ("host-C", [("CP1", "large", 297, True), ("CP2", "medium", 296, True),
                    ("CP3", "small", 296, True)]),
        ("host-D", [("D1", "medium", 176, False), ("D2", "medium", 200, False),
                    ("D3", "large", 116, False)]),
    ], "large", "host-A", {"AP2", "AP3", "AP4"}, 55),
    "table6": ([
        ("host-A", [("A1", "large", 234, False), ("A2", "medium", 122, False),
                    ("AP1", "medium", 172, True)]),
        ("host-B", [("BP1", "large", 272, True), ("BP2", "medium", 212, True),
                    ("BP3", "small", 380, True)]),
        ("host-C", [("C1", "small", 182, False), ("C2", "medium", 120, False),
                    ("C3", "large", 116, False)]),
        ("host-D", [("DP1", "large", 232, True), ("DP2", "small", 213, True),
                    ("DP3", "medium", 324, True), ("DP4", "small", 314, True)]),
    ], "medium", "host-B", {"BP3"}, 20),
}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_paper_table_selection(table):
    """The victims, the cost (the partial-hour remainder in minutes) and the
    single pass the paper reports, and the JAX package's same choice."""
    spec, flavor, host, victims, minutes = TABLES[table]
    got = tsched.PreemptibleScheduler(cost_fn=tcost.PeriodCost()).schedule(
        request(ttypes, flavor), build(ttypes, spec), NOW)
    assert got.ok and got.host == host and set(got.plan.ids) == victims
    assert got.plan.cost == pytest.approx(minutes * 60.0)
    assert got.passes == 1
    same_result(jsched.PreemptibleScheduler(cost_fn=jcost.PeriodCost()).schedule(
        request(jtypes, flavor), build(jtypes, spec), NOW), got)


def test_retry_scheduler_agrees_on_table6_but_needs_two_passes():
    spec = TABLES["table6"][0]
    got = tsched.RetryScheduler(cost_fn=tcost.PeriodCost()).schedule(
        request(ttypes, "medium"), build(ttypes, spec), NOW)
    assert got.ok and got.host == "host-B" and set(got.plan.ids) == {"BP3"}
    assert got.passes == 2
    same_result(jsched.RetryScheduler(cost_fn=jcost.PeriodCost()).schedule(
        request(jtypes, "medium"), build(jtypes, spec), NOW), got)


def test_cluster_apply_evacuates_and_places():
    out = []
    for types, cluster_mod, sched_mod, cost_mod in (
            (ttypes, tcluster, tsched, tcost), (jtypes, jcluster, jsched, jcost)):
        cluster = cluster_mod.Cluster(build(types, TABLES["table6"][0]))
        inst = cluster.schedule_and_place(
            sched_mod.PreemptibleScheduler(cost_fn=cost_mod.PeriodCost()),
            request(types, "medium"), NOW)
        assert inst is not None and inst.host == "host-B"
        ids = {i.id for i in cluster.hosts["host-B"].instances.values()}
        assert "BP3" not in ids and inst.id in ids
        assert cluster.stats.preemptions == 1
        assert not cluster.hosts["host-B"].free_full.any_negative()
        out.append((inst.id, sorted(ids), cluster.stats.placed,
                    cluster.stats.preemption_cost, cluster.utilization(),
                    cluster.utilization_normal()))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# paper fidelity: the prose against the evaluation
# ---------------------------------------------------------------------------


def test_literal_alg4_contradicts_papers_table5():
    """Literal Alg. 4 (all-instance partial periods) picks host-B; the
    published outcome (the termination-cost weigher) host-A."""
    spec = TABLES["table5"][0]
    for types, sched_mod, weigh_mod, cost_mod in (
            (ttypes, tsched, tweigh, tcost), (jtypes, jsched, jweigh, jcost)):
        literal = sched_mod.PreemptibleScheduler(
            cost_fn=cost_mod.PeriodCost(),
            weighers=(weigh_mod.OvercommitRank(), weigh_mod.PeriodRank()))
        assert literal.schedule(request(types, "large"), build(types, spec), NOW).host == "host-B"
        faithful = sched_mod.PreemptibleScheduler(
            cost_fn=cost_mod.PeriodCost(),
            weighers=(weigh_mod.OvercommitRank(), weigh_mod.TerminationCostRank()))
        res_ = faithful.schedule(request(types, "large"), build(types, spec), NOW)
        assert res_.host == "host-A" and set(res_.plan.ids) == {"AP2", "AP3", "AP4"}


def test_alg5_uses_the_hosts_free_resources():
    """Table 6's host-B: {BP3} frees one small slot, which with the host's
    free small slot admits a medium request (free_full + freed >= req)."""
    spec = [("host-B", [("BP1", "large", 272, True), ("BP2", "medium", 212, True),
                        ("BP3", "small", 380, True)])]
    (h,) = build(ttypes, spec)
    plan = best_plan(h, request(ttypes, "medium"), tcost.PeriodCost(), NOW)
    assert plan.feasible and plan.ids == ("BP3",)
    assert not res(ttypes, SIZE_VECS["medium"]).fits_in(res(ttypes, SIZE_VECS["small"]))


def test_run_time_modulo_costs_zero_at_exact_periods():
    """§4.2: among 120/119/61-minute instances the 120-minute one goes."""
    spec = [("h", [("a", "medium", 120, True), ("b", "medium", 119, True),
                   ("c", "medium", 61, True), ("n", "medium", 10, False)])]
    (h,) = build(ttypes, spec)
    plan = best_plan(h, request(ttypes, "medium"), tcost.PeriodCost(), NOW)
    assert plan.ids == ("a",) and plan.cost == 0.0


def test_greedy_fallback_matches_jax():
    """Above ``exact_k`` the greedy + prune heuristic; the same plan."""
    spec = [("h", [(f"p{j}", FLAVORS[j % 2], 17 * j + 5, True) for j in range(5)]
             + [("n", "small", 40, False)])]
    for flavor in FLAVORS:
        got = best_plan(build(ttypes, spec)[0], request(ttypes, flavor), tcost.PeriodCost(),
                        NOW, exact_k=2)
        want = best_plan(build(jtypes, spec)[0], request(jtypes, flavor), jcost.PeriodCost(),
                         NOW, exact_k=2)
        assert (got.ids, got.cost, got.feasible) == (want.ids, want.cost, want.feasible)


# ---------------------------------------------------------------------------
# a seeded stream through each package's Cluster
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["filter", "retry", "preemptible"])
def test_stream_through_cluster_matches_jax(name):
    rng = np.random.default_rng(42)
    spec = [(f"h{i}", []) for i in range(12)]
    clusters = (tcluster.Cluster(build(ttypes, spec)), jcluster.Cluster(build(jtypes, spec)))
    scheds = (tsched.SCHEDULER_REGISTRY[name](cost_fn=tcost.PeriodCost(), seed=7),
              jsched.SCHEDULER_REGISTRY[name](cost_fn=jcost.PeriodCost(), seed=7))
    now, live = NOW, []
    placed = preempted = 0
    for step in range(200):
        now += float(rng.integers(1, 30)) * 60.0
        if live and rng.random() < 0.25:          # a voluntary departure
            iid = live.pop(int(rng.integers(len(live))))
            for c in clusters:
                inst = next(i for h in c.hosts.values() for i in h.instances.values()
                            if i.id == iid)
                c.terminate(inst)
        flavor, pre = FLAVORS[int(rng.integers(3))], bool(rng.random() < 0.5)
        results = [s.schedule(request(types, flavor, pre, f"r{step}"), c.host_list(), now)
                   for s, c, types in zip(scheds, clusters, (ttypes, jtypes))]
        same_result(*results)
        insts = [c.apply(r, now) for c, r in zip(clusters, results)]
        if insts[0] is not None:
            assert insts[0].id == insts[1].id and insts[0].host == insts[1].host
            live = [i for i in live if i not in set(results[0].plan.ids)] + [insts[0].id]
            placed += 1
            preempted += len(results[0].plan.ids)
    ts_, js_ = (c.stats for c in clusters)
    assert (ts_.placed, ts_.failed, ts_.preemptions, ts_.preemption_cost) == \
        (js_.placed, js_.failed, js_.preemptions, js_.preemption_cost)
    assert [i.id for i in clusters[0].preempted] == [i.id for i in clusters[1].preempted]
    assert clusters[0].utilization() == clusters[1].utilization()
    assert placed > 50 and ts_.failed > 0        # the fleet filled up
    if name != "filter":
        assert preempted > 0


# ---------------------------------------------------------------------------
# properties (test_scheduler_properties.py's strategies)
# ---------------------------------------------------------------------------


@st.composite
def fleets(draw, max_hosts=8):
    """Fleet tuples; an instance that does not fit ends its host's list."""
    cap = np.asarray(PROP_NODE, np.float64)
    spec, iid = [], 0
    for i in range(draw(st.integers(1, max_hosts))):
        free, insts = cap.copy(), []
        for _ in range(draw(st.integers(0, 5))):
            fl = FLAVORS[draw(st.integers(0, 2))]
            vec = np.asarray(SIZE_VECS[fl], np.float64)
            if np.any(vec > free):
                break
            insts.append((f"x{iid}", fl, draw(st.integers(1, 500)), draw(st.booleans())))
            free = free - vec
            iid += 1
        spec.append((f"h{i}", insts))
    return spec


@st.composite
def requests(draw):
    return FLAVORS[draw(st.integers(0, 2))], draw(st.booleans())


def _both(spec, req, cls_name="PreemptibleScheduler", cost="PeriodCost"):
    """The port's result on its hosts, after checking the JAX package's."""
    flavor, pre = req
    hosts = build(ttypes, spec, PROP_NODE)
    got = getattr(tsched, cls_name)(cost_fn=getattr(tcost, cost)()).schedule(
        request(ttypes, flavor, pre, "q"), hosts, NOW)
    same_result(getattr(jsched, cls_name)(cost_fn=getattr(jcost, cost)()).schedule(
        request(jtypes, flavor, pre, "q"), build(jtypes, spec, PROP_NODE), NOW), got)
    return hosts, got


@given(fleets(), requests())
@PROPS
def test_success_iff_view_fits(spec, req):
    hosts, got = _both(spec, req)
    flavor, pre = req
    want = res(ttypes, SIZE_VECS[flavor])
    view = (lambda h: h.free_full) if pre else (lambda h: h.free_normal)
    assert got.ok == any(want.fits_in(view(h)) for h in hosts)


@given(fleets(), requests())
@PROPS
def test_plan_only_contains_preemptible_from_winner(spec, req):
    hosts, got = _both(spec, req)
    if got.ok:
        winner = next(h for h in hosts if h.name == got.host)
        for inst in got.plan.instances:
            assert inst.preemptible and inst.id in winner.instances


@given(fleets(), requests())
@PROPS
def test_apply_never_overcommits(spec, req):
    flavor, pre = req
    cluster = tcluster.Cluster(build(ttypes, spec, PROP_NODE))
    cluster.schedule_and_place(tsched.PreemptibleScheduler(cost_fn=tcost.PeriodCost()),
                               request(ttypes, flavor, pre, "q"), NOW)
    for h in cluster.hosts.values():
        assert not h.free_full.any_negative()


@given(fleets(), requests())
@PROPS
def test_retry_agrees_with_single_pass_on_feasibility(spec, req):
    _, a = _both(spec, req)
    _, b = _both(spec, req, "RetryScheduler")
    assert a.ok == b.ok


@given(fleets())
@PROPS
def test_dual_state_dominance(spec):
    for h in build(ttypes, spec, PROP_NODE):
        assert h.free_full <= h.free_normal


@given(fleets(), requests())
@PROPS
def test_best_plan_is_cost_minimal(spec, req):
    """Alg. 5's exact enumeration returns the minimum-cost feasible subset
    (an independent brute force), and the JAX package's plan."""
    flavor, pre = req
    cost_fn = tcost.PeriodCost()
    treq, jreq = request(ttypes, flavor, pre, "q"), request(jtypes, flavor, pre, "q")
    for h, jh in zip(build(ttypes, spec, PROP_NODE), build(jtypes, spec, PROP_NODE)):
        plan = best_plan(h, treq, cost_fn, NOW)
        jplan = jbest(jh, jreq, jcost.PeriodCost(), NOW)
        assert (plan.ids, plan.cost, plan.feasible) == (jplan.ids, jplan.cost, jplan.feasible)
        best = None
        if treq.resources.fits_in(h.free_full):
            best = 0.0
        else:
            need = np.maximum((treq.resources - h.free_full).vec, 0.0)
            pre_insts = h.preemptible_instances()
            for r in range(1, len(pre_insts) + 1):
                for combo in itertools.combinations(pre_insts, r):
                    freed = np.sum([i.resources.vec for i in combo], axis=0)
                    if np.all(freed >= need - 1e-9):
                        c = cost_fn.cost(combo, NOW)
                        if best is None or c < best - 1e-9:
                            best = c
        if best is None:
            assert not plan.feasible
        else:
            assert plan.feasible and plan.cost == pytest.approx(best, abs=1e-6)


@given(fleets(), requests())
@PROPS
def test_count_cost_minimizes_cardinality(spec, req):
    _, got = _both(spec, req, cost="CountCost")
    flavor, pre = req
    for h in build(ttypes, spec, PROP_NODE):
        plan = best_plan(h, request(ttypes, flavor, pre, "q"), tcost.CountCost(), NOW)
        if plan.feasible and plan.instances:
            assert plan.cost == len(plan.instances)
