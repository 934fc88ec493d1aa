"""Device-sharded fleet scheduling on the CPU: the port's ``fleet_sharding``
and the sharded decision against the JAX package.

The merge and the padding are held against the reference's own functions on
the same arrays.  Every sharded decision runs on a mesh of CPU shards
(``fleet_mesh(devices=["cpu"] * S)``) and is held bit for bit against the
JAX package's jitted unsharded path on the padded state: the reference
guarantees that its sharded path equals that one
(``tests/test_sharded_parity.py``), and a subprocess test in
``test_torch_fleet_sharding_fleet.py`` holds the port against the
reference's own sharded screen.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_scheduler as jref
from repro.core import fleet_sharding as jfs
from repro.core.policy import SchedulerPolicy as JPolicy
from repro.core.screen_math import NEG_INF
from repro_torch.core import fleet_sharding as tfs
from repro_torch.core import fleets
from repro_torch.core import torch_scheduler as port
from repro_torch.core.convert import (
    fleet_state_from_numpy,
    fleet_state_to_numpy,
    host_state_from_numpy,
)
from repro_torch.core.policy import SchedulerPolicy as TPolicy
from repro_torch.core.types import VM_SPEC, Host, Instance
from test_torch_scheduler import jax_hosts

torch.set_num_threads(1)

NOW = 500_000.0
CAP = VM_SPEC.make(vcpus=8, ram_mb=16000, disk_gb=160)
SIZES = [VM_SPEC.make(vcpus=1, ram_mb=2000, disk_gb=20),
         VM_SPEC.make(vcpus=2, ram_mb=4000, disk_gb=40),
         VM_SPEC.make(vcpus=4, ram_mb=8000, disk_gb=80)]
KINDS = ("period", "count", "revenue", "recompute")


def cpu_mesh(s):
    return tfs.fleet_mesh(devices=["cpu"] * s)


def random_fleet(rng, n_hosts, fill=0.85, k_max=8, zones=3, kinds=False):
    """``tests/test_sharded_parity.py::_random_fleet`` in the port's types,
    hosts spread over ``zones`` zones; with ``kinds`` each preemptible
    instance bills by a drawn kind and was checkpointed."""
    hosts = []
    iid = 0
    for i in range(n_hosts):
        h = Host(name=f"h{i}", capacity=CAP, zone=f"z{i % zones}")
        while h.used().vec[0] < fill * CAP.vec[0]:
            size = SIZES[int(rng.integers(3))]
            if not size.fits_in(h.free_full):
                break
            pre = bool(rng.random() < 0.6) and len(h.preemptible_instances()) < k_max
            inst = Instance(id=f"x{iid}", resources=size, preemptible=pre, host=h.name,
                            start_time=NOW - float(rng.integers(10, 500)) * 60.0)
            if pre and kinds:
                inst.cost_kind = KINDS[int(rng.integers(4))]
                inst.last_checkpoint = inst.start_time + 120.0
            h.place(inst)
            iid += 1
        hosts.append(h)
    return hosts


def jax_hosts_kinds(hosts):
    out = jax_hosts(hosts)
    for h, jh in zip(hosts, out):
        for iid, inst in h.instances.items():
            jh.instances[iid].cost_kind = inst.cost_kind
            jh.instances[iid].last_checkpoint = inst.last_checkpoint
    return out


def states(hosts, s, m, zone_term=None, zone_up=None):
    """(padded JAX state, the port's sharded state of the same arrays,
    mesh)."""
    kw = {}
    if zone_term is not None:
        kw = dict(zone_term=zone_term, zone_up=zone_up)
    jstate, _ = jref.build_fleet_state(jax_hosts_kinds(hosts), k_slots=8, **kw)
    jstate = jfs.pad_fleet_state(jstate, jfs.padded_hosts(len(hosts), s, m_keep=m + 1))
    arrays = {f: np.asarray(getattr(jstate, f)) for f in port.STATE_DTYPES}
    mesh = cpu_mesh(s)
    return jstate, fleet_state_from_numpy(arrays, mesh=mesh), mesh


def assert_outs(tout, jout, what):
    names = ("host_idx", "slot", "ok", "kill", "fell_back", "margin")
    for t, j, name in zip(tout, jout, names):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=f"{what}: {name}")


def assert_states(tstate, jstate):
    got = fleet_state_to_numpy(tstate)
    for f in port.STATE_DTYPES:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jstate, f)), err_msg=f)


# ---------------------------------------------------------------------------
# 1. merge_shortlists against the reference's
# ---------------------------------------------------------------------------


def forward_shards(omega, n_shards, m):
    """What each shard of the reference's jnp route forwards: its top-M by
    ``lax.top_k`` and the masked-argmax witness, with global indices
    (``test_sharded_parity._forward_shards``)."""
    t = len(omega) // n_shards
    scores, idxs = [], []
    for s in range(n_shards):
        blk = omega[s * t:(s + 1) * t]
        s_loc, p_loc = jax.lax.top_k(jnp.asarray(blk), m)
        s_loc, p_loc = np.asarray(s_loc), np.asarray(p_loc)
        mask = np.zeros(t, bool)
        mask[p_loc] = True
        out = np.where(mask, np.float32(NEG_INF), blk)
        scores.append(np.concatenate([s_loc, [out.max()]]))
        idxs.append(np.concatenate([p_loc, [out.argmax()]]) + s * t)
    return np.concatenate(scores).astype(np.float32), np.concatenate(idxs).astype(np.int32)


def assert_merge(scores, idxs, m):
    want = jfs.merge_shortlists(jnp.asarray(scores), jnp.asarray(idxs), m)
    got = tfs.merge_shortlists(torch.from_numpy(scores), torch.from_numpy(idxs), m)
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # u bit for bit (a -0.0 stays -0.0), j_u exactly
    assert got[1].numpy().view(np.int32) == np.asarray(want[1]).view(np.int32)
    assert int(got[2]) == int(want[2])
    return got


def oracle(omega, m):
    """The unsharded selection: lax.top_k's shortlist, the masked argmax."""
    cand = np.asarray(jax.lax.top_k(jnp.asarray(omega), m)[1])
    out = omega.copy()
    out[cand] = np.float32(NEG_INF)
    return cand, np.float32(out.max())


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("n_shards,m", [(2, 4), (4, 8), (8, 16)])
def test_merge_matches_reference_under_ties(seed, n_shards, m):
    """``test_merge_preserves_topk_tie_ordering``'s cases: scores from a
    four-value set, so ties dominate.  The port's merge equals the
    reference's on the reference's forwarded pairs, and on the kernel
    route's (each shard's top-(M+1) by the port's own plain screen order)
    it equals ``lax.top_k`` on the whole fleet."""
    rng = np.random.default_rng(seed)
    t = max(m + 1, 12)
    omega = rng.choice(np.asarray([NEG_INF, 0.25, 0.5, 1.0], np.float32), n_shards * t)
    assert_merge(*forward_shards(omega, n_shards, m), m)
    # the port forwards each shard's top-(M+1) (the kernel route)
    sc, ix = [], []
    for s in range(n_shards):
        blk = torch.from_numpy(omega[s * t:(s + 1) * t])
        order = torch.sort(blk, descending=True, stable=True).indices[:m + 1]
        sc.append(blk[order])
        ix.append(order.to(torch.int32) + s * t)
    scores, idxs = torch.cat(sc).numpy(), torch.cat(ix).numpy()
    cand, u, _ = assert_merge(scores, idxs, m)
    ref_cand, ref_u = oracle(omega, m)
    np.testing.assert_array_equal(cand.numpy(), ref_cand)
    assert np.float32(u) == ref_u


def test_merge_drops_duplicate_witness():
    """A shard whose hosts all sit in its top-M re-emits one as its witness;
    the duplicate goes behind every real entry."""
    omega = np.asarray([NEG_INF] * 4 + [1.0, 0.5, NEG_INF, NEG_INF], np.float32)
    scores, idxs = forward_shards(omega, 2, 4)
    assert len(np.unique(idxs)) < len(idxs)
    cand, _, _ = assert_merge(scores, idxs, 4)
    assert len(np.unique(cand.numpy())) == 4
    np.testing.assert_array_equal(cand.numpy(), oracle(omega, 4)[0])


@pytest.mark.parametrize("n_shards,m", [(2, 4), (4, 8)])
def test_merge_all_neg_inf_shards(n_shards, m):
    """Every host invalid on every shard, then on all shards but the last:
    the sentinel's collision (+POS_INF equals -NEG_INF) is broken by the
    int32-max index."""
    t = m + 1
    omega = np.full(n_shards * t, NEG_INF, np.float32)
    assert_merge(*forward_shards(omega, n_shards, m), m)
    omega[-3:] = np.asarray([2.0, 1.0, 2.0], np.float32)
    cand, u, j_u = assert_merge(*forward_shards(omega, n_shards, m), m)
    assert cand.numpy()[:3].tolist() == [n_shards * t - 3, n_shards * t - 1, n_shards * t - 2]


@pytest.mark.parametrize("seed", range(4))
def test_merge_signed_zero_ties(seed):
    """``-0.0`` and ``+0.0`` compare equal in ``lax.sort``: ties between them
    go by index, and the score's sign bit moves with it."""
    rng = np.random.default_rng(100 + seed)
    n_shards, m = 4, 8
    omega = rng.choice(np.asarray([0.0, -0.0, 1.0, -1.0, NEG_INF], np.float32), n_shards * 12)
    scores, idxs = forward_shards(omega, n_shards, m)
    assert np.signbit(scores[scores == 0]).any() and (~np.signbit(scores[scores == 0])).any()
    assert_merge(scores, idxs, m)
    # every forwarded score a signed zero, shuffled
    perm = rng.permutation(len(scores))
    zeros = np.where(rng.random(len(scores)) < 0.5, np.float32(-0.0), np.float32(0.0))
    assert_merge(zeros[perm], idxs[perm], m)


# ---------------------------------------------------------------------------
# 2. padding, the mesh and the sharded state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,s,m_keep", [(37, 4, 9), (2, 4, 2), (4099, 4, 65), (64, 8, 9),
                                        (1, 1, 65)])
def test_padded_hosts_match_reference(n, s, m_keep):
    assert tfs.padded_hosts(n, s, m_keep=m_keep) == jfs.padded_hosts(n, s, m_keep=m_keep)
    assert tfs.padded_hosts(n, s) == jfs.padded_hosts(n, s)


def test_padded_hosts_for_reads_the_policy():
    mesh = cpu_mesh(4)
    for kw in (dict(), dict(shortlist=8), dict(adaptive_shortlist=True, adaptive_bounds=(16, 128))):
        want = jfs.padded_hosts(101, 4, m_keep=JPolicy(**kw).max_shortlist() + 1)
        assert tfs.padded_hosts_for(101, TPolicy(mesh=mesh, **kw)) == want
    with pytest.raises(ValueError, match="mesh set"):
        tfs.padded_hosts_for(101, TPolicy())


@pytest.mark.parametrize("n_zones", [3, 20])
def test_pad_fleet_state_matches_reference(n_zones):
    """Every field padded as the reference pads it; with as many zones as
    hosts the zone accumulators still pass through unpadded (matched by
    name, not by shape)."""
    hosts = random_fleet(np.random.default_rng(5), 20, zones=n_zones, kinds=True)
    zt = np.arange(n_zones, dtype=np.float32)
    zu = np.arange(n_zones, dtype=np.float32) * 10 + 1
    jstate, _ = jref.build_fleet_state(jax_hosts_kinds(hosts), k_slots=8,
                                       zone_term=zt, zone_up=zu)
    arrays = {f: np.asarray(getattr(jstate, f)) for f in port.STATE_DTYPES}
    tstate = fleet_state_from_numpy(arrays, device="cpu")
    want = jfs.pad_fleet_state(jstate, 36)
    got = tfs.pad_fleet_state(tstate, 36)
    assert got.n_hosts == 36 and got.n_zones == n_zones
    assert_states(got, want)
    assert tfs.pad_fleet_state(tstate, 20) is tstate
    np.testing.assert_array_equal(tstate.free_f.numpy(), arrays["free_f"])   # untouched


def test_pad_host_state_matches_reference():
    hosts = random_fleet(np.random.default_rng(6), 21)
    zone_ids = {f"z{z}": z for z in range(3)}
    rates = {"z0": 0.0, "z1": 0.25, "z2": 0.5}
    jstate, _ = jref.build_soa_state(jax_hosts(hosts), NOW, k_slots=8, zone_rates=rates,
                                     zone_ids=zone_ids)
    arrays = {f: np.asarray(getattr(jstate, f)) for f in port.HOST_STATE_DTYPES}
    want = jfs.pad_fleet_state(jstate, 40)
    got = tfs.pad_fleet_state(host_state_from_numpy(arrays, device="cpu"), 40)
    for f in port.HOST_STATE_DTYPES:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_sharded_state_layout_and_gather():
    """Host-major blocks on the mesh's devices with the unsharded fields and
    dtypes, one zone pair shared by every block, n_hosts padded, and the
    gather back bit for bit."""
    hosts = random_fleet(np.random.default_rng(7), 37)
    jstate, tstate, mesh = states(hosts, 4, 8)
    assert tstate.mesh is mesh and tstate.n_hosts == 40 and tstate.shard_hosts == 10
    assert tstate.k_slots == 8 and tstate.device == torch.device("cpu")
    for b in tstate.blocks:
        assert b.zone_term is tstate.zone_term and b.zone_up is tstate.zone_up
        for f, dt in port.STATE_DTYPES.items():
            assert getattr(b, f).dtype == dt
    assert tstate.locate(23)[1] == 3 and tstate.locate(23)[0] is tstate.blocks[2]
    assert_states(tstate, jstate)
    assert_states(tstate.gather(), jstate)
    with pytest.raises(ValueError, match="does not divide"):
        tfs.shard_fleet_state(fleet_state_from_numpy(
            {f: np.asarray(getattr(jstate, f))[:37] if f not in tfs.ZONE_FIELDS
             else np.asarray(getattr(jstate, f)) for f in port.STATE_DTYPES},
            device="cpu"), mesh)


def test_fleet_mesh_and_policy():
    mesh = cpu_mesh(4)
    assert mesh.size == 4 and mesh.axis_names == ("hosts",)
    assert hash(mesh) == hash(cpu_mesh(4)) and mesh == cpu_mesh(4)
    assert TPolicy(mesh=mesh) == TPolicy(mesh=cpu_mesh(4))
    assert tfs.fleet_mesh(2, devices=["cpu"] * 4).size == 2
    with pytest.raises(ValueError, match="n_shards"):
        tfs.fleet_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="mesh must be a 1-D"):
        TPolicy(mesh=("cpu", "cpu"))
    if not torch.cuda.is_available():
        # no CUDA device: the default mesh raises instead of taking the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfs.fleet_mesh()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tfs.fleet_mesh(devices=["cuda:0"] * 2)


def test_core_exports_the_sharding_helpers():
    import repro_torch.core as core

    for name in ("fleet_mesh", "merge_shortlists", "pad_fleet_state", "padded_hosts",
                 "padded_hosts_for", "shard_fleet_state"):
        assert getattr(core, name) is getattr(tfs, name)
        assert name in core.__all__


# ---------------------------------------------------------------------------
# 3. decisions on a sharded state against the jitted unsharded reference
# ---------------------------------------------------------------------------

SHARD_CASES = [(n, s) for n in (37, 39, 41, 43, 50, 64, 101) for s in (2, 4, 8)]
POLICY_KW = dict(cost_kind="period", cost_kinds=KINDS, churn_multiplier=2.0,
                 churn_threshold=0.25)


def mixed_churn_states(n, s, m, seed):
    hosts = random_fleet(np.random.default_rng(seed), n, kinds=True)
    zt = np.asarray([0.0, 8.0, 32.0], np.float32)   # z0 cold, z1 warm, z2 hot
    zu = np.asarray([64.0, 64.0, 64.0], np.float32)
    return states(hosts, s, m, zone_term=zt, zone_up=zu)


def requests(rng, b, t0):
    res = np.stack([SIZES[i].vec for i in rng.integers(0, 3, b)]).astype(np.float32)
    pre = rng.random(b) < 0.5
    now = (t0 + np.cumsum(rng.integers(1, 90, b))).astype(np.float32)
    price = rng.integers(1, 5, b).astype(np.float32)
    kind = rng.integers(-1, 4, b).astype(np.int32)
    return res, pre, np.full(b, -1, np.int32), now, price, kind


@pytest.mark.parametrize("n,s", SHARD_CASES)
def test_schedule_many_sharded_matches_reference(n, s):
    """A batch of 16 under mixed cost kinds and churn (multiplier 2,
    threshold 0.25) on ``n`` hosts in ``s`` CPU shards (M = 8): every output
    and the final state, padding rows included, bitwise equal to the
    reference's unsharded run on the padded state."""
    m = 8
    jstate, tstate, mesh = mixed_churn_states(n, s, m, seed=n * 10 + s)
    args = requests(np.random.default_rng(n + s), 16, NOW)
    jstate, jout = jref.schedule_many(jstate, *args[:5], policy=JPolicy(shortlist=m, **POLICY_KW),
                                      req_cost_kind=args[5], donate=False)
    tstate, tout = port.schedule_many(tstate, *args[:5],
                                      policy=TPolicy(shortlist=m, mesh=mesh, **POLICY_KW),
                                      req_cost_kind=args[5])
    assert_outs(tout, jout, f"{n} hosts in {s} shards")
    assert_states(tstate, jstate)
    assert tout[2].any()


@pytest.mark.parametrize("n,s", [(37, 4), (64, 8), (101, 2)])
def test_schedule_step_sharded_matches_reference(n, s):
    """``schedule_step`` one request at a time, with a domain and a zone
    exclusion under a relocation-capable policy (the zone operand live)."""
    m = 8
    jstate, tstate, mesh = mixed_churn_states(n, s, m, seed=n)
    pol = dict(POLICY_KW, shortlist=m, relocate_threshold=0.5)
    for step in range(6):
        req = np.asarray(SIZES[step % 3].vec, np.float32)
        pre, excl, kind = bool(step % 2), (-1, 0, 2)[step % 3], step % 4 - 1
        jstate, jout = jref.schedule_step(
            jstate, req, pre, np.int32(-1), NOW + 60.0 * step, 1.0 + step,
            policy=JPolicy(**pol), req_cost_kind=np.int32(kind),
            req_exclude_zone=np.int32(excl), donate=False)
        tstate, tout = port.schedule_step(
            tstate, req, pre, -1, NOW + 60.0 * step, 1.0 + step,
            policy=TPolicy(mesh=mesh, **pol), req_cost_kind=kind, req_exclude_zone=excl)
        assert_outs(tout, jout, f"step {step}")
    assert_states(tstate, jstate)


def test_short_shards_and_full_enumeration_match_reference():
    """A sharded state whose shards hold fewer than M + 1 hosts (the
    reference runs its unsharded screen there) and M = 0 (the full
    enumeration, per shard here): outputs, fallback flag and margin
    included, equal to the reference's."""
    hosts = random_fleet(np.random.default_rng(11), 37, kinds=True)
    for m, m_pad in ((16, 8), (0, 8), (30, 8)):
        jstate, tstate, mesh = states(hosts, 4, m_pad)        # shards of 10 hosts
        args = requests(np.random.default_rng(m), 12, NOW)
        jstate, jout = jref.schedule_many(jstate, *args[:5], policy=JPolicy(shortlist=m),
                                          req_cost_kind=args[5], donate=False)
        tstate, tout = port.schedule_many(tstate, *args[:5], policy=TPolicy(shortlist=m),
                                          req_cost_kind=args[5])
        assert_outs(tout, jout, f"M={m}")
        assert_states(tstate, jstate)


def test_unsharded_state_split_per_call():
    """An unsharded state under a policy with a mesh is split into shard
    blocks for each decision (what ``shard_map`` does to unplaced arrays):
    the same outputs and state as without the mesh."""
    hosts = random_fleet(np.random.default_rng(12), 40, kinds=True)
    jstate, _ = jref.build_fleet_state(jax_hosts_kinds(hosts), k_slots=8)
    arrays = {f: np.asarray(getattr(jstate, f)) for f in port.STATE_DTYPES}
    plain = fleet_state_from_numpy(arrays, device="cpu")
    split = fleet_state_from_numpy(arrays, device="cpu")
    args = requests(np.random.default_rng(3), 16, NOW)
    pol = TPolicy(shortlist=8, cost_kinds=KINDS)
    plain, pout = port.schedule_many(plain, *args[:5], policy=pol, req_cost_kind=args[5])
    split, sout = port.schedule_many(split, *args[:5], req_cost_kind=args[5],
                                     policy=dataclasses.replace(pol, mesh=cpu_mesh(4)))
    assert_outs(sout, pout, "split per call")
    got, want = fleet_state_to_numpy(split), fleet_state_to_numpy(plain)
    for f in port.STATE_DTYPES:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_sharded_fallback_fixture():
    """``test_sharded_parity.py::test_sharded_fallback_parity``: host A's
    loose bound wins the 1-candidate shortlist, the admissibility check
    fails, and the full enumeration (per shard here) lands on host B."""
    free_f = np.zeros((2, 2), np.float32)
    inst_res = np.array([[[4, 0], [0, 4], [4, 4]], [[4, 4], [0, 0], [0, 0]]], np.float32)
    arrays = dict(free_f=free_f, free_n=np.full((2, 2), 4.0, np.float32),
                  schedulable=np.ones((2,), bool), domain=np.zeros((2,), np.int32),
                  slow=np.ones((2,), np.float32), inst_res=inst_res,
                  inst_cost=np.array([[10, 10, 50], [15, 0, 0]], np.float32),
                  inst_valid=np.array([[1, 1, 1], [1, 0, 0]], bool))
    jstate = jref.SoAHostState(**{f: jnp.asarray(v) for f, v in arrays.items()})
    for s in (2, 4, 8):
        mesh = cpu_mesh(s)
        padded = jfs.pad_fleet_state(jstate, jfs.padded_hosts(2, s, m_keep=2))
        sharded = host_state_from_numpy(
            {f: np.asarray(getattr(padded, f)) for f in arrays}, mesh=mesh)
        req = np.asarray([4.0, 4.0], np.float32)
        ref = jref.schedule_decision(padded, jnp.asarray(req), False, -1,
                                     policy=JPolicy(shortlist=1))
        pol = TPolicy(shortlist=1, mesh=mesh)
        got = port.schedule_decision(sharded, req, False, -1, policy=pol)
        assert got == tuple(int(x) for x in ref)
        assert got[0] == 1 and got[2]
        h, _, _, fell_back = port._rebuild_decision(sharded, req, False, -1, pol, -1)
        assert h == 1 and fell_back


@pytest.mark.parametrize("n,s", [(43, 4), (64, 2), (101, 8)])
@pytest.mark.parametrize("pre", [False, True])
def test_schedule_decision_sharded_host_state(n, s, pre):
    """The rebuild path's state sharded (churn column and zone ids present):
    ``schedule_decision`` equal to the reference's on the padded state."""
    hosts = random_fleet(np.random.default_rng(n + s), n)
    zone_ids = {f"z{z}": z for z in range(3)}
    rates = {"z0": 0.0, "z1": 0.125, "z2": 0.5}
    jstate, _ = jref.build_soa_state(jax_hosts(hosts), NOW, k_slots=8, zone_rates=rates,
                                     zone_ids=zone_ids)
    jstate = jfs.pad_fleet_state(jstate, jfs.padded_hosts(n, s, m_keep=9))
    mesh = cpu_mesh(s)
    tstate = host_state_from_numpy(
        {f: np.asarray(getattr(jstate, f)) for f in port.HOST_STATE_DTYPES}, mesh=mesh)
    for size in SIZES:
        for excl in (-1, 1):
            kw = dict(shortlist=8, churn_multiplier=2.0, churn_threshold=0.25,
                      relocate_threshold=0.5)
            ref = jref.schedule_decision(jstate, jnp.asarray(size.vec, jnp.float32), pre, -1,
                                         policy=JPolicy(**kw), req_exclude_zone=excl)
            got = port.schedule_decision(tstate, size.vec32, pre, -1,
                                         policy=TPolicy(mesh=mesh, **kw), req_exclude_zone=excl)
            assert got == tuple(int(x) for x in ref), (size, excl)


@pytest.mark.parametrize("s", [2, 4])
def test_relocate_many_sharded_matches_reference(s):
    """``relocate_many`` on a sharded state: checkpoint, re-placement with
    the zone excluded and the voluntary termination each routed to the
    owning shard; padding rows included, every output and the state equal
    to the reference's unsharded run."""
    n = 41
    hosts = fleets.saturated_fleet(n, seed=n)
    for i, h in enumerate(hosts):
        h.zone = f"z{i % 3}"
        if i % 2:
            for iid in list(h.instances):
                h.remove(iid)
    jstate, tstate, mesh = states(hosts, s, 8)
    arrays = fleet_state_to_numpy(tstate)
    rows = np.argwhere(arrays["inst_valid"] & (arrays["host_zone"][:, None] == 0))[:5]
    b = 8
    vh, vs, von = np.zeros(b, np.int32), np.zeros(b, np.int32), np.zeros(b, bool)
    res = np.full((b, 3), 1e9, np.float32)
    excl, price = np.full(b, -1, np.int32), np.ones(b, np.float32)
    for i, (h, sl) in enumerate(rows):
        vh[i], vs[i], von[i], excl[i] = h, sl, True, 0
        res[i] = arrays["inst_res"][h, sl]
        price[i] = i + 1
    dom, kind, period = np.full(b, -1, np.int32), np.full(b, -1, np.int32), np.full(b, -1.0, np.float32)
    now = float(fleets.NOW) + 100.0
    jstate, jout = jref.relocate_many(jstate, vh, vs, von, res, dom, kind, period, price, excl,
                                      now, policy=JPolicy(relocate_threshold=1e-4, shortlist=8),
                                      donate=False)
    tstate, tout = port.relocate_many(tstate, vh, vs, von, res, dom, kind, period, price, excl,
                                      now, policy=TPolicy(relocate_threshold=1e-4, shortlist=8,
                                                          mesh=mesh))
    for t, j, name in zip(tout, jout, ("host", "slot", "ok", "fell_back", "margin")):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert_states(tstate, jstate)
    assert tout[2].numpy()[:5].all()


def test_transitions_route_to_the_owning_shard():
    """Every one-host transition on a sharded state against the reference
    on the padded state, at hosts on the first and last row of a shard."""
    hosts = random_fleet(np.random.default_rng(13), 40)
    jstate, tstate, mesh = states(hosts, 4, 8)
    arr = fleet_state_to_numpy(tstate)
    req = np.asarray([1.0, 2000.0, 20.0], np.float32)
    for h in (9, 10, 39, 0):
        jstate, jslot = jref.apply_placement(jstate, h, req, True, 1234.5, 2.0, 1, 600.0)
        tstate, tslot = port.apply_placement(tstate, h, torch.from_numpy(req), True, 1234.5,
                                             2.0, 1, 600.0)
        assert int(tslot) == int(jslot)
        mask = arr["inst_valid"][h].copy()
        jstate = jref.apply_termination(jstate, h, mask, now=NOW, involuntary=True)
        tstate = port.apply_termination(tstate, h, mask, now=NOW, involuntary=True)
        jstate = jref.apply_departure(jstate, h, req)
        tstate = port.apply_departure(tstate, h, torch.from_numpy(req))
        jstate = jref.apply_checkpoint(jstate, h, 0, NOW + 5.0)
        tstate = port.apply_checkpoint(tstate, h, 0, NOW + 5.0)
        jstate = jref.set_slow_factor(jstate, h, 1.5)
        tstate = port.set_slow_factor(tstate, h, 1.5)
        jstate = jref.set_schedulable(jstate, h, False)
        tstate = port.set_schedulable(tstate, h, False)
    jstate = jref.apply_host_failure(jstate, 21, req, now=NOW + 9.0)
    tstate = port.apply_host_failure(tstate, 21, torch.from_numpy(req), now=NOW + 9.0)
    assert_states(tstate, jstate)


# ---------------------------------------------------------------------------
# 4. what a mesh is refused by, with the reference's messages
# ---------------------------------------------------------------------------


def test_traced_multipliers_refuse_the_mesh():
    """``mult_val`` (the ensemble's axis) on the mesh path raises as the
    reference's ``_decision_core`` does; where no shard holds M + 1 hosts
    the mesh path does not run, and it decides."""
    hosts = random_fleet(np.random.default_rng(14), 40)
    _, tstate, mesh = states(hosts, 4, 8)
    req = torch.from_numpy(SIZES[1].vec32.copy())
    kw = dict(policy=TPolicy(shortlist=8, mesh=mesh), mult_val=(1.0, 1.0, 0.0, 0.0))
    with pytest.raises(NotImplementedError, match="traced multiplier values"):
        port._step_core(tstate, req, False, -1, NOW, 1.0, -1, -1.0, **kw)
    whole = tstate.gather()
    cols = (whole.free_f, whole.free_n, whole.schedulable, whole.domain, whole.slow,
            whole.inst_res, port.fleet_slot_costs(whole, NOW, TPolicy()), whole.inst_valid)
    with pytest.raises(NotImplementedError, match="traced multiplier values"):
        port._decision_core(*cols, req, False, -1, require_free_slot=True, **kw)
    short = dict(kw, policy=TPolicy(shortlist=16, mesh=mesh))
    assert port._decision_core(*cols, req, False, -1, require_free_slot=True, **short)[:4] \
        == port._decision_core(*cols, req, False, -1, require_free_slot=True,
                               policy=TPolicy(shortlist=16), mult_val=kw["mult_val"])[:4]
