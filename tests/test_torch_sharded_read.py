"""The sharded service's read side: the engine's versioned pulls over
shard lanes and the read tier (``ReplicaSet`` / ``ParameterReplica``)
serving across lanes, held against the reference's on the same inputs.

Both packages host three jobs (numpy-seeded weights carried across by
``tree_from_numpy``) on three shard spaces; the reference runs eagerly
(``jit=False``).  Version vectors, block ids, flags, byte counts and
read counters are compared field for field, payloads within the 1-ulp
budget where Adam ran, and bit for bit inside the port where only copies
ran (a replica's serve against the engine's own pull, a patched diff
against a full pull).  The port stamps versions per job where the
reference stamps every owned block; the vectors a pull returns are equal.
The cases mirror the sharded ones of ``tests/test_replica.py`` and
``tests/test_fused_tick.py::test_sharded_versioned_pull_diffs_and_epoch_fence``.

Publishes fire PRE-apply, so a replica trails the live state by the tick
in flight; ``ReplicaSet.refresh()`` publishes the current state, and every
replica-versus-engine comparison refreshes first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ParameterService as JService
from repro.ps.faults import EngineQuarantinedError as JQuarantined
from repro.ps.faults import FaultInjector as JInjector
from repro.ps.replica import ReplicaSet as JReplicaSet
from repro.ps.service_runtime import ShardedServiceRuntime as JSharded
from repro_torch.core import ParameterService as TService
from repro_torch.ps.faults import (
    QUARANTINED,
    EngineQuarantinedError,
    FaultInjector,
)
from repro_torch.ps.replica import ReplicaSet
from repro_torch.ps.runtime import tree_from_numpy
from repro_torch.ps.service_runtime import ShardedServiceRuntime as TSharded

ULP_BUDGET = 1


def ulp_diff(a, b) -> int:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree(seed, sizes):
    rng = np.random.default_rng(seed)
    return {f"t{i}": rng.standard_normal(n).astype(np.float32)
            for i, n in enumerate(sizes)}


def _loss_torch(params, batch):
    return sum(torch.sum((params[k] - batch["target"][k]) ** 2)
               for k in params)


def _loss_jax(params, batch):
    return sum(jnp.sum((params[k] - batch["target"][k]) ** 2)
               for k in params)


TREES = {"a": _tree(0, (48, 16, 32)), "b": _tree(1, (32, 16)),
         "c": _tree(2, (48, 16))}
TARGETS = {j: {k: np.ones_like(v) for k, v in t.items()}
           for j, t in TREES.items()}
PROBE = _tree(9, (16,))


def _batch(j, port):
    if port:
        return {"target": tree_from_numpy(TARGETS[j], "cpu")}
    return {"target": jax.tree_util.tree_map(jnp.asarray, TARGETS[j])}


def _add(rt, jid, tree, port):
    params = (tree_from_numpy(tree, "cpu") if port
              else jax.tree_util.tree_map(jnp.asarray, tree))
    rt.add_job(jid, params, _loss_torch if port else _loss_jax, lr=0.05,
               required_servers=1,
               agg_throughput=sum(4 * v.size for v in tree.values()) / 0.2)


def _build(port, n_shards=3, **engine):
    engine.setdefault("max_staleness", 0)
    if port:
        svc = TService(total_budget=16, n_clusters=1, plan_pad_to=16)
        rt = TSharded(svc, device="cpu")
        eng = rt.attach_engine(**engine)
    else:
        svc = JService(total_budget=16, n_clusters=1, plan_pad_to=16)
        rt = JSharded(svc, jit=False)
        eng = rt.attach_engine(jit=False, **engine)
    for jid, t in TREES.items():
        _add(rt, jid, t, port)
    if n_shards > 1:
        svc.scale_out(n_shards - 1)
    return rt, eng


def _pair(n_shards=3, replicas=None, **engine):
    """[(port, rt, eng, replica set or None), (reference, ...)]; with
    ``fault_injector=True`` each engine gets its package's injector."""
    out = []
    for port in (True, False):
        opts = dict(engine)
        if opts.get("fault_injector"):
            opts["fault_injector"] = FaultInjector() if port else JInjector()
        rt, eng = _build(port, n_shards, **opts)
        rs = (None if replicas is None else
              (ReplicaSet if port else JReplicaSet)(eng, **replicas))
        out.append((port, rt, eng, rs))
    assert out[0][1].shard_ids == out[1][1].shard_ids
    return out


def _drive(eng, n, port, jobs=TREES):
    for _ in range(n):
        for j in jobs:
            eng.step(j, _batch(j, port))
    eng.drain()


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _assert_trees_close(t, j):
    assert set(t) == set(j)
    for k in j:
        assert ulp_diff(_np(t[k]), _np(j[k])) <= ULP_BUDGET, k


def _assert_diffs_match(td, jd):
    """A port PullDiff against the reference's: every field, the payload
    within the budget."""
    assert (td.job_id, td.full, td.block, td.bytes_wire, td.bytes_full) == \
        (jd.job_id, jd.full, jd.block, jd.bytes_wire, jd.bytes_full)
    assert td.version.epoch == jd.version.epoch
    np.testing.assert_array_equal(td.version.versions, jd.version.versions)
    np.testing.assert_array_equal(td.block_ids, jd.block_ids)
    assert tuple(td.data.shape) == tuple(jd.data.shape)
    assert ulp_diff(_np(td.data), _np(jd.data)) <= ULP_BUDGET


def _read_stats(rs):
    """ReadStats of every replica without the wall-clock fields."""
    out = rs.stats()
    for k, v in out.items():
        if k.startswith("replica_"):
            v.pop("serve_seconds")
            v.pop("pulls_per_sec")
    return out


# --------------------------------------------------------- engine pulls
def test_sharded_versioned_pull_diffs_and_epoch_fence():
    """A held vector pays only for the blocks later ticks touched (none
    for an untouched job), the diff chain rebuilds the full payload bit
    for bit, and a replan's epoch bump sends stale vectors to the full
    fallback; every diff equals the reference's."""
    diffs = []
    for port, rt, eng, _ in _pair():
        _drive(eng, 1, port)
        d0 = eng.pull("a", since_version=0)
        assert d0.full
        _drive(eng, 1, port, jobs=("b",))  # "a" untouched
        d1 = eng.pull("a", since_version=d0.version)
        assert not d1.full and d1.block_ids.size == 0 and d1.bytes_wire == 0
        _drive(eng, 1, port, jobs=("a",))
        d2 = eng.pull("a", since_version=d1.version)
        assert not d2.full and 0 < d2.bytes_wire <= d2.bytes_full
        fresh = eng.pull("a", since_version=0)
        patched = d2.apply(d1.apply(d0.data))
        if port:
            assert torch.equal(patched, fresh.data)
        _add(rt, "probe", PROBE, port)
        d3 = eng.pull("a", since_version=d2.version)
        assert d3.full and d3.version.epoch != d2.version.epoch
        diffs.append((d0, d1, d2, d3))
    for td, jd in zip(*diffs):
        _assert_diffs_match(td, jd)


def test_versions_follow_rollbacks_as_the_reference_does():
    """Ticks, a lane rollback's re-stamp and a fleet fall-back move the
    fleet-wide version clock as in the reference: every job's vector is
    equal, and a vector held from before the fault diffs to exactly the
    replayed blocks."""
    sides = _pair(fault_injector=True, snapshot_interval=2)
    held, after = [], []
    for port, rt, eng, _ in sides:
        _drive(eng, 3, port, jobs=("a", "b"))
        held.append({j: eng.pull(j, since_version=0) for j in TREES})
        eng.fault_injector.fail_apply(rt.shard_ids[0], at=1)
        _drive(eng, 1, port, jobs=("a", "b"))
        assert eng.stats.n_rollbacks >= 1
        after.append({j: eng.pull(j, since_version=held[-1][j].version)
                      for j in TREES})
        assert eng._version_clock > 0
    assert sides[0][2]._version_clock == sides[1][2]._version_clock
    for j in TREES:
        _assert_diffs_match(after[0][j], after[1][j])
        full = sides[0][2].pull(j, since_version=0).data
        assert torch.equal(after[0][j].apply(held[0][j].data), full)
    assert after[0]["c"].block_ids.size == 0


def test_pull_payloads_are_copies_of_the_arena():
    """Full pulls, diff payloads and served snapshots are new tensors:
    the next in-place tick leaves them as they were."""
    (_, rt, eng, rs), _ = _pair(replicas=dict(n_replicas=1))
    _drive(eng, 1, True)
    d0 = eng.pull("a", since_version=0)
    _drive(eng, 1, True)
    rs.refresh()
    kept = []
    for x in (d0.data, eng.pull("a", since_version=d0.version).data,
              rs.pull("a")["t0"], eng.pull("b")["t0"]):
        kept.append((x, x.clone()))
        for leaf in rt.arena.values():
            assert (x.untyped_storage().data_ptr()
                    != leaf.untyped_storage().data_ptr())
    _drive(eng, 2, True)
    for x, was in kept:
        assert torch.equal(x, was)
    for snap in rs.replicas[0]._snaps.values():
        assert (snap.flat.untyped_storage().data_ptr()
                != rt.arena["flat"].untyped_storage().data_ptr())


# ------------------------------------------------------ publish + parity
def test_tree_pull_parity_after_refresh():
    sides = _pair(replicas=dict(n_replicas=2))
    served = []
    for port, rt, eng, rs in sides:
        _drive(eng, 4, port)
        assert rs.n_publishes > 0
        rs.refresh()
        trees = {j: rs.pull(j) for j in TREES}
        if port:
            for j in TREES:
                _assert_trees_equal(eng.pull(j), trees[j])
        assert all(rep.stats.n_snapshots_seen > 0 for rep in rs.replicas)
        served.append(trees)
    for j in TREES:
        _assert_trees_close(served[0][j], served[1][j])
    (_, _, _, trs), (_, _, _, jrs) = sides
    assert (trs.n_publishes, trs.n_reused_snapshot_copies) == \
        (jrs.n_publishes, jrs.n_reused_snapshot_copies)


def test_versioned_pull_and_diff_chain_parity():
    out = []
    for port, rt, eng, rs in _pair(replicas=dict(n_replicas=1)):
        rep = rs.replicas[0]
        _drive(eng, 3, port)
        rs.refresh()
        boot = {}
        for j in TREES:
            de, d0 = eng.pull(j, since_version=0), rep.pull(j,
                                                            since_version=0)
            assert d0.full and d0.bytes_full == de.bytes_full
            np.testing.assert_array_equal(d0.version.versions,
                                          de.version.versions)
            if port:
                assert torch.equal(d0.data, de.data)
            boot[j] = d0
        _drive(eng, 2, port, jobs=("a",))
        rs.refresh()
        held = rep.pull("a", since_version=0)
        d1 = rep.pull("b", since_version=boot["b"].version)
        assert not d1.full and d1.block_ids.size == 0  # "b" never moved
        d2 = rep.pull("a", since_version=held.version)
        _drive(eng, 1, port, jobs=("a",))
        rs.refresh()
        d3 = rep.pull("a", since_version=d2.version)
        assert not d3.full and d3.block_ids.size > 0
        assert d3.bytes_wire == 4 * d3.block_ids.size * d3.block
        patched = d3.apply(d2.apply(held.data))
        if port:
            assert torch.equal(patched,
                               eng.pull("a", since_version=0).data)
        out.append((boot["a"], held, d1, d2, d3))
    for td, jd in zip(*out):
        _assert_diffs_match(td, jd)


def test_pull_batch_matches_sequential_pulls():
    out = []
    for port, rt, eng, rs in _pair(replicas=dict(n_replicas=1)):
        rep = rs.replicas[0]
        _drive(eng, 3, port)
        rs.refresh()
        boot = rep.pull_batch([(j, 0) for j in TREES])
        assert [d.job_id for d in boot] == list(TREES)
        for d in boot:
            assert d.full
            if port:
                assert torch.equal(
                    d.data, eng.pull(d.job_id, since_version=0).data)
        vec = {d.job_id: d.version for d in boot}
        _drive(eng, 2, port, jobs=("a",))
        rs.refresh()
        batch = rep.pull_batch([(j, vec[j]) for j in TREES])
        for d in batch:
            one = rep.pull(d.job_id, since_version=vec[d.job_id])
            assert (d.full, d.bytes_wire) == (one.full, one.bytes_wire)
            np.testing.assert_array_equal(d.block_ids, one.block_ids)
            np.testing.assert_array_equal(_np(d.data), _np(one.data))
        moved = {d.job_id: d.block_ids.size for d in batch}
        assert moved["a"] > 0 and moved["b"] == 0 and moved["c"] == 0
        assert rep.stats.n_batches == 2
        assert rep.stats.n_batch_jobs == 2 * len(TREES)
        out.append(boot + batch)
    for td, jd in zip(*out):
        _assert_diffs_match(td, jd)


# ------------------------------------------------------------ epoch fence
def test_replan_fences_snapshots_and_resubscribes():
    for port, rt, eng, rs in _pair(n_shards=2, replicas=dict(n_replicas=2)):
        _drive(eng, 3, port)
        rs.refresh()
        before = rs.epoch
        assert rt.service.scale_out(1) == 1
        assert rs.epoch > before
        _drive(eng, 2, port)
        assert all(rep._snaps[k].epoch == rs.epoch
                   for rep in rs.replicas for k in rt.shard_ids)
        rs.refresh()
        if port:
            for j in TREES:
                _assert_trees_equal(eng.pull(j), rs.pull(j))
            # A merge: the replicas drop the departed lane's snapshot.
            assert rt.service.scale_in(1) == 1
            assert all(set(rep._snaps) <= set(rt.shard_ids)
                       for rep in rs.replicas)
            for j in TREES:
                _assert_trees_equal(eng.pull(j), rs.pull(j))


def test_stale_epoch_pull_forces_refresh_not_stale_serve():
    for port, rt, eng, rs in _pair(n_shards=2, replicas=dict(
            n_replicas=1, publish_interval=1000)):
        rep = rs.replicas[0]
        _drive(eng, 2, port)
        rs.refresh()
        rep.pull("a")
        assert rt.service.scale_out(1) == 1
        n_before = rep.stats.n_forced_refreshes
        served = rep.pull("a")
        assert rep.stats.n_forced_refreshes == n_before + 1
        if port:
            _assert_trees_equal(eng.pull("a"), served)


def test_client_ahead_of_replica_forces_refresh():
    for port, rt, eng, rs in _pair(replicas=dict(n_replicas=1,
                                                 publish_interval=1000)):
        rep = rs.replicas[0]
        _drive(eng, 2, port)
        rs.refresh()
        _drive(eng, 2, port)
        ahead = eng.pull("a", since_version=0)
        d = rep.pull("a", since_version=ahead.version)
        assert rep.stats.n_forced_refreshes >= 1
        assert not d.full and d.block_ids.size == 0
        np.testing.assert_array_equal(d.version.versions,
                                      ahead.version.versions)


# ------------------------------------------------------ degraded serving
def test_quarantined_lane_serves_last_good_degraded():
    """Direct pulls die with the lane; the replica keeps serving the
    victim's rows from its last-good snapshot (the healthy lanes' rows
    stay current), flagged degraded, the same every time; refresh skips
    the dead lane.  The served trees equal the reference's."""
    served = []
    for port, rt, eng, rs in _pair(replicas=dict(n_replicas=1),
                                   fault_injector=True):
        rep = rs.replicas[0]
        victim = rt.shard_ids[-1]
        _drive(eng, 2, port)
        rs.refresh()
        eng.fault_injector.kill_shard(victim, at=1)
        with pytest.raises(JQuarantined if not port
                           else EngineQuarantinedError):
            _drive(eng, 8, port)
        assert eng.shard_health()[victim] == QUARANTINED
        hosted = [j for j in TREES
                  if victim in rt.splan.job_layout(j).shard_ids]
        assert hosted, "placement left no job on the victim shard"
        frozen = rep._snaps[victim]
        trees = {}
        for j in hosted:
            with pytest.raises(JQuarantined if not port
                               else EngineQuarantinedError):
                eng.pull(j)
            trees[j] = rep.pull(j)
            assert victim in rep.degraded_lanes
            again = rep.pull(j)
            for k in again:
                np.testing.assert_array_equal(_np(again[k]),
                                              _np(trees[j][k]))
        assert rep._snaps[victim] is frozen
        assert rep.stats.n_degraded_serves >= len(hosted)
        assert victim not in rs.refresh()
        served.append((trees, _read_stats(rs)))
    (t_trees, t_stats), (j_trees, j_stats) = served
    assert t_stats == j_stats
    for j in t_trees:
        _assert_trees_close(t_trees[j], j_trees[j])


def test_quarantined_lane_without_snapshot_raises():
    for port, rt, eng, _ in _pair(fault_injector=True):
        victim = rt.shard_ids[-1]
        eng.fault_injector.kill_shard(victim, at=1)
        with pytest.raises(JQuarantined if not port
                           else EngineQuarantinedError):
            _drive(eng, 8, port)
        rs = (ReplicaSet if port else JReplicaSet)(eng, n_replicas=1)
        hosted = [j for j in TREES
                  if victim in rt.splan.job_layout(j).shard_ids]
        with pytest.raises(JQuarantined if not port
                           else EngineQuarantinedError) as ei:
            rs.pull(hosted[0])
        assert ei.value.shard_id == victim


# ------------------------------------------------------------------ stats
def test_debug_stats_surfaces_read_tier():
    outs = []
    for port, rt, eng, _ in _pair():
        assert rt.debug_stats()["replicas"] is None
        rs = (ReplicaSet if port else JReplicaSet)(
            eng, n_replicas=2, max_staleness_ticks=8)
        _drive(eng, 2, port)
        rs.refresh()
        rs.pull("a")
        rs.pull_batch([("b", 0)])
        out = rt.debug_stats()["replicas"]
        assert out["n_replicas"] == 2 and out["max_staleness_ticks"] == 8
        assert out["replica_0"]["n_pulls"] == 1
        assert out["replica_0"]["bytes_served"] > 0
        assert out["replica_1"]["n_batches"] == 1
        outs.append(_read_stats(rs))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("max_staleness_ticks", [None, 1])
def test_staleness_bound_over_shard_lanes(max_staleness_ticks):
    """The staleness bound is per lane tick counter: past it a serve
    forces a refresh, without it the held snapshots keep serving."""
    stats = []
    for port, rt, eng, rs in _pair(replicas=dict(
            n_replicas=1, publish_interval=1000,
            max_staleness_ticks=max_staleness_ticks)):
        rep = rs.replicas[0]
        _drive(eng, 1, port)
        rs.refresh()
        held = rep.pull("a")
        _drive(eng, 4, port)
        served = rep.pull("a")
        bounded = max_staleness_ticks is not None
        assert (rep.stats.n_forced_refreshes == 1) == bounded
        if port:
            _assert_trees_equal(served, eng.pull("a") if bounded else held)
        stats.append(_read_stats(rs))
    assert stats[0] == stats[1]
