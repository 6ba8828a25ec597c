"""The read tier (``repro_torch.ps.replica``) and the engine's versioned
pulls, held against the reference's on the same jobs and the same pushes.

Both packages host three jobs (weights made with numpy, carried across
with ``tree_from_numpy``) in one flat service, and identical numpy
gradient trees go in through ``submit_push``.  The reference runs eagerly
(``jit=False``).  Version vectors, block ids, flags and byte counts are
compared field for field; payloads within the 1-ulp budget of
``tests/test_torch_service.py`` where Adam ran, and bit for bit inside the
port where only copies ran (a replica's serve against the engine's own
pull).  The cases mirror those of ``tests/test_replica.py`` that touch the
flat engine; ``tests/test_torch_sharded_read.py`` holds the sharded ones.

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
from repro.ps.faults import FaultInjector as JInjector
from repro.ps.replica import ReplicaSet as JReplicaSet
from repro.ps.service_runtime import ServiceRuntime as JRuntime
from repro_torch.core import ParameterService as TService
from repro_torch.ps.engine import PullDiff
from repro_torch.ps.faults import (QUARANTINED, EngineQuarantinedError,
                                   FaultInjector)
from repro_torch.ps.replica import ParameterReplica, ReadStats, ReplicaSet
from repro_torch.ps.runtime import tree_from_numpy
from repro_torch.ps.service_runtime import ServiceRuntime as TRuntime

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


TREES = {"a": _tree(0, (48, 16, 32)), "b": _tree(1, (32, 16)),
         "c": _tree(2, (48, 16))}
LATE = _tree(3, (40,))


def _no_loss(params, batch):
    raise AssertionError("pushes are given; no loss is taken")


def _add(rts, jid, tree):
    jrt, trt = rts
    nbytes = sum(4 * v.size for v in tree.values())
    kw = dict(lr=0.05, required_servers=1, agg_throughput=nbytes / 0.2)
    if jrt is not None:
        jrt.add_job(jid, jax.tree_util.tree_map(jnp.asarray, tree),
                    _no_loss, **kw)
    trt.add_job(jid, tree_from_numpy(tree, "cpu"), _no_loss, **kw)


def _both(j_injector=None, **engine_opts):
    """(reference, port) runtimes and engines hosting TREES; the port's
    ``fault_injector`` and the reference's ``j_injector`` are twins."""
    engine_opts.setdefault("max_staleness", 0)
    jrt = JRuntime(JService(total_budget=16, n_clusters=1, plan_pad_to=16),
                   jit=False)
    trt = TRuntime(TService(total_budget=16, n_clusters=1, plan_pad_to=16),
                   device="cpu")
    jeng = jrt.attach_engine(jit=False, **dict(engine_opts,
                                               fault_injector=j_injector))
    teng = trt.attach_engine(**engine_opts)
    for jid, t in TREES.items():
        _add((jrt, trt), jid, t)
    return (jrt, trt), (jeng, teng)


def _port(**engine_opts):
    engine_opts.setdefault("max_staleness", 0)
    trt = TRuntime(TService(total_budget=16, n_clusters=1, plan_pad_to=16),
                   device="cpu")
    teng = trt.attach_engine(**engine_opts)
    for jid, t in TREES.items():
        _add((None, trt), jid, t)
    return trt, teng


class Pushes:
    """One numpy gradient tree per (round, job), fed to every engine."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)

    def drive(self, engines, n, jobs=tuple(TREES)):
        for _ in range(n):
            for j in jobs:
                tree = TREES[j] if j in TREES else LATE
                g = {k: self.rng.standard_normal(v.shape).astype(np.float32)
                     for k, v in tree.items()}
                for eng in engines:
                    if hasattr(eng, "_jit"):  # the reference
                        eng.submit_push(j, jax.tree_util.tree_map(
                            jnp.asarray, g))
                    else:
                        eng.submit_push(j, tree_from_numpy(g, "cpu"))
        for eng in engines:
            eng.drain()


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _assert_trees_close(t, j):
    assert t.keys() == set(j.keys())
    for k in t:
        assert ulp_diff(_np(t[k]), _np(j[k])) <= ULP_BUDGET, k


def _assert_diffs_match(td: PullDiff, jd):
    """Field for field; the payload within the ulp budget."""
    assert td.job_id == jd.job_id and td.full == jd.full
    assert td.block == jd.block
    assert td.version.epoch == jd.version.epoch
    np.testing.assert_array_equal(td.version.versions, jd.version.versions)
    np.testing.assert_array_equal(td.block_ids, jd.block_ids)
    assert (td.bytes_wire, td.bytes_full) == (jd.bytes_wire, jd.bytes_full)
    assert tuple(td.data.shape) == tuple(jd.data.shape)
    assert ulp_diff(_np(td.data), _np(jd.data)) <= ULP_BUDGET


# ------------------------------------------------------------- construction
def test_replica_set_validates_arguments():
    trt, eng = _port()
    with pytest.raises(ValueError, match="n_replicas"):
        ReplicaSet(eng, n_replicas=0)
    with pytest.raises(ValueError, match="publish_interval"):
        ReplicaSet(eng, publish_interval=0)
    with pytest.raises(ValueError, match="max_staleness_ticks"):
        ReplicaSet(eng, max_staleness_ticks=-1)
    rs = ReplicaSet(eng, n_replicas=3)
    assert len(rs.replicas) == 3
    assert all(isinstance(r, ParameterReplica) for r in rs.replicas)
    with pytest.raises(ValueError, match="already has a ReplicaSet"):
        ReplicaSet(eng)

    class ShardedLike:  # a sharded engine: its lanes are its shard ids
        _lanes = {}
        plan = None

    sharded = ReplicaSet(ShardedLike())
    assert sharded._sharded and sharded._lane_keys() == []


# ---------------------------------------------- engine versioned pulls
def test_engine_versioned_pulls_match_reference_through_ticks():
    (jrt, trt), (jeng, teng) = _both()
    pushes = Pushes(0)
    held = {j: (teng.pull(j, since_version=0), jeng.pull(j, since_version=0))
            for j in TREES}
    for td, jd in held.values():
        _assert_diffs_match(td, jd)
    packed = {j: td.data for j, (td, _) in held.items()}
    for round_jobs in (("a",), ("a", "b"), ("c",), ()):
        pushes.drive([jeng, teng], 1, round_jobs)
        for j in TREES:
            td = teng.pull(j, since_version=held[j][0].version)
            jd = jeng.pull(j, since_version=held[j][1].version)
            _assert_diffs_match(td, jd)
            assert td.full is False
            assert (td.block_ids.size > 0) == (j in round_jobs)
            packed[j] = td.apply(packed[j])
            held[j] = (td, jd)
    assert teng.stats.n_diff_pulls == jeng.stats.n_diff_pulls > 0
    assert teng.stats.n_full_pulls == jeng.stats.n_full_pulls
    assert teng.stats.pull_bytes_wire == jeng.stats.pull_bytes_wire
    assert teng.stats.pull_bytes_full == jeng.stats.pull_bytes_full
    for j in TREES:  # the patched vectors equal full pulls, bit for bit
        assert torch.equal(packed[j], teng.pull(j, since_version=0).data)


def test_rollback_restamps_versions_as_the_reference_does():
    inj, jinj = FaultInjector(seed=0), JInjector(seed=0)
    inj.fail_apply(at=3)
    jinj.fail_apply(at=3)
    (jrt, trt), (jeng, teng) = _both(snapshot_interval=2,
                                     fault_injector=inj, j_injector=jinj)
    v0 = {j: (teng.pull(j, since_version=0), jeng.pull(j, since_version=0))
          for j in TREES}
    Pushes(1).drive([jeng, teng], 4)
    assert teng.stats.n_rollbacks == jeng.stats.n_rollbacks == 1
    assert teng._version_clock == jeng._version_clock
    np.testing.assert_array_equal(teng._versions_array(),
                                  jeng._versions_array())
    for j, (td0, jd0) in v0.items():
        _assert_diffs_match(teng.pull(j, since_version=td0.version),
                            jeng.pull(j, since_version=jd0.version))


def test_pull_diff_apply_leaves_the_clients_vector_alone():
    trt, eng = _port()
    d0 = eng.pull("a", since_version=0)
    prev = d0.data.clone()
    Pushes(2).drive([eng], 1, ("a",))
    d1 = eng.pull("a", since_version=d0.version)
    out = d1.apply(d0.data)
    assert torch.equal(d0.data, prev) and out is not d0.data
    assert torch.equal(out, eng.pull("a", since_version=0).data)


# ------------------------------------------------------- publish + parity
def test_tree_pull_parity_after_refresh():
    (jrt, trt), (jeng, teng) = _both()
    trs = ReplicaSet(teng, n_replicas=2)
    jrs = JReplicaSet(jeng, n_replicas=2)
    Pushes(3).drive([jeng, teng], 4)
    assert trs.n_publishes == jrs.n_publishes > 0
    trs.refresh()
    jrs.refresh()
    for j in TREES:
        served = trs.pull(j)
        _assert_trees_equal(teng.pull(j), served)
        _assert_trees_close(served, jrs.pull(j))
    for rep in trs.replicas:
        assert rep.stats.n_snapshots_seen > 0


def test_versioned_pull_and_diff_chain_parity():
    (jrt, trt), (jeng, teng) = _both()
    trs, jrs = ReplicaSet(teng, n_replicas=1), JReplicaSet(jeng, n_replicas=1)
    pushes = Pushes(4)
    pushes.drive([jeng, teng], 3)
    trs.refresh()
    jrs.refresh()
    trep, jrep = trs.replicas[0], jrs.replicas[0]
    for j in TREES:
        td, jd = trep.pull(j, since_version=0), jrep.pull(j, since_version=0)
        _assert_diffs_match(td, jd)
        assert torch.equal(td.data, teng.pull(j, since_version=0).data)
    pushes.drive([jeng, teng], 2, ("a",))
    trs.refresh()
    jrs.refresh()
    held = (trep.pull("a", since_version=0), jrep.pull("a", since_version=0))
    base = (trep.pull("b", since_version=0), jrep.pull("b", since_version=0))
    d1 = (trep.pull("b", since_version=base[0].version),
          jrep.pull("b", since_version=base[1].version))
    _assert_diffs_match(*d1)
    assert not d1[0].full and d1[0].block_ids.size == 0  # "b" never moved
    d2 = (trep.pull("a", since_version=held[0].version),
          jrep.pull("a", since_version=held[1].version))
    _assert_diffs_match(*d2)
    pushes.drive([jeng, teng], 1, ("a",))
    trs.refresh()
    jrs.refresh()
    d3 = (trep.pull("a", since_version=d2[0].version),
          jrep.pull("a", since_version=d2[1].version))
    _assert_diffs_match(*d3)
    assert not d3[0].full and d3[0].block_ids.size > 0
    assert d3[0].bytes_wire == 4 * d3[0].block_ids.size * d3[0].block
    patched = d3[0].apply(d2[0].apply(held[0].data))
    assert torch.equal(patched, teng.pull("a", since_version=0).data)


def test_pull_batch_matches_sequential_pulls():
    (jrt, trt), (jeng, teng) = _both()
    trs, jrs = ReplicaSet(teng, n_replicas=1), JReplicaSet(jeng, n_replicas=1)
    pushes = Pushes(5)
    pushes.drive([jeng, teng], 3)
    trs.refresh()
    jrs.refresh()
    rep = trs.replicas[0]
    boot = rep.pull_batch([(j, 0) for j in TREES])
    jboot = jrs.replicas[0].pull_batch([(j, 0) for j in TREES])
    assert [d.job_id for d in boot] == list(TREES)
    for d, jd in zip(boot, jboot):
        _assert_diffs_match(d, jd)
        assert d.full
        assert torch.equal(d.data,
                           teng.pull(d.job_id, since_version=0).data)
    vec = {d.job_id: d.version for d in boot}
    pushes.drive([jeng, teng], 2, ("a",))  # only "a" moves
    trs.refresh()
    batch = rep.pull_batch([(j, vec[j]) for j in TREES])
    for d in batch:
        want = rep.pull(d.job_id, since_version=vec[d.job_id])
        assert d.full == want.full
        np.testing.assert_array_equal(d.block_ids, want.block_ids)
        assert torch.equal(d.data, want.data)
        assert d.bytes_wire == want.bytes_wire
    moved = {d.job_id: d.block_ids.size for d in batch}
    assert moved["a"] > 0 and moved["b"] == 0 and moved["c"] == 0
    assert rep.stats.n_batches == 2
    assert rep.stats.n_batch_jobs == 2 * len(TREES)


# ------------------------------------------------------------ epoch fence
def test_replan_fences_snapshots_and_resubscribes():
    (jrt, trt), (jeng, teng) = _both()
    trs, jrs = ReplicaSet(teng, n_replicas=2), JReplicaSet(jeng, n_replicas=2)
    pushes = Pushes(6)
    pushes.drive([jeng, teng], 3)
    trs.refresh()
    jrs.refresh()
    before = trs.epoch
    _add((jrt, trt), "late", LATE)  # a replan: the epoch moves
    assert trs.epoch == jrs.epoch > before
    # ticks at the new epoch resubscribe as they apply: the epoch check
    # in on_tick overrides publish_interval
    pushes.drive([jeng, teng], 2, tuple(TREES) + ("late",))
    assert all(rep._snaps[k].epoch == trs.epoch
               for rep in trs.replicas for k in rep._snaps)
    trs.refresh()
    jrs.refresh()
    for j in tuple(TREES) + ("late",):  # bit-exact on the new geometry
        served = trs.pull(j)
        _assert_trees_equal(teng.pull(j), served)
        _assert_trees_close(served, jrs.pull(j))


def test_stale_epoch_pull_forces_refresh_not_stale_serve():
    (jrt, trt), (jeng, teng) = _both()
    trs = ReplicaSet(teng, n_replicas=1, publish_interval=1000)
    rep = trs.replicas[0]
    Pushes(7).drive([teng], 2)
    trs.refresh()
    rep.pull("a")
    _add((None, trt), "late", LATE)
    # no tick has run at the new epoch: the held snapshot is of the old
    # geometry, so the fence must force a refresh, not serve it
    n_before = rep.stats.n_forced_refreshes
    _assert_trees_equal(teng.pull("a"), rep.pull("a"))
    assert rep.stats.n_forced_refreshes == n_before + 1


# -------------------------------------------------------- staleness bound
def test_staleness_bound_forces_refresh():
    trt, eng = _port()
    rs = ReplicaSet(eng, n_replicas=1, publish_interval=1000,
                    max_staleness_ticks=1)
    rep = rs.replicas[0]
    pushes = Pushes(8)
    pushes.drive([eng], 1)
    rs.refresh()
    pushes.drive([eng], 4)  # past the bound, nothing republished
    n_before = rep.stats.n_forced_refreshes
    _assert_trees_equal(eng.pull("a"), rep.pull("a"))
    assert rep.stats.n_forced_refreshes == n_before + 1
    assert max(rep.stats.staleness_hist) <= 1


def test_unbounded_staleness_serves_old_snapshot():
    trt, eng = _port()
    rs = ReplicaSet(eng, n_replicas=1, publish_interval=1000,
                    max_staleness_ticks=None)
    rep = rs.replicas[0]
    pushes = Pushes(9)
    pushes.drive([eng], 1)
    rs.refresh()
    held = {j: rep.pull(j) for j in TREES}
    pushes.drive([eng], 4)
    for j in TREES:  # no bound: the old snapshot keeps serving
        _assert_trees_equal(held[j], rep.pull(j))
    assert rep.stats.n_forced_refreshes == 0
    assert max(rep.stats.staleness_hist) > 1


def test_client_ahead_of_replica_forces_refresh():
    trt, eng = _port()
    rs = ReplicaSet(eng, n_replicas=1, publish_interval=1000)
    rep = rs.replicas[0]
    pushes = Pushes(10)
    pushes.drive([eng], 2)
    rs.refresh()
    pushes.drive([eng], 2)
    # the client bootstrapped off the ENGINE: its vector is ahead of the
    # replica's snapshot, and a naive diff would report "no change"
    ahead = eng.pull("a", since_version=0)
    d = rep.pull("a", since_version=ahead.version)
    assert rep.stats.n_forced_refreshes >= 1
    assert not d.full and d.block_ids.size == 0
    np.testing.assert_array_equal(d.version.versions,
                                  ahead.version.versions)


# ------------------------------------------------------ degraded serving
def test_quarantined_engine_serves_last_good_degraded():
    inj, jinj = FaultInjector(seed=0), JInjector(seed=0)
    (jrt, trt), (jeng, teng) = _both(fault_injector=inj, j_injector=jinj)
    trs, jrs = ReplicaSet(teng, n_replicas=1), JReplicaSet(jeng, n_replicas=1)
    pushes = Pushes(11)
    pushes.drive([jeng, teng], 2)
    trs.refresh()
    jrs.refresh()
    inj.fail_apply(at=1, times=5)
    jinj.fail_apply(at=1, times=5)
    for eng in (teng, jeng):
        with pytest.raises(Exception) as ei:
            pushes.drive([eng], 2)
        assert type(ei.value).__name__ == "EngineQuarantinedError"
    assert teng.health == QUARANTINED
    rep = trs.replicas[0]
    frozen = rep._snaps[None]
    for j in TREES:
        # direct engine pulls die with the engine; the replica serves its
        # last-good snapshot, flagged degraded
        with pytest.raises(EngineQuarantinedError):
            teng.pull(j)
        served = rep.pull(j)
        assert rep.degraded_lanes == (None,)
        _assert_trees_equal(served, rep.pull(j))  # deterministic
        _assert_trees_close(served, jrs.replicas[0].pull(j))
    assert rep._snaps[None] is frozen  # nothing republished
    assert rep.stats.n_degraded_serves >= len(TREES)
    assert trs.refresh() == []  # refresh skips the dead lane


def test_quarantined_engine_without_snapshot_raises():
    inj = FaultInjector(seed=0)
    trt, eng = _port(fault_injector=inj)
    inj.fail_apply(at=1, times=5)
    with pytest.raises(EngineQuarantinedError):
        Pushes(12).drive([eng], 2)
    # subscribing AFTER the engine died: no last-good snapshot exists
    rs = ReplicaSet(eng, n_replicas=1)
    with pytest.raises(EngineQuarantinedError):
        rs.pull("a")


# ------------------------------------------------------- publish interval
def test_publish_interval_batches_publishes():
    trt, eng = _port()
    every = ReplicaSet(eng, n_replicas=1, publish_interval=1)
    Pushes(13).drive([eng], 6)
    trt2, eng2 = _port()
    sparse = ReplicaSet(eng2, n_replicas=1, publish_interval=4)
    Pushes(13).drive([eng2], 6)
    assert 0 < sparse.n_publishes < every.n_publishes


def test_publish_reuses_rollback_snapshot_copy():
    trt, eng = _port(snapshot_interval=2)
    rs = ReplicaSet(eng, n_replicas=2)
    Pushes(14).drive([eng], 6)
    assert 0 < rs.n_reused_snapshot_copies <= rs.n_publishes


def test_snapshots_are_shared_not_copied_per_replica():
    trt, eng = _port()
    rs = ReplicaSet(eng, n_replicas=4)
    Pushes(15).drive([eng], 2)
    rs.refresh()
    snaps = [rep._snaps[None] for rep in rs.replicas]
    assert all(s is snaps[0] for s in snaps[1:])


# ------------------------------------------------------------- aliasing
@pytest.mark.parametrize("snapshot_interval", [1, 3, 0])
def test_published_snapshot_unchanged_by_later_in_place_ticks(
        snapshot_interval):
    """The tick's kernel writes the live state in place: a published
    ``flat`` (the rollback anchor's clone, or the hub's own) and every
    served payload must not change under later ticks or rollbacks."""
    inj = FaultInjector(seed=0)
    trt, eng = _port(snapshot_interval=snapshot_interval,
                     fault_injector=inj)
    rs = ReplicaSet(eng, n_replicas=2)
    pushes = Pushes(16)
    pushes.drive([eng], 2)
    snap = rs.replicas[0]._snaps[None]
    kept = snap.flat.clone()
    assert snap.flat.data_ptr() != trt.state["flat"].data_ptr()
    served = rs.pull("a")
    served_kept = {k: v.clone() for k, v in served.items()}
    diff = rs.pull("b", since_version=0)
    diff_kept = diff.data.clone()
    if snapshot_interval:
        inj.fail_apply(at=2)  # a rollback installs a clone of the anchor
    pushes.drive([eng], 4)
    if snapshot_interval:
        assert eng.stats.n_rollbacks == 1
    trt.state["flat"].add_(1.0)  # and any later in-place write
    assert torch.equal(snap.flat, kept)
    _assert_trees_equal(served, served_kept)
    assert torch.equal(diff.data, diff_kept)
    for rep in rs.replicas:
        assert rep._snaps[None].flat.data_ptr() != \
            trt.state["flat"].data_ptr()


# ------------------------------------------------------------------ stats
def test_debug_stats_surfaces_read_tier():
    trt, eng = _port()
    assert trt.debug_stats()["replicas"] is None
    rs = ReplicaSet(eng, n_replicas=2, max_staleness_ticks=8)
    Pushes(17).drive([eng], 2)
    rs.refresh()
    rs.pull("a")
    rs.pull_batch([("b", 0)])
    out = trt.debug_stats()["replicas"]
    assert out["n_replicas"] == 2
    assert out["max_staleness_ticks"] == 8
    assert out["n_publishes"] == rs.n_publishes
    r0 = out["replica_0"]
    assert set(r0) >= {"n_pulls", "n_batches", "bytes_served",
                       "staleness_hist", "pulls_per_sec"}
    assert r0["n_pulls"] == 1 and r0["bytes_served"] > 0
    assert out["replica_1"]["n_batches"] == 1
    assert isinstance(ReadStats().pulls_per_sec, float)


def test_round_robin_spreads_load():
    trt, eng = _port()
    rs = ReplicaSet(eng, n_replicas=3)
    Pushes(18).drive([eng], 2)
    rs.refresh()
    for _ in range(6):
        rs.pull("a")
    assert [rep.stats.n_pulls for rep in rs.replicas] == [2, 2, 2]
