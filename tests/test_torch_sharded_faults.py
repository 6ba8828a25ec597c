"""Fault tolerance of the sharded service: lane rollback and replay, the
fleet tick's fall-back to per-shard launches, quarantine, fault hooks and
``recover_shard``, held against the reference's on the same inputs.

Both packages host three jobs (numpy-seeded weights carried across by
``tree_from_numpy``) on three shard spaces, each with its own
``FaultInjector`` armed the same way (the port's is a copy, so seeded
schedules agree).  The reference runs eagerly (``jit=False``): states and
parameters agree within the 1-ulp budget across packages, and counters,
health and recovery reports are equal.  Inside the port a recovered
trajectory is held bit for bit against a fault-free twin: rollback
replays the identical (piece, count) sequence, so any difference is a
recovery bug.  The cases mirror the sharded ones of
``tests/test_faults.py``; the port's own pins follow them.

One contract differs by design: K1 writes the fleet arena in place, so a
lane that fails with ``snapshot_interval=0`` may be half-written and is
quarantined, where the reference's eager engine re-raises; those cases
are held against the reference's jitted engine, which quarantines too.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ParameterService as JService
from repro.ps.autoscaler import AutoscalerConfig as JConfig
from repro.ps.autoscaler import ElasticScaler as JScaler
from repro.ps.faults import EngineQuarantinedError as JQuarantined
from repro.ps.faults import FaultInjector as JInjector
from repro.ps.service_runtime import ShardedServiceRuntime as JSharded
from repro_torch.core import ParameterService as TService
from repro_torch.ps.autoscaler import AutoscalerConfig, ElasticScaler
from repro_torch.ps.faults import (
    HEALTHY,
    QUARANTINED,
    EngineQuarantinedError,
    FaultInjector,
    InjectedFault,
)
from repro_torch.ps.runtime import tree_from_numpy
from repro_torch.ps.service_runtime import RecoveryReport
from repro_torch.ps.service_runtime import ShardedServiceRuntime as TSharded

ULP_BUDGET = 1


def ulp_diff(a, b) -> int:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


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


def _batch(j, port):
    if port:
        return {"target": tree_from_numpy(TARGETS[j], "cpu")}
    return {"target": jax.tree_util.tree_map(jnp.asarray, TARGETS[j])}


def _build(port, n_shards=3, jit=False, **engine):
    """A sharded runtime of one package hosting TREES on ``n_shards``
    shard spaces, with an engine (``max_staleness=0`` unless given)."""
    engine.setdefault("max_staleness", 0)
    if port:
        svc = TService(total_budget=16, n_clusters=1, plan_pad_to=16)
        rt = TSharded(svc, device="cpu")
        eng = rt.attach_engine(**engine)
    else:
        svc = JService(total_budget=16, n_clusters=1, plan_pad_to=16)
        rt = JSharded(svc, jit=jit)
        eng = rt.attach_engine(jit=jit, **engine)
    for jid, t in TREES.items():
        params = (tree_from_numpy(t, "cpu") if port
                  else jax.tree_util.tree_map(jnp.asarray, t))
        rt.add_job(jid, params, _loss_torch if port else _loss_jax, lr=0.05,
                   required_servers=1,
                   agg_throughput=sum(4 * v.size for v in t.values()) / 0.2)
    if n_shards > 1:
        svc.scale_out(n_shards - 1)
    return rt, eng


def _pair(arm=None, n_shards=3, jit=False, **engine):
    """[(port, rt, eng, injector), (reference, ...)], each engine with
    its package's FaultInjector armed by ``arm(inj, shard_ids)``."""
    out = []
    for port in (True, False):
        inj = FaultInjector() if port else JInjector()
        rt, eng = _build(port, n_shards, jit=jit, fault_injector=inj,
                         **engine)
        if arm is not None:
            arm(inj, rt.shard_ids)
        out.append((port, rt, eng, inj))
    assert out[0][1].shard_ids == out[1][1].shard_ids
    return out


def _drive(eng, n, port, jobs=TREES):
    for _ in range(n):
        for j in jobs:
            eng.step(j, _batch(j, port))
    eng.drain()


def _quarantined(port):
    return EngineQuarantinedError if port else JQuarantined


def _assert_bits(rt_a, rt_b):
    """Two port runtimes, bit for bit: arena and counts."""
    assert rt_a.shard_ids == rt_b.shard_ids
    for k in ("flat", "mu", "nu"):
        assert torch.equal(rt_a.arena[k], rt_b.arena[k]), k
    assert rt_a.counts == rt_b.counts


def _assert_ref(trt, jrt, jobs=TREES):
    """The port against the reference: shard map, every shard state and
    parameter within the budget, equal counts."""
    assert trt.shard_ids == jrt.shard_ids
    for sid in jrt.shard_ids:
        for k in ("flat", "mu", "nu"):
            assert ulp_diff(trt.states[sid][k].numpy(),
                            np.asarray(jrt.states[sid][k])) <= ULP_BUDGET
    for j in jobs:
        tp, jp = trt.params_of(j), jrt.params_of(j)
        for k in jp:
            assert ulp_diff(tp[k].numpy(), np.asarray(jp[k])) <= ULP_BUDGET
        assert trt.counts[j] == int(jrt.counts[j])


def _assert_stats(teng, jeng):
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    assert teng.shard_health() == jeng.shard_health()
    assert ({s: dataclasses.asdict(st) for s, st in teng.shard_stats().items()}
            == {s: dataclasses.asdict(st)
                for s, st in jeng.shard_stats().items()})


def _kill_last(inj, sids, at=2):
    inj.kill_shard(sids[-1], at=at)


# ------------------------------------------------ transient faults, fall-back
def test_transient_fault_falls_back_and_replays_bit_exact():
    """A transient fault inside a fused fleet tick: every participant
    rolls back and ticks alone, and the recovered trajectory equals a
    fault-free twin bit for bit and the reference's within the budget,
    counters included."""
    (_, trt, teng, tinj), (_, jrt, jeng, jinj) = _pair(
        lambda inj, sids: inj.fail_apply(sids[-1], at=2),
        snapshot_interval=4)
    twin, tweng = _build(True, snapshot_interval=4)
    _drive(teng, 8, True)
    _drive(jeng, 8, False)
    _drive(tweng, 8, True)
    assert tinj.n_fired == jinj.n_fired == 1
    assert teng.stats.n_fleet_fallbacks >= 1
    assert teng.stats.n_rollbacks >= 1 and teng.stats.n_quarantines == 0
    assert set(teng.shard_health().values()) == {HEALTHY}
    _assert_bits(trt, twin)
    _assert_ref(trt, jrt)
    _assert_stats(teng, jeng)


@pytest.mark.parametrize("seed", range(4))
def test_chaos_seeded_schedules_recover_bit_exact(seed):
    """Seeded random transient schedules (the same in both packages)
    recover to the fault-free trajectory at staleness 0."""
    (_, trt, teng, tinj), (_, jrt, jeng, jinj) = _pair(
        lambda inj, sids: inj.random_apply_faults(3, sids, max_at=15),
        snapshot_interval=4, max_apply_retries=3)
    assert [(r.shard_id, r.at) for r in tinj.rules] == \
        [(r.shard_id, r.at) for r in jinj.rules]
    twin, tweng = _build(True, snapshot_interval=4)
    _drive(teng, 10, True)
    _drive(jeng, 10, False)
    _drive(tweng, 10, True)
    assert teng.stats.n_quarantines == 0
    if tinj.n_fired:
        assert teng.stats.n_rollbacks >= 1
    _assert_bits(trt, twin)
    _assert_ref(trt, jrt)
    _assert_stats(teng, jeng)


# ------------------------------------------------------------- quarantine
def test_quarantine_isolates_one_lane_neighbors_tick_on():
    """A killed shard quarantines after its retries; jobs off it keep
    training, a drain blocked on it raises its error, and a drain scoped
    to the untouched jobs goes through; both packages alike."""
    sides = _pair(_kill_last)
    victim = sides[0][1].shard_ids[-1]
    for port, rt, eng, _ in sides:
        with pytest.raises(_quarantined(port)) as ei:
            _drive(eng, 12, port)
        assert ei.value.shard_id == victim
        assert eng.quarantined_shards() == (victim,)
        untouched = [j for j in TREES
                     if victim not in rt.splan.job_layout(j).shard_ids]
        assert untouched, "placement left no job off the victim shard"
        before = eng.stats.n_applied
        for _ in range(4):
            for j in untouched:
                eng.step(j, _batch(j, port))
        assert eng.stats.n_applied > before
        with pytest.raises(_quarantined(port)) as de:
            eng.drain()
        assert de.value.shard_id == victim
        eng.drain(only=untouched)
    (_, trt, teng, _), (_, jrt, jeng, _) = sides
    err = teng._lanes[victim].quarantine_error
    assert isinstance(err.original, InjectedFault)
    assert err.tick == jeng._lanes[victim].quarantine_error.tick
    assert err.job_ids == jeng._lanes[victim].quarantine_error.job_ids
    _assert_ref(trt, jrt)
    _assert_stats(teng, jeng)
    health = trt.debug_stats()["shards"]
    assert health[victim]["health"] == QUARANTINED
    assert trt.debug_stats()["faults"]["by_kind"]["fail_apply"] >= 2


def test_versioned_pull_against_quarantined_lane_raises():
    """Direct pulls, versioned or not, die with a hosting lane; jobs off
    the dead shard keep serving diffs."""
    for port, rt, eng, _ in _pair(_kill_last):
        victim = rt.shard_ids[-1]
        with pytest.raises(_quarantined(port)):
            _drive(eng, 12, port)
        hosted = [j for j in TREES
                  if victim in rt.splan.job_layout(j).shard_ids]
        spared = [j for j in TREES if j not in hosted]
        assert hosted and spared, "placement left nothing to compare"
        with pytest.raises(_quarantined(port)) as ei:
            eng.pull(hosted[0], since_version=0)
        assert ei.value.shard_id == victim
        with pytest.raises(_quarantined(port)):
            eng.pull(hosted[0])
        d = eng.pull(spared[0], since_version=0)
        assert d.full and d.bytes_full > 0


def test_push_future_result_raises_the_blocking_quarantine():
    """A push whose piece sits on a quarantined lane: ``result()`` raises
    that lane's error, with or without a timeout."""
    for port, rt, eng, _ in _pair(_kill_last, max_staleness=4):
        victim = rt.shard_ids[-1]
        j = next(j for j in TREES
                 if victim in rt.splan.job_layout(j).shard_ids)
        futs = [eng.step(j, _batch(j, port))["future"] for _ in range(3)]
        with pytest.raises(_quarantined(port)):
            futs[-1].result()
        assert eng.quarantined_shards() == (victim,)
        with pytest.raises(_quarantined(port)):
            futs[-1].result(timeout=0.05)
        assert not futs[-1].done()


# -------------------------------------------------------- push-piece faults
def test_dropped_piece_times_out_push_future():
    for port, rt, eng, inj in _pair(max_staleness=8):
        inj.drop_push(job_id="a", at=1)
        grads = (tree_from_numpy(TARGETS["a"], "cpu") if port else
                 jax.tree_util.tree_map(jnp.asarray, TARGETS["a"]))
        fut = eng.submit_push("a", grads)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            fut.result(timeout=0.2)
        assert time.monotonic() - t0 < 5.0
        assert not fut.done()
        assert inj.fire_counts() == {"drop_push": 1}


def test_duplicate_piece_applies_untracked():
    """An at-least-once duplicate applies as an extra untracked piece, in
    both packages alike."""
    sides = _pair(max_staleness=8)
    for port, rt, eng, inj in sides:
        inj.duplicate_push(job_id="a", at=1)
        grads = (tree_from_numpy(TARGETS["a"], "cpu") if port else
                 jax.tree_util.tree_map(jnp.asarray, TARGETS["a"]))
        assert eng.submit_push("a", grads).result() == 1
        eng.drain()
        assert not any(q for lane in eng._lanes.values()
                       for q in lane.queues.values())
    (_, trt, teng, _), (_, jrt, jeng, _) = sides
    _assert_ref(trt, jrt)
    _assert_stats(teng, jeng)


# ---------------------------------------------------- shard-loss recovery
def test_recover_shard_rehosts_and_training_continues():
    """A killed shard quarantines, ``recover_shard`` re-hosts its
    segments from the last-good snapshot, and the fleet trains on; the
    report, the states and the counters equal the reference's."""
    sides = _pair(_kill_last, snapshot_interval=4)
    reports = []
    for port, rt, eng, _ in sides:
        victim = rt.shard_ids[-1]
        with pytest.raises(_quarantined(port)):
            _drive(eng, 10, port)
        n_before = rt.n_shards
        reports.append(rt.recover_shard(victim))
        assert rt.n_shards == n_before - 1
        assert victim not in rt.shard_ids and victim not in eng._lanes
    (_, trt, teng, _), (_, jrt, jeng, _) = sides
    report = reports[0]
    assert isinstance(report, RecoveryReport)
    assert dataclasses.asdict(report) == dataclasses.asdict(reports[1])
    assert report.seeded_from == "snapshot" and report.moved_tasks >= 1
    assert report.rehosted_elements > 0
    assert (report.rolled_back_pushes + report.cancelled_pushes
            <= 4 * len(TREES) + len(TREES))
    _assert_ref(trt, jrt)
    for port, rt, eng, _ in sides:
        _drive(eng, 3, port)
        assert set(eng.shard_health().values()) == {HEALTHY}
    _assert_ref(trt, jrt)
    _assert_stats(teng, jeng)


def test_recover_healthy_shard_is_a_lossless_decommission():
    sides = _pair()
    for port, rt, eng, _ in sides:
        _drive(eng, 4, port)
    (_, trt, teng, _), (_, jrt, jeng, _) = sides
    before = {j: trt.params_of(j) for j in TREES}
    victim = trt.shard_ids[-1]
    report = trt.recover_shard(victim)
    assert dataclasses.asdict(report) == \
        dataclasses.asdict(jrt.recover_shard(victim))
    assert report.seeded_from == "live"
    assert report.rolled_back_pushes == report.cancelled_pushes == 0
    for j in TREES:
        after = trt.params_of(j)
        for k in after:
            assert torch.equal(after[k], before[j][k])
    _drive(teng, 2, True)
    _drive(jeng, 2, False)
    _assert_ref(trt, jrt)


def test_recover_shard_unknown_id_raises():
    rt, _ = _build(True)
    with pytest.raises(ValueError, match="unknown shard"):
        rt.recover_shard("nope/agg9")


def test_recover_cancels_pending_pushes_and_purges_siblings():
    """A push that spans the lost shard and a healthy one, with its piece
    still queued on the dead lane: recovery cancels its future and purges
    the sibling piece from the healthy lane, as the reference does."""
    out = []
    for port, rt, eng, inj in _pair(max_staleness=4, fleet_tick="per_shard",
                                     n_shards=2):
        span = next((j for j in TREES
                     if len(rt.splan.job_layout(j).shard_ids) >= 2), None)
        if span is None:
            pytest.skip("no job spans two shards")
        victim, healthy = rt.splan.job_layout(span).shard_ids[:2]
        inj.kill_shard(victim, at=1)
        fut = eng.step(span, _batch(span, port))["future"]
        for _ in range(2):  # two failures quarantine the victim
            eng.tick_shard(victim)
        assert eng.shard_health()[victim] == QUARANTINED
        report = rt.recover_shard(victim)
        assert fut.cancelled() and not fut.done()
        with pytest.raises(RuntimeError, match="never apply"):
            fut.result()
        assert not any(q for lane in eng._lanes.values()
                       for q in lane.queues.values())
        out.append((dataclasses.asdict(report), rt))
    (t_report, trt), (j_report, jrt) = out
    assert t_report == j_report
    assert t_report["cancelled_pushes"] == 1
    assert t_report["purged_sibling_pieces"] == 1
    _assert_ref(trt, jrt)


# --------------------------------------------------- scaler + migration
def test_autoscaler_holds_on_quarantined_fleet():
    decisions = []
    for port, rt, eng, inj in _pair():
        victim = rt.shard_ids[-1]
        cfg = dict(shard_capacity=1.0, max_shards=8, cooldown=1)
        scaler = (ElasticScaler(rt, AutoscalerConfig(**cfg)) if port
                  else JScaler(rt, JConfig(**cfg)))
        inj.kill_shard(victim, at=1)
        with pytest.raises(_quarantined(port)):
            _drive(eng, 8, port)
        n_before = rt.n_shards
        held = scaler.observe()
        assert held.quarantined == (victim,) and held.action == "hold"
        assert rt.n_shards == n_before
        rt.recover_shard(victim)
        _drive(eng, 4, port)
        grown = scaler.observe()
        assert grown.quarantined == () and grown.action == "grow"
        decisions.append([dataclasses.asdict(d) for d in (held, grown)])
    assert decisions[0] == decisions[1]


@pytest.mark.parametrize("after_shards", [None, 1])
def test_migration_fault_hook_fires_on_replan(after_shards):
    """A migration fault, at the boundary or after the first relaid shard,
    aborts the replan transaction, which rolls back and retries: the
    scale-out succeeds and both planes agree.  The aborted attempt leaves
    the old arena whole."""
    sides = _pair(n_shards=2)
    for port, rt, eng, inj in sides:
        _drive(eng, 2, port)
        if port:
            kept = {k: v.clone() for k, v in rt.arena.items()}
            old_arena = rt.arena
        inj.fail_migration(at=1, after_shards=after_shards)
        assert rt.service.scale_out(1) == 1
        assert inj.n_fired == 1
        assert inj.log[0]["kind"] == "fail_migration"
        assert rt.service.n_replan_aborts == rt.service.n_replan_retries == 1
        assert rt.service.compile_sharded_plan() == rt.splan
        assert rt.n_shards == 3
        if port:
            for k, v in kept.items():
                assert torch.equal(old_arena[k], v)
        _drive(eng, 2, port)
    (_, trt, teng, _), (_, jrt, jeng, _) = sides
    _assert_ref(trt, jrt)
    _assert_stats(teng, jeng)


# ------------------------------------------------------------ port pins
def test_rollback_copies_into_the_arena_views():
    """A rollback writes the snapshot back into the lane's views: every
    lane's tensors stay views of the fleet arena at the same addresses,
    the snapshot stays as it was taken, and the fused ticks after the
    fault equal the per-shard oracle bit for bit."""
    inj = FaultInjector()
    rt, eng = _build(True, snapshot_interval=8, fault_injector=inj)
    oracle, oeng = _build(True, snapshot_interval=8, fleet_tick="per_shard")
    ptrs = {sid: {k: v.data_ptr() for k, v in st.items()}
            for sid, st in rt.states.items()}
    _drive(eng, 2, True)
    victim = rt.shard_ids[0]
    lane = eng._lanes[victim]
    anchor = {k: v.clone() for k, v in lane.snapshot.items()}
    inj.fail_apply(victim, at=1)
    _drive(eng, 3, True)
    assert inj.n_fired == 1 and eng.stats.n_fleet_fallbacks == 1
    assert lane.stats.n_rollbacks == 1 and lane.stats.n_replayed > 0
    for k, v in anchor.items():  # only read by the rollback and replay
        assert torch.equal(lane.snapshot[k], v)
    launches, ticks = eng.stats.n_launches, eng.stats.n_ticks
    _drive(eng, 2, True)
    assert eng.stats.n_ticks > ticks  # fused again: one launch a tick
    assert eng.stats.n_launches - launches == eng.stats.n_ticks - ticks
    _drive(oeng, 7, True)
    _assert_bits(rt, oracle)
    for sid, st in rt.states.items():
        for k, v in st.items():
            assert v._base is rt.arena[k]
            assert v.data_ptr() == ptrs[sid][k]


def test_fleet_fault_touches_only_participants():
    """A lane with nothing pending is not in the failed launch: it is not
    rolled back or re-ticked, and its state stays bit for bit."""
    inj = FaultInjector()
    rt, eng = _build(True, max_staleness=2, fault_injector=inj)
    _drive(eng, 1, True)
    j = min(TREES, key=lambda j: len(rt.splan.job_layout(j).shard_ids))
    hosting = rt.splan.job_layout(j).shard_ids
    idle = [sid for sid in rt.shard_ids if sid not in hosting]
    if not idle:
        pytest.skip("every job spans every shard")
    kept = {sid: {k: v.clone() for k, v in rt.states[sid].items()}
            for sid in idle}
    stats = {sid: dataclasses.asdict(eng._lanes[sid].stats) for sid in idle}
    inj.fail_apply(hosting[0], at=1)
    eng.step(j, _batch(j, True))
    eng.tick()  # fails, and the participants replay their logs alone
    assert eng.stats.n_fleet_fallbacks == 1
    assert {sid for sid, lane in eng._lanes.items()
            if lane.stats.n_rollbacks} == set(hosting)
    for sid in idle:
        assert dataclasses.asdict(eng._lanes[sid].stats) == stats[sid]
        for k, v in kept[sid].items():
            assert torch.equal(rt.states[sid][k], v)


def test_multipart_future_unresolve_across_lane_rollback():
    """A spanning push applied on one lane, then un-applied by that lane's
    rollback, gets its part back: it resolves only once the replay and
    the other lane's piece have both applied, as in the reference."""
    seen = []
    for port, rt, eng, inj in _pair(max_staleness=4, fleet_tick="per_shard",
                                     n_shards=2):
        span = next((j for j in TREES
                     if len(rt.splan.job_layout(j).shard_ids) >= 2), None)
        if span is None:
            pytest.skip("no job spans two shards")
        first, second = rt.splan.job_layout(span).shard_ids[:2]
        fut = eng.step(span, _batch(span, port))["future"]
        assert eng.tick_shard(first) == 1 and not fut.done()
        inj.fail_apply(first, at=1)
        fut2 = eng.step(span, _batch(span, port))["future"]
        assert eng.tick_shard(first) == 0  # fails: the piece is re-queued
        assert eng._lanes[first].stats.n_rollbacks == 1
        assert fut._remaining == 2
        assert eng.tick_shard(second) == 1 and not fut.done()
        assert eng.tick_shard(first) == 1  # the replay
        assert fut.done() and fut.result() == 1 and not fut2.done()
        eng.drain()
        assert fut2.result() == 2
        seen.append(rt)
    _assert_ref(*seen)


@pytest.mark.parametrize("fleet_tick", ["fused", "per_shard"])
def test_snapshot_interval_zero_quarantines_and_recovers_from_zeros(
        fleet_tick):
    """With no rollback anchors a failed lane may be half-written (K1
    writes in place), so it is quarantined at once rather than re-raising;
    ``recover_shard`` then re-seeds its segments from zeros and carries
    every other segment over as it was.  Held against the reference's
    jitted engine, which quarantines the same way (its jitted Adam rounds
    differently, so values are held each against its own package)."""
    sides = []
    for port in (True, False):
        inj = FaultInjector() if port else JInjector()
        rt, eng = _build(port, jit=not port, snapshot_interval=0,
                         fault_injector=inj, fleet_tick=fleet_tick)
        sides.append((port, rt, eng, inj))
    reports = []
    for port, rt, eng, inj in sides:
        _drive(eng, 2, port)
        victim = rt.shard_ids[-1]
        inj.fail_apply(victim, at=1)
        with pytest.raises(_quarantined(port)):
            _drive(eng, 1, port)
        assert victim in eng.quarantined_shards()
        assert eng.stats.n_rollbacks == 0 and eng.stats.n_fleet_fallbacks == 0
        lost = {seg.skey for seg in rt.splan.shard_of(victim).segments}
        before = _segments(rt)
        reports.append(rt.recover_shard(victim))
        for skey, vals in _segments(rt).items():
            for got, was in zip(vals, before[skey]):
                np.testing.assert_array_equal(
                    got, np.zeros_like(was) if skey in lost else was)
    (_, trt, teng, _), (_, jrt, jeng, _) = sides
    assert dataclasses.asdict(reports[0]) == dataclasses.asdict(reports[1])
    assert reports[0].seeded_from == "zeros"
    assert trt.shard_ids == jrt.shard_ids
    assert teng.quarantined_shards() == jeng.quarantined_shards()
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)


def _segments(rt):
    """{segment key: (flat, mu, nu) of its lanes} over the live fleet."""
    return {seg.skey: tuple(np.asarray(rt.states[sid][k])
                            [seg.offset:seg.offset + seg.size]
                            for k in ("flat", "mu", "nu"))
            for sid, sp in zip(rt.splan.shard_ids, rt.splan.shards)
            for seg in sp.segments}
