"""The sharded service: the port's ShardedServiceRuntime, ShardedTickEngine,
sharded migrations and ElasticScaler held against the reference's.

Both packages run the same jobs (numpy-seeded weights carried across by
``tree_from_numpy``) on 1-3 shard spaces.  The reference runs eagerly
(``jit=False``), its path on the CPU, so each package applies the same
arithmetic op for op: states and parameters agree within the 1-ulp
budget across packages (the bias-correction power is the one scalar the
two may round differently), and plans, migration accounting and engine
counters are equal.  Inside the port the claims are the reference's own,
held bit for bit: sharded == flat, engine == direct steps, through
replans and scaling.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ParameterService as JService
from repro.ps.autoscaler import AutoscalerConfig as JConfig
from repro.ps.autoscaler import ElasticScaler as JScaler
from repro.ps.elastic import migrate_sharded_state as j_migrate
from repro.ps.plan import sharded_plan_to_json as j_plan_json
from repro.ps.service_runtime import ShardedServiceRuntime as JSharded
from repro_torch.core import ParameterService as TService
from repro_torch.ps import service_runtime as t_service_runtime
from repro_torch.ps.autoscaler import AutoscalerConfig, ElasticScaler
from repro_torch.ps.elastic import (
    migrate_sharded_state,
    sharded_transition_summary,
)
from repro_torch.ps.faults import ReplanAbortedError
from repro_torch.ps.plan import sharded_plan_to_json
from repro_torch.ps.runtime import tree_from_numpy
from repro_torch.ps.service_runtime import ServiceRuntime as TFlat
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


def _loss_jax(params, batch):
    return sum(jnp.sum((params[k] - batch["target"][k]) ** 2)
               for k in params)


def _loss_torch(params, batch):
    return sum(torch.sum((params[k] - batch["target"][k]) ** 2)
               for k in params)


TREES = {"a": _tree(0, (48, 16, 32)), "b": _tree(1, (32, 16))}
PROBE = _tree(7, (24,))


def _target(tree):
    return {k: np.ones_like(v) for k, v in tree.items()}


def _jbatch(tree):
    return {"target": jax.tree_util.tree_map(jnp.asarray, _target(tree))}


def _tbatch(tree):
    return {"target": tree_from_numpy(_target(tree), "cpu")}


def _throughput(tree, slack):
    return sum(4 * v.size for v in tree.values()) / slack


def _service(pkg):
    return pkg(total_budget=16, n_clusters=1, plan_pad_to=16)


def _add(rt, jid, tree, slack, port):
    params = (tree_from_numpy(tree, "cpu") if port
              else jax.tree_util.tree_map(jnp.asarray, tree))
    rt.add_job(jid, params, _loss_torch if port else _loss_jax, lr=0.05,
               required_servers=1, agg_throughput=_throughput(tree, slack))


def _port(engine=None, trees=TREES):
    rt = TSharded(_service(TService), device="cpu")
    eng = rt.attach_engine(**engine) if engine is not None else None
    for jid, t in trees.items():
        _add(rt, jid, t, 0.2, port=True)
    return rt, eng


def _ref(engine=None, trees=TREES):
    rt = JSharded(_service(JService), jit=False)
    eng = (rt.attach_engine(jit=False, **engine) if engine is not None
           else None)
    for jid, t in trees.items():
        _add(rt, jid, t, 0.2, port=False)
    return rt, eng


def _port_flat():
    rt = TFlat(_service(TService), device="cpu")
    for jid, t in TREES.items():
        _add(rt, jid, t, 0.2, port=True)
    return rt


def _assert_bits(rt_a, rt_b, jobs=TREES):
    """Two port runtimes' parameters, bit for bit."""
    for j in jobs:
        pa, pb = rt_a.params_of(j), rt_b.params_of(j)
        for k in pa:
            assert torch.equal(pa[k], pb[k]), (j, k)


def _assert_ref(trt, jrt, jobs=TREES):
    """The port against the reference: same shard map, every shard
    state and every job's parameters within the ulp budget, same
    counts."""
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


# ------------------------------------------------------------------- plan
def test_single_aggregator_shard_plan_matches_flat_plan():
    """With ONE Aggregator the shard space is the flat plan's single
    shard; the sharded plan equals the reference's, field for field."""
    rt, _ = _port()
    jrt, _ = _ref()
    assert sharded_plan_to_json(rt.splan) == j_plan_json(jrt.splan)
    if rt.service.n_aggregators != 1:
        pytest.skip("packing spread jobs; single-shard identity untestable")
    assert rt.splan.shards[0] == rt.service.compile_plan()


def test_arena_views_cover_the_fleet():
    """Each shard's flat/mu/nu is a view of the fleet arena at the plan's
    block-aligned concat offset, including after a split."""
    rt, _ = _port()
    rt.service.scale_out(1)
    offsets, total, block = rt.splan.concat_view()
    for k in ("flat", "mu", "nu"):
        assert rt.arena[k].shape == (total,)
        base = rt.arena[k].data_ptr()
        for sid, off in zip(rt.shard_ids, offsets):
            view = rt.states[sid][k]
            assert off % block == 0
            assert view.data_ptr() == base + 4 * off
            assert view.numel() == rt.splan.shard_of(sid).total_len


# ------------------------------------------------- trajectory bit-parity
def _drive(rt, step, port, n_steps=12, probe_at=(4, 9)):
    """Step all jobs n times; a probe job arrives and exits, forcing two
    replan migrations mid-trajectory."""
    batch = _tbatch if port else _jbatch
    arrive, leave = probe_at
    for i in range(n_steps):
        if i == arrive:
            _add(rt, "probe", PROBE, 0.3, port)
        if i == leave:
            rt.remove_job("probe")
        for jid, t in TREES.items():
            step(jid, batch(t))
        if arrive <= i < leave:
            step("probe", batch(PROBE))
    return rt


def test_sharded_runtime_matches_flat_and_reference_through_replans():
    """The sharded runtime reproduces the port's flat trajectory bit for
    bit and the reference's sharded one within the budget, through a
    probe job's arrival and exit replans."""
    flat = _port_flat()
    _drive(flat, flat.step, True)
    rt, _ = _port()
    _drive(rt, rt.step, True)
    jrt, _ = _ref()
    _drive(jrt, jrt.step, False)
    assert rt.n_replans == jrt.n_replans >= 2
    _assert_bits(flat, rt)
    for j in TREES:
        assert rt.counts[j] == flat.state["counts"][j]
    _assert_ref(rt, jrt)
    assert rt.total_relayout_bytes == jrt.total_relayout_bytes
    assert rt.total_migration_bytes == jrt.total_migration_bytes


def test_scale_out_in_bit_exact_and_moves_only_delta_bytes():
    """A shard split and the merge back move exactly the transition
    summary's bytes (the reference's too), leave every job's parameters
    as they were, and the trajectory stays the flat runtime's bit for
    bit and the reference's within the budget."""
    flat = _port_flat()
    rt, _ = _port()
    jrt, _ = _ref()

    def steps(n):
        for _ in range(n):
            for j, t in TREES.items():
                flat.step(j, _tbatch(t))
                rt.step(j, _tbatch(t))
                jrt.step(j, _jbatch(t))

    steps(4)
    for scale in ("scale_out", "scale_in"):
        old = rt.splan
        before = {j: rt.params_of(j) for j in TREES}
        assert getattr(rt.service, scale)(1) == 1
        assert getattr(jrt.service, scale)(1) == 1
        assert rt.n_shards == old.n_shards + (1 if scale == "scale_out"
                                              else -1)
        moved, touched = sharded_transition_summary(old, rt.splan)
        assert rt.last_relayout_bytes == moved * 12 == jrt.last_relayout_bytes
        assert rt.last_replan_touched == touched == jrt.last_replan_touched
        if scale == "scale_out":
            assert moved > 0  # a split really ships bytes across shards
        for j in TREES:
            after = rt.params_of(j)
            for k in after:
                assert torch.equal(before[j][k], after[k])
        steps(4)
        _assert_bits(flat, rt)
        _assert_ref(rt, jrt)


def test_migrate_sharded_state_matches_summary_and_reference():
    """On a real split: the executed migration's element count and touched
    set equal the O(segments) summary's; its states equal the reference's
    migration of the same numpy states bit for bit (a migration only
    copies); the input states are left untouched."""
    rt, _ = _port()
    jrt, _ = _ref()
    for _ in range(3):
        for j, t in TREES.items():
            jrt.step(j, _jbatch(t))
    # The reference's pre-split states, fed to both migrations.
    src = {sid: {k: np.asarray(st[k]) for k in ("flat", "mu", "nu")}
           for sid, st in jrt.states.items()}
    old_t, old_j = rt.splan, jrt.splan
    assert rt.service.scale_out(1) == jrt.service.scale_out(1) == 1
    t_states = {sid: {k: torch.from_numpy(v.copy()) for k, v in st.items()}
                for sid, st in src.items()}
    kept = {sid: {k: v.clone() for k, v in st.items()}
            for sid, st in t_states.items()}
    got, moved, touched = migrate_sharded_state(t_states, old_t, rt.splan)
    want, j_moved, j_touched = j_migrate(
        {sid: {k: jnp.asarray(v) for k, v in st.items()}
         for sid, st in src.items()}, old_j, jrt.splan)
    assert (moved, touched) == sharded_transition_summary(old_t, rt.splan)
    assert (moved, touched) == (j_moved, j_touched)
    assert set(got) == set(want)
    for sid in want:
        for k in ("flat", "mu", "nu"):
            np.testing.assert_array_equal(got[sid][k].numpy(),
                                          np.asarray(want[sid][k]))
    for sid, st in kept.items():
        for k, v in st.items():
            assert torch.equal(t_states[sid][k], v)


def test_aborted_sharded_replan_leaves_runtime_whole(monkeypatch):
    """A migration that fails leaves the plan, the arena, the states and
    the engine as they were; the service rolls the split back."""
    rt, eng = _port(engine=dict(max_staleness=0))
    for j, t in TREES.items():
        eng.step(j, _tbatch(t))
    eng.drain()
    plan, arena = rt.splan, rt.arena
    kept = {k: v.clone() for k, v in arena.items()}

    def fail(*args, **kw):
        raise RuntimeError("injected migration failure")

    monkeypatch.setattr(t_service_runtime, "migrate_sharded_state", fail)
    with pytest.raises(ReplanAbortedError):
        rt.service.scale_out(1)
    assert rt.splan is plan and rt.arena is arena
    for k, v in kept.items():
        assert torch.equal(arena[k], v)
    monkeypatch.undo()
    for j, t in TREES.items():
        eng.step(j, _tbatch(t))
    assert eng.drain() == sum(len(rt.splan.job_layout(j).shard_ids)
                              for j in TREES)


# --------------------------------------------------------- sharded engine
def test_sharded_engine_bsp_bit_exact_through_scaling():
    """Engine-driven (BSP) sharded training == direct sharded steps bit
    for bit, and == the reference's engine within the budget, straight
    through a split."""
    rt_ref, _ = _port()
    rt_eng, eng = _port(engine=dict(max_staleness=0))
    jrt, jeng = _ref(engine=dict(max_staleness=0))

    def both(n):
        for _ in range(n):
            for j, t in TREES.items():
                rt_ref.step(j, _tbatch(t))
                eng.step(j, _tbatch(t))
                jeng.step(j, _jbatch(t))
        eng.drain()
        jeng.drain()

    both(4)
    for rt in (rt_ref, rt_eng, jrt):
        rt.service.scale_out(1)
    both(4)
    _assert_bits(rt_ref, rt_eng)
    _assert_ref(rt_eng, jrt)
    assert eng.stats.n_applied > 0
    per_shard = eng.shard_stats()
    assert len(per_shard) == rt_eng.n_shards
    assert all(s.n_applied > 0 for s in per_shard.values())
    assert (dataclasses.asdict(eng.stats)
            == dataclasses.asdict(jeng.stats))


def test_sharded_engine_independent_cadence_and_multipart_futures():
    """Ticking ONE hosting shard applies only that shard's piece; the
    future resolves only when every hosting shard applied its piece."""
    rt, eng = _port(engine=dict(max_staleness=2))
    rt.service.scale_out(1)
    layout = rt.splan.job_layout("a")
    if len(layout.shard_ids) < 2:
        pytest.skip("split left job 'a' on one shard")
    fut = eng.step("a", _tbatch(TREES["a"]))["future"]
    first, rest = layout.shard_ids[0], layout.shard_ids[1:]
    assert eng.tick_shard(first) == 1
    assert not fut.done()  # other shards' pieces still queued
    assert eng.outstanding("a") == 1
    assert rt.counts["a"] == 0  # committed only by the last piece
    for sid in rest:
        eng.tick_shard(sid)
    assert fut.done() and fut.result() == 1 and rt.counts["a"] == 1
    assert eng.shard_stats()[first].n_ticks == 1


def test_sharded_engine_staleness_bound_forces_rounds():
    rt, eng = _port(engine=dict(max_staleness=1))
    jrt, jeng = _ref(engine=dict(max_staleness=1))
    for _ in range(3):
        eng.step("a", _tbatch(TREES["a"]))
        jeng.step("a", _jbatch(TREES["a"]))
        assert eng.outstanding("a") == jeng.outstanding("a") <= 2
    assert eng.stats.n_forced_staleness == jeng.stats.n_forced_staleness > 0
    eng.drain()
    jeng.drain()
    assert eng.outstanding("a") == 0
    _assert_ref(rt, jrt)


def test_replan_drains_only_touched_jobs_and_retags_the_rest():
    """A probe's arrival with every job's pushes queued: the replan drains
    only the jobs the sharded transition touches, the untouched jobs'
    pieces cross the epoch fence re-tagged, and after a drain the fleet
    matches the reference's, counters included."""
    rt, eng = _port(engine=dict(max_staleness=1))
    jrt, jeng = _ref(engine=dict(max_staleness=1))
    for _ in range(2):
        for j, t in TREES.items():
            eng.step(j, _tbatch(t))
            jeng.step(j, _jbatch(t))
    _add(rt, "probe", PROBE, 0.3, port=True)
    _add(jrt, "probe", PROBE, 0.3, port=False)
    assert rt.last_replan_touched == jrt.last_replan_touched == ("probe",)
    assert eng.stats.n_retagged == jeng.stats.n_retagged > 0
    for j in TREES:
        assert eng.outstanding(j) == jeng.outstanding(j) > 0
    jobs = {**TREES, "probe": PROBE}
    for j, t in jobs.items():
        eng.step(j, _tbatch(t))
        jeng.step(j, _jbatch(t))
    # A split with pieces queued: its touched jobs drain first.
    assert rt.service.scale_out(1) == jrt.service.scale_out(1) == 1
    assert rt.last_replan_touched == jrt.last_replan_touched
    assert eng.stats.n_forced_replan == jeng.stats.n_forced_replan > 0
    for j, t in jobs.items():
        eng.step(j, _tbatch(t))
        jeng.step(j, _jbatch(t))
    eng.drain()
    jeng.drain()
    _assert_ref(rt, jrt, jobs=list(TREES) + ["probe"])
    assert (dataclasses.asdict(eng.stats)
            == dataclasses.asdict(jeng.stats))


def test_sharded_engine_epoch_fence_raises_on_stale_piece():
    rt, eng = _port(engine=dict(max_staleness=1))
    eng.step("a", _tbatch(TREES["a"]))
    eng._epoch += 1  # a replan that migrated without draining
    with pytest.raises(RuntimeError, match="epoch fence"):
        eng.drain()


def test_submit_packed_and_submit_push_agree():
    """A packed gradient over the combined layout applies as the tree
    push it packs: one piece per hosting shard."""
    rt_a, eng_a = _port(engine=dict(max_staleness=0))
    rt_b, eng_b = _port(engine=dict(max_staleness=0))
    for rt in (rt_a, rt_b):
        rt.service.scale_out(1)
    rng = np.random.default_rng(5)
    for j, t in TREES.items():
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in t.items()}
        eng_a.submit_push(j, tree_from_numpy(g, "cpu"))
        layout = rt_b.splan.job_layout(j)
        packed = torch.zeros(layout.packed_len)
        for key, start, size, _, _ in layout.slots:
            packed[start:start + size] = torch.from_numpy(g[key])
        eng_b.submit_packed(j, packed)
    eng_a.drain()
    eng_b.drain()
    _assert_bits(rt_a, rt_b)
    with pytest.raises(ValueError, match="packed gradient"):
        eng_b.submit_packed("a", torch.zeros(3))


# ------------------------------------------------------------- autoscaler
def _scaler_run(rt, eng, scaler, batch):
    def window(steps):
        for _ in range(steps):
            for j, t in TREES.items():
                eng.step(j, batch(t))
        eng.drain()
        return scaler.observe()

    return [window(s) for s in (1, 1, 8, 8, 8, 8, 1, 1, 1, 1, 1)]


def test_autoscaler_follows_load_and_merges_back():
    """The scaler grows the fleet under load and merges it back when the
    load leaves, with the reference's decisions window for window, and the
    states stay within the budget of the reference's."""
    cfg = dict(shard_capacity=8.0, max_shards=4, cooldown=1)
    rt, eng = _port(engine=dict(max_staleness=0))
    jrt, jeng = _ref(engine=dict(max_staleness=0))
    scaler = ElasticScaler(rt, AutoscalerConfig(**cfg))
    jscaler = JScaler(jrt, JConfig(**cfg))
    got = _scaler_run(rt, eng, scaler, _tbatch)
    want = _scaler_run(jrt, jeng, jscaler, _jbatch)
    assert [dataclasses.asdict(d) for d in got] == \
        [dataclasses.asdict(d) for d in want]
    timeline = scaler.shard_timeline()
    assert max(timeline) > 1 and timeline[-1] == 1
    assert scaler.n_actions >= 2
    assert any(d.relayout_bytes > 0 for d in scaler.decisions)
    _assert_ref(rt, jrt)


def test_autoscaler_requires_engine():
    rt, _ = _port()
    with pytest.raises(RuntimeError, match="ShardedTickEngine"):
        ElasticScaler(rt).observe()


# ------------------------------------------------------------ debug stats
def test_debug_stats_unifies_cache_and_per_shard_ticks():
    rt, eng = _port(engine=dict(max_staleness=0))
    rt.service.scale_out(1)
    for _ in range(2):
        for j, t in TREES.items():
            eng.step(j, _tbatch(t))
    eng.drain()
    stats = rt.debug_stats()
    assert {"plan_cache", "runtime", "engine", "shards"} <= set(stats)
    assert {"hits", "misses", "entries"} <= set(stats["plan_cache"])
    assert stats["runtime"]["n_shards"] == rt.n_shards
    assert stats["runtime"]["n_jobs"] == 2
    assert set(stats["shards"]) <= set(rt.shard_ids)
    assert all(s["health"] == "healthy" for s in stats["shards"].values())
    assert sum(s["n_applied"] for s in stats["shards"].values()) \
        == stats["engine"]["n_applied"] > 0
    assert stats["engine"]["n_fleet_fallbacks"] == 0


# ------------------------------------------------------------ remove_job
def test_remove_job_unknown_leaves_sharded_runtime_untouched():
    rt, _ = _port()
    plan, arena = rt.splan, rt.arena
    with pytest.raises(ValueError, match="unknown job"):
        rt.remove_job("nope")
    assert set(rt.job_ids) == set(TREES)
    assert rt.splan is plan and rt.arena is arena


def test_last_exit_drops_the_fleet():
    rt, eng = _port(engine=dict(max_staleness=1))
    for j, t in TREES.items():
        eng.step(j, _tbatch(t))
    for j in TREES:
        rt.remove_job(j)
    assert rt.splan is None and rt.arena is None and rt.states == {}
    assert eng.outstanding("a") == 0 and not eng._lanes


# --------------------------------------------------- outside this slice
def _out_of_slice_cases():
    """Entry points that earlier slices refused with their Queue 1 item;
    items 4, 9 and 11 are ported now, so each must run."""
    def compression():
        rt = TSharded(_service(TService), device="cpu")
        rt.add_job("a", tree_from_numpy(TREES["a"], "cpu"), _loss_torch,
                   push_compression="int8")
        return "ef" in rt.arena

    def lease():
        rt = TSharded(_service(TService), device="cpu")
        return rt.attach_engine(lease_interval=1.0).lease_interval == 1.0

    def expire():
        return _port(engine={})[1].expire_leases() == ()

    def save(tmp):
        return _port()[0].save_checkpoint(tmp, 1).exists()

    def restore(tmp):
        rt = _port()[0]
        rt.save_checkpoint(tmp, 1)
        rt.restore_checkpoint(tmp, 1)
        return rt.counts == {j: 0 for j in TREES}

    return [("4", compression), ("9", lease), ("9", expire), ("11", save),
            ("11", restore)]


@pytest.mark.parametrize("item,call", _out_of_slice_cases(),
                         ids=lambda c: getattr(c, "__name__", c))
def test_out_of_slice_entry_points_raise(item, call, tmp_path):
    """Each entry point a slice refused (``NotImplementedError`` naming
    its item) runs now that items 4, 9 and 11 are ported."""
    assert call(tmp_path) if call.__code__.co_argcount else call(), item
