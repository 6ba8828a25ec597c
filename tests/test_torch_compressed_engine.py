"""Compressed pushes (error feedback) through the port's runtimes and
engines, held against the reference's on the same numpy-seeded inputs.

Across packages the claim is on ``ef``: the error-feedback residual
depends only on the pushed gradients and its own past, never on the
parameters, so the same packed pushes leave ``ef`` bit for bit equal in
both packages (the reference runs eagerly, ``jit=False``), and
flat/mu/nu within the 1-ulp budget.  Inside the port the claims are bit
for bit: engine == ``runtime.step()``, the fused fleet tick == the
per-shard appliers == ``ShardedServiceRuntime.step``, a faulted fleet ==
its fault-free replay, ``ef`` included.  On the sharded fleet ``ef`` is a
fourth arena leaf with a view per shard; the views must survive a
rollback, a replan and a widening.

Mirrors the compressed cases of ``tests/test_engine.py``,
``tests/test_fused_tick.py`` and ``tests/test_faults.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ParameterService as JService
from repro.ps.runtime import init_ps_state as j_init_ps_state
from repro.ps.runtime import make_ps_train_step as j_make_step
from repro.ps.service_runtime import ServiceRuntime as JRuntime
from repro.ps.service_runtime import ShardedServiceRuntime as JSharded
from repro_torch.core import ParameterService as TService
from repro_torch.kernels.agg_adam import ops as agg_ops
from repro_torch.ps import engine as engine_mod
from repro_torch.ps.faults import HEALTHY, FaultInjector
from repro_torch.ps.runtime import (
    build_flat_plan,
    init_ps_state,
    make_ps_train_step,
    tree_from_numpy,
)
from repro_torch.ps.service_runtime import ServiceRuntime as TRuntime
from repro_torch.ps.service_runtime import ShardedServiceRuntime as TSharded

ULP_BUDGET = 1
LEAVES4 = ("flat", "mu", "nu", "ef")


def ulp_diff(a, b) -> int:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


def _bits_equal(t, j):
    np.testing.assert_array_equal(
        t.numpy().view(np.int32), np.asarray(j, np.float32).view(np.int32))


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


def _params(t, port):
    return (tree_from_numpy(t, "cpu") if port
            else jax.tree_util.tree_map(jnp.asarray, t))


def _add_jobs(rt, port, compressed, trees=TREES, servers=1, share=0.2):
    for jid, t in trees.items():
        kind = compressed.get(jid)
        rt.add_job(jid, _params(t, port), _loss_torch if port else _loss_jax,
                   lr=0.05, required_servers=servers,
                   agg_throughput=sum(4 * v.size for v in t.values()) / share,
                   **({"push_compression": kind} if kind else {}))


def _flat(port, compressed, engine=None):
    svc = (TService if port else JService)(total_budget=16, n_clusters=1,
                                           plan_pad_to=16)
    rt = TRuntime(svc, device="cpu") if port else JRuntime(svc, jit=False)
    eng = None
    if engine is not None:
        eng = (rt.attach_engine(**engine) if port
               else rt.attach_engine(jit=False, **engine))
    _add_jobs(rt, port, compressed, servers=2, share=0.45)
    return rt, eng


def _sharded(port, compressed, n_shards=3, engine=None, **opts):
    svc = (TService if port else JService)(total_budget=16, n_clusters=1,
                                           plan_pad_to=16)
    rt = TSharded(svc, device="cpu") if port else JSharded(svc, jit=False)
    eng = None
    if engine is not None:
        engine.setdefault("max_staleness", 0)
        eng = (rt.attach_engine(**engine, **opts) if port
               else rt.attach_engine(jit=False, **engine, **opts))
    _add_jobs(rt, port, compressed)
    if n_shards > 1:
        svc.scale_out(n_shards - 1)
    return rt, eng


def _drive(eng, n, port, jobs=TREES):
    for _ in range(n):
        for j in jobs:
            eng.step(j, _batch(j, port))
    eng.drain()


def _packed_grads(rt, seed, jobs):
    """One seeded packed gradient per job over its combined layout, zero
    on intra-block padding (as packing leaves it)."""
    plan = rt.splan if hasattr(rt, "splan") else rt.plan
    rng = np.random.default_rng(seed)
    out = {}
    for j in jobs:
        layout = plan.job_layout(j)
        g = np.zeros(layout.packed_len, np.float32)
        for _, start, size, _, _ in layout.slots:
            g[start:start + size] = rng.standard_normal(size) * 0.5
        out[j] = g
    return out


def _same_plan(tplan, jplan) -> bool:
    from repro.ps.plan import plan_to_json as j_json
    from repro_torch.ps.plan import plan_to_json

    return plan_to_json(tplan) == j_json(jplan)


def _views_ok(rt):
    """Every shard's leaves (ef included) are views of the fleet arena at
    the shard's offset."""
    offsets = dict(zip(rt.shard_ids, rt.splan.concat_view()[0]))
    assert set(rt.arena) == set(next(iter(rt.states.values())))
    for sid, st in rt.states.items():
        for k, v in st.items():
            arena = rt.arena[k]
            assert v._base is arena, (sid, k)
            assert v.data_ptr() - arena.data_ptr() == 4 * offsets[sid]


def _assert_bits(rt_a, rt_b, leaves=LEAVES4):
    assert rt_a.shard_ids == rt_b.shard_ids
    for k in leaves:
        assert torch.equal(rt_a.arena[k], rt_b.arena[k]), k
    assert rt_a.counts == rt_b.counts


@pytest.fixture
def k1_calls(monkeypatch):
    calls = []
    real = agg_ops.aggregate_adam_multijob_fused

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(agg_ops, "aggregate_adam_multijob_fused", counted)
    return calls


# ------------------------------------------------------------ single space
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_single_job_compressed_step_matches_reference(kind):
    """The single-job step's EF round over the whole space, then Adam:
    ``ef`` equal to the reference's eager step bit for bit, the rest
    within the budget."""
    tree = TREES["a"]
    t_params = tree_from_numpy(tree, "cpu")
    plan = build_flat_plan(t_params, n_shards=2, pad_to=16)
    tstate = init_ps_state(plan, t_params, push_compression=kind)
    assert torch.equal(tstate["ef"], torch.zeros_like(tstate["flat"]))
    jparams = _params(tree, False)
    from repro.ps.runtime import build_flat_plan as j_build

    jplan = j_build(jparams, n_shards=2, pad_to=16)
    assert _same_plan(plan, jplan)
    jstate = j_init_ps_state(jplan, jparams, push_compression=kind)
    tstep = make_ps_train_step(_loss_torch, plan, t_params, lr=0.05,
                               push_compression=kind)
    jstep = j_make_step(_loss_jax, jplan, jparams, lr=0.05,
                        push_compression=kind)
    tstate, tm = tstep(tstate, _batch("a", True))
    jstate, jm = jstep(jstate, _batch("a", False))
    _bits_equal(tstate["ef"], jstate["ef"])
    assert float(tstate["ef"].abs().max()) > 0
    for k in ("flat", "mu", "nu"):
        assert ulp_diff(tstate[k].numpy(), np.asarray(jstate[k])) \
            <= ULP_BUDGET
    assert tstate["count"] == int(jstate["count"]) == 1


@pytest.mark.parametrize("mode", ["masked", "block"])
def test_shared_space_compressed_step_matches_reference(mode):
    """A compressed job's step in a shared space: the masked oracle
    quantizes the whole space (full-space block boundaries) and keeps the
    residual on the job's lanes only; the block step quantizes its packed
    gradient against its owned rows of ``ef``.  Either equals the
    reference's step of the same mode on ``ef`` bit for bit."""
    rt_t, _ = _flat(True, {})
    rt_j, _ = _flat(False, {})
    plan, jplan = rt_t.plan, rt_j.plan
    assert _same_plan(plan, jplan)
    from repro.ps.runtime import init_shared_state as j_init_shared
    from repro.ps.runtime import seed_job_params as j_seed
    from repro_torch.ps.runtime import init_shared_state, seed_job_params

    ts = init_shared_state(plan, "cpu", needs_ef=True)
    js = j_init_shared(jplan, needs_ef=True)
    for j, t in TREES.items():
        ts = seed_job_params(plan, ts, j, tree_from_numpy(t, "cpu"))
        js = j_seed(jplan, js, j, _params(t, False))
    ts["ef"].fill_(0.01)  # co-resident jobs' residuals must survive
    js = dict(js, ef=jnp.full_like(js["ef"], 0.01))
    tstep = make_ps_train_step(_loss_torch, plan, rt_t._jobs["a"]["abstract"],
                               lr=0.05, job_id="a", update_mode=mode,
                               push_compression="int8")
    jstep = j_make_step(_loss_jax, jplan, rt_j._jobs["a"]["abstract"],
                        lr=0.05, job_id="a", update_mode=mode,
                        push_compression="int8")
    ts, _ = tstep(ts, _batch("a", True))
    js, _ = jstep(js, _batch("a", False))
    _bits_equal(ts["ef"], js["ef"])
    for k in ("flat", "mu", "nu"):
        assert ulp_diff(ts[k].numpy(), np.asarray(js[k])) <= ULP_BUDGET


# ------------------------------------------------------------ flat engine
def test_flat_engine_accepts_compressed_jobs_and_prices_the_wire():
    """A compressed job joins a live service: the state gains ``ef`` at
    the replan, the job trains through batched ticks, and the wire
    counters equal the reference's (int8 under half of fp32)."""
    out = {}
    for port in (True, False):
        rt, eng = _flat(port, {}, engine=dict(max_staleness=0))
        assert "ef" not in rt.state
        tree_z = _tree(9, (32, 16))
        rt.add_job("z", _params(tree_z, port),
                   _loss_torch if port else _loss_jax, lr=0.05,
                   required_servers=1,
                   agg_throughput=sum(4 * v.size for v in tree_z.values())
                   / 0.6, push_compression="int8")
        target = {k: np.ones_like(v) for k, v in tree_z.items()}
        batch = ({"target": tree_from_numpy(target, "cpu")} if port else
                 {"target": jax.tree_util.tree_map(jnp.asarray, target)})
        losses = [float(eng.step("z", batch)["loss"]) for _ in range(30)]
        eng.drain()
        assert "ef" in rt.state
        assert losses[-1] < 0.5 * losses[0]
        assert 0 < eng.stats.push_bytes_wire <= 0.5 * eng.stats.push_bytes_raw
        out[port] = (eng.stats.push_bytes_raw, eng.stats.push_bytes_wire)
    assert out[True] == out[False]


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_flat_engine_compressed_matches_runtime_step(kind):
    """A compressed job stepped through the engine lands on
    ``runtime.step()``'s compressed path bit for bit (both run
    ``_ef_round``), flat/mu/nu/ef, at staleness 0."""
    rt_eng, eng = _flat(True, {"a": kind}, engine=dict(max_staleness=0))
    rt_seq, _ = _flat(True, {"a": kind})
    for _ in range(10):
        for j in TREES:
            eng.step(j, _batch(j, True))
            rt_seq.step(j, _batch(j, True))
    eng.drain()
    for k in LEAVES4:
        assert torch.equal(rt_eng.state[k], rt_seq.state[k]), k
    assert float(rt_eng.state["ef"].abs().max()) > 0


def test_flat_engine_ef_equals_reference_on_packed_pushes():
    """The same packed pushes through both packages' batched ticks: ``ef``
    bit for bit (it never reads the parameters), flat/mu/nu within the
    budget, across an arrival replan that moves the compressed job."""
    comp = {"a": "int8", "c": "bf16"}
    (rt_t, eng_t), (rt_j, eng_j) = (
        _flat(p, comp, engine=dict(max_staleness=0, min_batch_jobs=2))
        for p in (True, False))
    for r in range(6):
        if r == 3:
            for port, rt in ((True, rt_t), (False, rt_j)):
                probe = _tree(7, (64,))
                rt.add_job("probe", _params(probe, port),
                           _loss_torch if port else _loss_jax, lr=0.05,
                           required_servers=1, agg_throughput=256 / 0.45)
            assert _same_plan(rt_t.plan, rt_j.plan)
        gs = _packed_grads(rt_t, r, TREES)
        for j, g in gs.items():
            eng_t.submit_packed(j, torch.from_numpy(g))
            eng_j.submit_packed(j, jnp.asarray(g))
        eng_t.drain()
        eng_j.drain()
    _bits_equal(rt_t.state["ef"], rt_j.state["ef"])
    for k in ("flat", "mu", "nu"):
        assert ulp_diff(rt_t.state[k].numpy(),
                        np.asarray(rt_j.state[k])) <= ULP_BUDGET
    assert eng_t.stats.push_bytes_wire == eng_j.stats.push_bytes_wire


# ---------------------------------------------------------- sharded fleet
def test_sharded_engine_compressed_job_trains_through_fused_ticks(k1_calls):
    """A compressed job on the fleet: the arena gains ``ef`` (a view per
    shard), the job trains through fused fleet ticks (one K1 call each),
    and the wire counters land on the fleet and its hosting lanes."""
    rt, eng = _sharded(True, {}, n_shards=1, engine={})
    assert "ef" not in rt.arena
    tree_z = _tree(9, (32, 16))
    rt.add_job("z", tree_from_numpy(tree_z, "cpu"), _loss_torch, lr=0.05,
               required_servers=2,
               agg_throughput=sum(4 * v.size for v in tree_z.values()) / 0.2,
               push_compression="int8")
    _views_ok(rt)
    target = {"target": tree_from_numpy(
        {k: np.ones_like(v) for k, v in tree_z.items()}, "cpu")}
    losses = []
    for _ in range(30):
        losses.append(float(eng.step("z", target)["loss"]))
        for j in TREES:
            eng.step(j, _batch(j, True))
    n0, calls0 = eng.stats.n_ticks, len(k1_calls)
    eng.drain()
    assert len(k1_calls) - calls0 == eng.stats.n_ticks - n0
    assert losses[-1] < 0.5 * losses[0]
    for sid in rt.splan.job_layout("z").shard_ids:
        st = eng._lane(sid).stats
        assert 0 < st.push_bytes_wire < st.push_bytes_raw
    assert 0 < eng.stats.push_bytes_wire < eng.stats.push_bytes_raw
    _views_ok(rt)


def test_mixed_compression_fleet_matches_direct_step_and_oracle():
    """Compressed (int8, bf16) and plain jobs in one fused fleet tick:
    bit for bit with the per-shard oracle and with the sequential
    ``ShardedServiceRuntime.step`` twin, ``ef`` included."""
    comp = {"a": "int8", "b": "bf16"}
    rt_f, eng_f = _sharded(True, comp, engine={})
    rt_o, eng_o = _sharded(True, comp, engine=dict(fleet_tick="per_shard"))
    rt_s, _ = _sharded(True, comp)
    assert rt_f.n_shards >= 2
    for _ in range(10):
        for j in TREES:
            eng_f.step(j, _batch(j, True))
            eng_o.step(j, _batch(j, True))
            rt_s.step(j, _batch(j, True))
    eng_f.drain()
    eng_o.drain()
    _assert_bits(rt_f, rt_o)
    _assert_bits(rt_f, rt_s)
    assert float(rt_f.arena["ef"].abs().max()) > 0
    _views_ok(rt_f)


def test_sharded_ef_equals_reference_on_packed_pushes():
    """The same packed pushes through both packages' fused fleet ticks,
    across a scale-out that migrates ``ef`` through K2 and a cross-shard
    arrival: every shard's ``ef`` bit for bit, flat/mu/nu within the
    budget."""
    comp = {"a": "int8", "c": "bf16"}
    (rt_t, eng_t), (rt_j, eng_j) = (_sharded(p, comp, n_shards=2, engine={})
                                    for p in (True, False))
    for r in range(6):
        if r == 3:
            rt_t.service.scale_out(1)
            rt_j.service.scale_out(1)
            assert rt_t.shard_ids == rt_j.shard_ids
            _views_ok(rt_t)
        gs = _packed_grads(rt_t, 10 + r, TREES)
        for j, g in gs.items():
            # The reference's sharded engine takes gradient trees only.
            tree = {key: g[start:start + size].reshape(shape)
                    for key, start, size, shape, _
                    in rt_t.splan.job_layout(j).slots}
            eng_t.submit_push(j, tree_from_numpy(tree, "cpu"))
            eng_j.submit_push(j, jax.tree_util.tree_map(jnp.asarray, tree))
        eng_t.drain()
        eng_j.drain()
    for sid in rt_j.shard_ids:
        st, js = rt_t.states[sid], rt_j.states[sid]
        assert "ef" in js
        _bits_equal(st["ef"], js["ef"])
        for k in ("flat", "mu", "nu"):
            assert ulp_diff(st[k].numpy(), np.asarray(js[k])) <= ULP_BUDGET
    assert eng_t.stats.push_bytes_wire == eng_j.stats.push_bytes_wire
    assert float(rt_t.arena["ef"].abs().max()) > 0


# ------------------------------------------------------------------ faults
def test_rollback_restores_ef_buffer_bit_exact():
    """``ef`` rides the lane snapshot: a compressed job recovered by
    replay equals a fault-free compressed twin bit for bit, parameters
    and residual, and every lane's ``ef`` is still a view of the arena."""
    inj = FaultInjector(seed=5)
    rt, eng = _sharded(True, {"a": "int8"}, engine={}, fault_injector=inj,
                       snapshot_interval=4)
    twin, teng = _sharded(True, {"a": "int8"}, engine={},
                          snapshot_interval=4)
    victim = rt.splan.job_layout("a").shard_ids[0]
    inj.fail_apply(victim, at=3).fail_apply(victim, at=8)
    _drive(eng, 12, True)
    _drive(teng, 12, True)
    assert inj.n_fired >= 1
    assert eng.stats.n_rollbacks >= 1 and eng.stats.n_quarantines == 0
    _assert_bits(rt, twin)
    _views_ok(rt)


@pytest.mark.parametrize("fleet_tick", ["fused", "per_shard"])
def test_k1_failure_after_ef_rounds_rolls_ef_back(fleet_tick, monkeypatch):
    """K1 raises once INSIDE the applier, after the tick's EF rounds have
    written residuals into the arena's ``ef`` in place.  The rollback
    must copy ``ef`` back too, or the replay adds the error feedback
    twice: the drained arena equals the fault-free twin bit for bit,
    ``ef`` included, and every lane's ``ef`` is still a view."""
    comp = {"a": "int8", "b": "bf16"}
    real_k1 = agg_ops.aggregate_adam_multijob_fused
    real_round = engine_mod._ef_round
    ctl = {"armed": False, "ef_written": False, "fired": 0}

    def spy_round(layout, ef, g, kind, rows):
        before = ef.clone()
        out = real_round(layout, ef, g, kind, rows)
        ctl["ef_written"] |= not torch.equal(ef, before)
        return out

    def flaky_k1(*args, **kw):
        wrote, ctl["ef_written"] = ctl["ef_written"], False
        if ctl["armed"] and wrote:
            ctl["armed"] = False
            ctl["fired"] += 1
            raise RuntimeError("K1 failed after the EF rounds")
        return real_k1(*args, **kw)

    monkeypatch.setattr(engine_mod, "_ef_round", spy_round)
    monkeypatch.setattr(agg_ops, "aggregate_adam_multijob_fused", flaky_k1)
    opts = dict(fleet_tick=fleet_tick)
    twin, teng = _sharded(True, comp, engine=dict(opts), snapshot_interval=4)
    _drive(teng, 6, True)
    rt, eng = _sharded(True, comp, engine=dict(opts), snapshot_interval=4)
    _drive(eng, 3, True)
    ctl["armed"] = True
    _drive(eng, 3, True)
    assert ctl["fired"] == 1 and not ctl["armed"]
    assert eng.stats.n_rollbacks >= 1 and eng.stats.n_quarantines == 0
    if fleet_tick == "fused":
        assert eng.stats.n_fleet_fallbacks == 1
    assert float(rt.arena["ef"].abs().max()) > 0
    _assert_bits(rt, twin)
    _views_ok(rt)


@pytest.mark.parametrize("seed", [1, 3])
def test_chaos_mixed_compression_stays_quarantine_free(seed):
    """Seeded transient schedules over a mixed compressed/plain fleet
    recover in place and land on the fault-free twin bit for bit."""
    comp = {"a": "int8", "b": "bf16"}
    inj = FaultInjector(seed=seed)
    rt, eng = _sharded(True, comp, engine={}, fault_injector=inj,
                       snapshot_interval=4, max_apply_retries=3)
    twin, teng = _sharded(True, comp, engine={}, snapshot_interval=4)
    inj.random_apply_faults(3, rt.shard_ids, max_at=15)
    _drive(eng, 10, True)
    _drive(teng, 10, True)
    assert eng.stats.n_quarantines == 0
    assert set(eng.shard_health().values()) == {HEALTHY}
    _assert_bits(rt, twin)
    if inj.n_fired:
        assert eng.stats.n_rollbacks >= 1
    _views_ok(rt)


def test_rollback_to_a_snapshot_before_the_widening_zeroes_ef():
    """A lane snapshot taken before the fleet gained ``ef`` restores it as
    zeros (it was all zero then), written into the views, never rebound."""
    inj = FaultInjector()
    rt, eng = _sharded(True, {}, engine={}, fault_injector=inj,
                       snapshot_interval=8)
    _drive(eng, 1, True)  # every lane snapshots flat/mu/nu
    rt._widen_ef()
    _views_ok(rt)
    rt.arena["ef"].fill_(3.0)
    sid = rt.shard_ids[0]
    lane = eng._lanes[sid]
    assert "ef" not in lane.snapshot
    eng._rollback_lane(lane)
    _views_ok(rt)
    assert float(rt.states[sid]["ef"].abs().max()) == 0.0
    other = rt.states[rt.shard_ids[1]]["ef"]
    assert float(other.min()) == 3.0  # other lanes untouched


def test_widening_allocates_ef_without_touching_flat_mu_nu():
    """``_widen_ef`` on a live fleet adds a zero ``ef`` arena and a view
    per shard; flat/mu/nu keep their storage and values.  A rebound
    ``ef`` (a fresh tensor in a lane) is what ``_views_ok`` catches."""
    rt, eng = _sharded(True, {}, engine={})
    _drive(eng, 2, True)
    before = {k: (v.data_ptr(), v.clone()) for k, v in rt.arena.items()}
    rt._widen_ef()
    rt._widen_ef()  # a no-op the second time
    for k, (ptr, vals) in before.items():
        assert rt.arena[k].data_ptr() == ptr and torch.equal(rt.arena[k], vals)
    assert torch.equal(rt.arena["ef"], torch.zeros_like(rt.arena["flat"]))
    _views_ok(rt)
    sid = rt.shard_ids[0]
    rt.states[sid]["ef"] = rt.states[sid]["ef"].clone()
    with pytest.raises(AssertionError):
        _views_ok(rt)


def test_compressed_replan_and_arrival_keep_ef_views_and_bits():
    """A compressed job arrives at a live fleet (the replan allocates the
    ef arena), the fleet scales out and in, and the fused engine stays
    bit for bit with its per-shard twin, every leaf a view throughout."""
    rt_f, eng_f = _sharded(True, {}, n_shards=2, engine={})
    rt_o, eng_o = _sharded(True, {}, n_shards=2,
                           engine=dict(fleet_tick="per_shard"))
    tree_z = _tree(9, (40, 24))
    tz = {"target": tree_from_numpy(
        {k: np.ones_like(v) for k, v in tree_z.items()}, "cpu")}
    for rt in (rt_f, rt_o):
        rt.add_job("z", tree_from_numpy(tree_z, "cpu"), _loss_torch,
                   lr=0.05, required_servers=2,
                   agg_throughput=sum(4 * v.size for v in tree_z.values())
                   / 0.2, push_compression="int8")
        _views_ok(rt)
    for r in range(6):
        if r == 2:
            rt_f.service.scale_out(1)
            rt_o.service.scale_out(1)
        if r == 4:
            rt_f.service.scale_in(1)
            rt_o.service.scale_in(1)
        for eng in (eng_f, eng_o):
            eng.step("z", tz)
            for j in TREES:
                eng.step(j, _batch(j, True))
            eng.drain()
        _views_ok(rt_f)
    _assert_bits(rt_f, rt_o)
