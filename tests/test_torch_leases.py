"""Job leases and replan transactions of the port, held against the
reference's on the same scenario.

Leases: every push and pull renews a job's lease on an injected clock; a
trainer silent for a whole ``lease_interval`` is reclaimed by
``expire_leases()`` through ``runtime.remove_job`` (the replan path: a
delta through K2), its queued futures raising ``LeaseExpiredError``; a
failed reclaim re-arms the lease.  Transactions (``core/service.py``'s
``_transact``, a copy of the reference's): a replan that fails rolls the
registry back and retries under the service's ``RetryPolicy``, and after
any outcome the control plane and the data plane describe one layout.

Both packages run each scenario (the reference eagerly); expired ids,
deadlines, counters and transaction counts must be equal, and states
within the 1-ulp budget.  Inside the port a recovered trajectory is held
bit for bit against a fault-free twin.  Mirrors ``tests/test_leases.py``
and ``tests/test_transactions.py``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ParameterService as JService
from repro.ps.autoscaler import AutoscalerConfig as JConfig
from repro.ps.autoscaler import ElasticScaler as JScaler
from repro.ps.faults import FaultInjector as JInjector
from repro.ps.faults import LeaseExpiredError as JLeaseExpired
from repro.ps.faults import ReplanAbortedError as JAborted
from repro.ps.faults import RetryPolicy as JRetry
from repro.ps.service_runtime import ServiceRuntime as JRuntime
from repro.ps.service_runtime import ShardedServiceRuntime as JSharded
from repro_torch.core import ParameterService as TService
from repro_torch.core.service import _ReplanFailure
from repro_torch.ps.autoscaler import AutoscalerConfig, ElasticScaler
from repro_torch.ps.faults import (
    EngineQuarantinedError,
    FaultInjector,
    InjectedFault,
    LeaseExpiredError,
    ReplanAbortedError,
    RetryPolicy,
)
from repro_torch.ps.runtime import tree_from_numpy
from repro_torch.ps.service_runtime import ServiceRuntime as TRuntime
from repro_torch.ps.service_runtime import ShardedServiceRuntime as TSharded

ULP_BUDGET = 1


class Clock:
    def __init__(self, now=0.0):
        self.now = float(now)

    def __call__(self):
        return self.now


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


def _conv(port, tree):
    return (tree_from_numpy(tree, "cpu") if port
            else jax.tree_util.tree_map(jnp.asarray, tree))


def _batch(j, port):
    return {"target": _conv(port, TARGETS[j])}


def _grads(j, port):
    return _conv(port, {k: np.ones_like(v) for k, v in TREES[j].items()})


def _add_jobs(rt, port, trees=TREES):
    for jid, t in trees.items():
        rt.add_job(jid, _conv(port, t), _loss_torch if port else _loss_jax,
                   lr=0.05, required_servers=1,
                   agg_throughput=sum(4 * v.size for v in t.values()) / 0.2)


def _sharded(port, n_shards=2, **engine):
    svc = (TService if port else JService)(total_budget=16, n_clusters=1,
                                           plan_pad_to=16)
    rt = TSharded(svc, device="cpu") if port else JSharded(svc, jit=False)
    engine.setdefault("max_staleness", 0)
    eng = (rt.attach_engine(**engine) if port
           else rt.attach_engine(jit=False, **engine))
    _add_jobs(rt, port)
    if n_shards > 1:
        svc.scale_out(n_shards - 1)
    return rt, eng


def _flat(port, **engine):
    svc = (TService if port else JService)(total_budget=16, n_clusters=1,
                                           plan_pad_to=16)
    rt = TRuntime(svc, device="cpu") if port else JRuntime(svc, jit=False)
    engine.setdefault("max_staleness", 0)
    eng = (rt.attach_engine(**engine) if port
           else rt.attach_engine(jit=False, **engine))
    _add_jobs(rt, port)
    return rt, eng


def _opts(port, **kw):
    """Per-package fault injector / retry policy constructors."""
    out = dict(kw)
    if out.pop("injector", False):
        out["fault_injector"] = FaultInjector() if port else JInjector()
    if "retries" in out:
        n = out.pop("retries")
        out["retry_policy"] = (RetryPolicy if port else JRetry)(max_retries=n)
    return out


def _drive(eng, n, port, jobs=TREES):
    for _ in range(n):
        for j in jobs:
            eng.step(j, _batch(j, port))
    eng.drain()


def _agree(rt):
    """Control plane and data plane describe the same layout."""
    assert rt.service.compile_sharded_plan() == rt.splan
    assert set(rt.service._jobs) == set(rt._jobs)


def _assert_bits(rt_a, rt_b):
    assert rt_a.shard_ids == rt_b.shard_ids
    for k in ("flat", "mu", "nu"):
        assert torch.equal(rt_a.arena[k], rt_b.arena[k]), k
    assert rt_a.counts == rt_b.counts


def _assert_ref(trt, jrt):
    assert trt.shard_ids == jrt.shard_ids
    for sid in jrt.shard_ids:
        for k in ("flat", "mu", "nu"):
            assert ulp_diff(trt.states[sid][k].numpy(),
                            np.asarray(jrt.states[sid][k])) <= ULP_BUDGET
    assert trt.counts == {j: int(c) for j, c in jrt.counts.items()}


BUILDS = {"flat": _flat, "sharded": _sharded}


# ---------------------------------------------------------------- renewal
@pytest.mark.parametrize("kind", ["flat", "sharded"])
def test_pushes_and_pulls_renew_the_lease(kind):
    for port in (True, False):
        clock = Clock()
        rt, eng = BUILDS[kind](port, lease_interval=5.0, clock=clock)
        assert eng.lease_deadline("a") is None  # no contact yet
        eng.step("a", _batch("a", port))
        assert eng.lease_deadline("a") == pytest.approx(5.0)
        clock.now = 3.0
        eng.pull("a")
        assert eng.lease_deadline("a") == pytest.approx(8.0)
        clock.now = 4.0
        fut = eng.submit_push("a", _grads("a", port))
        assert eng.lease_deadline("a") == pytest.approx(9.0)
        eng.drain()
        assert fut.done()
        clock.now = 8.9  # an active trainer never expires
        assert eng.expire_leases() == ()
        assert "a" in rt._jobs


@pytest.mark.parametrize("kind", ["flat", "sharded"])
def test_silent_trainer_is_reclaimed_through_the_replan_path(kind):
    """a and b keep pushing, c goes silent: c expires at t = 2 in both
    packages, leaves both planes, and the survivors train on -- the
    port's states within the budget of the reference's."""
    runs = {}
    for port in (True, False):
        clock = Clock()
        rt, eng = BUILDS[kind](port, lease_interval=2.0, clock=clock)
        for j in TREES:
            eng.step(j, _batch(j, port))
        eng.drain()
        got = []
        for t in (1.0, 2.0, 3.0):
            clock.now = t
            eng.step("a", _batch("a", port))
            eng.step("b", _batch("b", port))
            got.append(eng.expire_leases())
        assert got == [(), ("c",), ()]
        assert eng.stats.n_lease_expirations == 1
        assert "c" not in rt._jobs and "c" not in rt.service._jobs
        assert eng.lease_deadline("c") is None
        if kind == "sharded":
            _agree(rt)
        eng.step("a", _batch("a", port))
        eng.drain()
        runs[port] = rt
    trt, jrt = runs[True], runs[False]
    if kind == "sharded":
        _assert_ref(trt, jrt)
    else:
        for k in ("flat", "mu", "nu"):
            assert ulp_diff(trt.state[k].numpy(),
                            np.asarray(jrt.state[k])) <= ULP_BUDGET


def test_lease_interval_validated_and_off_by_default():
    rt, eng = _sharded(True)
    assert eng.lease_interval is None
    assert eng.expire_leases() == ()  # a no-op with leases off
    with pytest.raises(ValueError):
        _sharded(True, lease_interval=0.0)
    with pytest.raises(ValueError):
        _flat(True, lease_interval=-1.0)


# ------------------------------------------------- graceful cancellation
@pytest.mark.parametrize("kind", ["flat", "sharded"])
def test_expired_jobs_queued_futures_raise_lease_expired(kind):
    clock = Clock()
    rt, eng = BUILDS[kind](True, max_staleness=8, lease_interval=2.0,
                           clock=clock)
    fut = eng.submit_push("c", _grads("c", True))
    clock.now = 5.0
    assert eng.expire_leases() == ("c",)
    assert fut.cancelled() and not fut.done()
    with pytest.raises(LeaseExpiredError) as ei:
        fut.result(timeout=1.0)
    assert ei.value.job_id == "c" and "lease" in str(ei.value)
    assert (ei.value.deadline, ei.value.now) == (2.0, 5.0)
    with pytest.raises(LeaseExpiredError):  # the stored error, at once
        fut.result(timeout=30.0)
    with pytest.raises(LeaseExpiredError):
        fut.result()


def test_first_cancellation_keeps_its_context():
    rt, eng = _sharded(True, max_staleness=8)
    fut = eng.submit_push("a", _grads("a", True))
    first = LeaseExpiredError("a", 1.0, 2.0)
    fut._cancel("lease", exc=first)
    fut._cancel("later", exc=RuntimeError("later"))
    with pytest.raises(LeaseExpiredError) as ei:
        fut.result()
    assert ei.value is first


def test_quarantined_lane_future_raises_quarantine_not_timeout():
    """A push stuck behind a lane that died mid-wait raises that lane's
    ``EngineQuarantinedError`` at the deadline, not a bare timeout."""
    inj = FaultInjector()
    rt, eng = _sharded(True, max_staleness=8, fault_injector=inj)
    victim = rt.shard_ids[-1]
    job = next(j for j in TREES
               if victim in rt.splan.job_layout(j).shard_ids)
    inj.kill_shard(victim, at=1)
    fut = eng.submit_push(job, _grads(job, True))
    for _ in range(8):
        if victim in eng.quarantined_shards():
            break
        eng.tick()
    assert victim in eng.quarantined_shards()
    assert not fut.done()
    with pytest.raises(EngineQuarantinedError) as ei:
        fut.result(timeout=0.3)
    assert ei.value.shard_id == victim


def test_reclaim_frees_load_the_autoscaler_sees():
    decisions = []
    for port in (True, False):
        clock = Clock()
        rt, eng = _sharded(port, max_staleness=64, lease_interval=2.0,
                           clock=clock)
        scaler = (ElasticScaler if port else JScaler)(
            rt, (AutoscalerConfig if port else JConfig)(
                shard_capacity=4.0, max_shards=4, cooldown=1))
        for _ in range(8):
            eng.submit_push("c", _grads("c", port))
        assert scaler.queued_pieces() > 0
        clock.now = 5.0
        assert eng.expire_leases() == ("c",)
        assert scaler.queued_pieces() == 0
        d = scaler.observe()
        assert d.action in ("hold", "shrink")
        decisions.append((d.action, d.n_shards_before, d.n_shards_after))
    assert decisions[0] == decisions[1]


def test_failed_reclaim_rearms_the_lease_and_retries():
    for port in (True, False):
        clock = Clock()
        rt, eng = _sharded(port, lease_interval=2.0, clock=clock,
                           **_opts(port, injector=True, retries=0))
        inj = eng.fault_injector
        for j in TREES:
            eng.step(j, _batch(j, port))
        eng.drain()
        inj.fail_migration(at=1, times=math.inf)
        clock.now = 5.0
        with pytest.raises(ReplanAbortedError if port else JAborted):
            eng.expire_leases()
        # Nothing leaked: every job on both planes, the lease re-armed one
        # interval out, so the next sweep tries again.
        for j in TREES:
            assert j in rt._jobs and j in rt.service._jobs
        assert eng.lease_deadline("a") == pytest.approx(7.0)
        assert rt.service.compile_sharded_plan() == rt.splan
        inj.rules.clear()
        clock.now = 8.0
        assert set(eng.expire_leases()) == set(TREES)
        assert not rt._jobs and not rt.service._jobs
        assert eng.stats.n_lease_expirations == 4


def test_reclaim_moves_blocks_through_k2_and_matches_the_gather(
        monkeypatch):
    """The reclaim's replan runs the survivors' deltas through K2 (the
    relayout wrappers are called) and leaves every survivor's parameters
    as they were (the gather oracle)."""
    from repro_torch.kernels.relayout import ops as rl_ops

    calls = []
    real = rl_ops.relayout_scatter

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(rl_ops, "relayout_scatter", counted)
    clock = Clock()
    rt, eng = _sharded(True, n_shards=1, lease_interval=2.0, clock=clock)
    _drive(eng, 2, True)
    sp = rt.splan.shard_of(rt.shard_ids[0])
    first = min(sp.segments, key=lambda seg: seg.offset).job_id
    alive = [j for j in TREES if j != first]
    clock.now = 1.0
    for j in alive:
        eng.step(j, _batch(j, True))
    eng.drain()
    want = {j: rt.params_of(j) for j in alive}
    clock.now = 2.5
    assert eng.expire_leases() == (first,)
    assert calls, "the reclaim moved no block through K2"
    for j, tree in want.items():
        got = rt.params_of(j)
        for k in tree:
            assert torch.equal(got[k], tree[k])


# ----------------------------------------------------------- transactions
def test_retry_policy_backoff_and_budget():
    slept = []
    pol = RetryPolicy(max_retries=3, base_delay=0.1, max_delay=0.25,
                      sleep=slept.append)
    assert pol.should_retry(1) and pol.should_retry(3)
    assert not pol.should_retry(4)
    assert pol.delay(1) == pytest.approx(0.1)
    assert pol.delay(2) == pytest.approx(0.2)
    assert pol.delay(3) == pytest.approx(0.25)  # capped
    for i in (1, 2, 3):
        pol.backoff(i)
    assert slept == pytest.approx([0.1, 0.2, 0.25])
    quiet = RetryPolicy(max_retries=2, sleep=slept.append)
    quiet.backoff(1)  # a zero base delay never sleeps
    assert len(slept) == 3


def test_transient_migration_fault_retries_and_planes_agree():
    """The abort rolls the registry back and the retry lands both planes
    on the new layout together, bit for bit with a fault-free twin and
    within the budget of the reference."""
    runs = {}
    for port in (True, False):
        rt, eng = _sharded(port, **_opts(port, injector=True))
        _drive(eng, 2, port)
        eng.fault_injector.fail_migration(at=1)
        assert rt.service.scale_out(1) == 1
        assert (rt.service.n_replan_aborts,
                rt.service.n_replan_retries) == (1, 1)
        assert rt.n_shards == 3
        _agree(rt)
        _drive(eng, 3, port)
        runs[port] = rt
    twin, teng = _sharded(True)
    _drive(teng, 2, True)
    twin.service.scale_out(1)
    _drive(teng, 3, True)
    _assert_bits(runs[True], twin)
    _assert_ref(runs[True], runs[False])


@pytest.mark.parametrize("after_shards", [None, 1])
def test_persistent_migration_fault_aborts_and_rolls_back(after_shards):
    """A migration that keeps failing (at the boundary, or after one
    shard of the new plan is relaid) aborts after the retries with both
    planes on the OLD layout; training continues bit for bit with a
    fault-free twin."""
    for port in (True, False):
        rt, eng = _sharded(port, **_opts(port, injector=True, retries=2))
        _drive(eng, 2, port)
        eng.fault_injector.fail_migration(at=1, after_shards=after_shards,
                                          times=math.inf)
        with pytest.raises(ReplanAbortedError if port else JAborted) as ei:
            rt.service.scale_out(1)
        assert ei.value.op == "scale_out" and ei.value.attempts == 3
        assert "rolled back" in str(ei.value)
        assert (rt.service.n_replan_aborts,
                rt.service.n_replan_retries) == (3, 2)
        assert rt.n_shards == 2
        _agree(rt)
        eng.fault_injector.rules.clear()
        _drive(eng, 3, port)
        if port:
            assert isinstance(ei.value.original, InjectedFault)
            twin, teng = _sharded(True)
            _drive(teng, 5, True)
            _assert_bits(rt, twin)


def test_register_and_exit_aborts_restore_both_planes():
    for port in (True, False):
        rt, eng = _sharded(port, **_opts(port, injector=True, retries=0))
        _drive(eng, 1, port)
        aborted = ReplanAbortedError if port else JAborted
        eng.fault_injector.fail_migration(at=1, times=math.inf)
        tree_d = _tree(7, (24, 24))
        with pytest.raises(aborted):
            rt.add_job("d", _conv(port, tree_d),
                       _loss_torch if port else _loss_jax, lr=0.05,
                       required_servers=1,
                       agg_throughput=sum(4 * v.size
                                          for v in tree_d.values()) / 0.2)
        assert "d" not in rt._jobs
        _agree(rt)
        with pytest.raises(aborted):
            rt.remove_job("a")
        assert "a" in rt._jobs and "a" in rt.service._jobs
        _agree(rt)
        eng.fault_injector.rules.clear()
        _drive(eng, 2, port)
        rt.remove_job("a")
        _agree(rt)


def test_validation_errors_bypass_retry():
    rt, _ = _sharded(True, n_shards=1)
    with pytest.raises(KeyError):
        rt.service.job_exit("nope")
    with pytest.raises(ValueError):
        rt.service.evacuate_aggregator("c9/a99")
    assert (rt.service.n_replan_aborts, rt.service.n_replan_retries) == (0, 0)


def test_replan_failure_marker_wraps_original():
    boom = RuntimeError("boom")
    assert _ReplanFailure(boom).original is boom


def test_debug_stats_surface_transactions_leases_and_faults():
    stats = {}
    for port in (True, False):
        rt, eng = _sharded(port, **_opts(port, injector=True))
        inj = eng.fault_injector
        inj.fail_apply(None, at=1)
        inj.fail_migration(at=1)
        _drive(eng, 2, port)
        assert rt.service.scale_out(1) == 1
        s = rt.debug_stats()
        assert s["transactions"] == {
            "n_replan_commits": rt.service.n_replan_commits,
            "n_replan_aborts": 1, "n_replan_retries": 1}
        assert s["faults"]["n_fired"] == inj.n_fired >= 2
        assert s["faults"]["by_kind"]["fail_migration"] == 1
        assert s["engine"]["n_lease_expirations"] == 0
        stats[port] = (s["transactions"], s["faults"], s["engine"])
    assert stats[True] == stats[False]
    flat, _ = _flat(True)
    fs = flat.debug_stats()
    assert fs["transactions"]["n_replan_commits"] >= 1
    assert fs["transactions"]["n_replan_aborts"] == 0
    assert fs["faults"] is None
    assert fs["engine"]["n_lease_expirations"] == 0
    assert dataclasses.asdict(flat.engine.stats)["n_lease_expirations"] == 0
