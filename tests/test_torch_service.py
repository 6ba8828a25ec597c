"""The slice as a whole: the port's ServiceRuntime + ServiceTickEngine held
against the reference's, and the port's own invariants.

Both packages run one shared service with two MLP jobs (the model of
``examples/multi_job_service.py``, weights made with numpy and carried
across by ``tree_from_numpy``); a third job arrives at tick 5 and exits at
tick 10; identical numpy gradients go in through ``submit_push``.  The
reference runs eagerly (``jit=False``), which is the path its engine
takes on the CPU, so its ticks do the port's arithmetic op for op: the
states must agree within the 1-ulp budget (the bias-correction power is
the one scalar the two packages may round differently), migrations are
copies and must move the same bytes, and the engine counters must be
equal.  Losses through ``engine.step`` go through two frameworks' matrix
products, so they are held at rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ParameterService as JService
from repro.ps.service_runtime import ServiceRuntime as JRuntime
from repro_torch.core import ParameterService as TService
from repro_torch.ps.faults import EngineQuarantinedError, FaultInjector
from repro_torch.ps.runtime import state_from_numpy, tree_from_numpy
from repro_torch.ps.service_runtime import ServiceRuntime as TRuntime

ULP_BUDGET = 1


def ulp_diff(a, b) -> int:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


# ------------------------------------------------------------------ jobs
def mlp_init(seed, d_in=16):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"w1": (rng.standard_normal((d_in, 64)) / 4.0).astype(f32),
            "b1": np.zeros(64, f32),
            "w2": (rng.standard_normal((64, 64)) / 8.0).astype(f32),
            "b2": np.zeros(64, f32),
            "w3": (rng.standard_normal((64, 1)) / 8.0).astype(f32),
            "b3": np.zeros(1, f32)}


def mlp_loss_jax(params, batch):
    h = jnp.tanh(batch["x"] @ params["w1"] + params["b1"])
    h = jnp.tanh(h @ params["w2"] + params["b2"])
    pred = (h @ params["w3"] + params["b3"])[:, 0]
    return jnp.mean((pred - batch["y"]) ** 2)


def mlp_loss_torch(params, batch):
    h = torch.tanh(batch["x"] @ params["w1"] + params["b1"])
    h = torch.tanh(h @ params["w2"] + params["b2"])
    pred = (h @ params["w3"] + params["b3"])[:, 0]
    return torch.mean((pred - batch["y"]) ** 2)


def _throughput(tree, busy):
    return sum(4 * v.size for v in tree.values()) / busy


JOBS = {"mlp_a": (mlp_init(0), 3e-3), "mlp_b": (mlp_init(1), 1e-3)}
PROBE = mlp_init(7, d_in=8)


def _add(rts, jid, params, lr, required, busy):
    jrt, trt = rts
    jrt.add_job(jid, jax.tree_util.tree_map(jnp.asarray, params),
                mlp_loss_jax, required_servers=required, lr=lr,
                agg_throughput=_throughput(params, busy))
    trt.add_job(jid, tree_from_numpy(params, "cpu"), mlp_loss_torch,
                required_servers=required, lr=lr,
                agg_throughput=_throughput(params, busy))


def _both(engine_opts, pad=128):
    jrt = JRuntime(JService(total_budget=16, n_clusters=1, plan_pad_to=pad),
                   jit=False)
    trt = TRuntime(TService(total_budget=16, n_clusters=1, plan_pad_to=pad),
                   device="cpu")
    jeng = jrt.attach_engine(jit=False, **engine_opts)
    teng = trt.attach_engine(**engine_opts)
    for jid, (params, lr) in JOBS.items():
        _add((jrt, trt), jid, params, lr, required=2, busy=0.45)
    return (jrt, trt), (jeng, teng)


def _assert_states(jrt, trt):
    assert trt.plan.total_len == jrt.plan.total_len
    for name in ("flat", "mu", "nu"):
        assert ulp_diff(trt.state[name].numpy(),
                        np.asarray(jrt.state[name])) <= ULP_BUDGET, name
    assert trt.state["counts"] == {
        j: int(c) for j, c in jrt.state["counts"].items()}


def test_service_matches_reference_through_arrival_and_exit():
    (jrt, trt), (jeng, teng) = _both(dict(max_staleness=1))
    rng = np.random.default_rng(42)
    live = dict(JOBS)
    for tick in range(14):
        if tick == 5:
            _add((jrt, trt), "probe", PROBE, 3e-3, required=1, busy=0.6)
            live["probe"] = (PROBE, 3e-3)
        if tick == 10:
            jrt.remove_job("probe")
            trt.remove_job("probe")
            live.pop("probe")
        if tick in (5, 10):
            assert trt.last_relayout_bytes == jrt.last_relayout_bytes
            assert trt.last_migration_bytes == jrt.last_migration_bytes
            assert trt.last_replan_touched == jrt.last_replan_touched
            _assert_states(jrt, trt)
        for jid, (params, _) in live.items():
            g = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                 for k, v in params.items()}
            jeng.submit_push(jid, jax.tree_util.tree_map(jnp.asarray, g))
            teng.submit_push(jid, tree_from_numpy(g, "cpu"))
        assert teng.tick() == jeng.tick()
    jeng.drain()
    teng.drain()
    _assert_states(jrt, trt)
    assert jrt.n_replans == trt.n_replans >= 2
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    assert teng.stats.n_per_job_dispatch > 0  # below the crossover too
    assert trt.debug_stats()["runtime"]["relayout_bytes_total"] == \
        jrt.debug_stats()["runtime"]["relayout_bytes_total"]


def test_state_from_numpy_carries_reference_state():
    (jrt, trt), _ = _both(dict(max_staleness=0))
    got = state_from_numpy(jrt.state, "cpu")
    for name in ("flat", "mu", "nu"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      trt.state[name].numpy())
    assert got["counts"] == trt.state["counts"]


def test_mlp_losses_track_reference():
    (jrt, trt), (jeng, teng) = _both(dict(max_staleness=1))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((256, 16)).astype(np.float32)
    y = np.sin(x.sum(1)).astype(np.float32)
    jl, tl = [], []
    for _ in range(20):
        for jid in JOBS:
            sel = rng.integers(0, 256, size=64)
            jl.append(float(jeng.step(jid, {"x": jnp.asarray(x[sel]),
                                             "y": jnp.asarray(y[sel])})["loss"]))
            tl.append(float(teng.step(jid, {"x": torch.from_numpy(x[sel]),
                                             "y": torch.from_numpy(y[sel])}
                                      )["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.mean(tl[-10:]) < np.mean(tl[:10])


# ------------------------------------------------ the port's own invariants
TARGET_SIZES = {"a": (48, 16, 32), "b": (40, 17, 8)}
PROBE_SIZES = (29,)


def _quad_tree(seed, sizes):
    rng = np.random.default_rng(seed)
    return {f"t{i}": torch.from_numpy(rng.standard_normal(n)
                                      .astype(np.float32))
            for i, n in enumerate(sizes)}


def _quad_loss(params, batch):
    return sum(torch.sum((params[k] - batch["target"][k]) ** 2)
               for k in params)


def _port_runtime(engine=None, **step_opts):
    rt = TRuntime(TService(total_budget=16, n_clusters=1, plan_pad_to=16),
                  device="cpu")
    eng = rt.attach_engine(**engine) if engine is not None else None
    for i, (jid, sizes) in enumerate(TARGET_SIZES.items()):
        tree = _quad_tree(i, sizes)
        rt.add_job(jid, tree, _quad_loss, lr=0.05, required_servers=2,
                   agg_throughput=sum(4 * v.numel() for v in tree.values())
                   / 0.45, **step_opts)
    return rt, eng


def _drive(rt, eng=None, n_steps=14, **step_opts):
    """Step all jobs n times; a probe job arrives at 5 and exits at 10."""
    probe = _quad_tree(7, PROBE_SIZES)
    step = eng.step if eng is not None else rt.step
    for i in range(n_steps):
        if i == 5:
            rt.add_job("probe", probe, _quad_loss, lr=0.05,
                       required_servers=1, agg_throughput=4 * 29 / 0.6,
                       **step_opts)
        if i == 10:
            rt.remove_job("probe")
        for jid in rt.job_ids:
            params = rt.params_of(jid)
            step(jid, {"target": {k: torch.ones_like(v)
                                  for k, v in params.items()}})
    if eng is not None:
        eng.drain()
    return rt


@pytest.mark.parametrize("fused_kernel", [False, True])
def test_batched_tick_bit_exact_vs_sequential_block_steps(fused_kernel):
    """Engine ticks (one launch for 3 pending jobs, per-job launches for
    2) equal sequential block steps bit for bit, through two replans.
    ``fused_kernel`` is accepted for the reference's signature; the block
    step runs K3 for either value."""
    rt_seq = _drive(_port_runtime(fused_kernel=fused_kernel)[0],
                    fused_kernel=fused_kernel)
    rt_eng, eng = _port_runtime(engine=dict(max_staleness=0))
    _drive(rt_eng, eng)
    assert rt_seq.n_replans == rt_eng.n_replans >= 2
    assert eng.stats.n_ticks < eng.stats.n_applied
    assert eng.stats.n_per_job_dispatch > 0
    # Below the crossover each of the two pending jobs is its own
    # launch; at three pending jobs the tick is one launch.
    assert eng.stats.n_launches == (eng.stats.n_ticks
                                    + eng.stats.n_per_job_dispatch)
    for name in ("flat", "mu", "nu"):
        torch.testing.assert_close(rt_eng.state[name], rt_seq.state[name],
                                   rtol=0, atol=0)


def test_masked_step_matches_block_step():
    rt_block = _drive(_port_runtime()[0])
    rt_masked = _drive(_port_runtime(update_mode="masked")[0],
                       update_mode="masked")
    for name in ("flat", "mu", "nu"):
        torch.testing.assert_close(rt_masked.state[name],
                                   rt_block.state[name], rtol=0, atol=0)


def test_gather_migration_matches_delta():
    """At staleness 0 (every pull sees its job's pushes applied) the
    gather path's full drains and the delta path's partial ones leave
    the same trajectory."""
    rt_delta, eng_delta = _port_runtime(engine=dict(max_staleness=0))
    _drive(rt_delta, eng_delta)
    rt_gather = TRuntime(TService(total_budget=16, n_clusters=1,
                                  plan_pad_to=16), device="cpu",
                         migration="gather")
    eng = rt_gather.attach_engine(max_staleness=0)
    for i, (jid, sizes) in enumerate(TARGET_SIZES.items()):
        tree = _quad_tree(i, sizes)
        rt_gather.add_job(jid, tree, _quad_loss, lr=0.05, required_servers=2,
                          agg_throughput=sum(4 * v.numel()
                                             for v in tree.values()) / 0.45)
    _drive(rt_gather, eng)
    assert rt_gather.n_replans == rt_delta.n_replans >= 2
    for name in ("flat", "mu", "nu"):
        torch.testing.assert_close(rt_gather.state[name],
                                   rt_delta.state[name], rtol=0, atol=0)


def test_epoch_fence_violation_raises():
    rt, eng = _port_runtime(engine=dict(max_staleness=1))
    eng.submit_push("a", {k: torch.ones_like(v)
                          for k, v in rt.params_of("a").items()})
    eng._epoch += 1  # a replan that migrated "a" without draining it
    with pytest.raises(RuntimeError, match="epoch fence"):
        eng.tick()


def test_fail_apply_rollback_replays_to_fault_free_state():
    clean_rt, clean_eng = _port_runtime(engine=dict(max_staleness=0))
    _drive(clean_rt, clean_eng)
    inj = FaultInjector(seed=0)
    inj.fail_apply(at=4)
    rt, eng = _port_runtime(engine=dict(max_staleness=0, snapshot_interval=2,
                                        fault_injector=inj))
    _drive(rt, eng)
    assert eng.stats.n_rollbacks == 1 and eng.stats.n_replayed > 0
    for name in ("flat", "mu", "nu"):
        torch.testing.assert_close(rt.state[name], clean_rt.state[name],
                                   rtol=0, atol=0)


def test_repeated_failures_quarantine():
    inj = FaultInjector(seed=0)
    inj.fail_apply(at=1, times=5)
    rt, eng = _port_runtime(engine=dict(max_staleness=0, fault_injector=inj))
    eng.submit_push("a", {k: torch.ones_like(v)
                          for k, v in rt.params_of("a").items()})
    with pytest.raises(EngineQuarantinedError):
        eng.drain()


def test_snapshot_and_pull_do_not_alias_live_state():
    rt, eng = _port_runtime(engine=dict(max_staleness=0))
    eng.submit_push("a", {k: torch.ones_like(v)
                          for k, v in rt.params_of("a").items()})
    eng.tick()  # takes the snapshot, then applies in place
    snap = eng._snapshot[0]
    kept = {k: snap[k].clone() for k in ("flat", "mu", "nu")}
    pulled = eng.pull("a")
    pulled_kept = {k: v.clone() for k, v in pulled.items()}
    for k in ("flat", "mu", "nu"):
        rt.state[k].add_(1.0)
    for k in kept:
        torch.testing.assert_close(snap[k], kept[k], rtol=0, atol=0)
    for k in pulled:
        torch.testing.assert_close(pulled[k], pulled_kept[k], rtol=0, atol=0)


def test_default_device_is_the_card():
    """No ``device=`` means CUDA; without a card that raises instead of
    running quietly on the CPU."""
    svc = TService(total_budget=16, n_clusters=1, plan_pad_to=16)
    if torch.cuda.is_available():
        assert TRuntime(svc).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TRuntime(svc)


def test_parts_outside_the_slice_raise():
    """What earlier slices refused runs now: versioned pulls, compressed
    pushes (item 4) and leases (item 9)."""
    rt, eng = _port_runtime(engine=dict(max_staleness=0))
    eng.pull("a", since_version=0)
    rt.add_job("c", _quad_tree(3, (8,)), _quad_loss,
               push_compression="int8")
    assert "ef" in rt.state
    eng2 = TRuntime(TService(total_budget=16, n_clusters=1), device="cpu"
                    ).attach_engine(lease_interval=1.0)
    assert eng2.lease_interval == 1.0 and eng2.expire_leases() == ()
