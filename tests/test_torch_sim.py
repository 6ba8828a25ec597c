"""The port's trace and cluster simulator (``repro_torch.sim``) against the
reference's (``repro.sim``): ``tests/test_sim.py``'s tests, each run on
both packages with the same ``SimConfig`` and trace, the two
``SimResult`` equal field for field, and the reference test's property
asserted on the port's.  The two long configurations (400 and 250 jobs,
the paper's Fig. 11 claims) are in ``test_torch_paper_claims.py``, run
through :func:`run_both_in_parallel`.
"""

import dataclasses
import functools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

import repro.sim as jsim
import repro_torch.sim as tsim


def same_trace(n_jobs, seed, **kw):
    """Both packages' traces; they must agree field for field."""
    jt = jsim.philly_like_trace(n_jobs=n_jobs, seed=seed, **kw)
    tt = tsim.philly_like_trace(n_jobs=n_jobs, seed=seed, **kw)
    assert [dataclasses.asdict(j) for j in tt] == [
        dataclasses.asdict(j) for j in jt]
    return jt, tt


def run_both(n_jobs=120, seed=3, **cfg):
    """(port SimResult, reference SimResult) of one configuration, after
    asserting them equal field for field."""
    jt, tt = same_trace(n_jobs, seed)
    want = jsim.ClusterSimulator(jsim.SimConfig(**cfg)).run(jt)
    got = tsim.ClusterSimulator(tsim.SimConfig(**cfg)).run(tt)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    return got, want


def reference_result(n_jobs, seed, cfg):
    """The reference's ``SimResult`` of one configuration, as a dict."""
    trace = jsim.philly_like_trace(n_jobs=n_jobs, seed=seed)
    return dataclasses.asdict(
        jsim.ClusterSimulator(jsim.SimConfig(**cfg)).run(trace))


def run_both_in_parallel(n_jobs, seed, **cfg):
    """:func:`run_both` for a long configuration: the reference runs in a
    spawned child process while the port runs here, so the test takes
    one simulation's time.  Returns the port's ``SimResult``."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as pool:
        want = pool.submit(reference_result, n_jobs, seed, cfg)
        got = tsim.ClusterSimulator(tsim.SimConfig(**cfg)).run(
            tsim.philly_like_trace(n_jobs=n_jobs, seed=seed))
        assert dataclasses.asdict(got) == want.result(timeout=1200)
    return got


@functools.lru_cache(maxsize=None)
def default_run():
    """``tests/test_sim.py``'s ``_run()``: 120 jobs, seed 3, 2 clusters."""
    return run_both(n_clusters=2)


@functools.lru_cache(maxsize=None)
def plans_run():
    return run_both(n_jobs=40, seed=3, n_clusters=2, track_plans=True)


def test_trace_and_windows_equal_reference():
    jt, tt = same_trace(40, 7)
    jw = jsim.trace.window_schedule(jt, 120.0, max_windows=9)
    tw = tsim.trace.window_schedule(tt, 120.0, max_windows=9)
    assert [dataclasses.asdict(w) for w in tw] == [
        dataclasses.asdict(w) for w in jw]


def test_simulator_deterministic():
    a, _ = default_run()
    b = tsim.ClusterSimulator(tsim.SimConfig(n_clusters=2)).run(
        tsim.philly_like_trace(n_jobs=120, seed=3))
    assert a.allocated == b.allocated
    assert a.cpu_time_saving == b.cpu_time_saving


def test_all_jobs_complete():
    res, _ = default_run()
    assert res.n_jobs_done == 120


def test_loss_limit_respected():
    res, _ = default_run()
    assert res.max_loss_seen <= 0.1 + 1e-9


def test_allocated_never_negative_and_bounded():
    res, _ = default_run()
    assert all(a >= 0 for a in res.allocated)
    assert all(a <= tsim.SimConfig().total_budget for a in res.allocated)


def test_simulator_config_not_shared():
    a, b = tsim.ClusterSimulator(), tsim.ClusterSimulator()
    assert a.cfg is not b.cfg
    a.cfg.total_budget = 1
    assert b.cfg.total_budget != 1
    assert dataclasses.asdict(tsim.SimConfig()) == dataclasses.asdict(
        jsim.SimConfig())


def test_simulator_tracks_compiled_plans():
    res, _ = plans_run()
    assert res.n_replans > 0
    assert res.migration_bytes_total >= 0
    assert res.padding_waste and all(0.0 <= w < 1.0
                                     for w in res.padding_waste)


def test_simulator_tracks_delta_migration_and_touched_stalls():
    res, _ = plans_run()
    assert res.relayout_bytes_total >= 0
    assert 0 <= res.replan_stalled_jobs <= res.replan_coresident_jobs
    assert res.replan_coresident_jobs > 0
    assert 0.0 <= res.replan_stall_free_fraction <= 1.0
    res_off, _ = run_both(n_jobs=40, seed=3, n_clusters=2)
    assert res_off.relayout_bytes_total == 0
    assert res_off.replan_coresident_jobs == 0
    assert res_off.replan_stall_free_fraction == 1.0


def test_engine_wire_and_read_accounting_equal_reference():
    """The tick, wire and read-tier models the simulator's accounting
    adds, on both packages (the port's ``compression.wire_bytes``)."""
    res, _ = run_both(n_jobs=30, seed=5, n_clusters=2, tick_interval=0.5,
                      push_compression="int8", pull_interval=30.0,
                      pull_dirty_fraction=0.25, read_qps=20.0,
                      n_read_replicas=2)
    assert res.update_passes_batched <= res.update_passes_sequential
    assert 0 < res.push_bytes_wire < 0.5 * res.push_bytes_raw
    assert res.reads_served > 0
    assert np.isfinite(res.read_staleness_seconds)
