"""The port's control plane (``repro_torch.core``) against the reference's
(``repro.core``): ``tests/test_core_assignment.py``'s unit and property
tests, each run on both packages on the same inputs.  The two results
must be equal (dataclasses compared field for field), and the reference
test's property is asserted on the port's.  Cyclic schedules and
late-request outcomes (``cyclic``), the Appendix-C evaluator and the
exact solver (``ip_model``) and the job and server profilers
(``profiler``) are the port's copies of this PR; Pseudocode 1,
scaling, the loss model and the migration protocol were ported before.
"""

import dataclasses
import enum
import math
import random
from types import SimpleNamespace

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # fallback shim; see requirements-dev.txt
    from _hypothesis_shim import given, settings, strategies as st

import repro.core as jcore
import repro.core.cyclic as jcyclic
import repro.core.ip_model as jip
import repro.core.migration as jmig
import repro.core.perf_model as jperf
import repro.core.profiler as jprof
import repro.core.scaling as jscaling
import repro_torch.core as tcore
import repro_torch.core.cyclic as tcyclic
import repro_torch.core.ip_model as tip
import repro_torch.core.migration as tmig
import repro_torch.core.perf_model as tperf
import repro_torch.core.profiler as tprof
import repro_torch.core.scaling as tscaling

PORT = SimpleNamespace(core=tcore, cyclic=tcyclic, ip=tip, mig=tmig,
                       perf=tperf, prof=tprof, scaling=tscaling)
REF = SimpleNamespace(core=jcore, cyclic=jcyclic, ip=jip, mig=jmig,
                      perf=jperf, prof=jprof, scaling=jscaling)


def plain(x):
    """Dataclasses, enums and containers as plain values, so results of
    the two packages compare with ``==``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, enum.Enum):
        return x.name
    return x


def both(fn):
    """``fn(ns)`` on both packages; equal results; returns the port's."""
    got, want = fn(PORT), fn(REF)
    assert plain(got) == plain(want)
    return got


def _job(ns, job_id, duration, exec_times, n_workers=2, required=1):
    tasks = [ns.core.AggTask(job_id, i, f"t{i}", nbytes=int(e * 1e9),
                             exec_time=e)
             for i, e in enumerate(exec_times)]
    return ns.core.JobProfile(job_id, "m", duration, tasks, n_workers,
                              required)


def _alloc_factory(ns):
    counter = [0]

    def alloc():
        counter[0] += 1
        return ns.core.Aggregator(agg_id=f"a{counter[0]}")

    return alloc


def _assign(ns, jobs):
    aggs, alloc = [], _alloc_factory(ns)
    for args in jobs:
        ns.core.assign_job(_job(ns, *args), aggs, alloc)
    return aggs


def _admit(ns, jobs):
    aggs, running, alloc = [], {}, _alloc_factory(ns)
    for job in jobs:
        ns.scaling.admit_job(job, aggs, running, alloc)
        running[job.job_id] = job
    return aggs, running


def _loads(aggs):
    return sorted((a.agg_id, a.busy_time(), a.cycle, len(a.tasks))
                  for a in aggs)


# ---------------------------------------------------------------- cyclic math
def test_paper_toy_example_cycles():
    got = both(lambda ns: (ns.core.iterations_per_cycle(12.0, 6.0),
                           ns.core.effective_iteration(12.0, 6.0),
                           ns.core.cyclic_loss(12.0, 6.0)))
    assert got == (2, 6.0, 0.0)


def test_paper_17pct_loss_example():
    d, loss = both(lambda ns: (ns.core.effective_iteration(12.0, 5.0),
                               ns.core.cyclic_loss(12.0, 5.0)))
    assert d == 6.0
    assert abs(loss - 1.0 / 6.0) < 1e-12


@given(cycle=st.floats(0.01, 1e3), duration=st.floats(0.01, 1e3))
def test_effective_iteration_invariants(cycle, duration):
    c = max(cycle, duration)
    d, reps, loss = both(lambda ns: (
        ns.core.effective_iteration(c, duration),
        ns.core.iterations_per_cycle(c, duration),
        ns.core.cyclic_loss(c, duration)))
    assert d >= duration - 1e-9
    assert reps * d == pytest.approx(c)
    assert 0.0 <= loss < 1.0


# ------------------------------------------------------------- Pseudocode 1
def test_assignment_packs_when_it_fits():
    aggs = both(lambda ns: _loads(_assign(
        ns, [("j1", 1.0, [0.3, 0.2]), ("j2", 1.0, [0.25, 0.15])])))
    assert len(aggs) == 1
    assert aggs[0][1] <= 1.0 + 1e-9


def test_assignment_spills_on_capacity():
    aggs = both(lambda ns: _loads(_assign(
        ns, [("j1", 1.0, [0.7]), ("j2", 1.0, [0.7])])))
    assert len(aggs) == 2


def test_assignment_rejects_cyclic_loss():
    aggs = both(lambda ns: _loads(_assign(
        ns, [("slow", 12.0, [0.5]), ("fast", 5.0, [0.1])])))
    assert len(aggs) == 2


def test_assignment_accepts_harmonic_periods():
    aggs = both(lambda ns: _loads(_assign(
        ns, [("slow", 12.0, [0.5]), ("fast", 6.0, [0.1])])))
    assert len(aggs) == 1


def test_best_fit_prefers_fullest_fitting_aggregator():
    def run(ns):
        aggs, alloc, sizes = [], _alloc_factory(ns), []
        for jid, e in (("j1", 0.6), ("j2", 0.2), ("j3", 0.5), ("j4", 0.15)):
            ns.core.assign_job(_job(ns, jid, 1.0, [e]), aggs, alloc)
            sizes.append(len(aggs))
        return sizes, sorted(a.busy_time() for a in aggs)

    sizes, loads = both(run)
    assert sizes == [1, 1, 2, 2]
    assert loads == pytest.approx([0.5, 0.95])


@settings(deadline=None, max_examples=60)
@given(execs=st.lists(st.floats(0.01, 0.5), min_size=1, max_size=12),
       duration=st.floats(0.5, 4.0))
def test_assignment_never_overloads(execs, duration):
    def run(ns):
        aggs = []
        ns.core.assign_job(_job(ns, "j", duration, execs), aggs,
                           _alloc_factory(ns))
        return [(a.busy_time(), a.capacity, a.cycle, len(a.tasks))
                for a in aggs]

    for busy, capacity, cycle, _ in both(run):
        assert busy <= capacity * cycle + 1e-9
    assert sum(n for *_, n in both(run)) == len(execs)


@settings(deadline=None, max_examples=25)
@given(n_jobs=st.integers(1, 4), seed=st.integers(0, 10_000))
def test_multi_job_losses_bounded(n_jobs, seed):
    def run(ns):
        rng = random.Random(seed)
        jobs = []
        for i in range(n_jobs):
            duration = rng.choice([0.5, 1.0, 2.0, 4.0])
            execs = [rng.uniform(0.02, 0.3)
                     for _ in range(rng.randint(1, 8))]
            jobs.append(_job(ns, f"j{i}", duration, execs))
        aggs, running = _admit(ns, jobs)
        return ns.perf.predict_all_losses(running, aggs)

    losses = both(run)
    assert max(losses.values()) < tcore.AssignmentConfig().loss_limit + 1e-9


# ------------------------------------------------------ balanced vs RR shards
def test_balanced_beats_round_robin_on_skew():
    def run(ns):
        job = _job(ns, "j", 1.0, [0.5, 0.04, 0.04, 0.3, 0.02, 0.1])
        return (ns.core.shard_imbalance(
                    ns.core.round_robin_shard_assignment(job, 2)),
                ns.core.shard_imbalance(
                    ns.core.balanced_shard_assignment(job, 2)))

    rr, bal = both(run)
    assert bal <= rr
    assert bal < 1.1


# ------------------------------------------------------------------- scaling
def test_job_exit_recycles_aggregators():
    def run(ns):
        aggs, jobs = _admit(ns, [_job(ns, f"j{i}", 1.0, [0.4])
                                 for i in range(3)])
        before = len(aggs)
        jobs.pop("j0")
        ns.scaling.release_job("j0", aggs, jobs)
        return before, len(aggs)

    assert both(run) == (2, 1)


def test_recycle_respects_loss_limit():
    def run(ns):
        aggs, jobs = _admit(ns, [_job(ns, "slow", 12.0, [0.5]),
                                 _job(ns, "fast", 5.0, [0.4])])
        return len(aggs), ns.scaling.recycle_aggregators(aggs, jobs), len(aggs)

    assert both(run) == (2, 0, 2)


# ----------------------------------------------------------------- outliers
def _schedule(ns, execs, duration=1.0):
    agg = ns.core.Aggregator("a0")
    for t in _job(ns, "j", duration, execs).tasks:
        agg.add_task(t, duration)
    return ns.cyclic.build_schedule(agg)


def test_late_request_executes_in_spare_slots():
    def run(ns):
        sched = _schedule(ns, [0.2, 0.1])
        return sched, sched.utilization, ns.cyclic.admit_late_request(
            sched, arrival=0.5, exec_time=0.1)

    _, util, out = both(run)
    assert util == pytest.approx(0.3)
    assert out.executed_now and out.postponed_iterations == 0


def test_late_request_postpones_when_full():
    def run(ns):
        sched = _schedule(ns, [0.5, 0.45])
        return sched, ns.cyclic.admit_late_request(sched, arrival=0.9,
                                                   exec_time=0.3)

    _, out = both(run)
    assert not out.executed_now
    assert out.postponed_iterations == 1


def test_cyclic_schedule_of_packed_jobs_equals_reference():
    """Two jobs of harmonic periods on one Aggregator: the EDF timetable,
    its slots' ends and free time after each slot."""
    def run(ns):
        agg = ns.core.Aggregator("a0")
        for job in (_job(ns, "slow", 12.0, [0.5, 0.25]),
                    _job(ns, "fast", 6.0, [0.1, 0.2, 0.05])):
            for t in job.tasks:
                agg.add_task(t, job.iteration_duration)
        sched = ns.cyclic.build_schedule(agg)
        return (sched, [s.end for s in sched.slots],
                [sched.free_after(s.end) for s in sched.slots],
                sched.busy_time, sched.utilization)

    sched, ends, free, busy, util = both(run)
    assert sched.cycle == 12.0 and len(sched.slots) == 2 + 2 * 3
    assert busy == pytest.approx(0.75 + 2 * 0.35)
    assert all(f >= 0.0 for f in free) and ends == sorted(ends)


# ---------------------------------------------------------------- migration
def test_migration_protocol_order_enforced():
    def run(ns):
        m = ns.mig.TensorMigration("j", 0, "a0", "a1")
        with pytest.raises(ns.mig.ProtocolError):
            m.advance(ns.mig.MigrationState.COPYING)
        seen = []
        for state in ("INIT", "REPOINTED", "COPYING", "COPY_DONE"):
            m.advance(getattr(ns.mig.MigrationState, state))
            seen.append((m.update_allowed_on("a0"),
                         m.update_allowed_on("a1")))
        m.run_to_completion()
        return seen, m.state.name

    seen, final = both(run)
    assert [a1 for _, a1 in seen] == [False, False, False, True]
    assert seen[-1][0] is False
    assert final == "COMPLETE"


def test_migration_hidden_by_compute_window():
    def run(ns):
        cost = ns.mig.migration_cost(575_000_000, link_bandwidth=12.5e9,
                                     compute_window=0.5)
        naive = ns.mig.checkpoint_restart_cost(575_000_000,
                                               storage_bandwidth=1e9)
        return cost, naive

    cost, naive = both(run)
    assert cost.visible_stall < 0.050
    assert naive > 10.0
    assert naive / max(cost.visible_stall, 1e-9) > 100


# ----------------------------------------------------------------- IP model
def test_heuristic_close_to_bruteforce_optimum():
    def run(ns):
        jobs = [_job(ns, "j1", 2.0, [0.6, 0.3]),
                _job(ns, "j2", 3.0, [0.5, 0.2])]
        best = ns.ip.brute_force(jobs, n_aggregators=2)
        aggs, _ = _admit(ns, jobs)
        ids = {a.agg_id: i for i, a in enumerate(aggs)}
        assignment = {key: ids[a.agg_id] for a in aggs for key in a.tasks}
        return best, ns.ip.evaluate(jobs, assignment, len(aggs))

    best, ev_h = both(run)
    assert best is not None
    assert ev_h.feasible
    assert ev_h.max_loss <= best[1].max_loss + 0.1


def test_ip_evaluate_infeasible_and_incomplete_equal_reference():
    """Over capacity, a task left unplaced, and a lossy pair of periods."""
    def run(ns):
        jobs = [_job(ns, "a", 1.0, [0.7, 0.6]), _job(ns, "b", 5.0, [0.2])]
        keys = [t.key for j in jobs for t in j.tasks]
        over = ns.ip.evaluate(jobs, dict.fromkeys(keys, 0), 1)
        missing = ns.ip.evaluate(jobs, {keys[0]: 0}, 2)
        lossy = ns.ip.evaluate(
            [_job(ns, "slow", 12.0, [0.1]), _job(ns, "fast", 5.0, [0.1])],
            {("slow", 0): 0, ("fast", 0): 0}, 1)
        return over, missing, lossy

    over, missing, lossy = both(run)
    assert not over.feasible
    assert not missing.feasible and math.isinf(missing.max_loss)
    assert lossy.feasible
    assert lossy.per_job_loss["fast"] == pytest.approx(1.0 / 6.0)


def test_brute_force_refuses_large_instances():
    for ns in (PORT, REF):
        jobs = [_job(ns, "j", 1.0, [0.01] * 30)]
        with pytest.raises(ValueError, match="too large"):
            ns.ip.brute_force(jobs, n_aggregators=2)


# ---------------------------------------------------------------- profilers
def test_job_profiler_equals_reference():
    """Median iteration time over stragglers, median per-tensor cost, and
    readiness after three iterations."""
    def run(ns):
        p = ns.prof.JobProfiler("j", model="vgg19", n_workers=4,
                                required_servers=2)
        ready = [p.ready]
        for i, d in enumerate((1.0, 1.2, 9.0, 1.1)):
            p.record_iteration(d)
            ready.append(p.ready)
            for tid, nb in ((0, 4096), (1, 1 << 20)):
                p.record_tensor(tid, nb, 0.01 * (tid + 1) * (1 + 0.1 * i))
        return ready, p.iteration_duration(), p.finalize()

    ready, duration, profile = both(run)
    assert ready == [False, False, False, True, True]
    assert duration == pytest.approx(1.15)
    assert [t.nbytes for t in profile.tasks] == [4096, 1 << 20]
    with pytest.raises(ValueError):
        tprof.JobProfiler("empty").iteration_duration()


def test_server_profiler_window_equals_reference():
    def run(ns):
        s = ns.prof.ServerProfiler("a0", window=10.0)
        seen = []
        for t, b in ((0.0, 0.5), (4.0, 1.0), (9.0, 0.0), (15.0, 0.25)):
            s.record(t, b)
            seen.append(s.utilization())
        return seen, s.samples

    seen, samples = both(run)
    assert seen[:3] == pytest.approx([0.5, 0.75, 0.5])
    assert [t for t, _ in samples] == [9.0, 15.0]


def test_profile_from_bytes_equals_reference():
    def run(ns):
        return ns.prof.profile_from_bytes(
            "j", "bert", [4 << 20, 1 << 10, 96 << 20], iteration_duration=0.8,
            n_workers=2, required_servers=2, agg_throughput=7e9)

    prof = both(run)
    assert [t.exec_time for t in prof.tasks] == pytest.approx(
        [2 * (4 << 20) / 7e9, 2 * (1 << 10) / 7e9, 2 * (96 << 20) / 7e9])
