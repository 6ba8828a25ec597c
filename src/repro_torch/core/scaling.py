"""Aggregator scaling (paper §3.3.2).

Job arrival: pack via the assignment scheme; if the predicted performance of
the new job (or any co-located job) is worse than standalone by more than
LossLimit, revert, allocate one more Aggregator, and re-assign the whole job
— repeating until the loss is within bounds (the Fig. 10 case study path).

Job exit: remove the job's tasks, return empty Aggregators, then opportunist-
ically drain the least-loaded Aggregator into the others *without* new
allocations; recycle on success and repeat on the next least-loaded one.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from . import perf_model
from .assignment import (
    AssignmentConfig,
    AggregatorAllocator,
    assign_job,
    assign_task,
    remove_job,
)
from .types import AggTask, Aggregator, JobProfile


def admit_job(
    job: JobProfile,
    aggregators: List[Aggregator],
    jobs: Dict[str, JobProfile],
    allocator: AggregatorAllocator,
    config: AssignmentConfig = AssignmentConfig(),
    max_retries: int = 16,
) -> Tuple[int, int]:
    """Admit a job with the feedback-revert loop.

    Returns (n_new_aggregators, n_retries). `jobs` must already contain every
    running job's profile (used for loss prediction) but NOT the new job.
    """
    jobs_after = dict(jobs)
    jobs_after[job.job_id] = job

    pinned_new = 0  # Aggregators force-allocated by the feedback loop
    retries = 0
    while True:
        n_before = len(aggregators)
        decisions = assign_job(job, aggregators, allocator, config)
        new_from_packing = len(aggregators) - n_before

        losses = perf_model.predict_all_losses(jobs_after, aggregators)
        if max(losses.values(), default=0.0) < config.loss_limit or retries >= max_retries:
            return pinned_new + new_from_packing, retries

        # Revert the whole job, allocate one more dedicated Aggregator, retry
        # (paper: "add a new Aggregator and re-assign the entire job").
        retries += 1
        remove_job(aggregators, job.job_id)
        # Drop any aggregators that became empty from the failed packing.
        aggregators[:] = [a for a in aggregators if not a.is_empty or _is_pinned(a)]
        fresh = allocator()
        fresh.pinned = True  # type: ignore[attr-defined]  # keep across revert
        aggregators.append(fresh)
        pinned_new += 1


def _is_pinned(agg: Aggregator) -> bool:
    return bool(getattr(agg, "pinned", False))


def release_job(
    job_id: str,
    aggregators: List[Aggregator],
    jobs: Dict[str, JobProfile],
    config: AssignmentConfig = AssignmentConfig(),
) -> Tuple[int, int]:
    """Handle job exit. Returns (n_released_empty, n_recycled)."""
    remove_job(aggregators, job_id)
    released = [a for a in aggregators if a.is_empty]
    aggregators[:] = [a for a in aggregators if not a.is_empty]
    recycled = recycle_aggregators(aggregators, jobs, config)
    return len(released), recycled


def recycle_aggregators(
    aggregators: List[Aggregator],
    jobs: Dict[str, JobProfile],
    config: AssignmentConfig = AssignmentConfig(),
    max_rounds: int = 4,
) -> int:
    """Drain least-loaded Aggregators into the rest, no new allocations.

    Paper §3.3.2: "Starting from the least-loaded Aggregator, Parameter
    Service reassigns its workload to other Aggregators without new
    allocations allowed. If it succeeds ... repeat on the next least-loaded."
    `max_rounds` bounds the O(aggs * tasks) trial work per exit event.
    """
    recycled = 0
    while len(aggregators) > 1 and recycled < max_rounds:
        victim = min(aggregators, key=lambda a: a.busy_time())
        survivors = [a for a in aggregators if a is not victim]
        trial = [a.clone() for a in survivors]

        ok = True
        for task in sorted(victim.tasks.values(), key=lambda t: -t.exec_time):
            job = jobs.get(task.job_id)
            if job is None:
                ok = False
                break
            try:
                assign_task(task, job, trial, allocator=_refuse_allocation, config=config)
            except _NoAllocation:
                ok = False
                break
        if ok:
            losses = perf_model.predict_all_losses(jobs, trial)
            ok = max(losses.values(), default=0.0) < config.loss_limit
        if ok and config.preserve_spread:
            # Optional: keep each job's aggregation spread at its parameter-
            # server requirement (pull-bandwidth provisioning). Off by
            # default -- the paper's Fig.-11 savings require consolidation.
            for job in jobs.values():
                hosting = sum(
                    1 for a in trial if any(k[0] == job.job_id for k in a.tasks)
                )
                before = sum(
                    1 for a in aggregators
                    if any(k[0] == job.job_id for k in a.tasks)
                )
                floor = min(job.required_servers, before)
                if hosting < floor:
                    ok = False
                    break

        if not ok:
            return recycled
        # Commit the trial placement.
        aggregators[:] = trial
        recycled += 1
    return recycled


def split_aggregator(
    aggregators: List[Aggregator],
    fresh: Aggregator,
    jobs: Dict[str, JobProfile],
    config: AssignmentConfig = AssignmentConfig(),
) -> bool:
    """Shard split: offload ~half the busiest Aggregator onto ``fresh``.

    The load-driven half of §3.3.2's elasticity: where :func:`admit_job`
    grows the fleet on job ARRIVAL and :func:`recycle_aggregators` shrinks
    it on EXIT, this grows it on measured LOAD -- the autoscaler's
    scale-out action.  Tasks move greedily (largest exec_time first) from
    the busiest Aggregator until the fresh one carries half its busy time;
    ``fresh`` is appended to ``aggregators`` on success.  Returns False --
    and allocates nothing -- when no Aggregator has two tasks to split.
    """
    candidates = [a for a in aggregators if len(a.tasks) > 1]
    if not candidates:
        return False
    victim = max(candidates, key=lambda a: a.busy_time())
    target = victim.busy_time() / 2.0
    # Largest-first gives the halving greedy its classic 2/3 bound; skim
    # from a sorted snapshot so removal during iteration is safe.
    tasks = sorted(victim.tasks.values(), key=lambda t: -t.exec_time)
    for task in tasks:
        if len(victim.tasks) <= 1 or fresh.busy_time() >= target:
            break
        job = jobs.get(task.job_id)
        duration = (job.iteration_duration if job is not None
                    else victim.job_durations.get(task.job_id, 1.0))
        victim.remove_task(task.key)
        fresh.add_task(task, duration)
    if fresh.is_empty:
        return False
    aggregators.append(fresh)
    return True


def evacuate_aggregator(
    aggregators: List[Aggregator],
    victim: Aggregator,
    jobs: Dict[str, JobProfile],
    config: AssignmentConfig = AssignmentConfig(),
    allocator: Optional[AggregatorAllocator] = None,
) -> int:
    """Forced drain of ONE named Aggregator: the shard-loss recovery move.

    Unlike :func:`recycle_aggregators` -- an opportunistic shrink that
    backs off whenever the trial placement would degrade performance --
    evacuation must not fail: the victim is already lost (or condemned),
    so its tasks are re-hosted on the survivors even if that overloads
    them.  Tasks move largest ``exec_time`` first through the normal
    assignment scheme; when nothing fits under the loss limit the task
    is force-placed on the least-busy survivor (degraded beats down).
    ``allocator`` is consulted only when the victim was the ONLY
    Aggregator (recovery must produce *some* host).  Returns the number
    of tasks moved; ``victim`` is removed from ``aggregators``.
    """
    survivors = [a for a in aggregators if a is not victim]
    if not survivors:
        if allocator is None:
            raise _NoAllocation(
                f"cannot evacuate {victim.agg_id!r}: it is the only "
                f"Aggregator and no allocator was provided")
        survivors = [allocator()]
    moved = 0
    for task in sorted(victim.tasks.values(), key=lambda t: -t.exec_time):
        job = jobs.get(task.job_id)
        if job is not None and _safe_assign(task, job, survivors, config):
            moved += 1
            continue
        duration = (job.iteration_duration if job is not None
                    else victim.job_durations.get(task.job_id, 1.0))
        host = min(survivors, key=lambda a: a.busy_time())
        host.add_task(task, duration)
        moved += 1
    aggregators[:] = survivors
    return moved


def _refuse_allocation() -> Aggregator:
    raise _NoAllocation()


class _NoAllocation(Exception):
    pass


# assign_task calls allocator() when nothing fits; catch that as "failed".
def _safe_assign(task: AggTask, job: JobProfile, aggs: List[Aggregator], config) -> bool:
    try:
        assign_task(task, job, aggs, _refuse_allocation, config)
        return True
    except _NoAllocation:
        return False
