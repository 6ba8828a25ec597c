"""Model-aggregation assignment (paper §3.3.1, Pseudocode 1).

Given a new task t of job k and the set of allocated Aggregators N:

1. For every Aggregator n, estimate the new execution cycle
   C_n_est = max(C_n, D_k) and the resulting effective iteration duration of
   every job already on n (plus k). If any job's estimated loss reaches
   LossLimit, n is disqualified.
2. Compute estimated free CPU slots F_n_est under C_n_est.
3. Among qualified Aggregators, pick the *best fit*: sufficient but least
   free CPU slots (paper line 16-21).
4. If none qualifies or none fits, allocate a new Aggregator.

`strict_paper=True` reproduces the paper's literal fit test F >= e_t; the
default additionally accounts for the task executing floor(C/d_k) times per
cycle (the occupancy the task actually adds), which is strictly safer and is
recorded as a beyond-paper correction in DESIGN.md.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .types import (
    AggTask,
    Aggregator,
    AssignmentDecision,
    JobProfile,
    cyclic_loss,
    effective_iteration,
    iterations_per_cycle,
)

DEFAULT_LOSS_LIMIT = 0.1  # paper: "LossLimit, default is 0.1"

AggregatorAllocator = Callable[[], Aggregator]


@dataclass
class AssignmentConfig:
    loss_limit: float = DEFAULT_LOSS_LIMIT
    strict_paper: bool = False
    # Refuse placements that would overload an Aggregator's cycle even if the
    # literal free-slot test passes (W <= capacity * C, paper App. C constraint 2).
    enforce_capacity: bool = True
    # Optional bandwidth-provisioning mode: recycling never consolidates a
    # job below its parameter-server requirement. The paper's Fig.-11 numbers
    # (52.7% saving) require full consolidation, so this defaults off.
    preserve_spread: bool = False


def _estimate(
    agg: Aggregator, job_duration: float
) -> Tuple[float, float]:
    """(C_n_est, F_n_est) if a task of a job with `job_duration` joins `agg`."""
    cycle_est = max(agg.cycle, job_duration)
    free_est = agg.capacity * cycle_est - agg.busy_time(cycle_est)
    return cycle_est, free_est


def _loss_ok(agg: Aggregator, new_duration: float, loss_limit: float,
             extra_busy: float = 0.0, cyclic_only: bool = False) -> bool:
    """Check every co-located job's estimated TOTAL loss under the new cycle.

    Pseudocode 1 checks only the cyclic term; we additionally fold in the
    calibrated contention estimate at the post-assignment utilization so the
    admission filter and the feedback perf model agree (strict_paper mode
    keeps the literal cyclic-only check)."""
    from .perf_model import contention_factor

    cycle_est = max(agg.cycle, new_duration)
    rho = 1.0
    if not cyclic_only and cycle_est > 0:
        rho = (agg.busy_time(cycle_est) + extra_busy) / (agg.capacity * cycle_est)
    cf = 1.0 if cyclic_only else contention_factor(rho)
    durations = list(agg.job_durations.values()) + [new_duration]
    for d in durations:
        cyc = cyclic_loss(cycle_est, d)
        total = 1.0 - (1.0 - cyc) / cf
        if total >= loss_limit:
            return False
    return True


def assign_task(
    task: AggTask,
    job: JobProfile,
    aggregators: List[Aggregator],
    allocator: AggregatorAllocator,
    config: AssignmentConfig = AssignmentConfig(),
) -> AssignmentDecision:
    """Pseudocode 1: place one task, allocating a new Aggregator if needed."""
    if config.strict_paper:
        required = lambda cycle_est: task.exec_time  # noqa: E731  (paper line 17)
    else:
        def required(cycle_est: float) -> float:
            reps = iterations_per_cycle(cycle_est, job.iteration_duration)
            return reps * task.exec_time

    candidates: List[Tuple[float, Aggregator]] = []  # (F_n_est, aggregator)
    for agg in aggregators:
        cycle_est, free_est = _estimate(agg, job.iteration_duration)
        if not _loss_ok(agg, job.iteration_duration, config.loss_limit,
                        extra_busy=required(cycle_est),
                        cyclic_only=config.strict_paper):
            continue  # line 5-7: estimated loss >= LossLimit -> drop n
        candidates.append((free_est, agg))

    # Best fit: sufficient but least free CPU slots.
    best: Optional[Aggregator] = None
    best_free = float("inf")
    for free_est, agg in candidates:
        cycle_est = max(agg.cycle, job.iteration_duration)
        need = required(cycle_est)
        if free_est >= need and free_est < best_free:
            best, best_free = agg, free_est

    if best is not None:
        best.add_task(task, job.iteration_duration)
        if config.enforce_capacity and best.free_slots() < -1e-9:
            # The literal test admitted an overload (possible in strict mode
            # when a fast job repeats within the cycle) -- revert.
            best.remove_task(task.key)
        else:
            return AssignmentDecision(task, best.agg_id, newly_allocated=False)

    fresh = allocator()
    fresh.add_task(task, job.iteration_duration)
    aggregators.append(fresh)
    return AssignmentDecision(task, fresh.agg_id, newly_allocated=True)


def assign_job(
    job: JobProfile,
    aggregators: List[Aggregator],
    allocator: AggregatorAllocator,
    config: AssignmentConfig = AssignmentConfig(),
) -> List[AssignmentDecision]:
    """Assign all tasks of a job, largest exec time first (best-fit decreasing).

    Descending order matters: big tensors (e.g. VGG19's fc6 at ~72% of model
    bytes) must claim space before small ones fragment it.
    """
    decisions = []
    for task in sorted(job.tasks, key=lambda t: -t.exec_time):
        decisions.append(assign_task(task, job, aggregators, allocator, config))
    return decisions


def remove_job(aggregators: Sequence[Aggregator], job_id: str) -> List[AggTask]:
    removed: List[AggTask] = []
    for agg in aggregators:
        removed.extend(agg.remove_job(job_id))
    return removed


def balanced_shard_assignment(
    job: JobProfile, n_shards: int
) -> Dict[int, List[AggTask]]:
    """AutoPS standalone placement: greedy balance of task exec time across a
    fixed number of shards (the Fig. 7 'better balanced load distribution').

    Longest-processing-time-first greedy: 4/3-approximation of makespan.
    """
    loads = [0.0] * n_shards
    shards: Dict[int, List[AggTask]] = {i: [] for i in range(n_shards)}
    for task in sorted(job.tasks, key=lambda t: -t.exec_time):
        i = min(range(n_shards), key=lambda s: loads[s])
        loads[i] += task.exec_time
        shards[i].append(task)
    return shards


def round_robin_shard_assignment(
    job: JobProfile, n_shards: int
) -> Dict[int, List[AggTask]]:
    """ps-lite baseline placement: round-robin by tensor id (paper §5.2.1)."""
    shards: Dict[int, List[AggTask]] = {i: [] for i in range(n_shards)}
    for idx, task in enumerate(sorted(job.tasks, key=lambda t: t.tensor_id)):
        shards[idx % n_shards].append(task)
    return shards


def shard_imbalance(shards: Dict[int, List[AggTask]]) -> float:
    """max shard load / mean shard load; 1.0 == perfectly balanced.

    The paper's single-job speedup (<=1.17x, Fig. 7) comes from reducing this
    imbalance, because the slowest shard paces the Pull barrier.
    """
    loads = [sum(t.exec_time for t in ts) for ts in shards.values()]
    mean = sum(loads) / len(loads) if loads else 0.0
    if mean <= 0:
        return 1.0
    return max(loads) / mean
