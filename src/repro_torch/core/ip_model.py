"""The assignment problem as an integer program (paper Appendix C).

Variables: p_tn in {0,1} -- task t assigned to Aggregator n.
Objective: minimize max_j L_j with
    C_n = max_{t on n} D_{job(t)}
    d_j = max_{t of j on n} C_n / floor(C_n / D_j)
    W_n = sum_j sum_{t of j on n} e_t * floor(C_n / d_j)
    L_j = (d_j - D_j) / d_j
Constraints: each task on exactly one Aggregator; W_n <= capacity * C_n.

The paper calls the IP NP-hard and infeasible at scale; we ship an exact
brute-force solver for tiny instances (used by tests to bound the heuristic's
optimality gap) plus the shared objective evaluator.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .types import AggTask, JobProfile, effective_iteration, iterations_per_cycle

Assignment = Dict[Tuple[str, int], int]  # task key -> aggregator index


@dataclass(frozen=True)
class Evaluation:
    feasible: bool
    max_loss: float
    per_job_loss: Dict[str, float]
    n_aggregators: int


def evaluate(
    jobs: Sequence[JobProfile],
    assignment: Assignment,
    n_aggregators: int,
    capacity: float = 1.0,
) -> Evaluation:
    """Evaluate the App.-C objective/constraints for a complete assignment."""
    by_job = {j.job_id: j for j in jobs}
    # Aggregator -> job ids/tasks hosted.
    hosted: Dict[int, List[AggTask]] = {n: [] for n in range(n_aggregators)}
    for job in jobs:
        for task in job.tasks:
            n = assignment.get(task.key)
            if n is None:
                return Evaluation(False, float("inf"), {}, n_aggregators)
            hosted[n].append(task)

    cycles: Dict[int, float] = {}
    for n, tasks in hosted.items():
        if tasks:
            cycles[n] = max(by_job[t.job_id].iteration_duration for t in tasks)

    # d_j = max over aggregators hosting any of j's tasks.
    per_job_d: Dict[str, float] = {}
    for job in jobs:
        d = job.iteration_duration
        for task in job.tasks:
            n = assignment[task.key]
            d = max(d, effective_iteration(cycles[n], job.iteration_duration))
        per_job_d[job.job_id] = d

    # W_n <= capacity * C_n
    feasible = True
    for n, tasks in hosted.items():
        if not tasks:
            continue
        c = cycles[n]
        w = 0.0
        job_ids = {t.job_id for t in tasks}
        for jid in job_ids:
            reps = iterations_per_cycle(c, by_job[jid].iteration_duration)
            w += reps * sum(t.exec_time for t in tasks if t.job_id == jid)
        if w > capacity * c + 1e-9:
            feasible = False

    losses = {
        jid: max(0.0, (d - by_job[jid].iteration_duration) / d)
        for jid, d in per_job_d.items()
    }
    return Evaluation(feasible, max(losses.values(), default=0.0), losses, n_aggregators)


def brute_force(
    jobs: Sequence[JobProfile],
    n_aggregators: int,
    capacity: float = 1.0,
) -> Optional[Tuple[Assignment, Evaluation]]:
    """Exact search over all placements (tiny instances only: n_tasks^n small)."""
    tasks = [t for j in jobs for t in j.tasks]
    if n_aggregators ** len(tasks) > 2_000_000:
        raise ValueError("instance too large for brute force")
    best: Optional[Tuple[Assignment, Evaluation]] = None
    for combo in itertools.product(range(n_aggregators), repeat=len(tasks)):
        assignment = {t.key: n for t, n in zip(tasks, combo)}
        ev = evaluate(jobs, assignment, n_aggregators, capacity)
        if not ev.feasible:
            continue
        if best is None or ev.max_loss < best[1].max_loss - 1e-12:
            best = (assignment, ev)
    return best
