"""Core datatypes for the Parameter Service control plane.

The vocabulary follows the paper (§3): a *job* submits one model-aggregation
*task* per tensor; tasks are hosted by *Aggregators*; Aggregators belong to
*clusters* managed by a central *pMaster*.

Units: time in seconds, CPU in "server units" (1.0 == one Aggregator server's
CPU capacity, matching the paper's normalized free-slot arithmetic), tensor
sizes in bytes.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

# Numerical guard for floor(C / D) on floats (11.9999999 / 4 must count as 3).
_EPS = 1e-9


def iterations_per_cycle(cycle: float, duration: float) -> int:
    """Number of times a job with iteration `duration` executes per `cycle`.

    Paper §3.3.1: jobs with smaller iteration duration get executed for
    multiple iterations within one Aggregator execution cycle.
    """
    if duration <= 0:
        raise ValueError(f"iteration duration must be positive, got {duration}")
    if cycle + _EPS < duration:
        # Cycle shorter than the job's iteration: executes once per cycle by
        # definition (the cycle will be extended to max(D) by the caller).
        return 1
    return max(1, int(math.floor(cycle / duration + _EPS)))


def effective_iteration(cycle: float, duration: float) -> float:
    """Effective iteration duration d_j = C / floor(C / D_j)  (App. C)."""
    return cycle / iterations_per_cycle(cycle, duration)


def cyclic_loss(cycle: float, duration: float) -> float:
    """Performance loss L_j = (d_j - D_j) / d_j caused by cyclic execution."""
    d = effective_iteration(cycle, duration)
    if d <= 0:
        return 0.0
    return max(0.0, (d - duration) / d)


@dataclass(frozen=True)
class AggTask:
    """One model-aggregation task == one tensor of one job (paper footnote 1:

    each task produces one aggregation request per training iteration).
    `exec_time` is the profiled CPU time e_t to aggregate + update the tensor
    once (sum of worker pushes + optimizer update).
    """

    job_id: str
    tensor_id: int
    name: str
    nbytes: int
    exec_time: float

    @property
    def key(self) -> Tuple[str, int]:
        return (self.job_id, self.tensor_id)


@dataclass
class JobProfile:
    """Profiled characteristics of a training job (pMaster's job profiler).

    `iteration_duration` is the standalone iteration time D_j measured during
    the initial profiling phase; `required_servers` is the number of parameter
    servers the job would allocate under ps-lite (the paper's baseline and the
    denominator of the CPU-reduction ratio).
    """

    job_id: str
    model: str
    iteration_duration: float
    tasks: List[AggTask]
    n_workers: int = 2
    required_servers: int = 1

    def __post_init__(self) -> None:
        if self.iteration_duration <= 0:
            raise ValueError("iteration_duration must be positive")
        for t in self.tasks:
            if t.job_id != self.job_id:
                raise ValueError(f"task {t.name} belongs to {t.job_id}, not {self.job_id}")

    @property
    def total_exec_time(self) -> float:
        return sum(t.exec_time for t in self.tasks)

    @property
    def total_bytes(self) -> int:
        return sum(t.nbytes for t in self.tasks)

    @property
    def standalone_utilization(self) -> float:
        """Average CPU utilization if served by `required_servers` dedicated
        servers (the Fig. 2 quantity)."""
        return self.total_exec_time / (self.iteration_duration * self.required_servers)


@dataclass
class Aggregator:
    """A model-aggregation server hosting master tensor copies.

    Tracks its assigned tasks, the iteration duration of every job with tasks
    on it (needed for the execution-cycle math), and exposes the paper's
    cyclic-execution quantities: cycle C_n, busy time W_n, free slots F_n.
    """

    agg_id: str
    capacity: float = 1.0  # CPU units; 1.0 == one server
    cluster_id: Optional[str] = None
    tasks: Dict[Tuple[str, int], AggTask] = field(default_factory=dict)
    job_durations: Dict[str, float] = field(default_factory=dict)

    # ------------------------------------------------------------------ state
    def add_task(self, task: AggTask, job_duration: float) -> None:
        self.tasks[task.key] = task
        self.job_durations[task.job_id] = job_duration

    def remove_task(self, key: Tuple[str, int]) -> AggTask:
        task = self.tasks.pop(key)
        if not any(k[0] == task.job_id for k in self.tasks):
            self.job_durations.pop(task.job_id, None)
        return task

    def remove_job(self, job_id: str) -> List[AggTask]:
        removed = [t for k, t in list(self.tasks.items()) if k[0] == job_id]
        for t in removed:
            self.tasks.pop(t.key)
        self.job_durations.pop(job_id, None)
        return removed

    # -------------------------------------------------------------- quantities
    @property
    def job_ids(self) -> List[str]:
        return sorted(self.job_durations)

    @property
    def is_empty(self) -> bool:
        return not self.tasks

    def tasks_of(self, job_id: str) -> List[AggTask]:
        return [t for k, t in self.tasks.items() if k[0] == job_id]

    @property
    def cycle(self) -> float:
        """Execution cycle C_n = max iteration duration among hosted jobs."""
        if not self.job_durations:
            return 0.0
        return max(self.job_durations.values())

    def busy_time(self, cycle: Optional[float] = None) -> float:
        """W_n = sum over jobs of (executions per cycle * per-iter exec time)."""
        c = self.cycle if cycle is None else cycle
        if c <= 0:
            return 0.0
        total = 0.0
        for job_id, duration in self.job_durations.items():
            reps = iterations_per_cycle(c, duration)
            total += reps * sum(t.exec_time for t in self.tasks_of(job_id))
        return total

    def free_slots(self, cycle: Optional[float] = None) -> float:
        """F_n = capacity * C_n - W_n (free CPU-time within one cycle)."""
        c = self.cycle if cycle is None else cycle
        return self.capacity * c - self.busy_time(c)

    @property
    def utilization(self) -> float:
        c = self.cycle
        if c <= 0:
            return 0.0
        return self.busy_time(c) / (self.capacity * c)

    def clone(self) -> "Aggregator":
        return Aggregator(
            agg_id=self.agg_id,
            capacity=self.capacity,
            cluster_id=self.cluster_id,
            tasks=dict(self.tasks),
            job_durations=dict(self.job_durations),
        )


@dataclass
class AssignmentDecision:
    """Result of assigning a single task."""

    task: AggTask
    aggregator_id: str
    newly_allocated: bool


def cpu_reduction_ratio(required_servers: int, allocated_aggregators: int) -> float:
    """Paper §5.1 metric: (#param servers - #Aggregators) / #param servers."""
    if required_servers <= 0:
        return 0.0
    return (required_servers - allocated_aggregators) / required_servers
