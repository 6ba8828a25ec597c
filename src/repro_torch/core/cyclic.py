"""Cyclic execution of an Aggregator (paper §3.3.1).

Builds the concrete per-cycle timetable of aggregation slots for the tasks
packed on one Aggregator, and implements the paper's outlier policy for late
(straggler-delayed) requests: run in the current cycle iff enough spare CPU
remains after reserving the still-scheduled slots, otherwise postpone one
cycle (worst case: the job is delayed by exactly one iteration).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .types import Aggregator, iterations_per_cycle


@dataclass(frozen=True)
class Slot:
    """One scheduled execution of one task within the cycle."""

    job_id: str
    tensor_id: int
    start: float
    duration: float
    repetition: int  # which of the job's floor(C/D) executions this is

    @property
    def end(self) -> float:
        return self.start + self.duration


@dataclass
class CyclicSchedule:
    """Concrete timetable for one Aggregator cycle.

    Slots are laid out earliest-deadline-first: repetition r of job j becomes
    *available* at r * d_j (the gradients exist only after that iteration's
    backward pass) and must finish by (r + 1) * d_j to not delay the next
    iteration. We schedule greedily by deadline, which is optimal for a single
    machine with release times when preemption is allowed (we allow slot
    splitting implicitly by tracking cumulative lateness instead).
    """

    cycle: float
    capacity: float
    slots: List[Slot] = field(default_factory=list)

    @property
    def busy_time(self) -> float:
        return sum(s.duration for s in self.slots)

    @property
    def utilization(self) -> float:
        if self.cycle <= 0:
            return 0.0
        return self.busy_time / (self.capacity * self.cycle)

    def free_after(self, t: float) -> float:
        """Free CPU-time in [t, cycle] after reserving remaining slots."""
        remaining = sum(s.duration for s in self.slots if s.end > t)
        return max(0.0, self.capacity * (self.cycle - t) - remaining)


def build_schedule(agg: Aggregator) -> CyclicSchedule:
    """Lay out all task executions of one cycle, EDF by repetition deadline."""
    cycle = agg.cycle
    sched = CyclicSchedule(cycle=cycle, capacity=agg.capacity)
    if cycle <= 0:
        return sched

    # (release, deadline, job, tensor, duration, repetition)
    pending: List[Tuple[float, float, str, int, float, int]] = []
    for job_id, duration_j in agg.job_durations.items():
        reps = iterations_per_cycle(cycle, duration_j)
        d_eff = cycle / reps
        for task in agg.tasks_of(job_id):
            for r in range(reps):
                pending.append(
                    (r * d_eff, (r + 1) * d_eff, job_id, task.tensor_id, task.exec_time, r)
                )
    pending.sort(key=lambda p: (p[1], p[0]))  # EDF

    clock = 0.0
    for release, _deadline, job_id, tensor_id, dur, rep in pending:
        start = max(clock, release)
        sched.slots.append(Slot(job_id, tensor_id, start, dur, rep))
        clock = start + dur / max(agg.capacity, 1e-12)
    return sched


@dataclass(frozen=True)
class LateRequestOutcome:
    executed_now: bool
    postponed_iterations: int  # 0 or 1 (paper: "worst case... one iteration")


def admit_late_request(
    sched: CyclicSchedule, arrival: float, exec_time: float
) -> LateRequestOutcome:
    """Paper §3.3.1 'Handling Outliers in Cyclic Execution'.

    A request arriving `arrival` seconds into the cycle (late vs its slot) is
    executed now iff the Aggregator still has `exec_time` of spare CPU after
    reserving every remaining scheduled slot; otherwise it is postponed to the
    next cycle so co-located aggregations are unaffected.
    """
    if sched.free_after(arrival) >= exec_time - 1e-12:
        return LateRequestOutcome(executed_now=True, postponed_iterations=0)
    return LateRequestOutcome(executed_now=False, postponed_iterations=1)
