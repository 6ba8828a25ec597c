"""Analytic performance model for packed model aggregation.

Predicts each job's effective iteration duration d_j given the current
task->Aggregator packing. Two effects are modelled:

1. **Cyclic execution** (paper §3.3.1 / App. C): an Aggregator executes with
   cycle C_n = max_j D_j over jobs hosted on it; a job executes
   floor(C_n / D_j) iterations per cycle, so its effective iteration is
   d_j^n = C_n / floor(C_n / D_j) >= D_j.

2. **Contention** (calibrated): the paper measures up to 9% residual loss at
   full packing (Fig. 9) that the pure cyclic model does not capture (equal-
   duration jobs have zero cyclic loss). We model it as a convex function of
   Aggregator utilization rho: contention(rho) = ALPHA * rho**P, calibrated so
   rho=1.0 -> 9% (the paper's observed worst case) and low utilization is
   nearly free. Overload (W_n > capacity * C_n) additionally stretches the
   cycle by the overload factor, because the CPU simply cannot finish the
   packed work in time.

The model is used by the assignment feedback loop (§3.3.2: revert + allocate
when observed loss exceeds LossLimit), by Aggregator recycling, and by the
discrete-event simulator.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

from .types import Aggregator, JobProfile, effective_iteration

# Contention calibration: loss(rho=1.0) == 0.09, matching the paper's measured
# worst-case multi-job loss (Fig. 9: "may lose up to 9% training speed").
CONTENTION_ALPHA = 0.09
CONTENTION_POWER = 3.0


def contention_factor(rho: float) -> float:
    """Multiplicative slowdown (>=1) from CPU contention at utilization rho."""
    rho = max(0.0, rho)
    slowdown = 1.0 + CONTENTION_ALPHA * min(rho, 1.0) ** CONTENTION_POWER
    if rho > 1.0:
        # Overloaded: the cycle stretches so all packed work fits.
        slowdown *= rho
    return slowdown


def predict_iteration(
    job: JobProfile, aggregators: Iterable[Aggregator]
) -> float:
    """Effective iteration duration of `job` under the current packing.

    A job is paced by its slowest aggregation path: the max over Aggregators
    hosting any of its tensors of (cyclic effective iteration x contention).
    Aggregators hosting none of the job's tensors are ignored.
    """
    d = job.iteration_duration
    for agg in aggregators:
        if not any(k[0] == job.job_id for k in agg.tasks):
            continue
        cycle = agg.cycle
        if cycle <= 0:
            continue
        rho = agg.busy_time(cycle) / (agg.capacity * cycle)
        d_n = effective_iteration(cycle, job.iteration_duration)
        d = max(d, d_n * contention_factor(rho))
    return d


def predict_loss(job: JobProfile, aggregators: Iterable[Aggregator]) -> float:
    """Predicted performance loss L_j = (d_j - D_j) / d_j."""
    d = predict_iteration(job, aggregators)
    if d <= 0:
        return 0.0
    return max(0.0, (d - job.iteration_duration) / d)


def predict_all_losses(
    jobs: Mapping[str, JobProfile], aggregators: Iterable[Aggregator]
) -> Dict[str, float]:
    aggs = list(aggregators)
    return {job_id: predict_loss(job, aggs) for job_id, job in jobs.items()}
