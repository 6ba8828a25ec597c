"""Two-level Aggregator-cluster management (paper §3.3.3).

pMaster no longer scans every Aggregator: the pool is split into independent
clusters, each run by a ClusterController that performs per-task assignment
(Pseudocode 1) within its own Aggregators. pMaster only does best-fit
*cluster* selection per arriving job (sufficient but least free CPU), which
bounds assignment work and confines reassignment blast radius to one cluster.

Hybrid resource scaling: controllers request allocations on demand (job
events) subject to pMaster approval; pMaster additionally rebalances cluster
budgets on a fixed period from demand measured over the last period.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import perf_model, scaling
from .assignment import AssignmentConfig
from .types import Aggregator, JobProfile, cpu_reduction_ratio


@dataclass
class ClusterController:
    """Owns one cluster's Aggregators and its jobs' placements."""

    cluster_id: str
    budget: int  # max Aggregators pMaster currently approves for this cluster
    config: AssignmentConfig = field(default_factory=AssignmentConfig)
    aggregators: List[Aggregator] = field(default_factory=list)
    jobs: Dict[str, JobProfile] = field(default_factory=dict)
    _ids: "itertools.count[int]" = field(default_factory=itertools.count)
    # demand accounting for pMaster's periodic rebalance
    denied_allocations: int = 0

    def _allocate(self) -> Aggregator:
        if len(self.aggregators) >= self.budget:
            self.denied_allocations += 1
            raise OverBudget(self.cluster_id)
        return Aggregator(agg_id=f"{self.cluster_id}/agg{next(self._ids)}",
                          cluster_id=self.cluster_id)

    # The allocator passed into assignment must append nothing itself --
    # assign_task appends. It may raise OverBudget, surfaced to pMaster.
    def admit_job(self, job: JobProfile) -> int:
        try:
            if not self.aggregators:
                # First job in the cluster: standalone mode. AutoPS gives the
                # job its parameter-server requirement, placed balanced
                # (Fig. 7 / Fig. 10: "following its parameter server
                # requirement, AutoPS allocates 2 Aggregators for it").
                new = self._admit_standalone(job)
            else:
                new, _ = scaling.admit_job(
                    job, self.aggregators, self.jobs, self._allocate, self.config
                )
        except OverBudget:
            # Atomic admission: roll back partial placements so a budget-
            # granted retry starts clean (otherwise duplicate task copies
            # inflate busy time and admission never converges).
            scaling.remove_job(self.aggregators, job.job_id)
            self.aggregators[:] = [a for a in self.aggregators if not a.is_empty]
            raise
        self.jobs[job.job_id] = job
        return new

    def _admit_standalone(self, job: JobProfile) -> int:
        from .assignment import balanced_shard_assignment

        n = max(1, job.required_servers)
        fresh = [self._allocate() for _ in range(n)]
        shards = balanced_shard_assignment(job, n)
        for idx, agg in enumerate(fresh):
            for task in shards[idx]:
                agg.add_task(task, job.iteration_duration)
        self.aggregators.extend(fresh)
        return n

    def release_job(self, job_id: str) -> Tuple[int, int]:
        self.jobs.pop(job_id, None)
        return scaling.release_job(job_id, self.aggregators, self.jobs, self.config)

    @property
    def free_cpu(self) -> float:
        """Free CPU slots across the cluster, counting unallocated budget."""
        used = sum(a.utilization * a.capacity for a in self.aggregators)
        return self.budget - used

    @property
    def n_aggregators(self) -> int:
        return len(self.aggregators)

    def losses(self) -> Dict[str, float]:
        return perf_model.predict_all_losses(self.jobs, self.aggregators)


class OverBudget(Exception):
    def __init__(self, cluster_id: str):
        super().__init__(f"cluster {cluster_id} at Aggregator budget")
        self.cluster_id = cluster_id


@dataclass
class PMaster:
    """Centralized manager: cluster bookkeeping + best-fit job forwarding.

    `total_budget` is the machine pool available for Aggregators; it is
    divided into `n_clusters` controller budgets, periodically rebalanced
    toward measured demand and topped-up on demand when denials exceed
    `on_demand_threshold` (hybrid scaling, §3.3.3).
    """

    total_budget: int
    n_clusters: int = 1
    config: AssignmentConfig = field(default_factory=AssignmentConfig)
    on_demand_threshold: int = 1
    clusters: Dict[str, ClusterController] = field(init=False)
    job_to_cluster: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        per = max(1, self.total_budget // self.n_clusters)
        self.clusters = {}
        for i in range(self.n_clusters):
            cid = f"c{i}"
            self.clusters[cid] = ClusterController(cid, budget=per, config=self.config)

    # ------------------------------------------------------------- forwarding
    def _best_fit_cluster(self, job: JobProfile) -> ClusterController:
        """Sufficient but least free CPU (paper: best-fit by total job CPU)."""
        demand = job.total_exec_time / job.iteration_duration  # avg CPU units
        fitting = [c for c in self.clusters.values() if c.free_cpu >= demand]
        pool = fitting or list(self.clusters.values())
        return min(pool, key=lambda c: c.free_cpu)

    def submit_job(self, job: JobProfile) -> str:
        ctrl = self._best_fit_cluster(job)
        attempts = 0
        while True:
            try:
                ctrl.admit_job(job)
                break
            except OverBudget:
                # On-demand scaling: approve extra budget if the pool allows.
                # Grant the job's full server requirement at once so a burst
                # arrival converges in O(1) retries.
                attempts += 1
                granted = 0
                for _ in range(max(1, job.required_servers)):
                    if self._grant_budget(ctrl):
                        granted += 1
                if granted == 0 or attempts > 64:
                    raise
        self.job_to_cluster[job.job_id] = ctrl.cluster_id
        return ctrl.cluster_id

    def job_exit(self, job_id: str) -> None:
        cid = self.job_to_cluster.pop(job_id)
        self.clusters[cid].release_job(job_id)

    def _grant_budget(self, ctrl: ClusterController) -> bool:
        if self.allocated_budget < self.total_budget:
            ctrl.budget += 1
            return True
        # Reclaim slack from the most over-provisioned other cluster.
        donor = max(
            (c for c in self.clusters.values() if c is not ctrl),
            key=lambda c: c.budget - c.n_aggregators,
            default=None,
        )
        if donor is not None and donor.budget - donor.n_aggregators > 0:
            donor.budget -= 1
            ctrl.budget += 1
            return True
        return False

    # ------------------------------------------------------------- accounting
    @property
    def allocated_budget(self) -> int:
        return sum(c.budget for c in self.clusters.values())

    @property
    def n_aggregators(self) -> int:
        return sum(c.n_aggregators for c in self.clusters.values())

    def periodic_rebalance(self) -> None:
        """Shift budget toward clusters that saw denials last period."""
        for ctrl in self.clusters.values():
            while ctrl.denied_allocations > 0:
                ctrl.denied_allocations -= 1
                if not self._grant_budget(ctrl):
                    break
            ctrl.denied_allocations = 0
        # Shrink budgets back toward usage (release idle machines).
        for ctrl in self.clusters.values():
            slack = ctrl.budget - max(ctrl.n_aggregators, 1)
            if slack > 0:
                ctrl.budget -= slack

    def stats(self) -> Dict[str, float]:
        required = 0
        for ctrl in self.clusters.values():
            required += sum(j.required_servers for j in ctrl.jobs.values())
        return {
            "n_jobs": float(len(self.job_to_cluster)),
            "n_aggregators": float(self.n_aggregators),
            "required_servers": float(required),
            "cpu_reduction_ratio": cpu_reduction_ratio(required, self.n_aggregators),
        }
