"""ParameterService facade: the user-visible surface of the control plane.

Ties together pMaster + cluster controllers (cluster.py), the assignment
scheme (assignment.py), scaling (scaling.py), and migration bookkeeping
(migration.py).  It is also the *single source of truth* for the data
plane: ``compile_plan()`` compiles the live tensor->Aggregator assignment
into a multi-job ``FlatPlan`` (repro.ps.plan), and every placement-changing
event (``register_job``, ``job_exit``, ``periodic_rebalance``) emits an
``(old_plan, new_plan)`` pair to replan listeners so the data-plane runtime
(repro.ps.service_runtime.ServiceRuntime) can migrate all co-resident jobs'
flat Adam state without a restart.  The simulator (repro.sim) drives the
same object with job arrival/exit events.

Replan transactions (PR 9).  Every registry mutation (``register_job``,
``job_exit``, ``scale_out``, ``scale_in``, ``evacuate_aggregator``,
``periodic_rebalance``) runs as a commit-or-abort transaction: the task
registry (pMaster + job tables + last plan) is snapshotted, the mutation
and its replan notification run, and if a replan LISTENER fails -- i.e.
the data plane's quiesce -> migrate -> commit sequence died, e.g. on an
injected migration fault -- the registry is rolled back to the snapshot
and the whole mutation retried under ``retry_policy``
(:class:`repro.ps.faults.RetryPolicy`).  Exhausted retries raise
:class:`repro.ps.faults.ReplanAbortedError` with the registry restored,
so control and data plane always agree on a single layout.  Control
plane errors (duplicate job, unknown aggregator, over budget) and
``EngineQuarantinedError`` (a liveness failure retrying cannot fix)
propagate unchanged -- the rollback still runs for the latter.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from .assignment import AssignmentConfig
from .cluster import PMaster
from .migration import TensorMigration
from .perf_model import predict_all_losses, predict_iteration
from .types import Aggregator, JobProfile, cpu_reduction_ratio

# (old_plan | None, new_plan | None) -> None; plans are repro.ps.plan.FlatPlan
ReplanListener = Callable[[object, object], None]


class _ReplanFailure(Exception):
    """Internal marker: a replan LISTENER failed (retryable data-plane
    fault) -- distinguishes transaction retries from control-plane
    validation errors, which propagate unchanged."""

    def __init__(self, original: BaseException):
        self.original = original
        super().__init__(str(original))


@dataclass
class ParameterService:
    """Cluster-wide shared model-aggregation service (the paper's system)."""

    total_budget: int = 1024
    n_clusters: int = 1
    loss_limit: float = 0.1
    strict_paper: bool = False
    preserve_spread: bool = False
    plan_pad_to: int = 128  # shard padding granularity of compiled plans
    # Replan-transaction retry schedule; None -> RetryPolicy() defaults
    # (2 retries, no sleeping).  Shared type with the engines' apply
    # retries (repro.ps.faults.RetryPolicy).
    retry_policy: Optional[object] = None

    def __post_init__(self) -> None:
        self._config = AssignmentConfig(
            loss_limit=self.loss_limit, strict_paper=self.strict_paper,
            preserve_spread=self.preserve_spread,
        )
        self._pmaster = PMaster(
            total_budget=self.total_budget,
            n_clusters=self.n_clusters,
            config=self._config,
        )
        self._jobs: Dict[str, JobProfile] = {}
        self._migrations: List[TensorMigration] = []
        self._specs: Dict[str, Mapping[int, object]] = {}  # job -> {tid: TensorSpec}
        self._plan = None  # last compiled FlatPlan handed to listeners
        self._listeners: List[ReplanListener] = []
        # Transaction counters, surfaced in the runtimes' debug_stats().
        self.n_replan_commits = 0
        self.n_replan_aborts = 0
        self.n_replan_retries = 0

    # ------------------------------------------------------- replan txn
    def _resolve_retry_policy(self):
        if self.retry_policy is None:
            from repro_torch.ps.faults import RetryPolicy

            self.retry_policy = RetryPolicy()
        return self.retry_policy

    def _registry_snapshot(self):
        """Deep-copy the task registry: everything a mutation + replan
        may touch (cheap -- the control plane is metadata-sized)."""
        return (copy.deepcopy(self._pmaster), dict(self._jobs),
                {j: dict(s) for j, s in self._specs.items()},
                list(self._migrations), self._plan)

    def _restore_registry(self, snap) -> None:
        (self._pmaster, self._jobs, self._specs,
         self._migrations, self._plan) = snap

    def _transact(self, op: str, mutate: Callable[[], object]):
        """Run ``mutate`` (a registry mutation ending in ``_replan()``)
        as a commit-or-abort transaction.  ``mutate`` must re-derive any
        registry references on each call: after an abort the snapshot's
        deep copies are installed, so objects from a failed attempt are
        stale."""
        policy = self._resolve_retry_policy()
        attempt = 0
        while True:
            attempt += 1
            snap = self._registry_snapshot()
            try:
                out = mutate()
            except _ReplanFailure as fail:
                self._restore_registry(snap)
                self.n_replan_aborts += 1
                if not policy.should_retry(attempt):
                    from repro_torch.ps.faults import ReplanAbortedError

                    raise ReplanAbortedError(
                        op, attempt, fail.original) from fail.original
                self.n_replan_retries += 1
                policy.backoff(attempt)
            except Exception:
                # Control-plane error or a non-retryable liveness
                # failure: roll back, propagate unchanged.
                self._restore_registry(snap)
                raise
            else:
                self.n_replan_commits += 1
                return out

    # ------------------------------------------------------------------- API
    def register_job(self, job: JobProfile, specs=None) -> str:
        """Admit a job (assign all its model aggregations); returns cluster id.

        ``specs`` optionally binds the job's data-plane tensor metadata
        (``{tensor_id: repro.ps.plan.TensorSpec}``) so compiled plans carry
        real shapes/dtypes instead of nbytes-derived 1-D placeholders."""
        if job.job_id in self._jobs:
            raise ValueError(f"job {job.job_id} already registered")

        def mutate():
            cluster_id = self._pmaster.submit_job(job)
            self._jobs[job.job_id] = job
            if specs is not None:
                self._specs[job.job_id] = dict(specs)
            self._replan()
            return cluster_id

        return self._transact("register_job", mutate)

    def job_exit(self, job_id: str) -> None:
        if job_id not in self._jobs:
            raise KeyError(job_id)

        def mutate():
            self._jobs.pop(job_id)
            self._specs.pop(job_id, None)
            self._pmaster.job_exit(job_id)
            self._replan()

        self._transact("job_exit", mutate)

    def placement(self, job_id: str) -> Dict[int, str]:
        """tensor_id -> aggregator_id for a job (the Agent mapping table)."""
        out: Dict[int, str] = {}
        for agg in self.aggregators:
            for (jid, tid) in agg.tasks:
                if jid == job_id:
                    out[tid] = agg.agg_id
        return out

    # ----------------------------------------------------------- ServicePlan
    def compile_plan(self, pad_to: Optional[int] = None):
        """Compile the live Aggregator.tasks assignment into a multi-job
        FlatPlan: one shard per allocated Aggregator, segments keyed by
        ``(job_id, tensor_key)``.  This is the plan the data plane executes;
        ``build_flat_plan`` is only the standalone single-job path."""
        from repro_torch.ps.plan import compile_service_plan

        return compile_service_plan(
            self.aggregators, self._specs,
            pad_to=self.plan_pad_to if pad_to is None else pad_to,
        )

    def compile_sharded_plan(self, pad_to: Optional[int] = None):
        """Compile the live assignment into per-Aggregator shard SPACES
        (``repro.ps.plan.ShardedPlan``): one independently sized flat
        layout per allocated Aggregator -- the sharded data plane's view
        of the same placement ``compile_plan`` flattens into one space."""
        from repro_torch.ps.plan import compile_sharded_plan

        return compile_sharded_plan(
            self.aggregators, self._specs,
            pad_to=self.plan_pad_to if pad_to is None else pad_to,
        )

    # ------------------------------------------------------- elastic scaling
    def scale_out(self, n: int = 1) -> int:
        """Load-driven scale-out: split the busiest Aggregator's workload
        onto a freshly allocated one, ``n`` times (§3.3.2's growth arm,
        driven by the data plane's measured load instead of a job event).
        Returns how many Aggregators were actually added; every successful
        split triggers a replan so the data plane re-shards live."""
        from .cluster import OverBudget
        from .scaling import split_aggregator

        def mutate():
            added = 0
            for _ in range(max(0, n)):
                busiest = None
                for ctrl in self._pmaster.clusters.values():
                    for agg in ctrl.aggregators:
                        if len(agg.tasks) > 1 and (
                                busiest is None
                                or agg.busy_time() > busiest[1].busy_time()):
                            busiest = (ctrl, agg)
                if busiest is None:
                    break
                ctrl = busiest[0]
                try:
                    fresh = ctrl._allocate()
                except OverBudget:
                    if not self._pmaster._grant_budget(ctrl):
                        break
                    fresh = ctrl._allocate()
                if not split_aggregator(ctrl.aggregators, fresh, ctrl.jobs,
                                        self._config):
                    break
                added += 1
            if added:
                self._replan()
            return added

        return self._transact("scale_out", mutate)

    def scale_in(self, n: int = 1) -> int:
        """Load-driven scale-in: drain the least-loaded Aggregator into
        the rest of its cluster (no new allocations), ``n`` times --
        exactly the paper's recycling move, here triggered by low measured
        load.  Returns Aggregators recycled; replans on any change."""
        from .scaling import recycle_aggregators

        def mutate():
            removed = 0
            for _ in range(max(0, n)):
                ctrl = max(
                    (c for c in self._pmaster.clusters.values()
                     if c.n_aggregators > 1),
                    key=lambda c: c.n_aggregators, default=None)
                if ctrl is None:
                    break
                got = recycle_aggregators(ctrl.aggregators, ctrl.jobs,
                                          self._config, max_rounds=1)
                if not got:
                    break
                removed += got
            if removed:
                self._replan()
            return removed

        return self._transact("scale_in", mutate)

    def evacuate_aggregator(self, agg_id: str) -> int:
        """Declare ONE Aggregator lost and re-host its tasks on the rest
        of its cluster -- the control-plane half of shard-loss recovery
        (the data-plane half, state migration, rides the replan this
        triggers; see ``ShardedServiceRuntime.recover_shard``).

        Unlike ``scale_in`` this names its victim and cannot refuse:
        tasks are force-placed on survivors even past the loss limit,
        and a fresh Aggregator is allocated only if the victim was the
        cluster's last one.  Returns the number of tasks moved; raises
        ``ValueError`` for an unknown ``agg_id``."""
        from .cluster import OverBudget
        from .scaling import evacuate_aggregator

        if all(a.agg_id != agg_id for a in self.aggregators):
            raise ValueError(
                f"unknown aggregator {agg_id!r} "
                f"(have {[a.agg_id for a in self.aggregators]})")

        def mutate():
            for ctrl in self._pmaster.clusters.values():
                victim = next((a for a in ctrl.aggregators
                               if a.agg_id == agg_id), None)
                if victim is None:
                    continue

                def _allocate():
                    try:
                        return ctrl._allocate()
                    except OverBudget:
                        if not self._pmaster._grant_budget(ctrl):
                            raise
                        return ctrl._allocate()

                moved = evacuate_aggregator(
                    ctrl.aggregators, victim, ctrl.jobs, self._config,
                    allocator=_allocate)
                self._replan()
                return moved
            raise ValueError(f"unknown aggregator {agg_id!r}")

        return self._transact("evacuate_aggregator", mutate)

    @property
    def current_plan(self):
        """Plan as of the last placement change (None before any job)."""
        return self._plan

    def on_replan(self, listener: ReplanListener) -> None:
        """Subscribe to ``(old_plan, new_plan)`` placement changes.  If jobs
        are already placed, the listener immediately sees (None, plan)."""
        self._listeners.append(listener)
        if self._jobs:
            if self._plan is None:
                self._plan = self.compile_plan()
            listener(None, self._plan)

    def _replan(self) -> None:
        if not self._listeners:
            return
        new = self.compile_plan() if self._jobs else None
        if new == self._plan:
            return
        old, self._plan = self._plan, new
        try:
            for listener in self._listeners:
                listener(old, new)
        except Exception as exc:
            from repro_torch.ps.faults import EngineQuarantinedError

            if isinstance(exc, EngineQuarantinedError):
                # A dead lane blocks the quiesce; retrying the replan
                # cannot revive it -- roll back, surface for recovery.
                raise
            # Data-plane failure mid-replan: mark it retryable so the
            # enclosing transaction rolls the registry back and retries.
            raise _ReplanFailure(exc) from exc

    # ------------------------------------------------------------ inspection
    @property
    def aggregators(self) -> List[Aggregator]:
        return [
            a
            for ctrl in self._pmaster.clusters.values()
            for a in ctrl.aggregators
        ]

    @property
    def n_aggregators(self) -> int:
        return len(self.aggregators)

    def predicted_losses(self) -> Dict[str, float]:
        return predict_all_losses(self._jobs, self.aggregators)

    def predicted_iteration(self, job_id: str) -> float:
        return predict_iteration(self._jobs[job_id], self.aggregators)

    def cpu_reduction(self) -> float:
        required = sum(j.required_servers for j in self._jobs.values())
        return cpu_reduction_ratio(required, self.n_aggregators)

    def utilizations(self) -> Dict[str, float]:
        return {a.agg_id: a.utilization for a in self.aggregators}

    def periodic_rebalance(self) -> None:
        def mutate():
            self._pmaster.periodic_rebalance()
            self._replan()

        self._transact("periodic_rebalance", mutate)

    def stats(self) -> Dict[str, float]:
        s = self._pmaster.stats()
        losses = self.predicted_losses()
        s["max_loss"] = max(losses.values(), default=0.0)
        s["mean_utilization"] = (
            sum(self.utilizations().values()) / max(1, self.n_aggregators)
        )
        return s
