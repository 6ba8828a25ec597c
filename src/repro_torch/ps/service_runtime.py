"""ServiceRuntime: the data-plane executor of a shared ParameterService
(PyTorch).

The counterpart of ``repro.ps.service_runtime.ServiceRuntime``.  It owns
ONE flat aggregation space (flat/mu/nu on the device, plus per-job step
counters) laid out by the service's compiled plan, and subscribes to the
control plane's replans: whenever ``register_job`` / ``job_exit`` /
``periodic_rebalance`` changes the assignment, the shared state migrates
onto the new layout -- as a :class:`~repro_torch.ps.elastic.MigrationDelta`
through the relayout kernels by default (``migration="delta"``), or by the
full-gather oracle (``migration="gather"``) -- and no job restarts.

With an attached :class:`~repro_torch.ps.engine.ServiceTickEngine`
(``rt.attach_engine()``) jobs submit pushes into bounded queues and every
tick applies all pending jobs in one launch of the multi-job Adam kernel;
a replan drains only the jobs whose layout it changes.

The runtime runs on the card unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from ..device import DeviceLike, resolve_device
from .elastic import (
    compile_migration_delta,
    migrate_flat_state,
    migrate_flat_state_delta,
    migration_bytes,
    plan_cache_stats,
)
from .plan import FlatPlan
from .runtime import (
    _not_in_slice,
    abstract_tree,
    init_shared_state,
    job_profile_from_tree,
    make_ps_train_step,
    seed_job_params,
    tree_map,
    unflatten_tree,
)


class ServiceRuntime:
    """Shared flat-state executor bound to one ParameterService."""

    def __init__(self, service, migration: str = "delta",
                 device: DeviceLike = None):
        if migration not in ("delta", "gather"):
            raise ValueError(f"unknown migration mode {migration!r}")
        self.device = resolve_device(device)
        self.service = service
        self.plan: Optional[FlatPlan] = None
        self.state: Optional[Dict[str, Any]] = None
        self.last_migration_bytes = 0  # cross-shard bytes (paper accounting)
        self.total_migration_bytes = 0
        self.last_relayout_bytes = 0  # flat-space bytes the delta path moved
        self.total_relayout_bytes = 0
        self.last_replan_touched: tuple = ()
        self.n_replans = 0
        self.migration = migration
        self._jobs: Dict[str, Dict[str, Any]] = {}
        self._steps: Dict[str, Callable] = {}
        self._engine = None
        service.on_replan(self._on_replan)

    def attach_engine(self, **engine_opts):
        """Create (once) and return the service-tick engine."""
        from .engine import ServiceTickEngine

        if self._engine is None:
            self._engine = ServiceTickEngine(self, **engine_opts)
        elif engine_opts:
            raise ValueError("engine already attached; cannot re-configure")
        return self._engine

    @property
    def engine(self):
        return self._engine

    def debug_stats(self) -> Dict[str, Any]:
        """The plan-pair cache, this runtime's migration counters, the
        service's replan-transaction counters, the attached engine's
        TickStats (None detached), the fault injector's fire counts and
        the read tier's per-replica ReadStats (None without a
        ReplicaSet)."""
        engine = self._engine
        injector = engine.fault_injector if engine is not None else None
        hub = getattr(engine, "_replica_hub", None)
        return {
            "plan_cache": plan_cache_stats(),
            "runtime": {
                "n_jobs": len(self._jobs),
                "n_replans": self.n_replans,
                "migration_bytes_total": self.total_migration_bytes,
                "relayout_bytes_total": self.total_relayout_bytes,
                "last_replan_touched": list(self.last_replan_touched),
                "migration": self.migration,
            },
            "transactions": {
                "n_replan_commits": self.service.n_replan_commits,
                "n_replan_aborts": self.service.n_replan_aborts,
                "n_replan_retries": self.service.n_replan_retries,
            },
            "engine": (dataclasses.asdict(engine.stats)
                       if engine is not None else None),
            "faults": (None if injector is None else {
                "n_fired": injector.n_fired,
                "by_kind": injector.fire_counts(),
            }),
            "replicas": hub.stats() if hub is not None else None,
        }

    # ----------------------------------------------------------------- jobs
    def add_job(
        self,
        job_id: str,
        params,
        loss_fn: Callable[[Any, Any], Any],
        *,
        iteration_duration: float = 1.0,
        n_workers: int = 2,
        required_servers: int = 1,
        agg_throughput: float = 7e9,
        lr: float = 3e-4,
        **step_opts,
    ) -> None:
        """Register a training job with the service and seed its parameters
        into the shared flat space.  Triggers a replan (and a migration of
        co-resident jobs' state) if placement changes."""
        if job_id in self._jobs:
            raise ValueError(f"job {job_id} already in the runtime")
        if step_opts.get("push_compression"):
            raise _not_in_slice("push_compression", "4")
        profile, specs = job_profile_from_tree(
            job_id, params,
            iteration_duration=iteration_duration,
            n_workers=n_workers,
            required_servers=required_servers,
            agg_throughput=agg_throughput,
        )
        self._jobs[job_id] = dict(loss_fn=loss_fn, abstract=abstract_tree(params),
                                  lr=lr, step_opts=step_opts)
        try:
            self.service.register_job(profile, specs=specs)
        except Exception:
            self._jobs.pop(job_id, None)
            raise
        # The replan listener has already moved the shared state onto the
        # new plan; the new job's lanes are zero until seeded here.
        params = tree_map(lambda t: t.to(self.device), params)
        self.state = seed_job_params(self.plan, self.state, job_id, params)

    def remove_job(self, job_id: str) -> None:
        """Job exit: its segments leave the plan; everyone else's state
        survives.  Raises ``ValueError`` for an unknown job."""
        if job_id not in self._jobs:
            raise ValueError(
                f"unknown job {job_id!r}: not registered with this runtime "
                f"(have {sorted(self._jobs)})")
        if self._engine is not None:
            # Quiesce the EXITING job: its queued pushes apply against the
            # old layout.  The replan below drains only the jobs whose
            # layout the exit disturbs.
            self._engine.quiesce_for_replan([job_id])
            self._engine._forget_job(job_id)
        info = self._jobs.pop(job_id)
        step = self._steps.pop(job_id, None)
        try:
            self.service.job_exit(job_id)
        except Exception:
            # The exit replan aborted with the registry rolled back:
            # restore this runtime's entries so both planes agree.
            self._jobs[job_id] = info
            if step is not None:
                self._steps[job_id] = step
            raise
        if self.state is not None and job_id in self.state.get("counts", {}):
            counts = dict(self.state["counts"])
            counts.pop(job_id)
            self.state = dict(self.state, counts=counts)

    @property
    def job_ids(self):
        return tuple(self._jobs)

    # ------------------------------------------------------------- training
    def step(self, job_id: str, batch):
        """One pull->compute->push->update iteration for one job, against
        the shared state."""
        self.state, metrics = self._steps[job_id](self.state, batch)
        return metrics

    def params_of(self, job_id: str):
        """Current parameters of one job (copies), pulled from the shared
        space."""
        return unflatten_tree(self.plan, self.state["flat"],
                              self._jobs[job_id]["abstract"], job_id=job_id)

    # --------------------------------------------------------------- replan
    def _on_replan(self, old: Optional[FlatPlan], new: Optional[FlatPlan]):
        engine = self._engine
        if new is None:  # last job exited
            if engine is not None and self.state is not None:
                engine.drain()
            self.plan, self.state, self._steps = None, None, {}
            if engine is not None:
                engine._on_plan_change()
            return
        # Everything that can fail runs before the migration, and the
        # runtime's plan/state/steps change together at the COMMIT below.
        delta = None
        touched = None  # None = every job's layout may have changed
        migrated = self.state is not None and old is not None
        if migrated and self.migration == "delta":
            delta = compile_migration_delta(old, new)
            touched = set(delta.touched_jobs)
        steps: Dict[str, Callable] = {}
        for job_id, info in self._jobs.items():
            # An untouched block-mode job's step closes over a layout that
            # is identical in the new plan: keep it.
            if (touched is not None and job_id not in touched
                    and job_id in self._steps
                    and info["step_opts"].get("update_mode",
                                              "block") == "block"):
                steps[job_id] = self._steps[job_id]
                continue
            steps[job_id] = make_ps_train_step(
                info["loss_fn"], new, info["abstract"],
                lr=info["lr"], job_id=job_id, **info["step_opts"])
        if migrated:
            if delta is not None:
                # Delta replan: drain ONLY the touched jobs against the OLD
                # plan; untouched jobs keep ticking.  Leaves that keep
                # their length migrate in place.
                if engine is not None:
                    engine.quiesce_for_replan(
                        [j for j in touched if j in self._jobs])
                state = migrate_flat_state_delta(self.state, old, new,
                                                 delta=delta)
            else:
                # Full-gather oracle path: hard-quiesce everything.
                if engine is not None:
                    engine.drain()
                state = migrate_flat_state(self.state, old, new)
        else:
            if engine is not None and self.state is not None:
                engine.drain()
            state = init_shared_state(new, self.device)
        # ---- COMMIT: the new layout becomes visible as a unit ----
        self.state = state
        if migrated:
            if delta is not None:
                self.last_relayout_bytes = delta.moved_bytes()
                self.total_relayout_bytes += self.last_relayout_bytes
            moved = migration_bytes(old, new)
            self.last_migration_bytes = moved
            self.total_migration_bytes += moved
            self.n_replans += 1
            self.last_replan_touched = (tuple(sorted(touched))
                                        if touched is not None
                                        else tuple(self._jobs))
        self.plan = new
        if engine is not None:
            engine._on_plan_change(touched)
        self._steps = steps
