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

:class:`ShardedServiceRuntime` is the sharded sibling: every live
Aggregator owns its own shard space, a job's step touches only the shards
hosting its blocks, the
:class:`~repro_torch.ps.engine.ShardedTickEngine` ticks the spaces on
independent cadences or the whole fleet in one launch, and the fleet
grows and shrinks with load (:class:`~repro_torch.ps.autoscaler.ElasticScaler`
through ``service.scale_out`` / ``scale_in``).  The shard spaces' states
are views into ONE fleet arena per leaf, so the fleet tick addresses
every shard without copying state.  ``recover_shard`` re-hosts a lost
(quarantined) shard's segments on the surviving fleet, and
``save_checkpoint`` / ``restore_checkpoint`` commit and restore the fleet
(a restore writes into the arena's views, migrating through K2 when the
saved fleet differs).

A job added with ``push_compression="bf16"|"int8"`` pushes through the
engines' error-feedback path: the state gains an ``ef`` buffer (on the
sharded fleet a fourth arena leaf) that migrates, snapshots and
checkpoints with flat/mu/nu.

Both runtimes run on the card unless given ``device="cpu"``.  The
sharded runtime times every replan's phases on the host into
``replan_s`` (shown by ``debug_stats()``) and, under ``torch.profiler``,
records ``add_job`` and ``replan`` spans (:mod:`repro_torch.tracing`).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..kernels.agg_adam import ops as agg_ops
from ..tracing import span, timed
from .elastic import (
    LEAVES,
    compile_migration_delta,
    migrate_flat_state,
    migrate_flat_state_delta,
    migrate_sharded_state,
    migration_bytes,
    plan_cache_stats,
    sharded_transition_summary,
)
from .faults import QUARANTINED
from .plan import FlatPlan, ShardedPlan
from .runtime import (
    _ef_round,
    _gather_packed,
    _gather_pieces,
    _layout_rows,
    _pack_slots,
    _scatter_owned,
    _split_pieces,
    _unpack_slots,
    abstract_tree,
    init_shared_state,
    job_profile_from_tree,
    make_ps_train_step,
    seed_job_params,
    tree_map,
    unflatten_tree,
)


def _debug_stats(rt, extra_runtime: Dict[str, Any],
                 shards: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """debug_stats of both runtimes: the plan-pair cache, the runtime's
    migration counters, the service's replan-transaction counters, the
    attached engine's TickStats (None detached), the fault injector's
    fire counts and the read tier's per-replica ReadStats (None without
    a ReplicaSet); the sharded runtime adds per-shard ``shards``."""
    engine = rt._engine
    injector = getattr(engine, "fault_injector", None)
    hub = getattr(engine, "_replica_hub", None)
    out = {
        "plan_cache": plan_cache_stats(),
        "runtime": {
            "n_jobs": len(rt._jobs),
            "n_replans": rt.n_replans,
            "migration_bytes_total": rt.total_migration_bytes,
            "relayout_bytes_total": rt.total_relayout_bytes,
            "last_replan_touched": list(rt.last_replan_touched),
            **extra_runtime,
        },
        "transactions": {
            "n_replan_commits": rt.service.n_replan_commits,
            "n_replan_aborts": rt.service.n_replan_aborts,
            "n_replan_retries": rt.service.n_replan_retries,
        },
        "engine": (dataclasses.asdict(engine.stats)
                   if engine is not None else None),
        "faults": (None if injector is None else {
            "n_fired": injector.n_fired,
            "by_kind": injector.fire_counts(),
        }),
        "replicas": hub.stats() if hub is not None else None,
    }
    if shards is not None:
        out["shards"] = shards
    return out


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
        """Plan-pair cache, migration and transaction counters, the
        engine's TickStats, fault and read-tier counters
        (:func:`_debug_stats`)."""
        return _debug_stats(self, {"migration": self.migration})

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
            state = init_shared_state(new, self.device,
                                      needs_ef=_needs_ef(self._jobs))
        if _needs_ef(self._jobs) and "ef" not in state:
            # A compressed job joined a state that predates it.
            state = dict(state, ef=torch.zeros_like(state["flat"]))
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


# --------------------------------------------------------------- sharded
@dataclass(frozen=True)
class RecoveryReport:
    """What one :meth:`ShardedServiceRuntime.recover_shard` did.

    ``seeded_from`` names where the re-hosted segments' values came from:
    ``"snapshot"`` (the quarantined lane's last-good snapshot, installed
    when it stopped), ``"live"`` (a healthy shard: no rollback) or
    ``"zeros"`` (quarantined with no snapshot: its in-place state was
    untrustworthy).  ``rolled_back_pushes`` counts done futures whose
    effect was discarded with the lost lane (``rolled_back`` set),
    ``cancelled_pushes`` pending pushes that can never apply, and
    ``purged_sibling_pieces`` queued pieces of those pushes removed from
    healthy lanes."""

    shard_id: str
    seeded_from: str  # 'snapshot' | 'live' | 'zeros'
    rolled_back_pushes: int
    cancelled_pushes: int
    purged_sibling_pieces: int
    rehosted_segments: int
    rehosted_elements: int
    moved_tasks: int


# The phases of a sharded replan, each timed into ``replan_s``.
REPLAN_PHASES = ("compile", "alloc", "migrate", "steps", "engine")


def _needs_ef(jobs) -> bool:
    """Whether any job pushes compressed gradients (its state then needs
    the error-feedback buffer ``ef``)."""
    return any(info["step_opts"].get("push_compression")
               for info in jobs.values())


def _arena_views(splan: ShardedPlan, arena) -> Dict[str, Dict[str, Any]]:
    """Each shard's state: a view of every arena leaf at the shard's
    ``concat_view()`` offset."""
    offsets, _, _ = splan.concat_view()
    return {sid: {k: buf[off : off + sp.total_len]
                  for k, buf in arena.items()}
            for sid, sp, off in zip(splan.shard_ids, splan.shards, offsets)}


def _init_shard_state(splan: ShardedPlan, device, leaves=LEAVES):
    """Zeroed state for every shard space of ``splan`` (the counterpart of
    the reference's per-shard ``_init_shard_state``), laid out as ONE fleet
    arena per leaf (flat/mu/nu, and ``ef`` when ``leaves`` names it): a
    (fleet lanes,) float32 buffer with each shard's leaf a view at
    ``splan.concat_view()``'s block-aligned offset.  No per-job counters:
    the runtime owns them.  Returns (arena, states)."""
    _, total, _ = splan.concat_view()
    arena = {k: torch.zeros(total, dtype=torch.float32, device=device)
             for k in leaves}
    return arena, _arena_views(splan, arena)


def _make_sharded_step(model_loss, layout, abstract_params, *, lr, b1, b2,
                       eps, device, push_compression=None):
    """O(job-bytes) step spanning ONLY the shards hosting the job:
    ``(shard_states, count, batch) -> (count + 1, {"loss"})``, writing the
    shard states in place.  The pull gathers each hosting shard's owned
    blocks into the job's packed domain; the update runs per shard, on
    that shard's piece with the job's GLOBAL step count, through K3 --
    elementwise, so splitting by shard changes nothing and the trajectory
    is the single-space block step's bit for bit.  With
    ``push_compression`` each piece first takes one error-feedback round
    against THAT shard's ``ef`` (``_ef_round``, the engines' function)."""
    rows = _layout_rows(layout, device)

    def step(shard_states, count, batch):
        pieces = _gather_pieces(layout, rows,
                                [st["flat"] for st in shard_states])
        p = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
        params = _unpack_slots(layout, p, abstract_params)
        grads, loss = torch.func.grad_and_value(model_loss)(params, batch)
        g = _pack_slots(layout, grads)
        new_count = count + 1
        for l, r, st, pp, gj in zip(layout.layouts, rows, shard_states,
                                    pieces, _split_pieces(layout, g)):
            if push_compression:
                gj = _ef_round(l, st["ef"], gj, push_compression, r)
            new_p, mu, nu = agg_ops.block_adam_update(
                pp, gj, st["mu"], st["nu"], new_count, block_idx=l.blocks,
                block=l.block, lr=lr, b1=b1, b2=b2, eps=eps, wd=0.0,
                p_packed=True)
            _scatter_owned(l, st["flat"], new_p)
            _scatter_owned(l, st["mu"], mu)
            _scatter_owned(l, st["nu"], nu)
        return new_count, {"loss": loss}

    return step


class ShardedServiceRuntime:
    """Per-Aggregator shard spaces bound to one ParameterService.

    Every live Aggregator owns a shard space (``states[agg_id]``, views
    into the fleet arena ``arena``); per-job step counts live here
    (``counts``).  A job's step touches only its hosting shards; the
    attached :class:`~repro_torch.ps.engine.ShardedTickEngine` ticks the
    spaces.  Replans, load-driven splits and merges included, migrate the
    states with :func:`~repro_torch.ps.elastic.migrate_sharded_state` into
    the next plan's arena: surviving shards run their delta through K2
    and only segments that changed Aggregator cross shard spaces.  With
    ONE Aggregator the shard space is the flat runtime's and the
    trajectory reproduces it bit for bit.

    A compressed job (``push_compression``) gives the arena a fourth leaf,
    ``ef``, with a view per shard like flat/mu/nu; K1 never reads it.
    Every write into the arena (a rollback, a restore) copies into the
    views, so the lanes, the engine's tables and the read tier keep
    addressing the one arena.
    """

    def __init__(self, service, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.service = service
        self.splan: Optional[ShardedPlan] = None
        self.arena: Optional[Dict[str, torch.Tensor]] = None
        self.states: Dict[str, Dict[str, torch.Tensor]] = {}
        self.counts: Dict[str, int] = {}  # job -> global step count
        self.last_migration_bytes = 0  # cross-Aggregator (paper accounting)
        self.total_migration_bytes = 0
        self.last_relayout_bytes = 0  # bytes the sharded delta path moved
        self.total_relayout_bytes = 0
        self.last_replan_touched: tuple = ()
        self.n_replans = 0
        # Host seconds of every replan (first layouts included), by phase.
        self.replan_s = dict.fromkeys(REPLAN_PHASES, 0.0)
        self._jobs: Dict[str, Dict[str, Any]] = {}
        self._steps: Dict[str, Tuple[Tuple[str, ...], Callable]] = {}
        self._engine = None
        service.on_replan(self._on_replan)

    # ------------------------------------------------------------- plumbing
    @property
    def n_shards(self) -> int:
        return self.splan.n_shards if self.splan is not None else 0

    @property
    def shard_ids(self):
        return self.splan.shard_ids if self.splan is not None else ()

    @property
    def job_ids(self):
        return tuple(self._jobs)

    @property
    def engine(self):
        return self._engine

    def attach_engine(self, **engine_opts):
        """Create (once) and return the per-shard tick engine."""
        from .engine import ShardedTickEngine

        if self._engine is None:
            self._engine = ShardedTickEngine(self, **engine_opts)
        elif engine_opts:
            raise ValueError("engine already attached; cannot re-configure")
        return self._engine

    def debug_stats(self) -> Dict[str, Any]:
        """:func:`_debug_stats` plus the shard count, the replans' host
        seconds by phase (``replan_s``) and every lane's TickStats and
        health."""
        extra = {"n_shards": self.n_shards, "replan_s": dict(self.replan_s)}
        eng = self._engine
        if eng is None:
            return _debug_stats(self, extra, shards={})
        health = eng.shard_health()
        return _debug_stats(
            self, extra,
            shards={sid: {**dataclasses.asdict(st), "health": health[sid]}
                    for sid, st in eng.shard_stats().items()})

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
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        **step_opts,
    ) -> None:
        """Register a job and seed its parameters into the shards the
        control plane assigned its tensors to.  With
        ``push_compression="bf16"|"int8"`` in ``step_opts`` its pushes take
        the error-feedback path, and the fleet gains the ``ef`` leaf."""
        if job_id in self._jobs:
            raise ValueError(f"job {job_id} already in the runtime")
        with span("add_job"):
            profile, specs = job_profile_from_tree(
                job_id, params,
                iteration_duration=iteration_duration,
                n_workers=n_workers,
                required_servers=required_servers,
                agg_throughput=agg_throughput,
            )
            self._jobs[job_id] = dict(
                loss_fn=loss_fn, abstract=abstract_tree(params),
                lr=lr, b1=b1, b2=b2, eps=eps, step_opts=step_opts)
            with span("add_job.register"):
                try:
                    self.service.register_job(profile, specs=specs)
                except Exception:
                    self._jobs.pop(job_id, None)
                    raise
            with span("add_job.seed"):
                self._seed_job(job_id, tree_map(lambda t: t.to(self.device),
                                                params))

    def remove_job(self, job_id: str) -> None:
        """Job exit: its segments leave every hosting shard.  The job's
        queued pushes drain against the old layout first.  Raises
        ``ValueError`` for an unknown job, leaving the runtime as it
        was."""
        if job_id not in self._jobs:
            raise ValueError(
                f"unknown job {job_id!r}: not registered with this runtime "
                f"(have {sorted(self._jobs)})")
        if self._engine is not None:
            self._engine.quiesce_for_replan([job_id])
            self._engine._forget_job(job_id)
        info = self._jobs.pop(job_id)
        step = self._steps.pop(job_id, None)
        count = self.counts.pop(job_id, None)
        try:
            self.service.job_exit(job_id)
        except Exception:
            # The exit replan aborted with the registry rolled back:
            # restore this runtime's entries so both planes agree.
            self._jobs[job_id] = info
            if step is not None:
                self._steps[job_id] = step
            if count is not None:
                self.counts[job_id] = count
            raise

    def _seed_job(self, job_id: str, params) -> None:
        """Write the job's parameters into its owned blocks of every
        hosting shard, in place, with zero moments, error feedback and
        step count."""
        layout = self.splan.job_layout(job_id)
        packed = _pack_slots(layout, params).to(self.device)
        for sid, l, piece in zip(layout.shard_ids, layout.layouts,
                                 _split_pieces(layout, packed)):
            st = self.states[sid]
            _scatter_owned(l, st["flat"], piece)
            for k in [k for k in st if k != "flat"]:
                _scatter_owned(l, st[k], torch.zeros(
                    l.packed_len, dtype=torch.float32, device=self.device))
        self.counts[job_id] = 0

    # ------------------------------------------------------------- training
    def step(self, job_id: str, batch):
        """One pull -> compute -> push -> update iteration for one job,
        touching only the shards that host its blocks."""
        hosting, fn = self._steps[job_id]
        self.counts[job_id], metrics = fn(
            [self.states[sid] for sid in hosting], self.counts[job_id],
            batch)
        return metrics

    def params_of(self, job_id: str):
        """Current parameters of one job (copies), gathered across its
        shards."""
        layout = self.splan.job_layout(job_id)
        packed = _gather_packed(
            layout, _layout_rows(layout, self.device),
            [self.states[sid]["flat"] for sid in layout.shard_ids])
        return _unpack_slots(layout, packed, self._jobs[job_id]["abstract"])

    def recover_shard(self, agg_id: str) -> RecoveryReport:
        """Declare ONE Aggregator lost and re-host its segments on the
        surviving fleet through an ordinary control-plane replan
        (``service.evacuate_aggregator``): untouched jobs tick straight
        through it and the moved segments ride the sharded delta path.

        A quarantined lane's state was restored to its last-good snapshot
        when it stopped, so clients see at most ``snapshot_interval``
        ticks of rollback; with no snapshot (``snapshot_interval=0``) the
        in-place apply may have left it half-written, so its views are
        zeroed and the segments re-seed empty.  A healthy shard drains
        first and its live state migrates (a decommission, no rollback).
        The pushes left on the lost lane surface on their futures: done
        ones get ``rolled_back``, pending ones are cancelled, and their
        sibling pieces are purged from healthy lanes so no push applies
        on some shards only."""
        if self.splan is None or agg_id not in self.splan.shard_ids:
            raise ValueError(
                f"unknown shard {agg_id!r}: not in the live fleet "
                f"(have {list(self.shard_ids)})")
        old_sp = self.splan.shard_of(agg_id)
        seeded_from = "live"
        rolled_back = cancelled = purged = 0
        eng = self._engine
        lane = None
        if eng is not None:
            lane = eng._lanes.get(agg_id)
            if lane is not None and lane.health != QUARANTINED:
                while any(lane.queues.values()):
                    if eng.tick_shard(agg_id) == 0:
                        break  # leftovers are cancelled below
            lane = eng._lanes.pop(agg_id, None)
        if lane is not None:
            if lane.health == QUARANTINED:
                if lane.snapshot is not None:
                    seeded_from = "snapshot"
                else:
                    seeded_from = "zeros"
                    for v in self.states[agg_id].values():
                        v.zero_()
            dead = set()
            for q in lane.queues.values():
                for _, _, fut, _ in q:
                    if fut is None:
                        continue
                    if fut.done():
                        if not fut._rolled_back:
                            fut._rolled_back = True
                            rolled_back += 1
                    elif not fut.cancelled():
                        fut._cancel(
                            f"shard {agg_id!r} was lost with this piece "
                            f"queued (inside its rollback window); re-push "
                            f"after recovery")
                        cancelled += 1
                        dead.add(id(fut))
            if dead:
                for other in eng._lanes.values():
                    for j, q in list(other.queues.items()):
                        kept = deque(e for e in q if e[2] is None
                                     or id(e[2]) not in dead)
                        purged += len(q) - len(kept)
                        other.queues[j] = kept
        moved_tasks = self.service.evacuate_aggregator(agg_id)
        return RecoveryReport(
            shard_id=agg_id, seeded_from=seeded_from,
            rolled_back_pushes=rolled_back, cancelled_pushes=cancelled,
            purged_sibling_pieces=purged,
            rehosted_segments=len(old_sp.segments),
            rehosted_elements=old_sp.payload_elements,
            moved_tasks=moved_tasks)

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self, directory, step: int, **kw):
        """Commit the shard map, every shard space (``ef`` included) and
        the per-job step counts atomically
        (:func:`~repro_torch.checkpoint.save_sharded_checkpoint`).  Drains
        the engine first (a queued push is lost to a restore) and records
        the fleet's health in the aux record."""
        from ..checkpoint import save_sharded_checkpoint

        if self._engine is not None:
            self._engine.drain()
            if "extra_aux" not in kw:
                kw["extra_aux"] = {"shard_health":
                                   self._engine.shard_health()}
        return save_sharded_checkpoint(directory, step, self.splan,
                                       self.states, self.counts, **kw)

    def restore_checkpoint(self, directory, step: int, **kw) -> None:
        """Restore the shard states and step counts of a sharded
        checkpoint INTO the live arena's views (``copy_``), so every lane,
        the engine's appliers and the read tier keep addressing the one
        arena; a checkpoint of another fleet (N shards into this
        runtime's M) migrates into the arena through
        ``migrate_sharded_state`` (K2 on the surviving shards' deltas).
        The jobs must already be registered.  A checkpoint with ``ef``
        widens a fleet without it; one without leaves ``ef`` zero.  The
        engine drains first, and its lane snapshots, replay logs and step
        mirrors are dropped: they describe the state before the restore,
        and every lane's jobs are stamped as changed for diff pulls."""
        from ..checkpoint import load_aux, restore_sharded_checkpoint

        if self._engine is not None:
            self._engine.drain()
        aux = load_aux(directory, step) or {}
        if any("ef" in leaves
               for leaves in aux.get("shard_leaves", {}).values()):
            self._widen_ef()
        _, _, counts = restore_sharded_checkpoint(
            directory, step, splan=self.splan, device=self.device,
            out=self.states, **kw)
        self.counts = dict(counts)
        eng = self._engine
        if eng is not None:
            eng._counts.clear()
            for lane in eng._lanes.values():
                lane.snapshot, lane.log, lane.ticks_since_snapshot = \
                    None, [], 0
                eng._stamp_lane(lane, self.splan.shard_of(
                    lane.shard_id).job_ids)

    # --------------------------------------------------------------- replan
    def _widen_ef(self) -> None:
        """Give the fleet a zero ``ef`` arena and every shard its view,
        leaving flat/mu/nu as they are (a no-op when it has one)."""
        if self.arena is None or "ef" in self.arena:
            return
        self.arena["ef"] = torch.zeros_like(self.arena["flat"])
        for sid, views in _arena_views(self.splan,
                                       {"ef": self.arena["ef"]}).items():
            self.states[sid]["ef"] = views["ef"]

    def _on_replan(self, old_flat, new_flat):
        """The service's replan listener: move the fleet onto the new
        sharded plan.  Each phase's host seconds add to ``replan_s``."""
        with span("replan"):
            self._replan(old_flat, new_flat)

    def _replan(self, old_flat, new_flat):
        engine = self._engine
        phase = self.replan_s
        if new_flat is None:  # last job exited
            if engine is not None and self.states:
                with timed("replan.migrate", phase):
                    engine.drain()
            self.splan, self.arena, self.states = None, None, {}
            self._steps, self.counts = {}, {}
            if engine is not None:
                with timed("replan.engine", phase):
                    engine._on_plan_change(None)
            return
        with timed("replan.compile", phase):
            new = self.service.compile_sharded_plan()
        old = self.splan
        # Everything up to the COMMIT below is computed into locals, and
        # the migration only reads the old states, so a failure leaves
        # splan/arena/states/steps on the old layout for the service's
        # transaction to roll back against.
        touched = None  # None: every job's layout may have changed
        moved_elems = 0
        migrated = old is not None and bool(self.states)
        with timed("replan.alloc", phase):
            # ef joins the arena with the first compressed job and stays,
            # as the reference's per-shard ef buffers do.
            leaves = (LEAVES + ("ef",) if _needs_ef(self._jobs) or (
                self.arena is not None and "ef" in self.arena) else LEAVES)
            arena, fresh = _init_shard_state(new, self.device, leaves)
        with timed("replan.migrate", phase):
            if migrated:
                _, touched_pre = sharded_transition_summary(old, new)
                if engine is not None:
                    engine.quiesce_for_replan(
                        [j for j in touched_pre if j in self._jobs])
                states, moved_elems, touched_exec = migrate_sharded_state(
                    self.states, old, new, out=fresh,
                    fault_injector=(engine.fault_injector
                                    if engine is not None else None))
                touched = set(touched_exec)
            else:
                if engine is not None and self.states:
                    engine.drain()
                states = fresh
        steps: Dict[str, Tuple[Tuple[str, ...], Callable]] = {}
        with timed("replan.steps", phase):
            for job_id, info in self._jobs.items():
                # An untouched job's layout is the same on every hosting
                # shard: keep its step.
                if (touched is not None and job_id not in touched
                        and job_id in self._steps):
                    steps[job_id] = self._steps[job_id]
                    continue
                layout = new.job_layout(job_id)
                steps[job_id] = (layout.shard_ids, _make_sharded_step(
                    info["loss_fn"], layout, info["abstract"], lr=info["lr"],
                    b1=info["b1"], b2=info["b2"], eps=info["eps"],
                    device=self.device,
                    push_compression=info["step_opts"].get(
                        "push_compression")))
        # ---- COMMIT: the new layout becomes visible as a unit ----
        self.arena, self.states = arena, states
        if migrated:
            self.last_relayout_bytes = moved_elems * 12
            self.total_relayout_bytes += self.last_relayout_bytes
            self.last_replan_touched = tuple(sorted(touched))
            self.n_replans += 1
            if old_flat is not None:
                moved = migration_bytes(old_flat, new_flat)
                self.last_migration_bytes = moved
                self.total_migration_bytes += moved
        self.splan = new
        if engine is not None:
            with timed("replan.engine", phase):
                engine._on_plan_change(touched)
        self._steps = steps
