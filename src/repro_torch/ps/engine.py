"""Service-tick engines: batched multi-job aggregation with bounded
staleness, over one flat shared space or a sharded fleet (PyTorch).

The counterpart of ``repro.ps.engine.ServiceTickEngine``:

  submit_push  a job pushes its packed gradient into its bounded per-job
               queue and gets a :class:`PushFuture`; nothing applies yet
  tick         the HEAD push of every pending job applies in ONE launch of
               the multi-job Adam kernel (K1), written in place into the
               shared flat/mu/nu; below ``min_batch_jobs`` pending jobs
               each job's push goes through the same applier alone
  pull         a job reads its own lanes; a job ``max_staleness`` steps
               ahead of the service forces ticks first; with
               ``since_version`` only the owned blocks whose version
               moved since the client's :class:`PullVersion` ship, as a
               :class:`PullDiff`

Block exclusivity makes the batched pass a pure execution-order change:
bit-exact with K sequential per-job block steps.  Replans are stall-free:
only the jobs a :class:`~repro_torch.ps.elastic.MigrationDelta` touches
are drained before the state migrates; untouched jobs keep their queues,
whose pushes are re-tagged across a per-push epoch fence.

Fault tolerance: every ``snapshot_interval`` applying ticks the engine
CLONES the state (appliers write in place, so a snapshot that aliased
live state would silently change) and logs the pushes applied since; a
failed apply restores a clone of the snapshot and replays the log, and
``max_apply_retries`` consecutive failures quarantine the engine.

Read tier: a :class:`~repro_torch.ps.replica.ReplicaSet` registers as
``engine._replica_hub`` and is offered a snapshot every applying tick,
pre-apply, at the rollback-snapshot point.  What it publishes is always a
clone (the rollback anchor's, or its own), never the live buffers.

:class:`ShardedTickEngine` is the counterpart of the reference's
sharded engine: one tick loop per shard space (``tick_shard``), a job's
push split into one piece per hosting shard, and ``tick_fleet`` applying
every pending piece of the fleet in ONE launch of K1.  Its shard states
are views into one fleet arena per leaf (``ShardedServiceRuntime.arena``),
so the fleet tick hands K1 the arena with block tables rebased by each
shard's offset, and no state is concatenated or sliced back.  Its
lanes roll back, replay and quarantine one by one, and a failed fleet
launch falls back to per-shard launches of the same kernel.

Compressed pushes (``push_compression="bf16"|"int8"`` on a job): each
applier runs one error-feedback round (``runtime._ef_round``: one
``ef_round`` kernel launch on a card) on every compressed job's packed
piece against its owned rows of the state's ``ef`` buffer before the K1
launch, so the compressed trajectory is the
block step's bit for bit.  ``ef`` rides snapshots, rollback and
migrations with flat/mu/nu; on the sharded fleet it is a fourth arena
leaf that K1 never reads.  ``TickStats.push_bytes_wire`` prices each push
with ``compression.wire_bytes``.

Leases: with ``lease_interval`` every push and pull renews the job's
lease (on an injectable ``clock``), and ``expire_leases()`` reclaims the
jobs whose trainers went silent through ``runtime.remove_job``, the
replan path; their queued futures raise :class:`LeaseExpiredError`.

Under ``torch.profiler`` both engines record their submits, pulls,
steps and ticks, and the parts of each, as ``repro_torch.*`` spans
(:mod:`repro_torch.tracing`); without a profiler the spans do nothing.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import host_to_device
from ..kernels.agg_adam import ops as agg_ops
from ..tracing import span
from .compression import wire_bytes
from .faults import (
    HEALTHY,
    QUARANTINED,
    EngineQuarantinedError,
    LeaseExpiredError,
    RetryPolicy,
)
from .plan import FlatPlan
from .runtime import (
    _ef_round,
    _gather_owned,
    _gather_packed,
    _layout_rows,
    _pack_slots,
    _rows,
    _split_pieces,
    _unpack_slots,
)

__all__ = ["PullDiff", "PullVersion", "PushFuture", "ServiceTickEngine",
           "ShardedTickEngine", "TickStats"]


class PushFuture:
    """Handle for one submitted push; resolves when a tick applies it.  A
    push dropped without applying is CANCELLED: ``result()`` raises
    instead of forcing ticks forever.  A push whose applied effect was
    later discarded by ``recover_shard`` (it lay in the lost lane's
    rollback window) keeps its step but reports ``rolled_back``."""

    __slots__ = ("job_id", "_engine", "_done", "_step", "_remaining",
                 "_cancelled", "_cancel_exc", "_rolled_back")

    def __init__(self, job_id: str, engine, parts: int = 1):
        self.job_id = job_id
        self._engine = engine
        self._done = False
        self._step = None
        # Under the sharded engine one push is one PIECE per hosting
        # shard; the future resolves when the last piece applies.
        self._remaining = int(parts)
        self._cancelled = None  # str reason once cancelled
        self._cancel_exc = None  # contextual exception behind the cancel
        self._rolled_back = False  # applied, then lost with a dead shard

    def done(self) -> bool:
        return self._done

    def cancelled(self) -> bool:
        return self._cancelled is not None

    @property
    def rolled_back(self) -> bool:
        """True if this push had applied but ``recover_shard`` discarded
        its effect (re-push to land the update again)."""
        return self._rolled_back

    def result(self, timeout: Optional[float] = None) -> int:
        """Force service ticks until applied; returns the job's 1-based
        step count as of this push.  When ticking makes no progress and
        the push can never resolve, raises the blocking lane's
        :class:`EngineQuarantinedError` (or a ``RuntimeError`` when the
        piece is gone); with ``timeout`` (seconds, wall clock) it waits
        out the deadline first and then raises that quarantine error or
        ``TimeoutError``.  A cancelled push raises at once: its stored
        error (a :class:`LeaseExpiredError` when its job was reclaimed),
        or a ``RuntimeError``.  The flat engine's single lane raises its
        quarantine out of ``tick()`` itself."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while not self._done:
            if self._cancelled is not None:
                if self._cancel_exc is not None:
                    raise self._cancel_exc
                raise RuntimeError(
                    f"push for job {self.job_id!r} will never apply: "
                    f"{self._cancelled}")
            if deadline is not None and time.monotonic() >= deadline:
                stall = self._engine._stall_error(self.job_id)
                if isinstance(stall, EngineQuarantinedError):
                    raise stall
                raise TimeoutError(
                    f"push for job {self.job_id!r} still unapplied after "
                    f"{timeout} s (hosting lane quarantined, or a piece "
                    f"was dropped in transit)")
            if self._engine.tick() == 0 and not self._done:
                # No progress: a rollback may just have re-queued work
                # (keep ticking), or the push is stuck for good.
                stall = self._engine._stall_error(self.job_id)
                if stall is None:
                    continue
                if deadline is None:
                    raise stall
                time.sleep(0.001)  # wait out the timeout, don't hot-spin
        return self._step

    def _resolve(self, step: int) -> bool:
        """One piece applied; True if this completed the push."""
        if self._done:
            return False
        self._remaining -= 1
        if self._remaining <= 0:
            self._done = True
            self._step = int(step)
            return True
        return False

    def _unresolve(self) -> None:
        """A rollback un-applied one piece: a pending future gets the part
        back (it must not complete before the replay re-applies it); a
        done one stays done, its result already observable and the
        replay re-landing the identical update."""
        if not self._done:
            self._remaining += 1

    def _cancel(self, reason: str,
                exc: Optional[BaseException] = None) -> None:
        """Cancel, with an optional exception for ``result()`` to raise.
        The FIRST cancellation wins, its context kept."""
        if not self._done and self._cancelled is None:
            self._cancelled = reason
            self._cancel_exc = exc


@dataclass
class TickStats:
    """Engine counters: how batched the service actually ran.  The fields
    are the reference's, so the two packages' counters compare directly;
    those of parts not ported yet stay 0."""

    n_ticks: int = 0  # batched passes executed
    n_applied: int = 0  # pushes applied across all ticks
    n_launches: int = 0  # applier launches (the single-launch gauge)
    n_forced_staleness: int = 0  # ticks forced by a pull at the bound
    n_forced_capacity: int = 0  # ticks forced by a full push queue
    n_forced_replan: int = 0  # ticks forced to drain TOUCHED jobs on a replan
    n_per_job_dispatch: int = 0  # ticks dispatched as per-job passes (< K_min)
    n_replans: int = 0  # plan changes the engine rode through
    n_retagged: int = 0  # untouched pushes carried across a replan (fence)
    n_snapshots: int = 0  # last-good state copies taken (rollback anchors)
    n_rollbacks: int = 0  # failed applies recovered by snapshot restore
    n_replayed: int = 0  # applied pushes re-queued for replay by rollbacks
    n_quarantines: int = 0  # lanes that exhausted retries and stopped
    n_fleet_fallbacks: int = 0  # failed fleet launches replayed per shard
    n_lease_expirations: int = 0  # jobs reclaimed by expire_leases
    # Push bytes are counted at submit time: fp32 4 B a lane, and on the
    # wire after each job's compression (``compression.wire_bytes``).
    push_bytes_raw: int = 0  # fp32 bytes of every submitted push
    push_bytes_wire: int = 0  # same pushes after each job's compression
    n_full_pulls: int = 0  # whole-slice pulls (incl. diff-pull fallbacks)
    n_diff_pulls: int = 0  # versioned pulls that shipped changed blocks only
    pull_bytes_wire: int = 0  # pull payload bytes actually shipped
    pull_bytes_full: int = 0  # what the same pulls cost as full pulls

    @property
    def mean_batch(self) -> float:
        """Mean jobs applied per tick."""
        if not self.n_ticks:
            return 0.0
        return self.n_applied / self.n_ticks


@dataclass(frozen=True)
class PullVersion:
    """Opaque version vector one versioned pull returns: the plan epoch it
    was taken under plus one monotone version per owned block of the job
    (packed layout order).  Hand it back as ``since_version`` to receive
    only the blocks that changed."""

    epoch: int
    versions: np.ndarray  # int64, one per owned block, layout order


@dataclass(frozen=True)
class PullDiff:
    """Result of ``pull(job_id, since_version=...)``: only the owned blocks
    whose version moved past the client's vector, plus the new vector.

    ``full=True`` is the fallback (first pull, plan-epoch mismatch, or a
    stale or mismatched vector): ``data`` is the whole packed job vector.
    Otherwise ``data`` is the ``(k, block)`` changed rows and
    ``block_ids`` their job-local packed block indices; :meth:`apply`
    patches them onto the client's previous packed vector.  ``bytes_wire``
    is what this pull shipped under the fp32 wire model, ``bytes_full``
    what a full pull would have.  ``data`` is always a new tensor, never
    a view of live or published state."""

    job_id: str
    version: PullVersion
    full: bool
    block: int
    block_ids: np.ndarray  # job-local packed block rows; empty when full
    data: torch.Tensor  # (packed_len,) when full, else (k, block) rows
    bytes_wire: int
    bytes_full: int

    def apply(self, prev_packed: torch.Tensor) -> torch.Tensor:
        """Patch this diff onto the client's previous packed vector and
        return the up-to-date packed vector: a new tensor when blocks
        changed (the client's vector is left as it was, as the reference's
        functional update leaves it), the client's vector itself when none
        did, as in the reference."""
        if self.full:
            return self.data
        if self.block_ids.size == 0:
            return prev_packed
        out = prev_packed.clone()
        rows = host_to_device(self.block_ids, out.device, torch.int64)
        out.view(-1, self.block)[rows] = self.data
        return out


def _copy_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """Deep copy of one state dict with every tensor CLONED: appliers write
    the live buffers in place, so a snapshot (or a restore) that aliased
    them would change under the next tick."""
    out = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
           for k, v in state.items()}
    if "counts" in out:
        out["counts"] = dict(out["counts"])
    return out


# ------------------------------------------------ shared applier building
def _flat_job_hp(info) -> Tuple[float, float, float, float]:
    """(lr, b1, b2, eps) of one flat-runtime job (Adam knobs ride in
    ``step_opts``)."""
    so = info["step_opts"]
    return (float(info["lr"]), float(so.get("b1", 0.9)),
            float(so.get("b2", 0.999)), float(so.get("eps", 1e-8)))


def _sharded_job_hp(info) -> Tuple[float, float, float, float]:
    """(lr, b1, b2, eps) of one sharded-runtime job (first-class fields)."""
    return (float(info["lr"]), float(info["b1"]), float(info["b2"]),
            float(info["eps"]))


def _fused_tables(layouts, infos, hp_of, base_blocks=None):
    """The tables one fused multi-job apply needs: the concatenated
    owned-block index table, per-entry block counts, and per-entry
    ``(lr, b1, b2, eps)`` columns.  The fleet tick passes ``base_blocks``,
    each entry's shard offset in the fleet arena in blocks, which rebases
    a shard-local block table to arena block ids."""
    if base_blocks is None:
        base_blocks = (0,) * len(layouts)
    block_idx = np.concatenate([l.blocks.astype(np.int32) + np.int32(b)
                                for l, b in zip(layouts, base_blocks)])
    job_sizes = tuple(int(l.blocks.size) for l in layouts)
    lr, b1, b2, eps = zip(*(hp_of(i) for i in infos))
    return block_idx, job_sizes, (lr, b1, b2, eps)


def _device_tables(block_idx, job_sizes, device):
    """An applier's block table and job-slot map, on ``device`` once."""
    job_slot = np.repeat(np.arange(len(job_sizes), dtype=np.int32),
                         np.asarray(job_sizes, np.int64))
    return (host_to_device(block_idx, device, torch.int32),
            host_to_device(job_slot, device, torch.int32))


def _fused_state_update(state, gs, counts, *, block, block_idx, job_slot,
                        job_sizes, hps):
    """ONE fused launch over one state dict: aggregation + Adam + the
    block writes for flat/mu/nu, in place.  ``gs`` is the per-entry packed
    gradient sequence, concatenated every tick as the reference does."""
    lr, b1, b2, eps = hps
    agg_ops.multi_job_adam_update_fused(
        state["flat"], gs, state["mu"], state["nu"], counts,
        block_idx=block_idx, job_slot=job_slot, job_sizes=job_sizes,
        block=block, lr=lr, b1=b1, b2=b2, eps=eps, wd=0.0)
    return state


def _compressed_entries(layouts, infos, device):
    """(entry index, kind, layout, owned rows on ``device``) of every
    compressed job among an applier's entries."""
    return [(i, kind, l, None if l.covers_all else _rows(l, device))
            for i, (l, info) in enumerate(zip(layouts, infos))
            if (kind := info["step_opts"].get("push_compression"))]


def _ef_rounds(gs, compressed, ef_of):
    """The gradients with each compressed entry's replaced by its
    error-feedback round against ``ef_of(entry index)`` (whose owned rows
    take the residual in place).  The queued gradients are only read, so
    a replay after a rollback compresses the same pushes again."""
    gs = list(gs)
    with span("tick.ef"):
        for i, kind, layout, rows in compressed:
            gs[i] = _ef_round(layout, ef_of(i), gs[i], kind, rows)
    return tuple(gs)


def _must_force(engine, job_id: str) -> bool:
    """Whether a step has to tick first: the job is more than
    ``max_staleness`` pushes ahead, or one of its queues is full."""
    return engine.outstanding(job_id) > min(engine.max_staleness,
                                            engine.queue_capacity - 1)


class _Leases:
    """Job leases, the same in both engines: ``lease_interval`` (None:
    off) on a clock (``time.monotonic`` unless injected); every push and
    pull renews the job's deadline."""

    def _init_leases(self, lease_interval, clock) -> None:
        if lease_interval is not None and lease_interval <= 0:
            raise ValueError(f"lease_interval must be > 0 (None disables "
                             f"leases), got {lease_interval}")
        self.lease_interval = (None if lease_interval is None
                               else float(lease_interval))
        self._clock = clock if clock is not None else time.monotonic
        self._leases: Dict[str, float] = {}  # job -> expiry deadline

    def _renew_lease(self, job_id: str) -> None:
        if self.lease_interval is not None:
            self._leases[job_id] = self._clock() + self.lease_interval

    def lease_deadline(self, job_id: str) -> Optional[float]:
        """The job's current lease expiry (None: leases off, or no contact
        yet)."""
        return self._leases.get(job_id)

    def _expire(self, queues_of, fut_of) -> Tuple[str, ...]:
        """``expire_leases`` over the job's queues (``queues_of(job)``, one
        per lane), ``fut_of(entry)`` a queued entry's future."""
        if self.lease_interval is None:
            return ()
        now = self._clock()
        expired = tuple(sorted(j for j, deadline in self._leases.items()
                               if deadline <= now and j in self.runtime._jobs))
        for job_id in expired:
            err = LeaseExpiredError(job_id, self._leases[job_id], now)
            for q in queues_of(job_id):
                if q:
                    for entry in q:
                        if fut_of(entry) is not None:
                            fut_of(entry)._cancel(str(err), exc=err)
                    q.clear()
            self._leases.pop(job_id, None)
            self.stats.n_lease_expirations += 1
            try:
                self.runtime.remove_job(job_id)
            except Exception:
                # The reclaim's replan failed: re-arm the lease so the
                # next sweep retries instead of leaking the job.
                self._leases[job_id] = now + self.lease_interval
                raise
        return expired


class ServiceTickEngine(_Leases):
    """Batched executor for one :class:`ServiceRuntime`'s shared state.

    Created via :meth:`ServiceRuntime.attach_engine`.  The engine owns the
    per-job push queues and the appliers (with their block tables on the
    device); the runtime owns plan + state and migrates them on replans,
    draining this engine's touched jobs first.
    """

    MAX_APPLIERS = 32  # appliers per plan (one per pending-job subset)

    def __init__(self, runtime, *, max_staleness: int = 1,
                 queue_capacity: Optional[int] = None,
                 min_batch_jobs: int = 3, snapshot_interval: int = 8,
                 max_apply_retries: int = 1, fault_injector=None,
                 retry_policy=None, lease_interval: Optional[float] = None,
                 clock=None):
        if max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got {max_staleness}")
        if snapshot_interval < 0:
            raise ValueError(
                f"snapshot_interval must be >= 0 (0 disables rollback "
                f"recovery), got {snapshot_interval}")
        self.runtime = runtime
        self.max_staleness = int(max_staleness)
        self.queue_capacity = (self.max_staleness + 1 if queue_capacity is None
                               else int(queue_capacity))
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        # Below this many pending jobs a tick applies each job's push on
        # its own (identical result: disjoint blocks commute).
        self.min_batch_jobs = int(min_batch_jobs)
        self.snapshot_interval = int(snapshot_interval)
        if retry_policy is None:
            retry_policy = RetryPolicy(max_retries=int(max_apply_retries))
        self.retry_policy = retry_policy
        self.max_apply_retries = int(retry_policy.max_retries)
        self.fault_injector = fault_injector
        self._init_leases(lease_interval, clock)
        self.stats = TickStats()
        self.health = HEALTHY
        self.quarantine_error: Optional[EngineQuarantinedError] = None
        self._snapshot = None  # (state clone, counts-mirror copy)
        self._snapshot_log: List[Tuple] = []  # (job, packed, fut) applied
        self._ticks_since_snapshot = 0
        self._failures = 0  # consecutive failed applies
        self._epoch = 0  # bumped per plan change; fences queued pushes
        self._queues: Dict[str, deque] = {}
        # Diff-pull versions: one monotone version per ``block_align``
        # block of the flat space, moved every applying tick; reset on
        # plan changes (the vector carries the epoch, so a stale client
        # falls back to a full pull).  Within an epoch every block is
        # owned by one job, so a block's version is its job's last stamp:
        # ticks stamp jobs (O(jobs)), and the per-block array is built
        # only when read (``_versions_array``).
        self._job_versions: Dict[str, int] = {}
        self._block_versions: Optional[np.ndarray] = None  # read-only
        self._version_clock = 0
        # Read tier: a ReplicaSet registers here and is offered a
        # publishable snapshot every applying tick.
        self._replica_hub = None
        # Host mirror of state["counts"]: futures resolve from it.
        self._counts: Dict[str, int] = {}
        # Per-plan caches, invalidated on replans.
        self._appliers: Dict[Tuple[str, ...], Callable] = {}
        self._rows: Dict[str, torch.Tensor] = {}  # owned blocks on device

    # ------------------------------------------------------------- plumbing
    @property
    def plan(self) -> Optional[FlatPlan]:
        return self.runtime.plan

    def _queue(self, job_id: str) -> deque:
        info = self.runtime._jobs.get(job_id)
        if info is None:
            raise ValueError(f"unknown job {job_id!r}: not registered with "
                             f"the runtime (have {sorted(self.runtime._jobs)})")
        if job_id not in self._counts:
            self._counts[job_id] = int(self.runtime.state["counts"][job_id])
        self._renew_lease(job_id)
        return self._queues.setdefault(job_id, deque())

    def outstanding(self, job_id: str) -> int:
        """Pushes submitted by the job but not yet applied by a tick."""
        q = self._queues.get(job_id)
        return len(q) if q else 0

    def expire_leases(self) -> Tuple[str, ...]:
        """Reclaim every job whose lease has lapsed; returns their ids.

        Every push and pull renews the job's lease, so only a trainer that
        was silent for a whole ``lease_interval`` expires.  Its queued
        pushes are cancelled with a :class:`LeaseExpiredError` (held
        futures raise it), then the job leaves through
        ``runtime.remove_job``, the replan path, so its space frees.  If
        that replan aborts, the lease is re-armed one interval out and
        the error raised; the next call retries."""
        return self._expire(lambda j: [self._queues.get(j)],
                            lambda entry: entry[1])

    def quiesce_for_replan(self, touched) -> int:
        """Drain ONLY the touched jobs' queues ahead of a migration: their
        pushes apply against the OLD plan.  Returns pushes applied."""
        applied = 0
        while True:
            pending = [j for j in touched if self._queues.get(j)]
            if not pending:
                return applied
            self.stats.n_forced_replan += 1
            applied += self.tick(only=pending)

    def _on_plan_change(self, touched=None) -> None:
        """Replan landed: drop the snapshot (it holds the old geometry) and
        what the new plan breaks.  ``touched=None`` (full quiesce) requires
        every queue empty and drops every applier; with a delta's touched
        set only their appliers go, and untouched jobs' queued pushes are
        re-tagged to the new epoch."""
        self._epoch += 1
        self.stats.n_replans += 1
        self._snapshot = None
        self._snapshot_log = []
        self._ticks_since_snapshot = 0
        # Block versions index the OLD geometry; the epoch bump already
        # invalidates every held PullVersion, so restart the vector.
        self._job_versions = {}
        self._block_versions = None
        if self._replica_hub is not None:
            # Read-tier snapshots hold the old geometry too: the epoch
            # fence marks them stale and the next serve resubscribes.
            self._replica_hub.on_replan()
        if touched is None:
            if any(self._queues.values()):
                raise RuntimeError("replan with queued pushes: the runtime "
                                   "must drain the engine first")
            self._appliers.clear()
            self._rows.clear()
            return
        touched = set(touched)
        for j in touched:
            if self._queues.get(j):
                raise RuntimeError(
                    f"replan with queued pushes for TOUCHED job {j!r}: "
                    f"quiesce_for_replan must drain it first")
        for j, q in self._queues.items():
            if q:  # untouched by construction: carry across the fence
                self.stats.n_retagged += len(q)
                self._queues[j] = deque(
                    (packed, fut, self._epoch) for packed, fut, _ in q)
        for j in touched:
            self._rows.pop(j, None)
        self._appliers = {k: v for k, v in self._appliers.items()
                          if not touched.intersection(k)}

    def _forget_job(self, job_id: str) -> None:
        q = self._queues.pop(job_id, None)
        if q:
            for _, fut, _ in q:
                if fut is not None:
                    fut._cancel("job removed from the runtime with this "
                                "push still queued (drain was bypassed)")
        self._snapshot_log = [e for e in self._snapshot_log
                              if e[0] != job_id]
        self._counts.pop(job_id, None)
        self._leases.pop(job_id, None)
        self._rows.pop(job_id, None)
        self._appliers = {k: v for k, v in self._appliers.items()
                          if job_id not in k}

    # ------------------------------------------------------------ data path
    def _owned_rows(self, job_id: str) -> torch.Tensor:
        rows = self._rows.get(job_id)
        if rows is None:
            rows = host_to_device(self.plan.job_layout(job_id).blocks,
                                  self.runtime.device, torch.int64)
            self._rows[job_id] = rows
        return rows

    def _pull_packed(self, job_id: str) -> torch.Tensor:
        """The job's packed lanes as a NEW tensor (never live state)."""
        layout = self.plan.job_layout(job_id)
        flat = self.runtime.state["flat"]
        if layout.covers_all:
            return flat.clone()
        return flat.view(-1, layout.block)[self._owned_rows(job_id)].reshape(-1)

    def pull(self, job_id: str, since_version=None):
        """The job's current parameters (a tree of copies).  A job
        ``max_staleness`` steps ahead of the service forces ticks first.

        ``since_version`` switches to the versioned diff protocol: pass
        the :class:`PullVersion` a previous versioned pull returned (or
        ``0`` to bootstrap) and get a :class:`PullDiff` of only the owned
        blocks whose version moved, plus the new vector.  A stale or
        cross-epoch vector falls back to a full-payload diff."""
        if self.health == QUARANTINED:
            # The state froze at the last-good snapshot: serving it as if
            # live would feed the trainer stale parameters.  Read-tier
            # replicas are the degraded-serving path.
            raise self.quarantine_error
        with span("pull"):
            self._queue(job_id)  # validates the job id
            while self.outstanding(job_id) > self.max_staleness:
                self.stats.n_forced_staleness += 1
                self.tick()
            if since_version is not None:
                return self._pull_versioned(job_id, since_version)
            layout = self.plan.job_layout(job_id)
            self.stats.n_full_pulls += 1
            self.stats.pull_bytes_wire += 4 * layout.packed_len
            self.stats.pull_bytes_full += 4 * layout.packed_len
            return _unpack_slots(layout, self._pull_packed(job_id),
                                 self.runtime._jobs[job_id]["abstract"])

    # ----------------------------------------------------- versioned pulls
    def _versions_array(self) -> np.ndarray:
        """One version per ``block_align`` block of the flat space (0:
        never stamped this epoch).  A read-only array, rebuilt after
        every stamp, so a holder (a published snapshot) never sees it
        change."""
        plan = self.plan
        nb = plan.total_len // plan.block_align
        if self._block_versions is None or self._block_versions.size != nb:
            versions = np.zeros(nb, np.int64)
            for j, v in self._job_versions.items():
                versions[plan.job_layout(j).blocks] = v
            versions.flags.writeable = False
            self._block_versions = versions
        return self._block_versions

    def _stamp_blocks(self, jobs) -> None:
        """Advance the version clock and stamp every given job's owned
        blocks: once per applying tick, and on rollback, so a rewound
        block never looks unchanged to a diff client."""
        if self.plan is None or not jobs:
            return
        self._version_clock += 1
        for j in jobs:
            self._job_versions[j] = self._version_clock
        self._block_versions = None

    def _pull_versioned(self, job_id: str, since) -> PullDiff:
        layout = self.plan.job_layout(job_id)
        blocks = layout.blocks
        vers = np.full(blocks.size, self._job_versions.get(job_id, 0),
                       np.int64)
        version = PullVersion(epoch=self._epoch, versions=vers)
        bytes_full = 4 * layout.packed_len
        flat = self.runtime.state["flat"]
        full = (not isinstance(since, PullVersion)
                or since.epoch != self._epoch
                or since.versions.size != vers.size)
        if full:
            diff = PullDiff(
                job_id=job_id, version=version, full=True,
                block=layout.block, block_ids=np.empty(0, np.int64),
                data=_gather_owned(layout, flat), bytes_wire=bytes_full,
                bytes_full=bytes_full)
            self.stats.n_full_pulls += 1
        else:
            sel = np.nonzero(vers > since.versions)[0]
            rows = host_to_device(blocks[sel], flat.device, torch.int64)
            diff = PullDiff(
                job_id=job_id, version=version, full=False,
                block=layout.block, block_ids=sel.astype(np.int64),
                data=flat.view(-1, layout.block)[rows],
                bytes_wire=4 * int(sel.size) * layout.block,
                bytes_full=bytes_full)
            self.stats.n_diff_pulls += 1
        self.stats.pull_bytes_wire += diff.bytes_wire
        self.stats.pull_bytes_full += bytes_full
        return diff

    def submit_push(self, job_id: str, grads) -> PushFuture:
        """Queue a job's gradient tree for the next tick; a full queue
        first forces ticks until a slot frees up."""
        with span("submit"):
            q = self._force_capacity(job_id)
            packed = _pack_slots(self.plan.job_layout(job_id), grads)
            return self._enqueue(q, job_id, packed.to(self.runtime.device))

    def submit_packed(self, job_id: str, packed: torch.Tensor) -> PushFuture:
        """Queue an ALREADY-PACKED job-local float32 gradient vector."""
        with span("submit"):
            return self._enqueue(self._force_capacity(job_id), job_id,
                                 packed)

    def _force_capacity(self, job_id: str) -> deque:
        """The job's queue, after ticks until it has a free slot."""
        q = self._queue(job_id)
        while len(q) >= self.queue_capacity:
            self.stats.n_forced_capacity += 1
            self.tick()
        return q

    def _enqueue(self, q: deque, job_id: str, packed) -> PushFuture:
        fut = PushFuture(job_id, self)
        # The bytes are spent even when the injector drops the push.
        n = int(packed.numel())
        kind = self.runtime._jobs[job_id]["step_opts"].get("push_compression")
        self.stats.push_bytes_raw += 4 * n
        self.stats.push_bytes_wire += wire_bytes(n, kind)
        action = ("deliver" if self.fault_injector is None
                  else self.fault_injector.on_push(job_id, None))
        if action != "drop":
            q.append((packed, fut, self._epoch))
            if action == "duplicate":
                q.append((packed, None, self._epoch))
        return fut

    def step(self, job_id: str, batch) -> Dict[str, Any]:
        """One engine-mode iteration: pull (staleness-bounded), compute
        loss and gradients, submit the push; ``metrics["future"]`` tracks
        it."""
        with span("step"):
            q = self._queue(job_id)
            if _must_force(self, job_id):
                with span("step.force"):
                    while self.outstanding(job_id) > self.max_staleness:
                        self.stats.n_forced_staleness += 1
                        self.tick()
                    self._force_capacity(job_id)
            layout = self.plan.job_layout(job_id)
            info = self.runtime._jobs[job_id]
            with span("step.pull"):
                params = _unpack_slots(layout, self._pull_packed(job_id),
                                       info["abstract"])
            with span("step.grad"):
                grads, loss = torch.func.grad_and_value(info["loss_fn"])(
                    params, batch)
            del params
            with span("step.pack"):
                packed = _pack_slots(layout, grads)
            with span("step.enqueue"):
                fut = self._enqueue(q, job_id, packed)
            return {"loss": loss, "future": fut}

    # ----------------------------------------------------------------- tick
    def tick(self, only=None) -> int:
        """One service tick: pop the head push of every pending job (or of
        the ``only`` subset during a replan quiesce) and apply them, in
        ONE launch when at least ``min_batch_jobs`` are pending, one per
        job below that.  Returns the number of jobs applied."""
        if self.health == QUARANTINED:
            raise self.quarantine_error
        with span("tick"):
            return self._tick(only)

    def _tick(self, only) -> int:
        with span("tick.select"):
            pending = [j for j in self.runtime._jobs
                       if self._queues.get(j) and (only is None or j in only)]
            if not pending:
                return 0
            # Epoch fence: a push packed under another plan epoch must
            # never reach the apply.
            for j in pending:
                if self._queues[j][0][2] != self._epoch:
                    raise RuntimeError(
                        f"epoch fence: job {j!r} queued a push under plan "
                        f"epoch {self._queues[j][0][2]} but the engine is "
                        f"at {self._epoch}; a replan migrated this job's "
                        f"layout without draining its queue")
            if 1 < len(pending) < self.min_batch_jobs:
                groups = [(j,) for j in pending]
                self.stats.n_per_job_dispatch += 1
            else:
                groups = [tuple(pending)]
        # Refresh the snapshot BEFORE any in-place apply.
        snapped = self._maybe_snapshot()
        if self._replica_hub is not None:
            # Publish point for the read tier, at the rollback snapshot:
            # on a refresh tick the hub publishes the clone just taken.
            with span("tick.publish"):
                self._replica_hub.on_tick(None, snapped)
        applied = 0
        for key in groups:
            heads = [self._queues[j].popleft() for j in key]
            try:
                applier = self._appliers.get(key)
                if applier is None:
                    with span("tick.build"):
                        applier = self._build_applier(key)
                    if len(self._appliers) >= self.MAX_APPLIERS:
                        self._appliers.pop(next(iter(self._appliers)))
                    self._appliers[key] = applier
                gs = tuple(packed for packed, _, _ in heads)
            except BaseException:
                # Build-time failure: nothing ran, re-queue the heads.
                for j, head in zip(key, heads):
                    self._queues[j].appendleft(head)
                raise
            try:
                if self.fault_injector is not None:
                    self.fault_injector.on_apply(None)
                self.runtime.state = applier(self.runtime.state, gs)
            except BaseException as exc:
                # The applier writes in place, so the state may be partly
                # updated: re-queue the heads, roll back to the snapshot
                # and replay (or quarantine).  The rollback undoes every
                # group this tick already applied.
                for j, head in zip(key, heads):
                    self._queues[j].appendleft(head)
                self._handle_apply_failure(exc, key)
                self.stats.n_ticks += 1
                return 0
            self._failures = 0
            with span("tick.commit"):
                for j, (packed, fut, _) in zip(key, heads):
                    self._counts[j] += 1
                    if fut is not None:
                        fut._resolve(self._counts[j])
                    self._snapshot_log.append((j, packed, fut))
            applied += len(key)
        self._stamp_blocks(pending)  # diff-pull clients see these as dirty
        self.stats.n_ticks += 1
        self.stats.n_applied += applied
        self.stats.n_launches += len(groups)
        self._ticks_since_snapshot += 1
        return applied

    # ------------------------------------------------------- fault recovery
    def _maybe_snapshot(self) -> bool:
        """Clone (state, counts mirror) as the rollback anchor, every
        ``snapshot_interval`` applying ticks, before the in-place apply.
        Returns True when the anchor was refreshed by this call (the read
        tier then publishes its clone instead of taking another)."""
        if self.snapshot_interval <= 0:
            return False
        if (self._snapshot is None
                or self._ticks_since_snapshot >= self.snapshot_interval):
            with span("tick.snapshot"):
                self._snapshot = (_copy_state(self.runtime.state),
                                  dict(self._counts))
            self._snapshot_log = []
            self._ticks_since_snapshot = 0
            self.stats.n_snapshots += 1
            return True
        return False

    def _rollback(self) -> None:
        """Install a CLONE of the snapshot (it stays pristine for another
        rollback, and the read tier may be serving its ``flat``) and
        re-queue the logged pushes in front, per-job order preserved, so
        later ticks replay the identical sequence."""
        state_copy, counts_copy = self._snapshot
        self.runtime.state = _copy_state(state_copy)
        self._counts = dict(counts_copy)
        # The restore rewound every block the logged pushes touched:
        # re-stamp them so a diff client that saw the undone values is
        # told those blocks changed (versions only move forward).
        self._stamp_blocks({j for j, _, _ in self._snapshot_log})
        # A replayed future stays done: its result was observable, and the
        # deterministic replay re-lands the identical update.
        for j, packed, fut in reversed(self._snapshot_log):
            self._queues.setdefault(j, deque()).appendleft(
                (packed, fut, self._epoch))
            self.stats.n_replayed += 1
        self._snapshot_log = []
        self._ticks_since_snapshot = 0
        self.stats.n_rollbacks += 1

    def _handle_apply_failure(self, exc: BaseException, key) -> None:
        """Roll back and return (later ticks replay), or quarantine when
        retries are exhausted or no snapshot exists."""
        self._failures += 1
        can_roll = self._snapshot is not None
        if can_roll and self.retry_policy.should_retry(self._failures):
            self.retry_policy.backoff(self._failures)
            self._rollback()
            return
        if can_roll:
            self._rollback()  # leave last-good state installed
        self.health = QUARANTINED
        self.quarantine_error = EngineQuarantinedError(
            shard_id=None, tick=self.stats.n_ticks, job_ids=key,
            original=exc)
        self.stats.n_quarantines += 1
        raise self.quarantine_error from exc

    def _stall_error(self, job_id: str) -> Optional[Exception]:
        if self.health == QUARANTINED:
            return self.quarantine_error
        if self._queues.get(job_id):
            return None
        return RuntimeError(
            f"push for job {job_id!r} can never resolve: no queued push "
            f"remains for it (dropped in transit?)")

    def drain(self, only=None) -> int:
        """Tick until every (selected) queue is empty; returns pushes
        applied."""
        applied = 0
        while True:
            n = self.tick(only=only)
            applied += n
            if n:
                continue
            if not any(q for j, q in self._queues.items()
                       if only is None or j in only):
                return applied

    def _build_applier(self, job_ids: Tuple[str, ...]) -> Callable:
        """The batched apply for one combination of pending jobs: its
        block table and job-slot map go to the device once, and each call
        is ONE launch of kernel K1 writing flat/mu/nu in place, after one
        error-feedback round per compressed job (``_ef_round`` on its
        owned rows of ``ef``, the block step's function)."""
        plan = self.plan
        layouts = [plan.job_layout(j) for j in job_ids]
        infos = [self.runtime._jobs[j] for j in job_ids]
        block_idx, job_sizes, hps = _fused_tables(layouts, infos,
                                                  _flat_job_hp)
        block_idx_t, job_slot_t = _device_tables(block_idx, job_sizes,
                                                 self.runtime.device)
        block = plan.block_align
        compressed = _compressed_entries(layouts, infos, self.runtime.device)

        def apply(state, gs):
            counts = [state["counts"][j] + 1 for j in job_ids]
            if compressed:
                gs = _ef_rounds(gs, compressed, lambda i: state["ef"])
            state = _fused_state_update(
                state, gs, counts, block=block, block_idx=block_idx_t,
                job_slot=job_slot_t, job_sizes=job_sizes, hps=hps)
            return dict(state, counts=dict(
                state["counts"], **dict(zip(job_ids, counts))))

        return apply


# --------------------------------------------------------------- sharded
class _ShardLane:
    """One shard space's service loop state: its own queues, appliers and
    TickStats, and its own health, rollback anchor and replay log (the
    unit of independent cadence is also the unit of failure isolation).
    Diff-pull versions are stamped per job: within an epoch every block
    of the lane belongs to one job, so a block's version is its job's
    last stamp."""

    __slots__ = ("shard_id", "queues", "appliers", "stats", "health",
                 "quarantine_error", "snapshot", "log",
                 "ticks_since_snapshot", "failures", "job_versions")

    def __init__(self, shard_id: str):
        self.shard_id = shard_id
        self.queues: Dict[str, deque] = {}  # job -> (piece, count, fut, ep)
        self.appliers: Dict[Tuple[str, ...], Callable] = {}
        self.stats = TickStats()
        self.health = HEALTHY
        self.quarantine_error: Optional[EngineQuarantinedError] = None
        self.snapshot = None  # clone of this shard's state (rollback anchor)
        self.log: List[Tuple] = []  # (job, piece, count, fut) since the clone
        self.ticks_since_snapshot = 0
        self.failures = 0  # consecutive failed applies (reset on success)
        self.job_versions: Dict[str, int] = {}  # job -> last version stamp


class ShardedTickEngine(_Leases):
    """Per-shard batched executor for one :class:`ShardedServiceRuntime`.

    Created via :meth:`ShardedServiceRuntime.attach_engine`.  One
    independent loop runs per shard space (``tick_shard``): a hot shard
    ticking never stalls a cold one, and the autoscaler reads each lane's
    :class:`TickStats` as its load signal.  A job's push splits into one
    packed PIECE per hosting shard, each tagged with the job's global
    step count at submit time; Adam is elementwise and each lane applies
    a job's pieces in order, so the trajectory is bit for bit the
    unsharded engine's however shard cadences interleave.  Staleness and
    capacity bounds are per job, over its hosting lanes.

    ``fleet_tick`` selects how :meth:`tick` runs a round: ``"fused"`` (the
    default) is :meth:`tick_fleet`, ONE launch of K1 over every lane with
    pending pieces; ``"per_shard"`` ticks each lane with its own launches,
    the bit-parity oracle.  The attribute may be flipped on a live
    engine; the two paths keep separate applier caches.

    Replans follow the flat engine's protocol: the runtime drains only
    the jobs the sharded transition touches, untouched jobs' pieces are
    re-tagged across the epoch fence, and lanes are keyed by the stable
    ``agg_id``.

    Fault tolerance is per lane.  Every ``snapshot_interval`` of its
    applying ticks a lane clones its state and logs the pieces applied
    since; a failed apply copies the clone back into the lane's views of
    the arena and replays the log, and ``max_apply_retries`` consecutive
    failures QUARANTINE the lane: ``tick_shard`` skips it, ``tick_fleet``
    leaves it out of the launch, and blocked work (``drain``, ``pull``,
    ``result``) raises its :class:`EngineQuarantinedError` while the other
    lanes tick on.  A failed fleet launch cannot say which lane failed, so
    every participating lane rolls back and ticks alone with its own
    launches of the same kernel (``n_fleet_fallbacks``).  K1 writes the
    arena in place, so with ``snapshot_interval=0`` a failed lane may be
    half-written and is quarantined at once.

    A compressed job's piece takes one error-feedback round against ITS
    shard's ``ef`` view of the arena before the launch, on the fleet and
    the per-shard path alike.  Leases are the flat engine's, with the
    job's queued pieces cancelled on every lane.
    """

    MAX_APPLIERS = 32  # appliers per lane (one per pending-job subset)

    def __init__(self, runtime, *, max_staleness: int = 1,
                 queue_capacity: Optional[int] = None,
                 min_batch_jobs: int = 3, fleet_tick: str = "fused",
                 snapshot_interval: int = 8, max_apply_retries: int = 1,
                 fault_injector=None, retry_policy=None,
                 lease_interval: Optional[float] = None, clock=None):
        if max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got {max_staleness}")
        if fleet_tick not in ("fused", "per_shard"):
            raise ValueError(f"fleet_tick must be 'fused' or 'per_shard', "
                             f"got {fleet_tick!r}")
        if snapshot_interval < 0:
            raise ValueError(
                f"snapshot_interval must be >= 0 (0 disables rollback "
                f"recovery), got {snapshot_interval}")
        self.runtime = runtime
        self.max_staleness = int(max_staleness)
        self.queue_capacity = (self.max_staleness + 1 if queue_capacity is None
                               else int(queue_capacity))
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        self.min_batch_jobs = int(min_batch_jobs)
        self.fleet_tick = fleet_tick
        self.snapshot_interval = int(snapshot_interval)
        if retry_policy is None:
            retry_policy = RetryPolicy(max_retries=int(max_apply_retries))
        self.retry_policy = retry_policy
        self.max_apply_retries = int(retry_policy.max_retries)
        self.fault_injector = fault_injector
        self._init_leases(lease_interval, clock)
        self.stats = TickStats()  # fleet-aggregate counters
        self._epoch = 0
        self._version_clock = 0  # fleet-wide monotone diff-pull clock
        self._lanes: Dict[str, _ShardLane] = {}
        self._counts: Dict[str, int] = {}  # job step mirror (submit time)
        # Fleet appliers are keyed by the whole pending pattern
        # ((shard_id, jobs), ...), apart from the per-lane caches.
        self._fleet_appliers: Dict[Tuple, Callable] = {}
        self._rows: Dict[str, Tuple] = {}  # job -> per-shard rows on device
        # Read tier: a ReplicaSet registers here and is offered each
        # ticking lane for publication.
        self._replica_hub = None

    # ------------------------------------------------------------- plumbing
    @property
    def plan(self):
        return self.runtime.splan

    def _lane(self, shard_id: str) -> _ShardLane:
        lane = self._lanes.get(shard_id)
        if lane is None:
            lane = self._lanes[shard_id] = _ShardLane(shard_id)
        return lane

    def _layout(self, job_id: str):
        info = self.runtime._jobs.get(job_id)
        if info is None:
            raise ValueError(f"unknown job {job_id!r}: not registered with "
                             f"the runtime (have {sorted(self.runtime._jobs)})")
        if job_id not in self._counts:
            self._counts[job_id] = int(self.runtime.counts[job_id])
        self._renew_lease(job_id)
        return self.plan.job_layout(job_id)

    def _job_rows(self, job_id: str, layout) -> Tuple:
        rows = self._rows.get(job_id)
        if rows is None:
            rows = self._rows[job_id] = _layout_rows(layout,
                                                     self.runtime.device)
        return rows

    def expire_leases(self) -> Tuple[str, ...]:
        """Reclaim every job whose lease has lapsed; returns their ids.
        :meth:`ServiceTickEngine.expire_leases`, with the job's queued
        pieces cancelled on every lane before it leaves through
        ``runtime.remove_job`` (the sharded replan, K2 on the surviving
        shards' deltas)."""
        return self._expire(lambda j: [lane.queues.get(j)
                                       for lane in self._lanes.values()],
                            lambda entry: entry[2])

    def outstanding(self, job_id: str) -> int:
        """Deepest per-shard queue of the job's not-yet-applied pieces."""
        return max((len(lane.queues.get(job_id, ()))
                    for lane in self._lanes.values()), default=0)

    def shard_stats(self) -> Dict[str, TickStats]:
        """Per-shard TickStats (the autoscaler's load signal)."""
        return {sid: lane.stats for sid, lane in self._lanes.items()}

    # ---------------------------------------------------------- lane health
    def shard_health(self) -> Dict[str, str]:
        """Per-lane health, ``'healthy'`` or ``'quarantined'`` (the
        autoscaler holds a fleet with a quarantined lane)."""
        return {sid: lane.health for sid, lane in self._lanes.items()}

    def quarantined_shards(self) -> Tuple[str, ...]:
        return tuple(sid for sid, lane in self._lanes.items()
                     if lane.health == QUARANTINED)

    def _quarantine_blocking(
            self, only=None) -> Optional[EngineQuarantinedError]:
        """The error of a quarantined lane that still holds queued pieces
        of the given jobs (any job when None): no ticking applies them."""
        for lane in self._lanes.values():
            if lane.health == QUARANTINED and any(
                    q and (only is None or j in only)
                    for j, q in lane.queues.items()):
                return lane.quarantine_error
        return None

    def _has_pending(self, only=None) -> bool:
        return any(q and (only is None or j in only)
                   for lane in self._lanes.values()
                   for j, q in lane.queues.items())

    def _stall_error(self, job_id: str) -> Optional[Exception]:
        """Why a tick round that applied nothing cannot resolve this job's
        push: an exception to raise, or None while progress is still
        possible (a rollback may just have re-queued the replay)."""
        exc = self._quarantine_blocking((job_id,))
        if exc is not None:
            return exc
        if any(lane.queues.get(job_id) for lane in self._lanes.values()):
            return None
        return RuntimeError(
            f"push for job {job_id!r} can never resolve: no queued piece "
            f"remains for it on any lane (dropped in transit?)")

    def _force_staleness(self, job_id: str) -> None:
        while self.outstanding(job_id) > self.max_staleness:
            self.stats.n_forced_staleness += 1
            if self.tick() == 0:
                stall = self._stall_error(job_id)
                if stall is not None:
                    # The backlog sits on a quarantined lane (or is gone):
                    # no number of ticks drains it.
                    raise stall

    # ------------------------------------------------------------ data path
    def pull(self, job_id: str, since_version=None):
        """The job's parameters gathered across its hosting shards (a tree
        of copies), after forcing tick rounds down to the staleness bound.
        A quarantined hosting lane raises its error: its state froze at
        the last-good snapshot, and read-tier replicas are the degraded
        path.

        ``since_version`` switches to the versioned diff protocol (see
        :meth:`ServiceTickEngine.pull`): the job-local version vector is
        its hosting shards' versions in shard order, the order its packed
        pieces concatenate in."""
        layout = self._layout(job_id)
        for sid in layout.shard_ids:
            lane = self._lanes.get(sid)
            if lane is not None and lane.health == QUARANTINED:
                raise lane.quarantine_error
        with span("pull"):
            self._force_staleness(job_id)
            if since_version is not None:
                return self._pull_versioned(job_id, layout, since_version)
            self.stats.n_full_pulls += 1
            self.stats.pull_bytes_wire += 4 * layout.packed_len
            self.stats.pull_bytes_full += 4 * layout.packed_len
            return self._params(job_id, layout)

    def _params(self, job_id: str, layout):
        """The job's parameter tree, gathered from its hosting shards into
        a new packed vector (never a view of the arena)."""
        return _unpack_slots(layout, self._packed(job_id, layout),
                             self.runtime._jobs[job_id]["abstract"])

    def _packed(self, job_id: str, layout) -> torch.Tensor:
        return _gather_packed(layout, self._job_rows(job_id, layout),
                              [self.runtime.states[sid]["flat"]
                               for sid in layout.shard_ids])

    # ----------------------------------------------------- versioned pulls
    def _stamp_lane(self, lane: _ShardLane, jobs) -> None:
        """Advance the fleet-wide version clock and stamp the given jobs
        on this lane: every applying tick, and on rollback, so a rewound
        block never looks unchanged to a diff client.  O(jobs): the
        per-block vector of a pull is built from the stamps."""
        if self.plan is None or not jobs:
            return
        self._version_clock += 1
        for j in jobs:
            if j in self.runtime._jobs:
                lane.job_versions[j] = self._version_clock

    def _pull_versioned(self, job_id: str, layout, since) -> PullDiff:
        vers = np.concatenate([
            np.full(l.blocks.size, self._lane(sid).job_versions.get(job_id, 0),
                    np.int64)
            for sid, l in zip(layout.shard_ids, layout.layouts)])
        version = PullVersion(epoch=self._epoch, versions=vers)
        bytes_full = 4 * layout.packed_len
        blocks = {l.block for l in layout.layouts}
        uniform = len(blocks) == 1
        full = (not uniform  # mixed granularity: no single row width
                or not isinstance(since, PullVersion)
                or since.epoch != self._epoch
                or since.versions.size != vers.size)
        if full:
            diff = PullDiff(
                job_id=job_id, version=version, full=True,
                block=(blocks.pop() if uniform else 0),
                block_ids=np.empty(0, np.int64),
                data=self._packed(job_id, layout), bytes_wire=bytes_full,
                bytes_full=bytes_full)
            self.stats.n_full_pulls += 1
        else:
            (block,) = blocks
            changed = vers > since.versions
            data_parts, id_parts = [], []
            off = 0  # job-local block row of this shard's first piece row
            for sid, l in zip(layout.shard_ids, layout.layouts):
                nb = int(l.blocks.size)
                sel = np.nonzero(changed[off:off + nb])[0]
                if sel.size:
                    flat = self.runtime.states[sid]["flat"]
                    rows = host_to_device(l.blocks[sel], flat.device,
                                          torch.int64)
                    data_parts.append(flat.view(-1, block)[rows])
                    id_parts.append(off + sel)
                off += nb
            if data_parts:
                data = (torch.cat(data_parts) if len(data_parts) > 1
                        else data_parts[0])
                ids = np.concatenate(id_parts).astype(np.int64)
            else:
                data = torch.zeros((0, block), dtype=torch.float32,
                                   device=self.runtime.device)
                ids = np.empty(0, np.int64)
            diff = PullDiff(
                job_id=job_id, version=version, full=False, block=block,
                block_ids=ids, data=data,
                bytes_wire=4 * int(ids.size) * block, bytes_full=bytes_full)
            self.stats.n_diff_pulls += 1
        self.stats.pull_bytes_wire += diff.bytes_wire
        self.stats.pull_bytes_full += bytes_full
        return diff

    def _enqueue(self, job_id: str, layout, pieces) -> PushFuture:
        count = self._counts[job_id] + 1
        self._counts[job_id] = count
        fut = PushFuture(job_id, self, parts=len(pieces))
        inj = self.fault_injector
        kind = self.runtime._jobs[job_id]["step_opts"].get("push_compression")
        for sid, piece in zip(layout.shard_ids, pieces):
            # Wire accounting per piece, on the fleet and the lane alike;
            # the bytes are spent even when the injector drops the piece.
            n = int(piece.numel())
            lane = self._lane(sid)
            for st in (self.stats, lane.stats):
                st.push_bytes_raw += 4 * n
                st.push_bytes_wire += wire_bytes(n, kind)
            action = "deliver" if inj is None else inj.on_push(job_id, sid)
            if action == "drop":
                continue  # lost in transit: the future keeps the part
            q = lane.queues.setdefault(job_id, deque())
            q.append((piece, count, fut, self._epoch))
            if action == "duplicate":
                # At-least-once delivery: the copy applies untracked.
                q.append((piece, count, None, self._epoch))
        return fut

    def _force_capacity(self, job_id: str, layout) -> None:
        while True:
            full = [sid for sid in layout.shard_ids
                    if len(self._lane(sid).queues.get(job_id, ()))
                    >= self.queue_capacity]
            if not full:
                return
            self.stats.n_forced_capacity += 1
            for sid in full:
                lane = self._lanes[sid]
                if lane.health == QUARANTINED:
                    # A full queue on a lane that never ticks again.
                    raise lane.quarantine_error
                self.tick_shard(sid)

    def submit_push(self, job_id: str, grads) -> PushFuture:
        """Queue a job's gradient tree: one packed piece per hosting
        shard, applied by each shard's own ticks."""
        with span("submit"):
            layout = self._layout(job_id)
            self._force_capacity(job_id, layout)
            packed = _pack_slots(layout, grads).to(self.runtime.device)
            return self._enqueue(job_id, layout,
                                 _split_pieces(layout, packed))

    def submit_packed(self, job_id: str, packed: torch.Tensor) -> PushFuture:
        """Queue an ALREADY-PACKED float32 gradient over the job's
        combined packed layout (its hosting shards' pieces in shard
        order)."""
        with span("submit"):
            layout = self._layout(job_id)
            if tuple(packed.shape) != (layout.packed_len,):
                raise ValueError(f"packed gradient of {job_id!r} must be "
                                 f"({layout.packed_len},), got "
                                 f"{tuple(packed.shape)}")
            self._force_capacity(job_id, layout)
            return self._enqueue(job_id, layout,
                                 _split_pieces(layout, packed))

    def step(self, job_id: str, batch) -> Dict[str, Any]:
        """One engine-mode iteration: staleness-bounded pull, loss and
        gradients, one queued piece per hosting shard."""
        with span("step"):
            layout = self._layout(job_id)
            if _must_force(self, job_id):
                with span("step.force"):
                    self._force_staleness(job_id)
                    self._force_capacity(job_id, layout)
            loss_fn = self.runtime._jobs[job_id]["loss_fn"]
            with span("step.pull"):
                params = self._params(job_id, layout)
            with span("step.grad"):
                grads, loss = torch.func.grad_and_value(loss_fn)(params,
                                                                 batch)
            del params
            with span("step.pack"):
                pieces = _split_pieces(layout, _pack_slots(layout, grads))
            with span("step.enqueue"):
                fut = self._enqueue(job_id, layout, pieces)
            return {"loss": loss, "future": fut}

    # ----------------------------------------------------------------- tick
    def _check_fence(self, sid: str, lane: _ShardLane, jobs) -> None:
        for j in jobs:
            if lane.queues[j][0][3] != self._epoch:
                raise RuntimeError(
                    f"epoch fence: job {j!r} queued a piece on shard "
                    f"{sid!r} under plan epoch {lane.queues[j][0][3]} but "
                    f"the engine is at {self._epoch}; a replan migrated "
                    f"this job's layout without draining it")

    def _applied(self, lane: _ShardLane, jobs, heads) -> None:
        """Resolve the applied pieces' futures and log them for replay; a
        push that applied on its LAST hosting shard commits the job's
        global step count (only the done transition commits, so a
        replayed piece never rewinds it)."""
        lane.failures = 0
        for j, (piece, count, fut, _) in zip(jobs, heads):
            if fut is not None and fut._resolve(count):
                self.runtime.counts[j] = count
            lane.log.append((j, piece, count, fut))

    def _lane_ticked(self, lane: _ShardLane, jobs) -> None:
        self._stamp_lane(lane, jobs)  # diff-pull dirty marks
        lane.stats.n_ticks += 1
        lane.stats.n_applied += len(jobs)
        lane.ticks_since_snapshot += 1

    def tick_shard(self, shard_id: str, only=None) -> int:
        """One tick of ONE shard space: pop the head piece of every
        pending job on this lane and apply them with the lane's own
        launches (one, at or above ``min_batch_jobs`` pending jobs; one
        per job below).  Other shards are untouched; a quarantined lane
        is skipped (returns 0)."""
        lane = self._lanes.get(shard_id)
        if lane is None or lane.health == QUARANTINED:
            return 0
        with span("tick"):
            return self._tick_shard(shard_id, lane, only)

    def _tick_shard(self, shard_id: str, lane: _ShardLane, only) -> int:
        with span("tick.select"):
            pending = [j for j in self.runtime._jobs
                       if lane.queues.get(j) and (only is None or j in only)]
            if not pending:
                return 0
            self._check_fence(shard_id, lane, pending)
            if 1 < len(pending) < self.min_batch_jobs:
                groups = [(j,) for j in pending]
                lane.stats.n_per_job_dispatch += 1
            else:
                groups = [tuple(pending)]
        snapped = self._maybe_snapshot_lane(lane)
        if self._replica_hub is not None:
            # Read-tier publish point, at the rollback snapshot: a refresh
            # tick's clone is published, not taken again.
            with span("tick.publish"):
                self._replica_hub.on_tick(shard_id, snapped)
        for key in groups:
            heads = [lane.queues[j].popleft() for j in key]
            try:
                applier = lane.appliers.get(key)
                if applier is None:
                    with span("tick.build"):
                        applier = self._build_applier(shard_id, key)
                    if len(lane.appliers) >= self.MAX_APPLIERS:
                        lane.appliers.pop(next(iter(lane.appliers)))
                    lane.appliers[key] = applier
            except BaseException:
                # Build-time failure: nothing ran, re-queue the heads.
                for j, head in zip(key, heads):
                    lane.queues[j].appendleft(head)
                raise
            try:
                if self.fault_injector is not None:
                    self.fault_injector.on_apply(shard_id)
                applier(self.runtime.states[shard_id],
                        tuple(h[0] for h in heads),
                        tuple(h[1] for h in heads))
            except Exception as exc:
                # The applier writes in place, so the lane may be partly
                # updated: re-queue the heads, roll back and replay (the
                # rollback also undoes this tick's earlier groups), or
                # quarantine this lane alone.
                for j, head in zip(key, heads):
                    lane.queues[j].appendleft(head)
                self._handle_lane_failure(lane, exc, key)
                lane.stats.n_ticks += 1
                self.stats.n_ticks += 1
                return 0
            with span("tick.commit"):
                self._applied(lane, key, heads)
        self._lane_ticked(lane, pending)
        lane.stats.n_launches += len(groups)
        self.stats.n_ticks += 1
        self.stats.n_applied += len(pending)
        self.stats.n_launches += len(groups)
        return len(pending)

    # ------------------------------------------------------- fault recovery
    def _maybe_snapshot_lane(self, lane: _ShardLane) -> bool:
        """Refresh the lane's rollback anchor, a CLONE of its state (the
        appliers write the arena in place), every ``snapshot_interval``
        of its applying ticks, before the apply; the replay log empties
        with it.  Returns True when this call refreshed it (the read tier
        then publishes this clone's ``flat``)."""
        if self.snapshot_interval <= 0:
            return False
        if (lane.snapshot is None
                or lane.ticks_since_snapshot >= self.snapshot_interval):
            with span("tick.snapshot"):
                lane.snapshot = None  # free the old clone before taking one
                lane.snapshot = _copy_state(
                    self.runtime.states[lane.shard_id])
            lane.log = []
            lane.ticks_since_snapshot = 0
            lane.stats.n_snapshots += 1
            self.stats.n_snapshots += 1
            return True
        return False

    def _rollback_lane(self, lane: _ShardLane) -> None:
        """Copy the lane's snapshot back INTO its views of the fleet arena
        (rebinding them would drop the lane out of every later fleet
        tick, which launches K1 over the arena) and re-queue the logged
        pieces in front, per-job order kept: later ticks replay the
        identical (piece, count) sequence, bit for bit since counts were
        fixed at submit time.  The snapshot is only read: it stays
        pristine for another rollback, and a replica may serve its
        ``flat``.  A leaf the snapshot lacks (``ef``, when the snapshot
        predates the fleet's widening) was all zero then, and is zeroed."""
        state = self.runtime.states[lane.shard_id]
        for k, v in state.items():
            if k in lane.snapshot:
                v.copy_(lane.snapshot[k])
            else:
                v.zero_()
        # The restore rewound the logged jobs' blocks: re-stamp them so a
        # diff client that saw the undone values is told they changed.
        self._stamp_lane(lane, {j for j, _, _, _ in lane.log})
        for j, piece, count, fut in reversed(lane.log):
            if fut is not None:
                fut._unresolve()
            lane.queues.setdefault(j, deque()).appendleft(
                (piece, count, fut, self._epoch))
            lane.stats.n_replayed += 1
            self.stats.n_replayed += 1
        lane.log = []
        lane.ticks_since_snapshot = 0
        lane.stats.n_rollbacks += 1
        self.stats.n_rollbacks += 1

    def _quarantine(self, lane: _ShardLane, jobs, exc: Exception) -> None:
        lane.health = QUARANTINED
        lane.quarantine_error = EngineQuarantinedError(
            shard_id=lane.shard_id, tick=lane.stats.n_ticks, job_ids=jobs,
            original=exc)
        lane.stats.n_quarantines += 1
        self.stats.n_quarantines += 1

    def _handle_lane_failure(self, lane: _ShardLane, exc: Exception,
                             key) -> None:
        """Roll the lane back for replay, or quarantine it when retries
        are exhausted or it has no snapshot (the error is stored, not
        raised: the other lanes keep ticking, and blocked work raises
        it)."""
        lane.failures += 1
        can_roll = lane.snapshot is not None
        if can_roll and self.retry_policy.should_retry(lane.failures):
            self.retry_policy.backoff(lane.failures)
            self._rollback_lane(lane)
            return
        if can_roll:
            self._rollback_lane(lane)  # leave last-good state installed
        self._quarantine(lane, key, exc)

    def tick(self, only=None) -> int:
        """One ROUND over the fleet: :meth:`tick_fleet` (one launch) with
        ``fleet_tick="fused"``, every lane's :meth:`tick_shard` with
        ``"per_shard"``.  Returns pieces applied (0: nothing applied)."""
        plan = self.plan
        if plan is None:
            return 0
        if self.fleet_tick == "fused":
            return self.tick_fleet(only=only)
        return sum(self.tick_shard(sid, only=only)
                   for sid in plan.shard_ids)

    def tick_fleet(self, only=None) -> int:
        """One FLEET tick: pop the head piece of every pending job on
        every healthy lane and apply all of them in ONE launch of K1 over
        the fleet arena, each entry's block table rebased by its shard's
        offset.  Lanes with nothing pending, and quarantined lanes, are
        not in the table and their stats do not move.  On a failure every
        participating lane rolls back and ticks alone (``tick_shard``).
        Returns pieces applied."""
        plan = self.plan
        if plan is None:
            return 0
        with span("tick"):
            return self._tick_fleet(plan, only)

    def _tick_fleet(self, plan, only) -> int:
        with span("tick.select"):
            entries = []
            for sid in plan.shard_ids:
                lane = self._lanes.get(sid)
                if lane is None or lane.health == QUARANTINED:
                    continue
                pending = tuple(
                    j for j in self.runtime._jobs
                    if lane.queues.get(j) and (only is None or j in only))
                if pending:
                    self._check_fence(sid, lane, pending)
                    entries.append((sid, pending))
            if not entries:
                return 0
            key = tuple(entries)
            # Build before popping: a build failure leaves every queue
            # whole.
            applier = self._fleet_appliers.get(key)
            if applier is None:
                with span("tick.build"):
                    applier = self._build_fleet_applier(key)
                if len(self._fleet_appliers) >= self.MAX_APPLIERS:
                    self._fleet_appliers.pop(
                        next(iter(self._fleet_appliers)))
                self._fleet_appliers[key] = applier
        # Snapshot the participants with their queues whole, so each
        # lane's (snapshot, log) anchors a rollback of this very launch.
        for sid, _ in key:
            snapped = self._maybe_snapshot_lane(self._lanes[sid])
            if self._replica_hub is not None:
                with span("tick.publish"):
                    self._replica_hub.on_tick(sid, snapped)
        popped = [(sid, jobs, [self._lanes[sid].queues[j].popleft()
                               for j in jobs]) for sid, jobs in key]
        heads = [h for _, _, hs in popped for h in hs]
        try:
            if self.fault_injector is not None:
                for sid, _ in key:
                    self.fault_injector.on_apply(sid)
            applier(self.runtime.arena, tuple(h[0] for h in heads),
                    tuple(h[1] for h in heads))
        except Exception as exc:
            for sid, jobs, hs in popped:
                for j, head in zip(jobs, hs):
                    self._lanes[sid].queues[j].appendleft(head)
            self.stats.n_ticks += 1
            if self.snapshot_interval <= 0:
                # No anchors, and K1 may have half-written any
                # participant in place: quarantine them all.
                for sid, jobs in key:
                    self._quarantine(self._lanes[sid], jobs, exc)
                return 0
            self.stats.n_fleet_fallbacks += 1
            for sid, _ in key:
                self._rollback_lane(self._lanes[sid])
            return sum(self.tick_shard(sid) for sid, _ in key)
        with span("tick.commit"):
            for sid, jobs, hs in popped:
                self._applied(self._lanes[sid], jobs, hs)
            for sid, jobs in key:
                self._lane_ticked(self._lanes[sid], jobs)
        self.stats.n_ticks += 1
        self.stats.n_applied += len(heads)
        self.stats.n_launches += 1  # ONE launch for the whole fleet
        return len(heads)

    def drain(self, only=None) -> int:
        """Tick rounds until every (selected) queue on every lane is
        empty.  Returns pieces applied.  A round may apply nothing while
        a rollback replays (the loop goes on); pieces stuck on a
        quarantined lane never drain, so that raises the lane's
        :class:`EngineQuarantinedError`."""
        applied = 0
        while True:
            n = self.tick(only=only)
            applied += n
            if n:
                continue
            stuck = self._quarantine_blocking(only)
            if stuck is not None:
                raise stuck
            if not self._has_pending(only):
                return applied

    def quiesce_for_replan(self, touched) -> int:
        """Drain ONLY the touched jobs' pieces (on every lane) ahead of a
        sharded migration; untouched jobs keep their queues.  A touched
        piece frozen on a quarantined lane raises that lane's error
        (``recover_shard`` takes the lost lane out first)."""
        applied = 0
        while True:
            pending = [j for j in touched
                       if any(lane.queues.get(j)
                              for lane in self._lanes.values())]
            if not pending:
                return applied
            self.stats.n_forced_replan += 1
            n = self.tick(only=pending)
            applied += n
            if n == 0:
                stuck = self._quarantine_blocking(pending)
                if stuck is not None:
                    raise stuck

    # --------------------------------------------------------------- replan
    def _on_plan_change(self, touched=None) -> None:
        """A sharded replan landed.  Every fleet applier goes (each bakes
        every shard's arena offset, and any shard joining or leaving moves
        the later ones), and so does every lane's snapshot, log and
        version stamps (they hold the old geometry; the epoch bump sends
        held PullVersions to the full fallback).  Health survives: a
        quarantined lane stays quarantined.  ``touched=None`` requires
        every queue empty and drops everything; with a touched set only
        the touched jobs' appliers and rows go, lanes whose Aggregator
        left are dropped, and untouched jobs' queued pieces are re-tagged
        to the new epoch."""
        self._epoch += 1
        self.stats.n_replans += 1
        self._fleet_appliers.clear()
        for lane in self._lanes.values():
            lane.snapshot = None
            lane.log = []
            lane.ticks_since_snapshot = 0
            lane.job_versions = {}
        if self._replica_hub is not None:
            # Read-tier snapshots hold the old geometry too: the epoch
            # fence marks them stale and the next serve resubscribes.
            self._replica_hub.on_replan()
        if touched is None:
            if self._has_pending():
                raise RuntimeError("replan with queued pieces: the runtime "
                                   "must drain the engine first")
            self._lanes.clear()
            self._rows.clear()
            return
        touched = set(touched)
        live = set(self.plan.shard_ids) if self.plan is not None else set()
        for sid in list(self._lanes):
            lane = self._lanes[sid]
            for j in touched:
                if lane.queues.get(j):
                    raise RuntimeError(
                        f"replan with queued pieces for TOUCHED job {j!r} "
                        f"on shard {sid!r}: quiesce_for_replan must drain "
                        f"it first")
            if sid not in live:
                if any(lane.queues.values()):
                    raise RuntimeError(f"shard {sid!r} left the fleet with "
                                       f"queued pieces")
                del self._lanes[sid]
                continue
            for j, q in lane.queues.items():
                if q:  # untouched by construction: carry across the fence
                    self.stats.n_retagged += len(q)
                    lane.queues[j] = deque(
                        (piece, count, fut, self._epoch)
                        for piece, count, fut, _ in q)
            for j in touched:
                lane.queues.pop(j, None)
            lane.appliers = {k: v for k, v in lane.appliers.items()
                             if not touched.intersection(k)}
        for j in touched:
            self._rows.pop(j, None)

    def _forget_job(self, job_id: str) -> None:
        for lane in self._lanes.values():
            q = lane.queues.pop(job_id, None)
            if q:
                for _, _, fut, _ in q:
                    if fut is not None:
                        fut._cancel("job removed from the runtime with this "
                                    "piece still queued (drain was "
                                    "bypassed)")
            lane.log = [e for e in lane.log if e[0] != job_id]
            lane.job_versions.pop(job_id, None)
            lane.appliers = {k: v for k, v in lane.appliers.items()
                             if job_id not in k}
        self._fleet_appliers = {
            k: v for k, v in self._fleet_appliers.items()
            if not any(job_id in jobs for _, jobs in k)}
        self._counts.pop(job_id, None)
        self._leases.pop(job_id, None)
        self._rows.pop(job_id, None)

    # -------------------------------------------------------------- applier
    def _build_applier(self, shard_id: str, job_ids: Tuple[str, ...]):
        """The batched apply for one shard space and one pending-job
        combination: ONE launch of K1 over the shard's views of the arena,
        written in place.  The per-job step counts arrive with the queued
        pieces (fixed at submit time), so the order in which shards tick
        cannot skew the bias correction.  A compressed piece first takes
        its error-feedback round against the shard's ``ef``."""
        shard_plan = self.plan.shard_of(shard_id)
        layouts = [shard_plan.job_layout(j) for j in job_ids]
        infos = [self.runtime._jobs[j] for j in job_ids]
        block_idx, job_sizes, hps = _fused_tables(layouts, infos,
                                                  _sharded_job_hp)
        block_idx_t, job_slot_t = _device_tables(block_idx, job_sizes,
                                                 self.runtime.device)
        block = shard_plan.block_align
        compressed = _compressed_entries(layouts, infos, self.runtime.device)

        def apply(state, gs, counts):
            if compressed:
                gs = _ef_rounds(gs, compressed, lambda i: state["ef"])
            _fused_state_update(state, gs, counts, block=block,
                                block_idx=block_idx_t, job_slot=job_slot_t,
                                job_sizes=job_sizes, hps=hps)

        return apply

    def _build_fleet_applier(self, key) -> Callable:
        """The SINGLE-LAUNCH fleet apply for one pending pattern ``key``
        (``((shard_id, (job, ...)), ...)``, plan order): one K1 launch
        over the whole fleet arena, each entry's block table rebased by
        its shard's arena offset in blocks.  The offsets are
        block-aligned, so block exclusivity holds across the arena and
        the launch is bit for bit the per-shard oracle's.  Each compressed
        piece takes its error-feedback round first, against its OWN
        shard's span of the ``ef`` arena (which K1 never reads)."""
        plan = self.plan
        _, _, block = plan.concat_view([sid for sid, _ in key])
        arena_off = dict(zip(plan.shard_ids, plan.concat_view()[0]))
        layouts, infos, bases, spans = [], [], [], []
        for sid, jobs in key:
            shard_plan = plan.shard_of(sid)
            for j in jobs:
                layouts.append(shard_plan.job_layout(j))
                infos.append(self.runtime._jobs[j])
                bases.append(arena_off[sid] // block)
                spans.append((arena_off[sid], shard_plan.total_len))
        block_idx, job_sizes, hps = _fused_tables(
            layouts, infos, _sharded_job_hp, base_blocks=bases)
        block_idx_t, job_slot_t = _device_tables(block_idx, job_sizes,
                                                 self.runtime.device)
        compressed = _compressed_entries(layouts, infos, self.runtime.device)

        def apply(arena, gs, counts):
            if compressed:
                gs = _ef_rounds(gs, compressed, lambda i: arena["ef"][
                    spans[i][0]:spans[i][0] + spans[i][1]])
            _fused_state_update(arena, gs, counts, block=block,
                                block_idx=block_idx_t, job_slot=job_slot_t,
                                job_sizes=job_sizes, hps=hps)

        return apply
