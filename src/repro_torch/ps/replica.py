"""Read tier: pull-only parameter replicas fed by publish-on-tick snapshots
of the tick engines' lanes (``repro.ps.replica``): the flat engine's one
space, or each shard space of the sharded engine.

  publish      every applying tick each lane offers the hub a snapshot
               ``(flat, version stamps, epoch)`` at ``publish_interval``,
               pre-apply, at the rollback-snapshot point.  On a tick that
               refreshes the rollback anchor the published ``flat`` IS the
               anchor's clone; other publish ticks clone ``flat`` alone
               (never mu/nu).
  pull         a :class:`ParameterReplica` serves ``pull(job_id)`` (a
               parameter tree) and versioned ``pull(job_id,
               since_version=...)`` diffs (the engine's :class:`PullDiff`
               protocol) from its held snapshots: no work on the write
               path.
  pull_batch   ``[(job_id, since_version), ...]`` gathers every requested
               job's needed rows with ONE ``torch.cat`` + ``index_select``
               per replica instead of K sequential per-job pulls.
  staleness    ``max_staleness_ticks`` bounds how far a served snapshot may
               trail the engine's tick counter; past it the replica forces
               a refresh (``ReadStats.n_forced_refreshes``).

Replans cross an epoch fence: a held snapshot of the old geometry is
detected stale on the next serve and the replica resubscribes with a
forced publish.  A quarantined lane stops publishing; the replica keeps
serving its last-good snapshot with the serve flagged ``degraded``, and a
job spanning several shards is stitched from each hosting lane's
snapshot.

Aliasing.  The reference publishes immutable arrays.  Here the tick's
kernel writes the live state in place, so a published ``flat`` is always
a clone: the rollback anchor's (which the engine never writes: a
rollback copies it back into the live state) or one taken at publish
time.  Every served payload is a new tensor.

Versions.  The engines stamp versions per job (within an epoch every
block of a lane belongs to one job), so a snapshot carries the lane's
per-job stamps and a serve builds the job's per-block vector from them:
no per-block work on the write path.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import host_to_device
from .engine import PullDiff, PullVersion
from .faults import QUARANTINED
from .runtime import _unpack_slots

__all__ = ["ParameterReplica", "ReadStats", "ReplicaSet", "ShardSnapshot"]

# The flat engine is one unnamed lane; its snapshots key on None.
_FLAT_LANE = None


@dataclass(frozen=True)
class ShardSnapshot:
    """One lane's published state.  ``flat`` is a clone that nothing
    writes, so every subscribed replica shares the same tensor."""

    shard_id: Optional[str]  # None: the flat engine's single lane
    epoch: int  # plan epoch the geometry belongs to
    tick: int  # the lane's applying-tick counter at publish
    seq: int  # hub-wide publish sequence number
    flat: torch.Tensor  # (total_len,) parameter buffer
    job_versions: Dict[str, int]  # job -> its blocks' version (0: none)


@dataclass
class ReadStats:
    """Per-replica serving counters, surfaced by ``debug_stats()`` under
    ``"replicas"``."""

    n_pulls: int = 0  # single-job pulls served (full + diff)
    n_batches: int = 0  # pull_batch calls served
    n_batch_jobs: int = 0  # jobs served inside those batches
    n_full_serves: int = 0  # full-payload serves (bootstrap/fallback)
    n_diff_serves: int = 0  # changed-blocks-only serves
    bytes_served: int = 0  # payload bytes shipped (fp32 wire model)
    n_snapshots_seen: int = 0  # publishes this replica received
    n_forced_refreshes: int = 0  # staleness-bound / epoch-fence refreshes
    n_degraded_serves: int = 0  # serves from a quarantined lane's last-good
    serve_seconds: float = 0.0  # wall time inside pull/pull_batch
    # Snapshot age at serve time, in engine ticks: {staleness: serves}.
    staleness_hist: Dict[int, int] = field(default_factory=dict)

    @property
    def pulls_per_sec(self) -> float:
        """Jobs served per second of serve time (batched jobs count)."""
        if self.serve_seconds <= 0:
            return 0.0
        return (self.n_pulls + self.n_batch_jobs) / self.serve_seconds

    def _record_staleness(self, ticks: int) -> None:
        t = int(ticks)
        self.staleness_hist[t] = self.staleness_hist.get(t, 0) + 1


def _gather_rows(flat: torch.Tensor, block: int, blocks) -> torch.Tensor:
    """Rows ``blocks`` of ``flat`` viewed as ``(-1, block)``: a new tensor."""
    rows = host_to_device(np.asarray(blocks), flat.device, torch.int64)
    return flat.view(-1, block).index_select(0, rows)


class ParameterReplica:
    """One pull-only serving endpoint: holds the published snapshots
    (shared tensors: N replicas cost one publish, not N copies) and serves
    reads from them without touching the engine's write path."""

    def __init__(self, hub: "ReplicaSet", replica_id: int):
        self.replica_id = int(replica_id)
        self._hub = hub
        self._snaps: Dict[Optional[str], ShardSnapshot] = {}
        self.stats = ReadStats()
        self.degraded_lanes: Tuple[Optional[str], ...] = ()

    # ------------------------------------------------------------ freshness
    def _ensure_fresh(self, keys: Sequence[Optional[str]]) -> bool:
        """Bring every named lane's snapshot within the epoch fence and
        the staleness bound; returns True when a serve has to fall back to
        a quarantined lane's last-good snapshot (degraded)."""
        hub = self._hub
        epoch = hub.epoch
        bound = hub.max_staleness_ticks
        stale: List[Optional[str]] = []
        degraded: List[Optional[str]] = []
        for key in keys:
            snap = self._snaps.get(key)
            if hub.lane_quarantined(key):
                # The lane never ticks (or publishes) again.  A snapshot of
                # the current epoch is its last-good state: serve it,
                # flagged, whatever the staleness bound.  One of another
                # epoch (or none) has the wrong geometry.
                if snap is not None and snap.epoch == epoch:
                    degraded.append(key)
                    continue
                raise hub.lane_error(key)
            fence = snap is None or snap.epoch != epoch
            over = (not fence and bound is not None
                    and hub.lane_tick(key) - snap.tick > bound)
            if fence or over:
                stale.append(key)
        if stale:
            # Stale epoch: resubscribe with a full publish; over the
            # staleness bound: refuse to serve, force a refresh.
            self.stats.n_forced_refreshes += 1
            hub.refresh(stale)
        self.degraded_lanes = tuple(degraded)
        max_stale = 0
        for key in keys:
            if key in self.degraded_lanes:
                continue
            max_stale = max(max_stale,
                            hub.lane_tick(key) - self._snaps[key].tick)
        self.stats._record_staleness(max_stale)
        if degraded:
            self.stats.n_degraded_serves += 1
        return bool(degraded)

    def _publish(self, snap: ShardSnapshot) -> None:
        self._snaps[snap.shard_id] = snap
        self.stats.n_snapshots_seen += 1

    # ----------------------------------------------------------- single pull
    def pull(self, job_id: str, since_version=None):
        """Serve one job from held snapshots: a parameter tree, or, with
        ``since_version``, a :class:`PullDiff` of the blocks whose
        published version moved past the client's vector (``0``
        bootstraps full).  The engine's protocol, served from the read
        tier."""
        t0 = time.perf_counter()
        keys, layouts = self._hub.job_lanes(job_id)
        self._ensure_fresh(keys)
        if isinstance(since_version, PullVersion):
            # A client that last pulled from the ENGINE may hold versions
            # AHEAD of this replica's snapshot; a diff against older
            # published versions would report "no change".  Refresh to at
            # least the client's view.
            vers = self._job_versions(job_id, keys, layouts)
            if (since_version.epoch == self._hub.epoch
                    and since_version.versions.size == vers.size
                    and np.any(since_version.versions > vers)):
                self.stats.n_forced_refreshes += 1
                self._hub.refresh([k for k in keys
                                   if k not in self.degraded_lanes])
        try:
            if since_version is None:
                out = self._serve_tree(job_id, keys, layouts)
            else:
                out = self._serve_diff(job_id, keys, layouts, since_version)
            self.stats.n_pulls += 1
            return out
        finally:
            self.stats.serve_seconds += time.perf_counter() - t0

    def _job_versions(self, job_id, keys, layouts) -> np.ndarray:
        """The job-local version vector: one entry per owned block, the
        hosting lanes in shard order (the packed pieces' order)."""
        return np.concatenate([
            np.full(l.blocks.size, self._snaps[k].job_versions.get(job_id, 0),
                    np.int64) for k, l in zip(keys, layouts)])

    def _packed(self, keys, layouts) -> torch.Tensor:
        pieces = [_gather_rows(self._snaps[k].flat, l.block, l.blocks
                               ).reshape(-1) for k, l in zip(keys, layouts)]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces)

    def _serve_tree(self, job_id, keys, layouts):
        layout, abstract = self._hub.job_layout_abstract(job_id)
        packed = self._packed(keys, layouts)
        self.stats.n_full_serves += 1
        self.stats.bytes_served += 4 * int(layout.packed_len)
        return _unpack_slots(layout, packed, abstract)

    def _serve_diff(self, job_id, keys, layouts, since) -> PullDiff:
        vers = self._job_versions(job_id, keys, layouts)
        version = PullVersion(epoch=self._hub.epoch, versions=vers)
        blocks = {l.block for l in layouts}
        uniform = len(blocks) == 1
        bytes_full = 4 * sum(int(l.blocks.size) * l.block for l in layouts)
        full = (not uniform  # mixed granularity: no single row width
                or not isinstance(since, PullVersion)
                or since.epoch != self._hub.epoch
                or since.versions.size != vers.size)
        if full:
            diff = PullDiff(
                job_id=job_id, version=version, full=True,
                block=(blocks.pop() if uniform else 0),
                block_ids=np.empty(0, np.int64),
                data=self._packed(keys, layouts), bytes_wire=bytes_full,
                bytes_full=bytes_full)
            self.stats.n_full_serves += 1
        else:
            (block,) = blocks
            changed = vers > since.versions
            data_parts, id_parts = [], []
            off = 0
            for key, l in zip(keys, layouts):
                nb = int(l.blocks.size)
                sel = np.nonzero(changed[off:off + nb])[0]
                if sel.size:
                    data_parts.append(_gather_rows(self._snaps[key].flat,
                                                   block, l.blocks[sel]))
                    id_parts.append(off + sel)
                off += nb
            if data_parts:
                data = (torch.cat(data_parts) if len(data_parts) > 1
                        else data_parts[0])
                ids = np.concatenate(id_parts).astype(np.int64)
            else:
                flat = self._snaps[keys[0]].flat
                data = torch.zeros((0, block), dtype=flat.dtype,
                                   device=flat.device)
                ids = np.empty(0, np.int64)
            diff = PullDiff(
                job_id=job_id, version=version, full=False, block=block,
                block_ids=ids, data=data,
                bytes_wire=4 * int(ids.size) * block, bytes_full=bytes_full)
            self.stats.n_diff_serves += 1
        self.stats.bytes_served += diff.bytes_wire
        return diff

    # ---------------------------------------------------------- batched pull
    def pull_batch(self, requests: Sequence[Tuple[str, Any]]
                   ) -> List[PullDiff]:
        """Serve K jobs with ONE gather: every requested job's needed rows
        (all owned blocks for a bootstrap or fallback, the changed blocks
        for a held vector) collect into one row-index table over the
        involved lanes' snapshot matrices, one ``index_select`` ships
        them all, and the rows split back into per-job
        :class:`PullDiff` results.  Lanes that disagree on
        ``block_align`` have no single row width: those batches are
        served job by job."""
        t0 = time.perf_counter()
        try:
            reqs = [(j, since) for j, since in requests]
            lanes: List[Optional[str]] = []
            per_job = []
            for j, _ in reqs:
                keys, layouts = self._hub.job_lanes(j)
                per_job.append((keys, layouts))
                for k in keys:
                    if k not in lanes:
                        lanes.append(k)
            self._ensure_fresh(lanes)
            blocks = {l.block for _, layouts in per_job for l in layouts}
            if len(blocks) == 1:
                out = self._serve_batch(reqs, per_job, lanes, blocks.pop())
            else:
                out = [self._serve_diff(j, keys, layouts,
                                        0 if since is None else since)
                       for (j, since), (keys, layouts) in zip(reqs, per_job)]
            self.stats.n_batches += 1
            self.stats.n_batch_jobs += len(reqs)
            return out
        finally:
            self.stats.serve_seconds += time.perf_counter() - t0

    def _serve_batch(self, reqs, per_job, lanes, block) -> List[PullDiff]:
        epoch = self._hub.epoch
        base: Dict[Optional[str], int] = {}
        n_rows = 0
        mats = []
        for key in lanes:
            base[key] = n_rows
            flat = self._snaps[key].flat
            n_rows += int(flat.shape[0]) // block
            mats.append(flat.view(-1, block))
        plan_rows: List[np.ndarray] = []  # global row ids, request order
        metas = []  # (job_id, version, full, ids, n_rows, bytes_full)
        for (j, since), (keys, layouts) in zip(reqs, per_job):
            vers = self._job_versions(j, keys, layouts)
            version = PullVersion(epoch=epoch, versions=vers)
            bytes_full = 4 * sum(int(l.blocks.size) * block for l in layouts)
            full = (not isinstance(since, PullVersion)
                    or since.epoch != epoch
                    or since.versions.size != vers.size)
            if full:
                g = np.concatenate([l.blocks.astype(np.int64) + base[k]
                                    for k, l in zip(keys, layouts)])
                ids = np.empty(0, np.int64)
            else:
                changed = vers > since.versions
                g_parts, id_parts = [], []
                off = 0
                for k, l in zip(keys, layouts):
                    nb = int(l.blocks.size)
                    sel = np.nonzero(changed[off:off + nb])[0]
                    if sel.size:
                        g_parts.append(l.blocks[sel].astype(np.int64)
                                       + base[k])
                        id_parts.append(off + sel)
                    off += nb
                g = (np.concatenate(g_parts) if g_parts
                     else np.empty(0, np.int64))
                ids = (np.concatenate(id_parts).astype(np.int64)
                       if id_parts else np.empty(0, np.int64))
            plan_rows.append(g)
            metas.append((j, version, full, ids, int(g.size), bytes_full))
        mat = mats[0] if len(mats) == 1 else torch.cat(mats)
        rows = host_to_device(np.concatenate(plan_rows), mat.device,
                              torch.int64)
        gathered = mat.index_select(0, rows)  # the one gather
        out: List[PullDiff] = []
        off = 0
        for j, version, full, ids, n, bytes_full in metas:
            part = gathered[off:off + n]
            off += n
            if full:
                diff = PullDiff(
                    job_id=j, version=version, full=True, block=block,
                    block_ids=np.empty(0, np.int64), data=part.reshape(-1),
                    bytes_wire=bytes_full, bytes_full=bytes_full)
                self.stats.n_full_serves += 1
            else:
                diff = PullDiff(
                    job_id=j, version=version, full=False, block=block,
                    block_ids=ids, data=part, bytes_wire=4 * n * block,
                    bytes_full=bytes_full)
                self.stats.n_diff_serves += 1
            self.stats.bytes_served += diff.bytes_wire
            out.append(diff)
        return out


class ReplicaSet:
    """N pull-only replicas subscribed to one tick engine.

    The set registers itself as the engine's replica hub: every applying
    tick the engine offers each ticking lane for publication (pre-apply,
    at the rollback-snapshot point, so a snapshot tick adds no extra
    copy), and the hub publishes the same snapshot to every replica.  On
    a :class:`~repro_torch.ps.engine.ShardedTickEngine` the lanes are its
    shard spaces, keyed by shard id; on the flat engine one ``None``
    lane.  Reads route round robin via :meth:`pull` / :meth:`pull_batch`
    (or pick a replica from :attr:`replicas`)."""

    def __init__(self, engine, n_replicas: int = 2, *,
                 publish_interval: int = 1,
                 max_staleness_ticks: Optional[int] = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if publish_interval < 1:
            raise ValueError(
                f"publish_interval must be >= 1, got {publish_interval}")
        if max_staleness_ticks is not None and max_staleness_ticks < 0:
            raise ValueError(
                f"max_staleness_ticks must be >= 0 (None disables the "
                f"bound), got {max_staleness_ticks}")
        if getattr(engine, "_replica_hub", None) is not None:
            raise ValueError("engine already has a ReplicaSet attached")
        self.engine = engine
        self.publish_interval = int(publish_interval)
        self.max_staleness_ticks = (None if max_staleness_ticks is None
                                    else int(max_staleness_ticks))
        self._sharded = hasattr(engine, "_lanes")
        self._seq = 0
        self._since_pub: Dict[Optional[str], int] = {}
        self.n_publishes = 0
        self.n_reused_snapshot_copies = 0  # publishes riding the anchor
        self._rr = 0
        self.replicas: Tuple[ParameterReplica, ...] = tuple(
            ParameterReplica(self, i) for i in range(n_replicas))
        engine._replica_hub = self

    # ------------------------------------------------------- engine facing
    @property
    def epoch(self) -> int:
        return self.engine._epoch

    def _lane_keys(self) -> List[Optional[str]]:
        if not self._sharded:
            return [_FLAT_LANE]
        plan = self.engine.plan
        return [] if plan is None else list(plan.shard_ids)

    def lane_tick(self, key: Optional[str]) -> int:
        if not self._sharded:
            return self.engine.stats.n_ticks
        lane = self.engine._lanes.get(key)
        return 0 if lane is None else lane.stats.n_ticks

    def lane_quarantined(self, key: Optional[str]) -> bool:
        if not self._sharded:
            return self.engine.health == QUARANTINED
        lane = self.engine._lanes.get(key)
        return lane is not None and lane.health == QUARANTINED

    def lane_error(self, key: Optional[str]):
        if not self._sharded:
            return self.engine.quarantine_error
        return self.engine._lanes[key].quarantine_error

    def _lane_job_versions(self, key: Optional[str]) -> Dict[str, int]:
        """A copy of the lane's per-job version stamps."""
        if not self._sharded:
            return dict(self.engine._job_versions)
        lane = self.engine._lanes.get(key)
        return {} if lane is None else dict(lane.job_versions)

    def _live_flat(self, key: Optional[str]) -> torch.Tensor:
        """The lane's live ``flat``: the tick writes it in place, so a
        publish clones it."""
        if not self._sharded:
            return self.engine.runtime.state["flat"]
        return self.engine.runtime.states[key]["flat"]

    def _anchor_flat(self, key: Optional[str]) -> Optional[torch.Tensor]:
        """The rollback anchor's ``flat`` (already a clone), or None when
        the lane holds no snapshot."""
        if not self._sharded:
            snap = self.engine._snapshot
            return None if snap is None else snap[0]["flat"]
        lane = self.engine._lanes.get(key)
        return (None if lane is None or lane.snapshot is None
                else lane.snapshot["flat"])

    def on_tick(self, key: Optional[str], snapped: bool) -> None:
        """Engine hook, once per applying tick, PRE-apply (right after the
        rollback-snapshot point): the published state is the result of
        every completed tick.  With ``snapped`` the rollback anchor was
        refreshed this very tick and its ``flat`` clone is published."""
        count = self._since_pub.get(key, 0) + 1
        snap = self.replicas[0]._snaps.get(key)
        due = (count >= self.publish_interval
               or snap is None or snap.epoch != self.engine._epoch)
        if not due:
            self._since_pub[key] = count
            return
        flat = self._anchor_flat(key) if snapped else None
        if flat is None:
            flat = self._live_flat(key).clone()
        else:
            self.n_reused_snapshot_copies += 1
        self._publish(key, flat)
        self._since_pub[key] = 0

    def on_replan(self) -> None:
        """Engine hook: a replan landed (epoch bumped).  The next serve
        detects the stale epoch and resubscribes with a forced publish.
        Snapshots of lanes that left the fleet (a merge, a recovered
        shard) are dropped: no job routes to them any more, and each
        holds a clone of a whole shard's ``flat``."""
        self._since_pub.clear()
        live = set(self._lane_keys())
        for rep in self.replicas:
            for key in [k for k in rep._snaps if k not in live]:
                del rep._snaps[key]

    # ---------------------------------------------------------- publication
    def _publish(self, key: Optional[str], flat: torch.Tensor) -> None:
        snap = ShardSnapshot(
            shard_id=key, epoch=self.engine._epoch,
            tick=self.lane_tick(key), seq=self._seq, flat=flat,
            job_versions=self._lane_job_versions(key))
        self._seq += 1
        self.n_publishes += 1
        for rep in self.replicas:
            rep._publish(snap)

    def refresh(self, keys: Optional[Sequence[Optional[str]]] = None
                ) -> List[Optional[str]]:
        """Force-publish a clone of the CURRENT state of the named lanes
        (default: every lane): the staleness-bound and epoch-fence refresh
        path, and the way to expose the state after a drain (the on-tick
        publish is pre-apply, so it trails the tick in flight).  A
        quarantined lane cannot republish (its last-good snapshot
        stands); returns the lanes actually published."""
        if keys is None:
            keys = self._lane_keys()
        published = []
        for key in keys:
            if self.lane_quarantined(key):
                continue
            self._publish(key, self._live_flat(key).clone())
            self._since_pub[key] = 0
            published.append(key)
        return published

    # ------------------------------------------------------------ job lookup
    def job_lanes(self, job_id: str):
        """(lane keys, per-lane JobLayouts) hosting the job, in shard
        order; the flat engine's single ``None`` lane."""
        plan = self.engine.plan
        if plan is None:
            raise ValueError("no plan compiled: the service hosts no jobs")
        layout = plan.job_layout(job_id)
        if self._sharded:
            return list(layout.shard_ids), list(layout.layouts)
        return [_FLAT_LANE], [layout]

    def job_layout_abstract(self, job_id: str):
        return (self.engine.plan.job_layout(job_id),
                self.engine.runtime._jobs[job_id]["abstract"])

    # -------------------------------------------------------------- serving
    def _next(self) -> ParameterReplica:
        rep = self.replicas[self._rr % len(self.replicas)]
        self._rr += 1
        return rep

    def pull(self, job_id: str, since_version=None):
        """Round-robin a replica and serve (:meth:`ParameterReplica.pull`)."""
        return self._next().pull(job_id, since_version=since_version)

    def pull_batch(self, requests: Sequence[Tuple[str, Any]]
                   ) -> List[PullDiff]:
        """Round-robin a replica and serve the batch with one gather
        (:meth:`ParameterReplica.pull_batch`)."""
        return self._next().pull_batch(requests)

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        """Per-replica ReadStats (plus the hub's publish counters) as
        plain dicts: the ``debug_stats()["replicas"]`` payload."""
        out: Dict[str, Any] = {
            "n_replicas": len(self.replicas),
            "publish_interval": self.publish_interval,
            "max_staleness_ticks": self.max_staleness_ticks,
            "n_publishes": self.n_publishes,
            "n_reused_snapshot_copies": self.n_reused_snapshot_copies,
        }
        for rep in self.replicas:
            d = dataclasses.asdict(rep.stats)
            d["pulls_per_sec"] = rep.stats.pulls_per_sec
            out[f"replica_{rep.replica_id}"] = d
        return out
