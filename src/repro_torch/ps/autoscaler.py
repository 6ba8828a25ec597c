"""Load-driven elastic scaling of the Aggregator fleet (paper §3.3.2).

The control plane already grows the fleet on job ARRIVAL (admit + revert
loop) and shrinks it on job EXIT (recycling).  This module closes the
paper's remaining loop -- "the number of Aggregators follows the measured
aggregation load" (Fig. 2 / Fig. 11, up to 75% CPU reduction) -- from the
DATA PLANE's side: the :class:`repro_torch.ps.engine.ShardedTickEngine` exposes
one :class:`~repro_torch.ps.engine.TickStats` per shard space, and the
:class:`ElasticScaler` turns the per-window deltas of those counters
(pieces applied = pushes/sec, queue occupancy = drain pressure) into
``ParameterService.scale_out`` / ``scale_in`` decisions:

    shard spaces tick  ->  per-shard TickStats  ->  observe() window
         ^                                               |
         |              (split_aggregator /              v
    sharded replan  <-  recycle_aggregators)  <-  desired fleet size

Every action is an ordinary control-plane replan, so the data plane
migrates shard states with the O(moved-bytes) sharded delta path and
untouched jobs tick straight through -- scaling is load-following AND
stall-free.

The policy is deliberately simple and deterministic (benchmarks and the
simulator replay it): the fleet targets ``ceil(load / shard_capacity)``
shards, where load is the window's applied pieces plus what is still
queued, clamped to ``[min_shards, max_shards]``, one fleet change per
``cooldown`` windows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass(frozen=True)
class AutoscalerConfig:
    """Knobs of the load-following policy.

    ``shard_capacity`` is the pushes-per-window one shard space is sized
    to absorb (the paper's per-Aggregator CPU budget, in units of applied
    aggregation passes); ``headroom`` scales the demand before dividing,
    so 1.25 keeps the fleet ~20% under saturation.
    """

    shard_capacity: float = 64.0  # applied pieces per shard per window
    headroom: float = 1.0
    min_shards: int = 1
    max_shards: int = 64
    cooldown: int = 1  # observe() calls between fleet changes
    max_step: int = 2  # fleet changes at most this many shards per action


@dataclass
class ScaleDecision:
    """One observe() window's record (the benchmark's audit trail)."""

    window: int
    load: float  # applied-in-window + still-queued pieces
    per_shard: Dict[str, float]  # applied pieces per shard this window
    n_shards_before: int
    n_shards_after: int
    action: str  # 'grow' | 'shrink' | 'hold'
    relayout_bytes: int = 0  # shard bytes the action's migration moved
    quarantined: tuple = ()  # shards quarantined this window (forces hold)


class ElasticScaler:
    """Feedback loop from per-shard TickStats to the Aggregator fleet.

    Usage::

        rt = ShardedServiceRuntime(svc)
        eng = rt.attach_engine(max_staleness=0)
        scaler = ElasticScaler(rt, AutoscalerConfig(shard_capacity=32))
        for window in workload:
            for job, batch in window:
                eng.step(job, batch)
            eng.expire_leases()     # reclaim silent trainers first ...
            scaler.observe()        # ... so the fleet sees the freed load

    ``observe()`` is pull-based on purpose: the caller decides the window
    (wall clock, tick rounds, or trace epochs), so simulators, benchmarks
    and tests replay the identical policy deterministically.  Run the
    engine's ``expire_leases()`` sweep on the same cadence, BEFORE
    ``observe()``: a reclaimed job's queued pieces leave with it (both
    halves of the load signal drop -- no window applies them and the
    drain occupancy is cancelled), so the fleet shrinks away from dead
    trainers instead of holding capacity for their stalled queues
    (``scripts/replay_trace.py`` is the end-to-end demonstration).
    """

    def __init__(self, runtime, config: Optional[AutoscalerConfig] = None):
        self.runtime = runtime
        self.config = config or AutoscalerConfig()
        if self.config.min_shards < 1:
            raise ValueError("min_shards must be >= 1")
        if self.config.max_shards < self.config.min_shards:
            raise ValueError("max_shards must be >= min_shards")
        self.decisions: List[ScaleDecision] = []
        # Snapshot the engine's lifetime counters NOW: a scaler attached
        # to a warm engine must not read its whole history as the first
        # window's load (and fire a spurious scale-out).
        self._last_applied: Dict[str, int] = (
            {sid: s.n_applied for sid, s in runtime.engine.shard_stats()
             .items()} if runtime.engine is not None else {})
        self._since_action = self.config.cooldown  # allow an immediate act

    # ------------------------------------------------------------- signals
    def _engine(self):
        eng = self.runtime.engine
        if eng is None:
            raise RuntimeError(
                "ElasticScaler needs the runtime's ShardedTickEngine "
                "attached (runtime.attach_engine()) -- per-shard TickStats "
                "are its load signal")
        return eng

    def window_loads(self) -> Dict[str, float]:
        """Applied pieces per shard since the last observe() (and update
        the high-water marks): the pushes/sec half of the load signal."""
        eng = self._engine()
        loads: Dict[str, float] = {}
        for sid, stats in eng.shard_stats().items():
            seen = self._last_applied.get(sid, 0)
            loads[sid] = float(stats.n_applied - seen)
            self._last_applied[sid] = stats.n_applied
        # Shards that left the fleet stop contributing.
        for sid in list(self._last_applied):
            if sid not in loads:
                del self._last_applied[sid]
        return loads

    def queued_pieces(self) -> int:
        """Drain occupancy: pieces sitting in queues right now."""
        eng = self._engine()
        return sum(len(q) for lane in eng._lanes.values()
                   for q in lane.queues.values())

    # ------------------------------------------------------------ decision
    def observe(self) -> ScaleDecision:
        """Close one window: read the load, resize the fleet toward
        ``ceil(load * headroom / shard_capacity)``, record the decision."""
        cfg = self.config
        per_shard = self.window_loads()
        load = sum(per_shard.values()) + self.queued_pieces()
        n_before = self.runtime.n_shards
        # A degraded fleet is never resized: splits and merges migrate
        # shard state, and a quarantined lane's buffers are condemned --
        # recover it first (ShardedServiceRuntime.recover_shard), then
        # let load drive the fleet again.
        quarantined = tuple(self._engine().quarantined_shards())
        desired = max(
            cfg.min_shards,
            min(cfg.max_shards,
                int(math.ceil(load * cfg.headroom
                              / max(1e-9, cfg.shard_capacity)))))
        action = "hold"
        relayout = 0
        self._since_action += 1
        if (not quarantined and self._since_action >= cfg.cooldown
                and desired != n_before):
            step = max(1, min(cfg.max_step, abs(desired - n_before)))
            before_bytes = self.runtime.total_relayout_bytes
            if desired > n_before:
                if self.runtime.service.scale_out(step):
                    action = "grow"
            else:
                if self.runtime.service.scale_in(step):
                    action = "shrink"
            if action != "hold":
                self._since_action = 0
                relayout = self.runtime.total_relayout_bytes - before_bytes
        decision = ScaleDecision(
            window=len(self.decisions), load=load, per_shard=per_shard,
            n_shards_before=n_before, n_shards_after=self.runtime.n_shards,
            action=action, relayout_bytes=relayout,
            quarantined=quarantined)
        self.decisions.append(decision)
        return decision

    # ----------------------------------------------------------- accounting
    @property
    def n_actions(self) -> int:
        return sum(1 for d in self.decisions if d.action != "hold")

    def shard_timeline(self) -> List[int]:
        """Fleet size after each window (the Fig.-2-style series)."""
        return [d.n_shards_after for d in self.decisions]
