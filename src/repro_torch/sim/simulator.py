"""Discrete-event simulator for Parameter Service at cluster scale.

Replays a job trace against the real control plane (ParameterService with
pMaster + cluster controllers + Pseudocode-1 assignment). Models the
paper's hybrid resource scaling: Aggregators freed by job exit are held in
an idle pool until the next periodic-scaling tick (which is why Fig. 11's
allocated/required ratio occasionally exceeds 1), while allocation is
on-demand. Job durations stretch by the predicted performance loss (a job
packed at 5% loss finishes 5% later), closing the loop between packing
decisions and trace timing.

With ``track_plans=True`` every placement change additionally compiles the
ServicePlan and accounts its data-plane consequences in the result: bytes
migrated across shards (paper accounting), padding waste, and the
delta-migration view (repro.ps.elastic.plan_transition_summary) -- bytes
actually moved by the run-copy path and how many resident jobs each
replan touches (stalls) vs rides past (stall-free).

With ``tick_interval > 0`` the simulator also accounts service-tick
batching (repro.ps.engine driven by a periodic tick): while J jobs run,
each pushes one update per effective iteration, but the engine applies
one pending push per job per batched pass -- so the service executes
``max_j(rate_j)`` passes per second instead of ``sum_j(rate_j)``.  A
tick-limited job's sustained push rate is one per tick (each tick frees
exactly one queue slot; the engine's ``max_staleness`` only sizes the
transient burst a job may run ahead, not its steady-state rate), so
rates are capped at ``1 / tick_interval``.  ``SimResult`` reports sequential vs batched
update-pass totals and the resulting batching factor for the Fig. 11
runs.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.service import ParameterService
from repro_torch.sim.trace import TraceJob


@dataclass
class SimConfig:
    total_budget: int = 4096
    n_clusters: int = 4
    loss_limit: float = 0.1
    scaling_period: float = 600.0  # idle Aggregators released on this tick
    sample_interval: float = 60.0  # Fig. 11 measures at 1-min intervals
    # Compile the ServicePlan after every placement change and account the
    # data-plane consequences (bytes migrated across shards, padding waste).
    track_plans: bool = False
    # Service-tick engine accounting: 0 = per-job immediate updates
    # (legacy); > 0 = the engine drains all pending jobs every
    # tick_interval seconds in one batched pass.  (The engine's
    # max_staleness knob sizes only the transient burst a job may run
    # ahead -- the sustained push rate of a tick-limited job is one per
    # tick regardless -- so it does not appear in this accounting.)
    tick_interval: float = 0.0
    # Wire accounting.  ``push_compression`` prices every push
    # under repro.ps.compression.wire_bytes (None = fp32, "bf16" = 2B/
    # elem, "int8" = 1B/elem + scales); pushes themselves are unchanged
    # -- this is the transfer-byte model of the engines' compressed push
    # path.  With ``pull_interval > 0`` each running job is also pulled
    # by a reader every pull_interval seconds; a versioned diff pull
    # ships only the blocks that changed since the reader's last vector,
    # modeled as ``pull_dirty_fraction`` of the job's bytes (1.0 = every
    # pull is effectively full).
    push_compression: Optional[str] = None
    pull_interval: float = 0.0
    pull_dirty_fraction: float = 1.0
    # Read tier.  With ``read_qps > 0`` a replica set of
    # ``n_read_replicas`` pull-only endpoints (repro.ps.replica) serves
    # an aggregate ``read_qps`` requests/sec, round-robin over the
    # running jobs.  Replicas hold snapshots published every
    # ``replica_publish_interval`` seconds (0 = every service tick, i.e.
    # ``tick_interval``): ONE publish is shared by every replica (the
    # ReplicaSet ships one immutable copy, not N), so the publish wire is
    # priced once per interval while reads scale with traffic; a served
    # read is on average half a publish interval stale.  Reads ship
    # ``pull_dirty_fraction`` of the job's bytes (versioned diff model,
    # same knob as engine pulls).
    read_qps: float = 0.0
    n_read_replicas: int = 1
    replica_publish_interval: float = 0.0


@dataclass
class SimResult:
    times: List[float] = field(default_factory=list)
    allocated: List[int] = field(default_factory=list)  # AutoPS servers (incl. idle pool)
    required: List[int] = field(default_factory=list)  # ps-lite requirement
    allocated_cpu_seconds: float = 0.0
    required_cpu_seconds: float = 0.0
    max_loss_seen: float = 0.0
    n_jobs_done: int = 0
    # Data-plane accounting from *compiled* ServicePlans (track_plans=True).
    migration_bytes_total: int = 0  # cross-Aggregator bytes (paper Table 3)
    n_replans: int = 0
    padding_waste: List[float] = field(default_factory=list)
    # Delta-migration accounting (track_plans=True): what each replan
    # actually costs on the data plane once transitions are executed as
    # compiled MigrationDeltas -- bytes = moved runs only, stalls = the
    # TOUCHED jobs only (untouched co-residents tick straight through).
    relayout_bytes_total: int = 0  # flat-space bytes the delta paths move
    replan_stalled_jobs: int = 0  # sum over replans of touched resident jobs
    replan_coresident_jobs: int = 0  # what a hard quiesce would have stalled
    # Service-tick engine accounting (tick_interval > 0).
    n_service_ticks: float = 0.0  # ticks elapsed while >= 1 job ran
    update_passes_sequential: float = 0.0  # one pass per push (per-job steps)
    update_passes_batched: float = 0.0  # one pass per tick round (engine)
    tick_limited_job_seconds: float = 0.0  # job-time spent at the staleness cap
    # Wire accounting (push_compression / pull_interval in SimConfig):
    # bytes every push would cost raw (fp32) vs on the modeled wire, and
    # bytes readers pull full vs as versioned diffs.
    push_bytes_raw: float = 0.0  # fp32 cost of every push
    push_bytes_wire: float = 0.0  # same pushes under push_compression
    pull_bytes_full: float = 0.0  # full-pull cost of the reader model
    pull_bytes_wire: float = 0.0  # versioned-diff cost (dirty fraction)
    # Read-tier accounting (read_qps > 0 in SimConfig): requests served
    # by the replica set, the bytes they shipped, the bytes the engines
    # published to feed the replicas (one shared copy per interval), and
    # the integral of snapshot age over served reads.
    reads_served: float = 0.0
    read_bytes_served: float = 0.0
    publish_bytes_total: float = 0.0
    read_staleness_seconds: float = 0.0  # sum over reads of snapshot age
    # Elastic-fleet CPU-tick accounting: each ALLOCATED Aggregator burns
    # one shard tick per tick_interval (its shard space wakes, drains,
    # applies) whether hot or cold -- so the integral of fleet size over
    # time, divided by the tick interval, is the CPU-ticks the elastic
    # (load-following) fleet consumed; a STATIC fleet provisioned for the
    # peak burns max_aggregators ticks every interval of the whole run.
    shard_tick_seconds: float = 0.0  # integral of allocated fleet size
    max_aggregators: int = 0  # peak fleet (the static fleet's size)
    elapsed_seconds: float = 0.0  # trace wall-clock covered

    @property
    def cpu_ticks_autoscaled(self) -> float:
        """Shard ticks the elastic fleet executed (tick_interval > 0)."""
        return self.shard_tick_seconds / self._tick  # set by the simulator

    @property
    def cpu_ticks_static(self) -> float:
        """Shard ticks a peak-sized always-on fleet would execute."""
        return self.max_aggregators * self.elapsed_seconds / self._tick

    @property
    def cpu_tick_reduction(self) -> float:
        """static / autoscaled CPU-ticks (>= 1: the Fig. 2/11 claim)."""
        if self.shard_tick_seconds <= 0:
            return 1.0
        return (self.max_aggregators * self.elapsed_seconds
                / self.shard_tick_seconds)

    _tick: float = 1.0  # tick_interval used (for the tick properties)
    _n_read_replicas: int = 1  # replica count used (read-tier properties)

    @property
    def cpu_time_saving(self) -> float:
        if self.required_cpu_seconds <= 0:
            return 0.0
        return 1.0 - self.allocated_cpu_seconds / self.required_cpu_seconds

    @property
    def mean_padding_waste(self) -> float:
        if not self.padding_waste:
            return 0.0
        return sum(self.padding_waste) / len(self.padding_waste)

    @property
    def replan_stall_free_fraction(self) -> float:
        """Fraction of (replan, resident job) pairs that did NOT stall
        under delta migration (1.0 = every replan was invisible to every
        co-resident job; 0.0 = hard-quiesce behavior)."""
        if self.replan_coresident_jobs <= 0:
            return 1.0
        return 1.0 - self.replan_stalled_jobs / self.replan_coresident_jobs

    @property
    def push_compression_ratio(self) -> float:
        """wire / raw push bytes (<= 1; 1.0 when nothing was pushed)."""
        if self.push_bytes_raw <= 0:
            return 1.0
        return self.push_bytes_wire / self.push_bytes_raw

    @property
    def pull_diff_saving(self) -> float:
        """1 - wire/full pull bytes (0 when the reader model is off)."""
        if self.pull_bytes_full <= 0:
            return 0.0
        return 1.0 - self.pull_bytes_wire / self.pull_bytes_full

    @property
    def reads_per_replica_per_sec(self) -> float:
        """Sustained serve rate one replica carried (read_qps > 0)."""
        if self.elapsed_seconds <= 0:
            return 0.0
        return (self.reads_served / self.elapsed_seconds
                / max(1, self._n_read_replicas))

    @property
    def mean_read_staleness_seconds(self) -> float:
        """Mean snapshot age a served read observed: half the publish
        interval under steady publishing (0 when the read tier is off)."""
        if self.reads_served <= 0:
            return 0.0
        return self.read_staleness_seconds / self.reads_served

    @property
    def read_publish_fanout(self) -> float:
        """Read bytes served per publish byte spent (the read-tier
        amortization claim: one shared publish feeds N replicas' worth
        of read traffic; higher = the tier pays for itself)."""
        if self.publish_bytes_total <= 0:
            return 0.0
        return self.read_bytes_served / self.publish_bytes_total

    @property
    def tick_batching_factor(self) -> float:
        """Sequential update passes per batched pass (>= 1): how many
        per-job step-functions one service tick replaces on average."""
        if self.update_passes_batched <= 0:
            return 1.0
        return self.update_passes_sequential / self.update_passes_batched

    def ratio_series(self) -> List[float]:
        return [a / r for a, r in zip(self.allocated, self.required) if r > 0]


class ClusterSimulator:
    def __init__(self, cfg: Optional[SimConfig] = None):
        # `cfg` must not default to SimConfig(): a dataclass default would be
        # shared by every simulator instance.
        self.cfg = SimConfig() if cfg is None else cfg
        cfg = self.cfg
        self.service = ParameterService(
            total_budget=cfg.total_budget,
            n_clusters=cfg.n_clusters,
            loss_limit=cfg.loss_limit,
        )
        self.idle_pool = 0  # released Aggregators awaiting the periodic tick
        self._last_plan = None

    def run(self, trace: List[TraceJob]) -> SimResult:
        cfg = self.cfg
        res = SimResult()
        res._tick = cfg.tick_interval if cfg.tick_interval > 0 else 1.0
        res._n_read_replicas = max(1, int(cfg.n_read_replicas))
        # Publish cadence of the read tier: explicit interval, else every
        # service tick, else 1 s (read_qps without any tick model).
        publish_period = (cfg.replica_publish_interval
                          if cfg.replica_publish_interval > 0
                          else res._tick)
        self._last_plan = None  # plan accounting must not leak across runs
        events: List[Tuple[float, int, str, Optional[TraceJob]]] = []
        for tj in trace:
            heapq.heappush(events, (tj.arrival, 0, tj.job_id, tj))
        if not events:
            return res
        t0 = events[0][0]
        heapq.heappush(events, (t0, 2, "__tick__", None))
        heapq.heappush(events, (t0, 3, "__sample__", None))

        running: Dict[str, TraceJob] = {}
        d_effs: Dict[str, float] = {}  # effective iteration durations
        last_t = t0
        if cfg.push_compression is not None:
            # Lazy like track_plan: the base simulator stays importable
            # without the JAX-backed data-plane modules.
            from repro_torch.ps.compression import wire_bytes
        else:
            wire_bytes = None
        dirty = min(1.0, max(0.0, cfg.pull_dirty_fraction))
        horizon = max(tj.arrival for tj in trace) + 1.0
        pending_work = len(trace)  # arrivals + exits not yet processed

        def record_interval(now: float) -> None:
            nonlocal last_t
            dt = now - last_t
            if dt > 0:
                alloc = self.service.n_aggregators + self.idle_pool
                req = sum(j.profile.required_servers for j in running.values())
                res.allocated_cpu_seconds += alloc * dt
                res.required_cpu_seconds += req * dt
                res.shard_tick_seconds += self.service.n_aggregators * dt
                res.max_aggregators = max(res.max_aggregators,
                                          self.service.n_aggregators)
                res.elapsed_seconds += dt
                if cfg.tick_interval > 0 and running:
                    # Service-tick batching: each job pushes 1/d_eff
                    # updates per second; per-job steps would execute one
                    # pass per push, the engine executes one pass per tick
                    # round -- set by the FASTEST job, since a tick drains
                    # one queued push per job.  A tick-limited job
                    # sustains ONE push per tick (each tick frees exactly
                    # one queue slot; max_staleness only allows a
                    # transient burst), so rates cap at 1/tick_interval.
                    cap = 1.0 / cfg.tick_interval
                    rates = []
                    for jid in running:
                        r = 1.0 / max(1e-9, d_effs[jid])
                        if r > cap:
                            res.tick_limited_job_seconds += dt
                            r = cap
                        rates.append(r)
                    res.update_passes_sequential += dt * sum(rates)
                    res.update_passes_batched += dt * max(rates)
                    res.n_service_ticks += dt / cfg.tick_interval
                if running and (wire_bytes is not None
                                or cfg.pull_interval > 0):
                    # Wire model: each job pushes its gradient bytes once
                    # per effective iteration (tick-capped like above),
                    # and readers pull it every pull_interval seconds --
                    # full pulls raw, versioned diffs at the dirty
                    # fraction of its blocks.
                    cap = (1.0 / cfg.tick_interval
                           if cfg.tick_interval > 0 else float("inf"))
                    for jid, tj in running.items():
                        rate = min(cap, 1.0 / max(1e-9, d_effs[jid]))
                        nbytes = tj.profile.total_bytes
                        res.push_bytes_raw += dt * rate * nbytes
                        res.push_bytes_wire += dt * rate * (
                            wire_bytes(nbytes // 4, cfg.push_compression)
                            if wire_bytes is not None else nbytes)
                        if cfg.pull_interval > 0:
                            pulls = dt / cfg.pull_interval
                            res.pull_bytes_full += pulls * nbytes
                            res.pull_bytes_wire += pulls * nbytes * dirty
                if running and cfg.read_qps > 0:
                    # Read tier: read_qps requests/sec land round-robin
                    # on the running jobs, so each read ships the MEAN
                    # job's bytes (dirty fraction under the versioned
                    # reader model); publishing ships each running job's
                    # bytes ONCE per publish interval regardless of the
                    # replica count (one shared immutable snapshot), and
                    # a served read observes on average half a publish
                    # interval of snapshot staleness.
                    reads = dt * cfg.read_qps
                    mean_bytes = (sum(j.profile.total_bytes
                                      for j in running.values())
                                  / len(running))
                    res.reads_served += reads
                    res.read_bytes_served += reads * mean_bytes * dirty
                    res.publish_bytes_total += (
                        dt / publish_period
                        * sum(j.profile.total_bytes
                              for j in running.values()))
                    res.read_staleness_seconds += (
                        reads * publish_period / 2.0)
            last_t = now

        def track_plan() -> None:
            """Account the data-plane cost of the placement change that a
            job arrival/exit/tick just made, from the *compiled* plan."""
            if not cfg.track_plans:
                return
            from repro_torch.ps.elastic import plan_transition_summary
            from repro_torch.ps.plan import plan_migration_bytes, plan_padding_waste

            plan = self.service.compile_plan()
            if self._last_plan is not None:
                moved = plan_migration_bytes(self._last_plan, plan)
                if moved or plan != self._last_plan:
                    res.n_replans += 1
                res.migration_bytes_total += moved
                if plan != self._last_plan:
                    # Delta accounting (segment-level summary, O(segments)
                    # -- the lane-exact delta compile would materialize
                    # full-space index arrays at simulator scale): bytes =
                    # moved runs only; stalls = the touched resident jobs
                    # only (vs every resident job under a hard quiesce).
                    moved_elems, touched_jobs = plan_transition_summary(
                        self._last_plan, plan)
                    res.relayout_bytes_total += moved_elems * 12
                    touched = set(touched_jobs)
                    res.replan_stalled_jobs += sum(
                        1 for j in running if j in touched)
                    res.replan_coresident_jobs += len(running)
            if plan.n_shards:
                res.padding_waste.append(plan_padding_waste(plan))
            self._last_plan = plan

        while events:
            t, kind, jid, payload = heapq.heappop(events)
            record_interval(t)

            if kind == 0:  # arrival
                tj = payload
                before = self.service.n_aggregators
                self.service.register_job(tj.profile)
                grew = self.service.n_aggregators - before
                # On-demand allocations first consume the idle pool.
                reuse = min(self.idle_pool, max(0, grew))
                self.idle_pool -= reuse
                running[jid] = tj
                d_eff = self.service.predicted_iteration(jid)
                d_effs[jid] = d_eff
                loss = max(0.0, 1.0 - tj.profile.iteration_duration / d_eff)
                res.max_loss_seen = max(res.max_loss_seen, loss)
                finish = t + tj.duration / max(1e-9, (1.0 - loss))
                heapq.heappush(events, (finish, 1, jid, None))
                track_plan()
            elif kind == 1:  # exit
                pending_work -= 1
                if jid in running:
                    before = self.service.n_aggregators
                    self.service.job_exit(jid)
                    freed = before - self.service.n_aggregators
                    self.idle_pool += max(0, freed)
                    running.pop(jid)
                    d_effs.pop(jid, None)
                    res.n_jobs_done += 1
                    track_plan()
            elif kind == 2:  # periodic scaling tick: release idle servers
                self.idle_pool = 0
                self.service.periodic_rebalance()
                track_plan()
                if pending_work > 0:
                    heapq.heappush(events, (t + cfg.scaling_period, 2, jid, None))
            elif kind == 3:  # sampling
                alloc = self.service.n_aggregators + self.idle_pool
                req = sum(j.profile.required_servers for j in running.values())
                res.times.append(t)
                res.allocated.append(alloc)
                res.required.append(req)
                if pending_work > 0:
                    heapq.heappush(events, (t + cfg.sample_interval, 3, jid, None))

            if pending_work <= 0:
                break
        return res
