"""Chaos-soak trace replay (PyTorch): the fig11-style trace driven end to
end through ``ShardedServiceRuntime`` + ``ShardedTickEngine`` +
``ElasticScaler`` + ``FaultInjector``.

The counterpart of ``repro.sim.replay``, with its control flow, chaos
schedule and report keys.  The harness buckets a Philly-like trace
(:mod:`repro_torch.sim.trace`) into fixed windows and replays it against
the port's data plane: arrivals register jobs, live jobs step through the
tick engine, exits remove jobs, the autoscaler resizes the fleet from
measured load, and an injected manual clock drives deterministic lease
expiry.  Each job's parameter tree comes from ``job_tree(job_id,
trace_job)``; the default is the reference's small synthetic tree (the
same sizes; values from a seeded ``torch.Generator``), and a caller may
hand in each trace job's full tensor inventory instead.  Two modes:

* ``chaos=True``: seeded apply faults, a boundary AND a mid-migration
  ``fail_migration``, a dropped push piece, a killed shard (recovered
  via ``recover_shard``), and a dead trainer that silently stops
  stepping until its lease reclaims it.  Every window checks that the
  control plane and data plane agree on the layout
  (``service.compile_sharded_plan() == runtime.splan``) -- the replan
  transaction's end-to-end guarantee.

* ``chaos=False``: the identical replay plus a FLAT ``ServiceRuntime``
  twin stepping the same (job, batch) sequence; every window compares
  every live job's parameters bit for bit (the engine runs at
  ``max_staleness=0``, so any divergence is a migration or recovery bug,
  not staleness).  The fleet ticks through the fused multi-job Adam
  kernel and the twin through the block kernel, so this holds the two
  against each other across migrations.

Everything runs on the card unless ``device="cpu"`` is passed.
``scripts/torch_replay_trace.py`` is the CLI.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..tree import tree_map

__all__ = ["ManualClock", "ReplayConfig", "run_replay",
           "replan_overhead_micro", "report_rows"]


class ManualClock:
    """Injectable engine clock: one unit per replay window."""

    def __init__(self, now: float = 0.0):
        self.now = float(now)

    def __call__(self) -> float:
        return self.now


@dataclass
class ReplayConfig:
    """Knobs for one replay run (defaults are smoke-sized)."""

    # Trace shape (trace seconds; the replay clock is WINDOWS).
    n_jobs: int = 14
    seed: int = 0
    mean_interarrival: float = 60.0
    median_duration: float = 240.0
    sigma: float = 1.0
    max_duration: float = 1400.0
    trace_window: float = 120.0
    max_windows: int = 12
    # Data plane.
    steps_per_window: int = 2
    max_live: int = 6  # admission cap: keeps the toy fleet bounded
    plan_pad_to: int = 16
    total_budget: int = 64
    snapshot_interval: int = 4
    max_apply_retries: int = 3
    # Autoscaler.
    shard_capacity: float = 8.0
    max_shards: int = 4
    cooldown: int = 2
    # Leases (in replay-clock units = windows).
    lease_interval: float = 3.0
    # Chaos schedule.
    chaos: bool = True
    apply_fault_ats: tuple = (5, 11)  # transient, any lane
    migration_fault_at: int = 2  # Nth migration dies at the boundary
    mid_migration_fault_at: int = 3  # Nth migration dies after 1 shard
    drop_push_at: int = 7
    kill_window: Optional[int] = 5  # arm a kill on the last shard here
    dead_job_window: Optional[int] = 4  # a trainer goes silent here
    # Parity twin (only meaningful with chaos=False).
    parity_twin: bool = False


def _sized_tree(sizes, seed: int) -> Dict[str, torch.Tensor]:
    """``{"t{i}": N(0, 1) of sizes[i]}``, the values from a CPU
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return {f"t{i}": torch.randn(int(n), generator=gen)
            for i, n in enumerate(sizes)}


def default_job_tree(job_id: str, trace_job=None) -> Dict[str, torch.Tensor]:
    """Small deterministic parameter tree for trace job ``jN`` -- the
    trace's real profiles are 64 MB-chunk scale, so the replay swaps in
    toy tensors and keeps only the trace's temporal structure.  The sizes
    are the reference's (``np.random.default_rng(1000 + N)``)."""
    index = int(job_id[1:])
    rng = np.random.default_rng(1000 + index)
    sizes = rng.choice([16, 24, 32, 48], size=int(rng.integers(2, 4)),
                       replace=True)
    return _sized_tree(sizes, index)


def _loss(params, batch):
    return sum(torch.sum((params[k] - batch["target"][k]) ** 2)
               for k in params)


def _params_equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def run_replay(
    cfg: ReplayConfig,
    *,
    device: DeviceLike = None,
    job_tree: Optional[Callable[[str, Any], Dict[str, torch.Tensor]]] = None,
    on_window: Optional[Callable[[Dict[str, Any], Any], None]] = None,
) -> Dict[str, Any]:
    """Replay the trace; returns the per-window log + invariant report.

    ``job_tree(job_id, trace_job)`` makes each admitted job's parameters
    (default :func:`default_job_tree`).  ``on_window(row, runtime)`` is
    called at the end of every window with that window's log row and the
    sharded runtime (a caller's per-window checks and timings; the final
    live jobs' parameters are ``runtime.params_of``).

    Raises only on harness bugs: injected faults are expected to be
    absorbed by the replan transactions, rollback recovery, shard
    recovery, and lease reclaim.  ``registry_divergence_windows`` counts
    windows where control and data plane disagreed on the layout -- the
    chaos acceptance criterion is that it stays 0.
    """
    from ..core import ParameterService
    from ..ps.autoscaler import AutoscalerConfig, ElasticScaler
    from ..ps.faults import EngineQuarantinedError, FaultInjector
    from ..ps.service_runtime import ServiceRuntime, ShardedServiceRuntime
    from .trace import philly_like_trace, window_schedule

    device = resolve_device(device)
    job_tree = job_tree or default_job_tree
    trace = philly_like_trace(
        n_jobs=cfg.n_jobs, mean_interarrival=cfg.mean_interarrival,
        median_duration=cfg.median_duration, sigma=cfg.sigma,
        max_duration=cfg.max_duration, seed=cfg.seed,
        chunk_bytes=1 << 12)
    trace_jobs = {j.job_id: j for j in trace}
    windows = window_schedule(trace, cfg.trace_window,
                              max_windows=cfg.max_windows)
    exit_at = {}
    for w in windows:
        for j in w.exits:
            exit_at[j] = w.index

    clock = ManualClock()
    inj = FaultInjector(seed=cfg.seed)
    svc = ParameterService(total_budget=cfg.total_budget, n_clusters=1,
                           plan_pad_to=cfg.plan_pad_to)
    rt = ShardedServiceRuntime(svc, device=device)
    eng = rt.attach_engine(
        max_staleness=0, snapshot_interval=cfg.snapshot_interval,
        max_apply_retries=cfg.max_apply_retries, fault_injector=inj,
        lease_interval=cfg.lease_interval, clock=clock)
    scaler = ElasticScaler(rt, AutoscalerConfig(
        shard_capacity=cfg.shard_capacity, max_shards=cfg.max_shards,
        cooldown=cfg.cooldown))

    twin = None
    if cfg.parity_twin:
        twin = ServiceRuntime(
            ParameterService(total_budget=cfg.total_budget, n_clusters=1,
                             plan_pad_to=cfg.plan_pad_to), device=device)

    if cfg.chaos:
        for at in cfg.apply_fault_ats:
            inj.fail_apply(None, at=int(at))
        inj.fail_migration(at=cfg.migration_fault_at)
        inj.fail_migration(at=cfg.mid_migration_fault_at, after_shards=1)
        inj.drop_push(at=cfg.drop_push_at)

    admitted: List[str] = []
    targets: Dict[str, Any] = {}
    live: List[str] = []
    dead: set = set()  # trainers gone silent (chaos)
    reclaimed: set = set()  # lease-expired jobs
    read_vectors: Dict[str, Any] = {}  # reader's held PullVersions
    skipped_arrivals = 0
    n_exits = n_steps = n_reads = n_recoveries = 0
    dead_job = None
    dead_window = reclaim_window = None
    parity_violations = 0
    divergence = 0
    window_log: List[Dict[str, Any]] = []

    def add(jid: str) -> None:
        tree = tree_map(lambda t: t.to(device),
                        job_tree(jid, trace_jobs[jid]))
        admitted.append(jid)
        targets[jid] = tree_map(lambda p: p * 0 + 1.0, tree)
        nbytes = sum(4 * v.numel() for v in tree.values())
        kw = dict(lr=0.05, required_servers=1, agg_throughput=nbytes / 0.2)
        rt.add_job(jid, tree, _loss, **kw)
        if twin is not None:
            twin.add_job(jid, tree, _loss, **kw)
        live.append(jid)

    def step(jid: str) -> None:
        nonlocal n_recoveries
        try:
            eng.step(jid, {"target": targets[jid]})
        except EngineQuarantinedError:
            # A lane died mid-step: re-host the quarantined shard(s) on
            # the survivors (transactional replan) and retry once.
            for sid in eng.quarantined_shards():
                rt.recover_shard(sid)
                n_recoveries += 1
            eng.step(jid, {"target": targets[jid]})
        if twin is not None:
            twin.step(jid, {"target": targets[jid]})

    def read(jid: str) -> None:
        """One versioned pull per live job per window -- the read-path
        consumer that makes the soak price the pull wire (diff pulls
        across rollbacks/replans, full-pull fallbacks)."""
        nonlocal n_reads, n_recoveries
        try:
            diff = eng.pull(jid, since_version=read_vectors.get(jid, 0))
        except EngineQuarantinedError:
            # A hosting lane died before the read: re-host it (same
            # recovery path the trainer uses) and retry once.
            for sid in eng.quarantined_shards():
                rt.recover_shard(sid)
                n_recoveries += 1
            diff = eng.pull(jid, since_version=read_vectors.get(jid, 0))
        read_vectors[jid] = diff.version
        n_reads += 1

    for w in windows:
        clock.now = float(w.index)
        pulls_at_start = (eng.stats.n_full_pulls, eng.stats.n_diff_pulls,
                          eng.stats.pull_bytes_wire,
                          eng.stats.pull_bytes_full)
        for jid in w.arrivals:
            if len(live) >= cfg.max_live:
                skipped_arrivals += 1
                continue
            add(jid)
        if (cfg.chaos and cfg.kill_window is not None
                and w.index == cfg.kill_window and rt.n_shards >= 1):
            inj.kill_shard(rt.shard_ids[-1], at=1)
        if (cfg.chaos and cfg.dead_job_window is not None
                and w.index == cfg.dead_job_window and dead_job is None):
            # The live job with the LATEST scheduled exit goes silent:
            # only its lease can reclaim it.
            candidates = [j for j in live if j not in dead]
            if candidates:
                dead_job = max(
                    candidates,
                    key=lambda j: exit_at.get(j, cfg.max_windows + 1))
                dead.add(dead_job)
                dead_window = w.index
        for jid in list(live):
            if jid in dead or jid in reclaimed:
                continue
            for _ in range(cfg.steps_per_window):
                step(jid)
                n_steps += 1
        # Read path: the dead trainer's job is NOT read -- a pull renews
        # its lease, and the point of the dead-job scenario is that only
        # the lease reclaims it.
        for jid in list(live):
            if jid in dead or jid in reclaimed:
                continue
            read(jid)
        expired = eng.expire_leases()
        for jid in expired:
            reclaimed.add(jid)
            if jid in live:
                live.remove(jid)
            targets.pop(jid, None)
            if jid == dead_job and reclaim_window is None:
                reclaim_window = w.index
        decision = scaler.observe()
        # Trace exits fire at window end; a dead trainer never calls
        # remove_job (that is the point -- its lease does the cleanup).
        for jid in w.exits:
            if jid not in live or jid in dead or jid in reclaimed:
                continue
            rt.remove_job(jid)
            if twin is not None:
                twin.remove_job(jid)
            live.remove(jid)
            targets.pop(jid)
            n_exits += 1
        # ---- invariants ----
        if rt.splan is not None:
            agree = (svc.compile_sharded_plan() == rt.splan
                     and set(svc._jobs) == set(rt._jobs)
                     and set(eng._lanes) <= set(rt.splan.shard_ids))
        else:
            agree = not svc._jobs and not rt._jobs
        if not agree:
            divergence += 1
        window_parity = True
        if twin is not None:
            eng.drain()
            for jid in live:
                if not _params_equal(rt.params_of(jid),
                                     twin.params_of(jid)):
                    window_parity = False
            if not window_parity:
                parity_violations += 1
        window_log.append(dict(
            window=w.index, arrivals=len(w.arrivals), exits=len(w.exits),
            live=len(live), n_shards=rt.n_shards, action=decision.action,
            agree=bool(agree), parity=bool(window_parity),
            faults_fired=inj.n_fired,
            # Wire counters, this window's deltas: the soak prices the
            # read path alongside the chaos invariants.
            full_pulls=eng.stats.n_full_pulls - pulls_at_start[0],
            diff_pulls=eng.stats.n_diff_pulls - pulls_at_start[1],
            pull_bytes_wire=eng.stats.pull_bytes_wire - pulls_at_start[2],
            pull_bytes_full=eng.stats.pull_bytes_full - pulls_at_start[3]))
        if on_window is not None:
            on_window(window_log[-1], rt)

    return dict(
        windows=window_log,
        n_windows=len(windows),
        n_trace_jobs=len(trace),
        n_admitted=len(admitted),
        n_skipped_arrivals=skipped_arrivals,
        n_exits=n_exits,
        n_steps=n_steps,
        n_reads=n_reads,
        n_full_pulls=eng.stats.n_full_pulls,
        n_diff_pulls=eng.stats.n_diff_pulls,
        pull_bytes_wire=eng.stats.pull_bytes_wire,
        pull_bytes_full=eng.stats.pull_bytes_full,
        n_recoveries=n_recoveries,
        faults_by_kind=inj.fire_counts(),
        n_faults_fired=inj.n_fired,
        n_replan_commits=svc.n_replan_commits,
        n_replan_aborts=svc.n_replan_aborts,
        n_replan_retries=svc.n_replan_retries,
        n_lease_expirations=eng.stats.n_lease_expirations,
        n_rollbacks=eng.stats.n_rollbacks,
        n_quarantines=eng.stats.n_quarantines,
        registry_divergence_windows=divergence,
        parity_violations=parity_violations,
        dead_job=dead_job,
        dead_window=dead_window,
        reclaim_window=reclaim_window,
        reclaim_latency_windows=(None if reclaim_window is None
                                 or dead_window is None
                                 else reclaim_window - dead_window),
        lease_interval=cfg.lease_interval,
        final_n_shards=rt.n_shards,
        final_live=sorted(live),
    )


def replan_overhead_micro(n_cycles: int = 3,
                          device: DeviceLike = None) -> Dict[str, float]:
    """Wall-clock cost of a RECOVERED replan (one injected migration
    fault -> abort -> registry rollback -> retry to success) vs a clean
    one, on identical scale-out transitions."""
    from ..core import ParameterService
    from ..ps.faults import FaultInjector
    from ..ps.service_runtime import ShardedServiceRuntime

    device = resolve_device(device)

    def build(inj=None):
        svc = ParameterService(total_budget=16, n_clusters=1,
                               plan_pad_to=16)
        rt = ShardedServiceRuntime(svc, device=device)
        rt.attach_engine(max_staleness=0, fault_injector=inj)
        for i, sizes in enumerate(((48, 16, 32), (32, 16), (48, 16))):
            tree = tree_map(lambda t: t.to(device), _sized_tree(sizes, i))
            nbytes = sum(4 * v.numel() for v in tree.values())
            rt.add_job(f"m{i}", tree, _loss, lr=0.05, required_servers=1,
                       agg_throughput=nbytes / 0.2)
        return svc, rt

    def cycle_ms(svc, inj=None):
        # One warm-up cycle amortizes plan-pair-cache misses for both
        # variants identically.
        out = []
        for _ in range(n_cycles + 1):
            if inj is not None:
                inj.fail_migration(at=1)
                inj.rules[-1].seen = 0  # fresh rule per cycle
            t0 = time.perf_counter()
            svc.scale_out(1)
            out.append((time.perf_counter() - t0) * 1e3)
            svc.scale_in(1)
        return out[1:]

    svc_clean, _rt_clean = build()
    clean = cycle_ms(svc_clean)
    inj = FaultInjector()
    svc_chaos, _rt_chaos = build(inj)
    recovered = cycle_ms(svc_chaos, inj)
    clean_ms = sum(clean) / len(clean)
    recovered_ms = sum(recovered) / len(recovered)
    return dict(
        clean_ms=clean_ms,
        recovered_ms=recovered_ms,
        overhead_pct=100.0 * (recovered_ms / clean_ms - 1.0),
        aborts=svc_chaos.n_replan_aborts,
        retries=svc_chaos.n_replan_retries,
    )


def _pull_saving(report: Dict[str, Any]) -> float:
    """Shipped pull bytes as a fraction of the all-full-pull cost."""
    full = report.get("pull_bytes_full", 0)
    return report.get("pull_bytes_wire", 0) / full if full else 1.0


def report_rows(chaos: Dict[str, Any], parity: Dict[str, Any],
                micro: Optional[Dict[str, float]] = None):
    """Flatten two replay reports (+ the replan micro-bench) into the
    benchmark row shape: ``(name, value, derived-from)`` tuples."""
    lease_ok = (chaos["reclaim_latency_windows"] is not None
                and chaos["reclaim_latency_windows"]
                # one lease interval + the window sweep granularity
                <= int(chaos["lease_interval"]) + 1)
    rows = [
        ("chaos/windows", str(chaos["n_windows"]),
         "replay windows of the fig11-style trace under seeded chaos"),
        ("chaos/jobs_admitted", str(chaos["n_admitted"]),
         f"of {chaos['n_trace_jobs']} trace jobs "
         f"({chaos['n_skipped_arrivals']} skipped at the admission cap)"),
        ("chaos/steps", str(chaos["n_steps"]),
         "engine steps driven across all live jobs"),
        ("chaos/faults_fired", str(chaos["n_faults_fired"]),
         str(chaos["faults_by_kind"])),
        ("chaos/replan_aborts", str(chaos["n_replan_aborts"]),
         "replans rolled back on injected migration faults"),
        ("chaos/replan_retries", str(chaos["n_replan_retries"]),
         "aborted replans retried (all to success: the soak completed)"),
        ("chaos/rollbacks", str(chaos["n_rollbacks"]),
         "apply faults recovered by snapshot rollback"),
        ("chaos/shard_recoveries", str(chaos["n_recoveries"]),
         "killed shards re-hosted via recover_shard"),
        ("chaos/lease_expirations", str(chaos["n_lease_expirations"]),
         f"dead trainer {chaos['dead_job']!r} reclaimed"),
        ("chaos/reclaim_latency_windows",
         str(chaos["reclaim_latency_windows"]),
         "windows from trainer death to lease reclaim"),
        ("chaos/reclaimed_within_lease", str(int(lease_ok)),
         "acceptance: dead job reclaimed within one lease interval"),
        ("chaos/registry_divergence_windows",
         str(chaos["registry_divergence_windows"]),
         "windows where control and data plane disagreed"),
        ("chaos/zero_divergence",
         str(int(chaos["registry_divergence_windows"] == 0)),
         "acceptance: zero registry/runtime divergence under chaos"),
        ("chaos/reads", str(chaos["n_reads"]),
         "versioned pulls driven by the per-window read consumer"),
        ("chaos/read_full_pulls", str(chaos["n_full_pulls"]),
         "full-payload pulls (bootstraps + replan/rollback fallbacks)"),
        ("chaos/read_diff_pulls", str(chaos["n_diff_pulls"]),
         "pulls that shipped changed blocks only"),
        ("chaos/read_pull_bytes_wire", str(chaos["pull_bytes_wire"]),
         f"vs {chaos['pull_bytes_full']} B as all-full pulls "
         f"({_pull_saving(chaos):.2f}x of full)"),
        ("nofault/windows", str(parity["n_windows"]),
         "chaos-free replay vs a flat eager twin at s=0"),
        ("nofault/parity_violations", str(parity["parity_violations"]),
         "windows with any bit-level param divergence"),
        ("nofault/bit_exact", str(int(parity["parity_violations"] == 0)),
         "acceptance: no-fault replay bit-exact vs the chaos-free twin"),
    ]
    if micro is not None:
        rows += [
            ("replan/clean_ms", f"{micro['clean_ms']:.2f}",
             "mean wall ms of a fault-free scale-out replan"),
            ("replan/recovered_ms", f"{micro['recovered_ms']:.2f}",
             "same replan with one injected migration fault "
             "(abort -> rollback -> retry)"),
            ("replan/recovered_overhead_pct",
             f"{micro['overhead_pct']:.1f}",
             "recovered-replan overhead vs clean"),
        ]
    return rows
