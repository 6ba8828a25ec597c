"""Job and server profilers (pMaster components, paper §3.1/Fig. 4).

The job profiler turns observed iteration timestamps into a robust iteration-
duration estimate D_j and per-tensor aggregation costs e_t; the server
profiler tracks each Aggregator's busy time so utilization can be reported
and fed to the scaling policy. The paper profiles a job standalone for ~100
iterations before packing (Fig. 10 case study: "after monitoring enough
iterations (default is 100)").
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .types import AggTask, JobProfile

DEFAULT_PROFILE_ITERS = 100  # paper default monitoring window


@dataclass
class JobProfiler:
    """Accumulates per-iteration observations for one job."""

    job_id: str
    model: str = ""
    n_workers: int = 2
    required_servers: int = 1
    iteration_times: List[float] = field(default_factory=list)
    tensor_bytes: Dict[int, int] = field(default_factory=dict)
    tensor_exec: Dict[int, List[float]] = field(default_factory=list)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if not isinstance(self.tensor_exec, dict):
            self.tensor_exec = {}

    def record_iteration(self, duration: float) -> None:
        self.iteration_times.append(duration)

    def record_tensor(self, tensor_id: int, nbytes: int, exec_time: float) -> None:
        self.tensor_bytes[tensor_id] = nbytes
        self.tensor_exec.setdefault(tensor_id, []).append(exec_time)

    @property
    def ready(self) -> bool:
        return len(self.iteration_times) >= min(DEFAULT_PROFILE_ITERS, 3)

    def iteration_duration(self) -> float:
        """Median is robust to transient stragglers (§3.3.1 outliers)."""
        if not self.iteration_times:
            raise ValueError("no iterations recorded")
        return statistics.median(self.iteration_times)

    def finalize(self) -> JobProfile:
        tasks = []
        for tid in sorted(self.tensor_bytes):
            execs = self.tensor_exec.get(tid, [0.0])
            tasks.append(
                AggTask(
                    job_id=self.job_id,
                    tensor_id=tid,
                    name=f"t{tid}",
                    nbytes=self.tensor_bytes[tid],
                    exec_time=statistics.median(execs),
                )
            )
        return JobProfile(
            job_id=self.job_id,
            model=self.model,
            iteration_duration=self.iteration_duration(),
            tasks=tasks,
            n_workers=self.n_workers,
            required_servers=self.required_servers,
        )


@dataclass
class ServerProfiler:
    """Sliding-window busy/idle accounting for one Aggregator."""

    agg_id: str
    window: float = 60.0
    samples: List[Tuple[float, float]] = field(default_factory=list)  # (t, busy_frac)

    def record(self, t: float, busy_fraction: float) -> None:
        self.samples.append((t, busy_fraction))
        cutoff = t - self.window
        while self.samples and self.samples[0][0] < cutoff:
            self.samples.pop(0)

    def utilization(self) -> float:
        if not self.samples:
            return 0.0
        return sum(b for _, b in self.samples) / len(self.samples)


def profile_from_bytes(
    job_id: str,
    model: str,
    tensor_sizes: Sequence[int],
    iteration_duration: float,
    n_workers: int,
    required_servers: int,
    agg_throughput: float,
) -> JobProfile:
    """Synthesize a JobProfile from tensor byte sizes.

    e_t = n_workers * nbytes / agg_throughput: each aggregation sums
    `n_workers` pushed gradients and applies the update, so CPU time scales
    with total pushed bytes (the model behind Fig. 2/3's spikes).
    """
    tasks = [
        AggTask(
            job_id=job_id,
            tensor_id=i,
            name=f"t{i}",
            nbytes=int(nb),
            exec_time=n_workers * nb / agg_throughput,
        )
        for i, nb in enumerate(tensor_sizes)
    ]
    return JobProfile(
        job_id=job_id,
        model=model,
        iteration_duration=iteration_duration,
        tasks=tasks,
        n_workers=n_workers,
        required_servers=required_servers,
    )
