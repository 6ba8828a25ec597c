"""Synthetic Philly-like job trace.

The paper replays a 10-week trace from a 2000-GPU Microsoft cluster
(Jeon et al., ATC'19 -- the Philly trace). That trace is not shipped
offline, so we generate a synthetic one matching its published statistics:

  * inter-arrival: Poisson with diurnal modulation (day rate ~3x night);
  * durations: log-normal, median ~13 min with a heavy tail out to days
    (Philly: >50% jobs < 15 min, ~5% > 1 day), truncated at 7 days;
  * job mix: the four paper workloads x {1s-2w, 2s-2w, 4s-4w} configs,
    weighted toward small jobs (Philly: most jobs use few GPUs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs.paper_workloads import make_job
from repro_torch.core.types import JobProfile

MODELS = ["alexnet", "vgg19", "awd-lm", "bert"]
CONFIGS: List[Tuple[int, int, float]] = [  # (servers, workers, weight)
    (1, 2, 0.5),
    (2, 2, 0.35),
    (4, 4, 0.15),
]


@dataclass(frozen=True)
class TraceJob:
    job_id: str
    arrival: float
    duration: float
    profile: JobProfile


def philly_like_trace(
    n_jobs: int = 1000,
    mean_interarrival: float = 30.0,
    median_duration: float = 780.0,
    sigma: float = 1.8,
    max_duration: float = 7 * 86400.0,
    seed: int = 0,
    chunk_bytes: int = 64 << 20,
) -> List[TraceJob]:
    rng = np.random.default_rng(seed)
    jobs: List[TraceJob] = []
    t = 0.0
    weights = np.array([w for _, _, w in CONFIGS])
    weights = weights / weights.sum()
    for i in range(n_jobs):
        # Diurnal modulation of the arrival rate.
        hour = (t / 3600.0) % 24.0
        rate_scale = 0.5 + 0.75 * (1 + np.sin((hour - 6) / 24 * 2 * np.pi))
        t += rng.exponential(mean_interarrival / max(rate_scale, 0.1))
        duration = min(
            float(np.exp(np.log(median_duration) + sigma * rng.standard_normal())),
            max_duration,
        )
        model = MODELS[rng.integers(len(MODELS))]
        si = rng.choice(len(CONFIGS), p=weights)
        servers, workers, _ = CONFIGS[si]
        profile = make_job(model, f"j{i}", servers, workers,
                           chunk_bytes=chunk_bytes)
        jobs.append(TraceJob(f"j{i}", t, duration, profile))
    return jobs


@dataclass(frozen=True)
class TraceWindow:
    """One fixed-width slice of a trace: who arrives, who exits, who is
    live at the window's END (arrivals-then-exits within a window, so a
    job that both arrives and exits inside it appears in both lists but
    not in ``live``)."""

    index: int
    t0: float
    t1: float
    arrivals: Tuple[str, ...]
    exits: Tuple[str, ...]
    live: Tuple[str, ...]


def window_schedule(jobs: List[TraceJob], window: float,
                    max_windows: Optional[int] = None) -> List[TraceWindow]:
    """Bucket a trace into fixed-width windows -- the replay harness's
    clock (scripts/replay_trace.py).  ``window`` is in trace seconds;
    ``max_windows`` truncates the schedule (jobs still live at the cut
    simply never exit within it)."""
    if window <= 0:
        raise ValueError(f"window must be > 0, got {window}")
    if not jobs:
        return []
    ends = {j.job_id: j.arrival + j.duration for j in jobs}
    horizon = max(ends.values())
    n = int(np.ceil(horizon / window))
    if max_windows is not None:
        n = min(n, int(max_windows))
    out: List[TraceWindow] = []
    for i in range(n):
        t0, t1 = i * window, (i + 1) * window
        arrivals = tuple(j.job_id for j in jobs if t0 <= j.arrival < t1)
        exits = tuple(j.job_id for j in jobs
                      if j.arrival < t1 and t0 <= ends[j.job_id] < t1)
        live = tuple(j.job_id for j in jobs
                     if j.arrival < t1 and ends[j.job_id] >= t1)
        out.append(TraceWindow(i, t0, t1, arrivals, exits, live))
    return out
