"""Host spans and the device trace of a bounded stretch of work.

A traced run (``--trace 1``) keeps the benchmark's own spans (host clock,
each ended where the benchmark synchronizes) and profiles a bounded
stretch of ticks or steps with ``torch.profiler``.  Only a summary of the
profile is kept: each device operation's total time, the union of device
busy intervals, and the longest idle gaps labelled by the benchmark span
the host was in (``record_function`` names starting with ``psbench.``).
"""

from __future__ import annotations

import collections
import time
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List, Tuple

import torch

SPAN_PREFIX = "psbench."


class Spans:
    """Named host-clock spans, kept in memory for the run."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)

    @contextmanager
    def span(self, name: str, sync: Callable[[], None]):
        """Time the block to ``sync()``, which the block's work ends
        in."""
        t0 = time.perf_counter()
        yield
        sync()
        self.seconds[name].append(time.perf_counter() - t0)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(device_ops: List[Tuple[str, float, float]],
              host_spans: List[Tuple[str, float, float]]) -> Dict:
    """Reduce a trace to its summary.  ``device_ops`` and ``host_spans``
    are (name, start us, end us) in the profiler's one time base.  The
    traced window runs from the first benchmark span's start to the last
    one's end (the stretch as the host drove it); busy time is the union
    of device intervals clipped to it."""
    if not host_spans:
        return {"busy_s": 0.0, "window_s": 0.0, "by_name": {},
                "launches": {}, "idle_gaps": []}
    w0 = min(s for _, s, _ in host_spans)
    w1 = max(e for _, _, e in host_spans)
    by_name: Dict[str, float] = collections.Counter()
    launches: Dict[str, int] = collections.Counter()
    for name, s, e in device_ops:
        by_name[name] += (e - s) / 1e6
        launches[name] += 1
    busy = [(max(s, w0), min(e, w1)) for _, s, e in device_ops
            if e > w0 and s < w1]
    merged = _union(busy)
    busy_s = sum(b - a for a, b in merged) / 1e6
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    labelled = []
    for a, b in gaps:
        mid = (a + b) / 2
        inside = [(e - s, name) for name, s, e in host_spans if s <= mid <= e]
        label = min(inside)[1] if inside else "outside any span"
        labelled.append((label, (b - a) / 1e6))
    labelled.sort(key=lambda x: -x[1])
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e6,
            "by_name": dict(by_name), "launches": dict(launches),
            "idle_gaps": labelled}


def profile(body: Callable[[int], None], n: int, sync: Callable[[], None],
            device: torch.device) -> Dict:
    """Run ``body(i)`` for i < n under ``torch.profiler`` and summarize.
    ``body`` marks its parts with :func:`mark`."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync()
    with torch_profile(activities=acts) as prof:
        for i in range(n):
            body(i)
        sync()
    dev, host = [], []
    for evt in prof.events():
        rng = (evt.name, float(evt.time_range.start),
               float(evt.time_range.end))
        if evt.name.startswith(SPAN_PREFIX):
            # A span shows on the device's timeline too (as a GPU user
            # annotation); only its host side is a span.
            if evt.device_type == torch.autograd.DeviceType.CPU:
                host.append(rng)
        elif evt.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(rng)
    return summarize(dev, host)


def mark(name: str, on: bool = True):
    """A host span visible in the profile (``psbench.<name>``); nothing
    when ``on`` is false."""
    if not on:
        return nullcontext()
    return torch.profiler.record_function(SPAN_PREFIX + name)
