"""A profiled stretch read two ways: the benchmark's summary of it
(:func:`trace.summarize`, unchanged, from the ``psbench.*`` spans and the
device operations), and the device time of the operations launched
inside each of the program's own spans (``repro_torch.*``).

An operation belongs to the innermost program span that was open on the
host when its CUDA runtime call ran: the call of the same correlation id
gives the moment, on whichever thread made it (the autograd engine runs a
backward pass on threads of its own, after the forward's spans closed).
"""

from __future__ import annotations

import bisect
import collections
from typing import Callable, Dict, Tuple

import torch

from . import trace

PROGRAM = "repro_torch."


def _cpu(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CPU


def _launches(prof) -> Dict[int, float]:
    """{correlation id: host start in us} of the CUDA runtime calls that
    launched device work, in the time base of ``prof.events()``."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    cpu = torch.autograd.DeviceType.CPU
    return {k.correlation_id(): (k.start_ns() - t0) / 1e3
            for k in res.events()
            if k.device_type() == cpu and k.linked_correlation_id() > 0}


def _innermost(spans, starts, t: float):
    """The name of the innermost of ``spans`` ((start, end, name) by
    start, nested as one thread opens them) holding ``t``: the last to
    start of those that hold it."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if t <= spans[i][1]:
            return spans[i][2]
    return None


def profile(body: Callable[[int], None], n: int, sync: Callable[[], None],
            device: torch.device) -> Tuple[Dict, Dict[str, float]]:
    """Run ``body(i)`` for i < n under ``torch.profiler``.  Returns the
    benchmark's summary (as :func:`trace.profile` makes it) and the
    device seconds launched inside each program span, by the span's name
    without its prefix (operations launched inside no span under
    ``""``)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync()
    with torch_profile(activities=acts) as prof:
        for i in range(n):
            body(i)
        sync()
    events = prof.events()
    dev, host, prog, ops = [], [], [], []
    for evt in events:
        rng = (evt.name, float(evt.time_range.start),
               float(evt.time_range.end))
        if evt.name.startswith(trace.SPAN_PREFIX):
            if _cpu(evt):
                host.append(rng)
        elif evt.name.startswith(PROGRAM):
            if _cpu(evt):
                prog.append((rng[1], rng[2], evt.name[len(PROGRAM):]))
        elif not _cpu(evt):
            dev.append(rng)
            ops.append(evt)
    summary = trace.summarize(dev, host)
    launched = _launches(prof) if ops else {}
    prog.sort()
    starts = [s for s, _, _ in prog]
    inside: Dict[str, float] = collections.Counter()
    for evt in ops:
        t = launched.get(evt.id)
        name = None if t is None else _innermost(prog, starts, t)
        inside[name or ""] += float(evt.time_range.end
                                    - evt.time_range.start) / 1e6
    return summary, dict(inside)
