"""Spans of the service's layers on the profiler's clock.

Run any workload under ``torch.profiler.profile`` and the service's
layers show as ``repro_torch.<name>`` events beside the kernels they
launch: ``submit``, ``pull``, the job step (``step`` and its
``step.*`` parts), the tick (``tick`` and its ``tick.*`` parts), the
sharded runtime's ``add_job`` and ``replan`` with their phases.  Spans
nest, so each event has its parent; an event's ``device_time_total`` is
the device time of the kernels and copies launched inside it.
``prof.key_averages()`` tables them, and
``prof.export_chrome_trace(path)`` draws them above the device's
timeline.

Outside a profiler a span costs one call and one check, and returns a
shared no-op context: there is nothing to switch on.

A span is recorded with operator scope (the profiler's
``RecordFunctionFast``), not as a user annotation.  A kernel that a
wrapper launches straight from inside a span, as the CUDA kernels' ctypes
wrappers do, is then correlated with the span, and the device's timeline
carries no second copy of it.

Replans are rare and long, so their phases are also timed on the host
clock whether or not a profiler records (:func:`timed`).

Counters (:func:`count`) are device tensors the model adds to while a
profiler records and a :func:`counting` block is open: the MoE layer's
``moe.kept`` and ``moe.dropped`` choices.  Each addition is kept as its
own tensor (a step under ``torch.func`` may not write a tensor made
outside it), so nothing waits for the device until
:meth:`Counts.read` after the traced stretch.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import time
from typing import Callable, Dict, List, Optional

import torch

PREFIX = "repro_torch."

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_Record = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """``repro_torch.<name>`` on the profiler's timeline while a profiler
    records; a shared no-op context otherwise."""
    if not _recording():
        return _OFF
    return _Record(PREFIX + name)


@contextlib.contextmanager
def timed(name: str, totals: Dict[str, float]):
    """:func:`span` ``name``, with the block's host seconds added to
    ``totals`` under the name's last part (``"replan.compile"`` adds to
    ``totals["compile"]``), profiler or not."""
    key = name.rsplit(".", 1)[-1]
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        totals[key] = totals.get(key, 0.0) + time.perf_counter() - t0


class Counts:
    """The counters added inside one :func:`counting` block."""

    def __init__(self):
        self._parts: Dict[str, List[torch.Tensor]] = \
            collections.defaultdict(list)

    def add(self, name: str, value: torch.Tensor) -> None:
        self._parts[name].append(value)

    def read(self) -> Dict[str, int]:
        """{name: total} of every counter added to (one synchronize)."""
        return {name: int(torch.stack([p.reshape(()) for p in parts]).sum())
                for name, parts in self._parts.items()}


_COUNTS: contextvars.ContextVar[Optional[Counts]] = contextvars.ContextVar(
    "repro_torch_counts", default=None)


@contextlib.contextmanager
def counting():
    """A block whose counters are kept, while a profiler records, in the
    :class:`Counts` it yields."""
    counts = Counts()
    token = _COUNTS.set(counts)
    try:
        yield counts
    finally:
        _COUNTS.reset(token)


def count(name: str, value: Callable[[], torch.Tensor]) -> None:
    """Add ``value()`` (a device scalar, computed only then) to counter
    ``name`` while a profiler records inside a :func:`counting` block;
    nothing otherwise."""
    if not _recording():
        return
    counts = _COUNTS.get()
    if counts is not None:
        counts.add(name, value())
