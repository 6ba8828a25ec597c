#!/usr/bin/env python3
"""Where a service round or a training step goes, by the port's own spans.

Builds a cell of the port's benchmark (``psbench``) as its run does, warms
it up, and profiles a stretch of rounds or steps under ``torch.profiler``
exactly as a traced run of the benchmark does (the same ``psbench.*``
marks, the same number of rounds).  It then reads the ``repro_torch.*``
spans the service records (``repro_torch.tracing``) beside the
benchmark's own and prints, per cell, one JSON object:

- ``base``: the benchmark's own summary of the stretch (busy and window
  seconds, the device's idle share, the profiled round's milliseconds,
  ``tick_nonk1_ms`` and K1's time a launch), computed by the benchmark's
  ``summarize``;
- ``spans``: each span's count, host and device milliseconds a round (a
  span's device time is that of the kernels and copies launched inside
  it, its children's included; ``self`` leaves them out);
- ``layers``: the per-layer quantities the spans measure (submit host
  time, concatenation, snapshot and error-feedback device time a tick;
  the model, pull-and-pack and snapshot device time a step);
- ``checks``: ``tick.k1``'s device time against K1's by kernel name,
  the tick's device time outside ``tick.k1`` against ``tick_nonk1_ms``,
  and the device time launched inside no span against all of it
  (``program_spans_on_device`` counts copies of the spans on the
  device's timeline, which operator-scope spans do not make);
- ``idle_gaps``: the longest idle gaps as [label, the benchmark's own
  label, seconds], the label the innermost span of either kind holding
  the gap's midpoint;
- ``replan_s``: the runtime's replan seconds by phase over set-up
  (``debug_stats()["runtime"]["replan_s"]``), beside the benchmark's
  ``register`` seconds;
- ``cost`` (with ``--cost PAIRS``): the profiled round's milliseconds
  and the idle share of stretches profiled with the spans on and off,
  alternating in one process.

Run from the repository root on a machine with one NVIDIA card:
``python3 scripts/torch_service_spans.py [--cell NAME ...] [--seed N]
[--cost PAIRS] [--json PATH]``; each cell runs in a process of its own.
Without CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = "psbench."
PROG = "repro_torch."
K1 = "multijob_fused_kernel"
CELLS = ("paper3.sync", "paper3.ef_mixed", "granite-8b-l4.train")


def _cpu(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CPU


def split_events(events):
    """(device ops as (name, start us, end us), the benchmark's host
    spans as the same, the program's span events) of a profile's events.
    A span of either kind is a host event; its copy on the device's
    timeline, if the profiler makes one, is not device work."""
    dev, bench, prog = [], [], []
    for evt in events:
        rng = (evt.name, float(evt.time_range.start),
               float(evt.time_range.end))
        if evt.name.startswith((BENCH, PROG)):
            if _cpu(evt):
                (bench.append(rng) if evt.name.startswith(BENCH)
                 else prog.append(evt))
        elif not _cpu(evt):
            dev.append(rng)
    return dev, bench, prog


def _parent_span(evt):
    p = evt.cpu_parent
    while p is not None and not p.name.startswith(PROG):
        p = p.cpu_parent
    return p


def launches(prof) -> Dict[int, float]:
    """{correlation id: host start in us} of the CUDA runtime calls in a
    finished profile that launched device work (those linked to an
    operator), from the profiler's own results, in the time base of
    ``prof.events()``."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    cpu = torch.autograd.DeviceType.CPU
    return {k.correlation_id(): (k.start_ns() - t0) / 1e3
            for k in res.events()
            if k.device_type() == cpu and k.linked_correlation_id() > 0}


def _innermost(spans, t: float):
    """The shortest of ``spans`` ((start, end, event), by start) that
    holds ``t``, or None."""
    best = None
    for s, e, span in spans:
        if s > t:
            break
        if t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, span)
    return None if best is None else best[2]


def attribute(events, prog, launched):
    """Device microseconds by the innermost program span that was open
    on the host when each device operation was launched: the CUDA
    runtime call of the same correlation id (``launched``, see
    :func:`launches`) gives the moment, on whichever thread made it (the
    autograd engine runs a backward pass on threads of its own while the
    caller waits inside its span).  Returns ({id(span): {operation name:
    us}}, us launched inside no span)."""
    spans = sorted(((float(e.time_range.start), float(e.time_range.end), e)
                    for e in prog), key=lambda x: x[0])
    own = collections.defaultdict(collections.Counter)
    outside = 0.0
    for evt in events:
        if _cpu(evt) or evt.name.startswith((BENCH, PROG)):
            continue
        us = float(evt.time_range.end - evt.time_range.start)
        t = launched.get(evt.id)
        span = None if t is None else _innermost(spans, t)
        if span is None:
            outside += us
        else:
            own[id(span)][evt.name] += us
    return own, outside


def span_table(prog, own, per: int) -> Dict[str, Dict]:
    """Each program span's count, its host milliseconds, and its device
    milliseconds (``device``: what it and the spans nested in it launched;
    ``self``: what it launched outside them; ``own`` from
    :func:`attribute`) a round over ``per`` rounds, with its three
    largest device operations."""
    self_us = {id(evt): sum(own[id(evt)].values()) for evt in prog}
    total = collections.Counter(self_us)
    for evt in prog:
        parent = _parent_span(evt)
        while parent is not None:
            total[id(parent)] += self_us[id(evt)]
            parent = _parent_span(parent)
    out: Dict[str, Dict] = {}
    ops = collections.defaultdict(collections.Counter)
    for evt in prog:
        name = evt.name[len(PROG):]
        parent = _parent_span(evt)
        row = out.setdefault(name, {
            "count": 0, "host_ms": 0.0, "device_ms": 0.0, "self_ms": 0.0,
            "parent": None if parent is None else parent.name[len(PROG):]})
        row["count"] += 1
        row["host_ms"] += (evt.time_range.end - evt.time_range.start) / 1e3
        row["device_ms"] += total[id(evt)] / 1e3
        row["self_ms"] += self_us[id(evt)] / 1e3
        ops[name].update(own[id(evt)])
    for name, row in out.items():
        for k in ("host_ms", "device_ms", "self_ms"):
            row[k] /= per
        row["top_ops"] = [[n, us / per / 1e3]
                          for n, us in ops[name].most_common(3)]
    return out


def idle_gaps(dev, bench, prog) -> List[Tuple[str, str, float]]:
    """The device's idle gaps inside the benchmark's window, longest
    first, as (label, the benchmark's own label, seconds): the label is
    the innermost span of either kind that holds the gap's midpoint."""
    from psbench.trace import _union

    if not bench:
        return []
    w0 = min(s for _, s, _ in bench)
    w1 = max(e for _, _, e in bench)
    merged = _union([(max(s, w0), min(e, w1)) for _, s, e in dev
                     if e > w0 and s < w1])
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    spans = bench + [(e.name, float(e.time_range.start),
                      float(e.time_range.end)) for e in prog]

    def label(mid, among):
        inside = [(e - s, name) for name, s, e in among if s <= mid <= e]
        return min(inside)[1] if inside else "outside any span"

    out = [(label((a + b) / 2, spans), label((a + b) / 2, bench),
            (b - a) / 1e6) for a, b in gaps]
    return sorted(out, key=lambda g: -g[2])


def _ms(table, *names, field="device_ms"):
    """The spans' summed milliseconds a round; None when none ran."""
    rows = [table[n][field] for n in names if n in table]
    return sum(rows) if rows else None


def layers(table, kind: str) -> Dict[str, float]:
    """The per-layer quantities the spans measure, a round or a step
    (None where the span did not run)."""
    if kind == "service_fleet":
        return {"submit_host_ms": _ms(table, "submit", field="host_ms"),
                "concat_ms": _ms(table, "tick.concat"),
                "snapshot_ms": _ms(table, "tick.snapshot"),
                "ef_ms": _ms(table, "tick.ef")}
    return {"model_ms": _ms(table, "step.grad"),
            "pull_pack_ms": _ms(table, "step.pull", "step.pack"),
            "snapshot_ms": _ms(table, "tick.snapshot")}


def report(events, launched, per: int, kind: str) -> Dict:
    """The cell's summary from a profile's events and launch times
    (:func:`launches`) over ``per`` rounds."""
    from psbench.trace import summarize

    dev, bench, prog = split_events(events)
    base = summarize(dev, bench)
    k1_s = sum(s for n, s in base["by_name"].items() if K1 in n)
    k1_n = sum(c for n, c in base["launches"].items() if K1 in n)
    nonk1_ms = (sum(base["by_name"].values()) - k1_s) / per * 1e3
    own, outside_us = attribute(events, prog, launched)
    table = span_table(prog, own, per)
    tick_ms = _ms(table, "tick") or 0.0
    k1_span = _ms(table, "tick.k1") or 0.0
    return {
        "base": {"busy_s": base["busy_s"], "window_s": base["window_s"],
                 "idle_pct": (100.0 * (1 - base["busy_s"] / base["window_s"])
                              if base["window_s"] else None),
                 "round_ms": base["window_s"] / per * 1e3,
                 "tick_nonk1_ms": nonk1_ms,
                 "k1_ms_per_launch": k1_s / k1_n * 1e3 if k1_n else None,
                 "k1_ms_per_round": k1_s / per * 1e3},
        "spans": table,
        "layers": layers(table, kind),
        "checks": {
            "tick.k1_over_k1_by_name": (k1_span / (k1_s / per * 1e3)
                                        if k1_s else None),
            "tick_outside_k1_ms": tick_ms - k1_span,
            "tick_outside_k1_over_tick_nonk1": ((tick_ms - k1_span)
                                                / nonk1_ms
                                                if nonk1_ms else None),
            "device_ms_outside_spans": outside_us / per / 1e3,
            "device_ms_by_name": sum(base["by_name"].values()) / per * 1e3},
        "idle_gaps": [list(g) for g in idle_gaps(dev, bench, prog)[:12]],
        "program_spans_on_device": sum(
            1 for e in events if e.name.startswith(PROG) and not _cpu(e)),
    }


def _profile(body, n: int, sync):
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            body(i)
        sync()
    return prof.events(), launches(prof)


def _cost(body, n: int, sync, kind: str, pairs: int) -> Dict:
    """The profiled round's milliseconds and the device's idle share with
    the program's spans on and off (its span check patched to say no
    profiler records), ``pairs`` stretches of each, alternating."""
    from repro_torch import tracing

    real = tracing._recording
    rows = {"on": [], "off": []}
    for i in range(pairs):
        for mode in ("on", "off") if i % 2 == 0 else ("off", "on"):
            if mode == "off":
                tracing._recording = lambda: False
            try:
                base = report(*_profile(body, n, sync), n, kind)["base"]
            finally:
                tracing._recording = real
            rows[mode].append([base["round_ms"], base["idle_pct"]])
    return rows


def run_cell(name: str, seed: int, cost: int = 0) -> Dict:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from psbench import harness, lm_job, service_fleet, trace

    cell = harness.find_cell(name)
    device = torch.device("cuda", 0)
    sync = harness.syncer(device)
    rec = harness.Record(t_start=time.perf_counter())
    tr = cell.traffic
    kind = cell.config["kind"]
    if kind == "service_fleet":
        app = service_fleet.Fleet(cell, seed, device, rec.spans, sync)
        for _ in range(tr["warmup_rounds"] + 40):
            app.round()
        n = tr["profile_rounds"]

        def body(_):
            with trace.mark("round"):
                app.round(marks=True)
    else:
        app = lm_job.Job(cell, seed, device, rec.spans, sync)
        for _ in range(lm_job.CHECKED_STEPS + tr["warmup_steps"] + 4):
            app.step()
        n = tr["profile_steps"]

        def body(_):
            with trace.mark("round"):
                app.step(marks=True)
    sync()
    out = report(*_profile(body, n, sync), n, kind)
    if cost:
        out["cost"] = _cost(body, n, sync, kind, cost)
    out["cell"] = name
    out["seed"] = seed
    out["replan_s"] = app.rt.debug_stats()["runtime"].get("replan_s")
    out["register_s"] = sum(rec.spans.seconds["register"])
    out["card"] = torch.cuda.get_device_name(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", action="append", choices=CELLS)
    ap.add_argument("--seed", type=int, default=2718281829)
    ap.add_argument("--json", help="append each cell's object to this file")
    ap.add_argument("--cost", type=int, default=0, metavar="PAIRS",
                    help="also profile PAIRS stretches with the spans on and "
                         "as many with them off, alternating (``cost``)")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_service_spans: needs a CUDA card", file=sys.stderr)
        return 1
    if args.one:
        print(json.dumps(run_cell(args.cell[0], args.seed, args.cost)),
              flush=True)
        return 0
    rc = 0
    for name in args.cell or CELLS:
        proc = subprocess.run(
            [sys.executable, __file__, "--one", "--cell", name, "--seed",
             str(args.seed), "--cost", str(args.cost)], cwd=ROOT,
            capture_output=True, text=True)
        if proc.returncode:
            rc = proc.returncode
            print(f"{name}: exit {proc.returncode}\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            continue
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        if args.json:
            with open(args.json, "a") as fh:
                fh.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
