"""Finding a cell's files by name, running it, and the result line.

``BENCHMARK.json`` at the root names each cell's configuration and
traffic mix; the files are found by those names:

- the configuration: the ``file`` its entry names (``psbench/configs/``);
  its ``kind`` names the module of this package that builds and drives
  it (``service_fleet``);
- the traffic mix: ``psbench/traffic/<traffic>.json``, parameters that
  the kind's general loop reads;
- each metric: ``psbench/metrics/<name>.py``, a reader ``read(rec)`` of
  the run's record that returns a number or None (nothing to read);
- the limits of the compared numbers: ``psbench/limits/<cell>.json``.

A later cell, mix or metric is added with new files and entries alone.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from . import trace

ROOT = Path(__file__).resolve().parents[1]
# Top-level module names no run may load (compared whole: the port's
# package name begins with the JAX package's).
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, float]


@dataclass
class Record:
    """What a run measured, for the metric readers."""

    t_start: float
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    spans: trace.Spans = field(default_factory=trace.Spans)
    latencies: List[float] = field(default_factory=list)
    tick_host_s: List[float] = field(default_factory=list)
    tick_s: List[float] = field(default_factory=list)
    applied_params: int = 0
    tokens: int = 0
    attempted: int = 0
    failed: int = 0
    owned_lanes: int = 0
    owned_blocks: int = 0
    model_flops_per_token: Optional[float] = None
    profile: Optional[Dict[str, Any]] = None
    profile_ticks: int = 0
    memory_peak_bytes: int = 0
    detail: Dict[str, Any] = field(default_factory=dict)


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded;
    KeyError for a name it does not have."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "psbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    limits = json.loads((root / "psbench" / "limits"
                         / f"{name}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                limits=limits)


def reader(name: str, root: Path = ROOT):
    """The metric ``name``'s reader module (``psbench/metrics/<name>.py``)."""
    path = root / "psbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "psbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def syncer(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def judge(readings: Dict[str, float], limits: Dict[str, float],
          failed: int = 0):
    """The compared numbers beside their limits, and ``correct``: no
    request failed and every number is within its limit.  Names with a
    ``.`` (``info.``, ``control.`` ...) are not compared."""
    checks = {}
    for name, value in readings.items():
        if "." in name:
            continue
        if name not in limits:
            raise KeyError(f"no limit for {name!r}")
        checks[name] = {"value": value, "limit": limits[name]}
    return checks, bool(failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))


def variants(readings: Dict[str, float], limits: Dict[str, float]):
    """Each stand-in's verdict through ``judge``: the control's (or a
    planted fault's) readings ``<stand-in>.<name>`` put in the place of
    the program's ``<name>``; the numbers it does not read stay the
    program's.  {stand-in: {"correct": ..., "checks": ...}}."""
    own = {k: v for k, v in readings.items() if "." not in k}
    out = {}
    for prefix in sorted({k.split(".")[0] for k in readings if "." in k}
                         - {"info"}):
        swapped = dict(own)
        swapped.update({k[len(prefix) + 1:]: v for k, v in readings.items()
                        if k.startswith(prefix + ".")})
        checks, correct = judge(swapped, limits)
        out[prefix] = {"correct": correct, "checks": checks}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, *, t_start: Optional[float] = None,
             control: bool = False) -> Dict[str, Any]:
    """One run of ``cell``: its result line as a dict, the compared
    numbers under ``checks`` (last).  With ``control`` the stand-ins'
    readings are made too and judged apart (``_variants``)."""
    rec = Record(t_start=time.perf_counter() if t_start is None else t_start)
    kind = importlib.import_module(f"psbench.{cell.config['kind']}")
    readings = kind.run(cell, seed, seconds, traced, device, rec,
                        syncer(device), control=control)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": rec.memory_peak_bytes}
    out: Dict[str, Any] = {"correct": None, "attempted": rec.attempted,
                           "failed": rec.failed, "metrics": metrics,
                           "device": dev}
    if traced and rec.profile is not None:
        prof = rec.profile
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        ops = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = {"device_ops": [list(x) for x in ops[:10]],
                            "idle_gaps": [list(x) for x in
                                          prof["idle_gaps"][:10]]}
    out["checks"], out["correct"] = judge(readings, cell.limits, rec.failed)
    out["_readings"] = readings
    out["_variants"] = variants(readings, cell.limits)
    out["_detail"] = rec.detail
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({k.split(".")[0] for k, v in sys.modules.items()
                   if v is not None} & FORBIDDEN)


def emit(result: Dict[str, Any]) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard
    output."""
    line = {k: v for k, v in result.items() if not k.startswith("_")}
    for what, gaps in result.get("_detail", {}).items():
        print(f"detail {what}: {gaps}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}={c['value']!r} limit={c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
