"""The service's spans on the profiler's clock (``repro_torch.tracing``).

Under ``torch.profiler`` the engines' submit, step, pull and tick and the
sharded runtime's ``add_job`` and replan record ``repro_torch.*`` events
in a tree; without a profiler nothing is recorded and nothing changes.
The replan's phases are timed into ``debug_stats()``.  The last tests
hold ``scripts/torch_service_spans.py``'s reading of a profile against
the benchmark's own summary.
"""

import dataclasses
import importlib.util
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core import ParameterService
from repro_torch.ps.runtime import tree_from_numpy
from repro_torch.ps.service_runtime import (
    REPLAN_PHASES,
    ServiceRuntime,
    ShardedServiceRuntime,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def _tree(seed, sizes):
    rng = np.random.default_rng(seed)
    return {f"t{i}": rng.standard_normal(n).astype(np.float32)
            for i, n in enumerate(sizes)}


TREES = {"a": _tree(0, (48, 16, 32)), "b": _tree(1, (32, 16)),
         "c": _tree(2, (16,))}


def _loss(params, batch):
    return sum(torch.sum((params[k] - 1.0) ** 2) for k in params)


def _service():
    return ParameterService(total_budget=16, n_clusters=1, plan_pad_to=16)


def _add(rt, jid, compressed=()):
    t = TREES[jid]
    nbytes = sum(4 * v.size for v in t.values())
    extra = {"push_compression": "int8"} if jid in compressed else {}
    rt.add_job(jid, tree_from_numpy(t, "cpu"), _loss, lr=0.05,
               required_servers=1, agg_throughput=nbytes / 0.2, **extra)


def _sharded(compressed=(), **engine):
    rt = ShardedServiceRuntime(_service(), device="cpu")
    eng = rt.attach_engine(**engine)
    for jid in TREES:
        _add(rt, jid, compressed)
    for _ in range(3):
        if rt.n_shards >= 2:
            break
        rt.service.scale_out(1)
    assert rt.n_shards >= 2
    return rt, eng


def _grad(rt, jid, i):
    n = rt.splan.job_layout(jid).packed_len
    g = torch.Generator().manual_seed(1000 * i + ord(jid))
    return torch.randn(n, generator=g) * 1e-2


def _spans(prof):
    """{name: [parent span name or None, ...]} of the repro_torch events."""
    out = {}
    for evt in prof.events():
        if not evt.name.startswith(tracing.PREFIX):
            continue
        p = evt.cpu_parent
        while p is not None and not p.name.startswith(tracing.PREFIX):
            p = p.cpu_parent
        out.setdefault(evt.name[len(tracing.PREFIX):], []).append(
            None if p is None else p.name[len(tracing.PREFIX):])
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def test_sharded_engine_records_the_span_tree():
    rt, eng = _sharded(compressed=("b",), max_staleness=0)
    assert not _profiled(lambda: None)

    def work():
        for jid in TREES:
            eng.submit_packed(jid, _grad(rt, jid, 0))
        eng.tick()
        eng.step("a", None)
        eng.step("a", None)  # a push ahead at max_staleness 0: forces
        eng.tick()
        eng.pull("c")

    spans = _profiled(work)
    assert set(spans["submit"]) == {None} and len(spans["submit"]) == 3
    assert spans["pull"] == [None]
    assert set(spans["step"]) == {None} and len(spans["step"]) == 2
    for part in ("step.pull", "step.grad", "step.pack", "step.enqueue"):
        assert spans[part] == ["step", "step"], part
    assert spans["step.force"] == ["step"]
    # The forced tick runs inside step.force.
    assert spans["tick"].count("step.force") == 1
    assert spans["tick"].count(None) == 2
    for part in ("tick.select", "tick.concat", "tick.k1", "tick.commit"):
        assert set(spans[part]) == {"tick"}, part
        assert len(spans[part]) == 3, part
    assert set(spans["tick.ef"]) == {"tick"}
    assert set(spans["tick.build"]) == {"tick.select"}
    assert "replan" not in spans and "tick.publish" not in spans


def test_ef_span_only_with_a_compressed_job():
    rt, eng = _sharded()

    def work():
        for jid in TREES:
            eng.submit_packed(jid, _grad(rt, jid, 0))
        eng.tick()

    spans = _profiled(work)
    assert "tick.k1" in spans and "tick.ef" not in spans


def test_snapshot_span_only_on_snapshot_ticks():
    rt, eng = _sharded(snapshot_interval=2)
    per_tick = []
    for i in range(5):
        before = eng.stats.n_snapshots

        def work():
            for jid in TREES:
                eng.submit_packed(jid, _grad(rt, jid, i))
            eng.tick()

        spans = _profiled(work)
        taken = eng.stats.n_snapshots - before
        assert len(spans.get("tick.snapshot", [])) == taken
        assert set(spans.get("tick.snapshot", ["tick"])) == {"tick"}
        per_tick.append(taken > 0)
    assert per_tick == [True, False, True, False, True]


def test_per_shard_tick_and_flat_engine_record_their_spans():
    rt, eng = _sharded(fleet_tick="per_shard")

    def sharded():
        for jid in TREES:
            eng.submit_packed(jid, _grad(rt, jid, 0))
        eng.tick()

    spans = _profiled(sharded)
    assert len(spans["tick"]) == rt.n_shards
    assert set(spans["tick.k1"]) == {"tick"}

    flat = ServiceRuntime(_service(), device="cpu")
    feng = flat.attach_engine(max_staleness=0)
    for jid in TREES:
        _add(flat, jid)

    def flat_work():
        feng.step("a", None)
        feng.step("a", None)
        feng.submit_push("b", tree_from_numpy(
            {k: np.ones_like(v) for k, v in TREES["b"].items()}, "cpu"))
        feng.tick()
        feng.pull("b")

    spans = _profiled(flat_work)
    assert spans["step.force"] == ["step"]
    for part in ("step.pull", "step.grad", "step.pack", "step.enqueue"):
        assert spans[part] == ["step", "step"], part
    assert spans["submit"] == [None] and spans["pull"] == [None]
    assert set(spans["tick.k1"]) == {"tick"}
    assert set(spans["tick.select"]) == {"tick"}


def test_no_profiler_enters_no_record(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing, "_Record", Counting)
    rt, eng = _sharded(compressed=("b",))
    for i in range(3):
        for jid in TREES:
            eng.submit_packed(jid, _grad(rt, jid, i))
        eng.tick()
        eng.step("c", None)
        eng.pull("a")
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        eng.tick()
    assert "repro_torch.tick" in entered


def _drive(rt, eng):
    for i in range(4):
        for jid in TREES:
            eng.submit_packed(jid, _grad(rt, jid, i))
        eng.tick()
        eng.step("a", None)
        eng.tick()
    eng.pull("b")


def test_spans_change_no_state():
    rt0, eng0 = _sharded(compressed=("b",), snapshot_interval=2)
    rt1, eng1 = _sharded(compressed=("b",), snapshot_interval=2)
    _drive(rt0, eng0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drive(rt1, eng1)
    assert _spans(prof)["tick.snapshot"]
    for k in rt0.arena:
        assert torch.equal(rt0.arena[k], rt1.arena[k]), k
    assert rt0.counts == rt1.counts
    assert dataclasses.asdict(eng0.stats) == dataclasses.asdict(eng1.stats)
    assert ({s: dataclasses.asdict(v) for s, v in eng0.shard_stats().items()}
            == {s: dataclasses.asdict(v)
                for s, v in eng1.shard_stats().items()})


def test_replan_phases_are_timed_into_debug_stats():
    rt = ShardedServiceRuntime(_service(), device="cpu")
    rt.attach_engine()
    assert rt.debug_stats()["runtime"]["replan_s"] == dict.fromkeys(
        REPLAN_PHASES, 0.0)
    t0 = time.perf_counter()
    _add(rt, "a")
    _add(rt, "b")
    wall = time.perf_counter() - t0
    got = rt.debug_stats()["runtime"]["replan_s"]
    assert set(got) == set(REPLAN_PHASES)
    assert all(v >= 0 for v in got.values())
    assert got["compile"] > 0 and got["steps"] > 0
    assert sum(got.values()) <= wall


def test_add_job_and_replan_spans_nest():
    rt = ShardedServiceRuntime(_service(), device="cpu")
    rt.attach_engine()
    _add(rt, "a")
    spans = _profiled(lambda: _add(rt, "b"))
    assert spans["add_job"] == [None]
    assert spans["add_job.register"] == ["add_job"]
    assert spans["add_job.seed"] == ["add_job"]
    assert spans["replan"] == ["add_job.register"]
    for ph in REPLAN_PHASES:
        assert spans["replan." + ph] == ["replan"], ph


def test_timed_adds_host_seconds_even_when_the_block_raises():
    totals = {}
    with tracing.timed("replan.compile", totals):
        pass
    with pytest.raises(RuntimeError):
        with tracing.timed("replan.compile", totals):
            raise RuntimeError("x")
    assert set(totals) == {"compile"} and totals["compile"] >= 0


# ------------------------------------------- the span script's reading
def _script():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(
        "torch_service_spans", ROOT / "scripts" / "torch_service_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ev(name, start, end, device=CPU, parent=None, id=0):
    return SimpleNamespace(
        name=name, device_type=device, id=id,
        time_range=SimpleNamespace(start=start, end=end), cpu_parent=parent)


def _stand_in_trace(with_program: bool):
    """A two-round stretch: the benchmark's spans, K1 and a copy on the
    device, and (optionally) the program's spans with device-side
    annotations of them; with the launch time of each device
    operation."""
    rnd = [_ev("psbench.round", 0, 100), _ev("psbench.round", 100, 200)]
    tick = [_ev("psbench.tick", 10, 60, parent=rnd[0]),
            _ev("psbench.tick", 110, 160, parent=rnd[1])]
    dev = [_ev("Memcpy DtoD", 30, 40, CUDA, id=101),
           _ev("multijob_fused_kernel", 45, 90, CUDA, id=102),
           _ev("multijob_fused_kernel", 145, 190, CUDA, id=103)]
    evs = rnd + tick + dev
    if with_program:
        t = _ev("repro_torch.tick", 12, 58, parent=tick[0])
        t2 = _ev("repro_torch.tick", 112, 158, parent=tick[1])
        evs += [t, _ev("repro_torch.tick.snapshot", 14, 30, parent=t),
                _ev("repro_torch.tick.k1", 40, 44, parent=t), t2,
                _ev("repro_torch.tick.k1", 140, 144, parent=t2),
                _ev("repro_torch.tick", 30, 90, CUDA),
                _ev("repro_torch.tick.k1", 45, 90, CUDA)]
    return evs, {101: 16, 102: 41, 103: 141}


def _psbench_classes(events):
    """The benchmark's own classification (``psbench.trace.profile``)."""
    dev, host = [], []
    for e in events:
        rng = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name.startswith("psbench."):
            if e.device_type == CPU:
                host.append(rng)
        elif e.device_type == CUDA:
            dev.append(rng)
    return dev, host


def test_script_keeps_the_benchmark_summary_and_relabels_gaps():
    mod = _script()
    from psbench.trace import summarize

    bare, _ = _stand_in_trace(False)
    want = summarize(*_psbench_classes(bare))
    for evs in (bare, _stand_in_trace(True)[0]):
        dev, bench, _ = mod.split_events(evs)
        got = summarize(dev, bench)
        for k in ("busy_s", "window_s", "by_name", "launches"):
            assert got[k] == want[k], k
    out = mod.report(*_stand_in_trace(True), 2, "service_fleet")
    # The first gap (0-30 us) has its midpoint inside tick.snapshot,
    # inside psbench.tick.
    gaps = {(round(s * 1e6), lab): old for lab, old, s in out["idle_gaps"]}
    assert gaps[(30, "repro_torch.tick.snapshot")] == "psbench.tick"
    assert out["spans"]["tick.k1"]["parent"] == "tick"
    assert out["spans"]["tick"]["device_ms"] == pytest.approx(0.05)
    assert out["spans"]["tick"]["self_ms"] == pytest.approx(0.0)
    assert out["checks"]["tick.k1_over_k1_by_name"] == pytest.approx(1.0)
    assert out["checks"]["tick_outside_k1_over_tick_nonk1"] == \
        pytest.approx(1.0)
    assert out["checks"]["device_ms_outside_spans"] == 0.0
    assert out["spans"]["tick.snapshot"]["top_ops"] == [
        ["Memcpy DtoD", pytest.approx(0.005)]]
    assert out["layers"] == {"submit_host_ms": None, "concat_ms": None,
                             "snapshot_ms": pytest.approx(0.005),
                             "ef_ms": None}
    assert out["program_spans_on_device"] == 2


def test_script_reads_a_real_profile_of_the_engine():
    mod = _script()
    from psbench import trace

    rt, eng = _sharded(compressed=("b",))

    def work():
        for i in range(2):
            with trace.mark("round"):
                with trace.mark("submit"):
                    for jid in TREES:
                        eng.submit_packed(jid, _grad(rt, jid, i))
                with trace.mark("tick"):
                    eng.tick()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    out = mod.report(prof.events(), mod.launches(prof), 2, "service_fleet")
    assert out["spans"]["tick"]["count"] == 2
    assert out["spans"]["submit"]["count"] == 6
    assert out["layers"]["submit_host_ms"] > 0
    assert out["layers"]["ef_ms"] == 0.0  # no device on the CPU
    assert out["program_spans_on_device"] == 0
    lm = mod.layers(out["spans"], "lm_job")
    assert lm == {"model_ms": None, "pull_pack_ms": None,
                  "snapshot_ms": out["layers"]["snapshot_ms"]}


def test_script_gives_a_backward_on_another_thread_to_its_span():
    mod = _script()
    rnd = _ev("psbench.round", 0, 100)
    step = _ev("repro_torch.step", 5, 95, parent=rnd)
    grad = _ev("repro_torch.step.grad", 20, 80, parent=step)
    pull = _ev("repro_torch.step.pull", 6, 19, parent=step)
    dev = [_ev("gemm", 25, 35, CUDA, id=201), _ev("gemm", 45, 65, CUDA,
                                                 id=202),
           _ev("gather", 9, 13, CUDA, id=203), _ev("add", 97, 98, CUDA,
                                                   id=204)]
    # 202 is the backward's, launched by the autograd engine's thread
    # (no parent on the caller's) while the caller waits in step.grad.
    launched = {201: 21, 202: 40, 203: 7, 204: 96}
    out = mod.report([rnd, step, grad, pull] + dev, launched, 1, "lm_job")
    assert out["layers"]["model_ms"] == pytest.approx(0.03)
    assert out["layers"]["pull_pack_ms"] == pytest.approx(0.004)
    assert out["spans"]["step"]["device_ms"] == pytest.approx(0.034)
    assert out["spans"]["step"]["self_ms"] == 0.0
    assert out["checks"]["device_ms_outside_spans"] == pytest.approx(0.001)
    assert out["checks"]["device_ms_by_name"] == pytest.approx(0.035)
