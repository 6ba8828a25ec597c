"""A run's ``correct`` on the CPU at a small size: true for the program as
it is, false for the control (the reference in bfloat16 put in the
program's place, judged by the harness's own comparison) and for each
fault a service cell can have, planted in the program underneath the
harness (the harness's look for a card is skipped: ``run_cell`` is
driven on the CPU).  The cell's configuration is replaced by one with
every tensor, chunk and throughput cut by ``SCALE``.  One card holds the
whole fleet, so no exchange between cards can be left out."""

import copy
import dataclasses
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from psbench import harness  # noqa: E402

SCALE = 2e-5
SECONDS = 0.05


@contextmanager
def _threads(n):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _small_cell(cell_name):
    """The cell with its jobs' tensors, chunk size and throughput cut
    by ``SCALE``: the same placement at a CPU's size."""
    cell = harness.find_cell(cell_name)
    cfg = copy.deepcopy(cell.config)
    cfg["chunk_bytes"] = int(cfg["chunk_bytes"] * SCALE)
    cfg["service"]["agg_throughput"] *= SCALE
    for job in cfg["jobs"]:
        job["tensors"] = [[name, max(1, int(n * SCALE))]
                          for name, n in job["tensors"]]
    return dataclasses.replace(cell, config=cfg)


def _run(cell_name, seed, control=False):
    with _threads(2):
        return harness.run_cell(_small_cell(cell_name), seed, SECONDS,
                                False, torch.device("cpu"),
                                t_start=time.perf_counter(), control=control)


@pytest.mark.parametrize("cell", ["paper3.sync", "paper3.ef_mixed"])
def test_the_program_is_correct(cell):
    res = _run(cell, 2 ** 31 + 11)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    line = [k for k in res if not k.startswith("_")]
    assert line[-1] == "checks"  # the last key of the printed line


@pytest.mark.parametrize("cell", ["paper3.sync", "paper3.ef_mixed"])
def test_the_control_is_not_correct(cell):
    res = _run(cell, 2 ** 31 + 12, control=True)
    assert res["correct"], res["checks"]
    control = res["_variants"]["control"]
    assert not control["correct"], control["checks"]
    limit = harness.find_cell(cell).limits["state_gap"]
    assert control["checks"]["state_gap"]["value"] > limit


def _no_apply(monkeypatch):
    """A tick that returns the state unchanged."""
    from repro_torch.ps import engine

    monkeypatch.setattr(engine.ShardedTickEngine, "_build_fleet_applier",
                        lambda self, key: (lambda arena, gs, counts: None))


def _half_batch(monkeypatch):
    """Half of every tick's gradient left out, the mean taken over the
    rest (the kept half doubled)."""
    from repro_torch.ps import engine

    real = engine._fused_state_update

    def update(state, gs, counts, **kw):
        halved = []
        for g in gs:
            h = g.clone()
            n = h.numel() // 2
            h[n:] = 0
            h[:n] *= 2
            halved.append(h)
        return real(state, tuple(halved), counts, **kw)

    monkeypatch.setattr(engine, "_fused_state_update", update)


def _altered(monkeypatch):
    """An answer altered where it is produced: every 8th block row that
    the tick writes is nudged after the update."""
    from repro_torch.ps import engine

    real = engine._fused_state_update

    def update(state, gs, counts, *, block, block_idx, **kw):
        out = real(state, gs, counts, block=block, block_idx=block_idx,
                   **kw)
        rows = block_idx[::8].long()
        state["flat"].view(-1, block)[rows] += 1e-3
        return out

    monkeypatch.setattr(engine, "_fused_state_update", update)


def _no_feedback(monkeypatch):
    """Compressed pushes applied without their error-feedback round."""
    from repro_torch.ps import engine

    monkeypatch.setattr(engine, "_ef_rounds",
                        lambda gs, compressed, ef_of: tuple(gs))


def _stale_step_count(monkeypatch):
    """Every push applied with the step count of the job's first push
    (the bias correction never advances)."""
    from repro_torch.ps import engine

    real = engine._fused_state_update

    def update(state, gs, counts, **kw):
        return real(state, gs, tuple(1 for _ in counts), **kw)

    monkeypatch.setattr(engine, "_fused_state_update", update)


@pytest.mark.parametrize("cell,fault", [
    ("paper3.sync", _no_apply),
    ("paper3.sync", _half_batch),
    ("paper3.sync", _altered),
    ("paper3.sync", _stale_step_count),
    ("paper3.ef_mixed", _half_batch),
    ("paper3.ef_mixed", _no_feedback),
])
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell, 2 ** 31 + 13)
    assert not res["correct"], res["checks"]
