"""The training cell's ``correct`` on the CPU with a small decoder of the
same architecture: true for the program, false for the control (the
reference with float8 products) and for each fault a training step can
have, planted in the program under the harness.  One card holds the
whole job, so no exchange between cards can be left out."""

import copy
import dataclasses
import math
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from psbench import harness, lm_job  # noqa: E402

CELL = "granite-8b-l4.train"
SMALL = dict(num_hidden_layers=1, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, intermediate_size=128,
             vocab_size=256, max_position_embeddings=64)


@contextmanager
def _threads(n):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _small_cell():
    cell = harness.find_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(SMALL)
    return dataclasses.replace(cell, config=cfg,
                               traffic=dict(cell.traffic, rows=2, seq=32))


def _run(seed, control=False, traced=False):
    with _threads(2):
        return harness.run_cell(_small_cell(), seed, 0.05, traced,
                                torch.device("cpu"),
                                t_start=time.perf_counter(), control=control)


def test_a_traced_run_times_the_tick_after_the_window():
    """The window's steps are not split by a synchronize in a traced
    run; the tick is timed on ``tick_steps`` steps after it."""
    res = _run(2 ** 31 + 24, traced=True)
    assert res["correct"], res["checks"]
    steps = res["_detail"]["seconds"]["steps"]
    tick_steps = _small_cell().traffic["tick_steps"]
    assert res["attempted"] == steps
    assert "tick_ms.lm" in res["metrics"]
    assert res["_readings"]["count_gap"] == 0
    assert tick_steps > 0


def test_the_configuration_lists_what_departs_from_its_source():
    cfg = harness.find_cell(CELL).config
    published = {k: v for k, v in cfg["published"].items() if k != "note"}
    for key, value in published.items():
        assert cfg["model"][key] != value and key in cfg["reduced"]
    assert cfg["model"]["max_position_embeddings"] == \
        harness.find_cell(CELL).traffic["seq"]


@pytest.mark.parametrize("key,value", [("mlp_bias", True),
                                       ("attention_bias", True),
                                       ("rms_norm_eps", 1e-5)])
def test_a_model_the_port_cannot_run_is_refused(key, value):
    m = dict(harness.find_cell(CELL).config["model"], **{key: value})
    with pytest.raises(ValueError):
        lm_job.lm_config(m)


def test_flops_per_token_by_hand():
    m = dict(SMALL, num_hidden_layers=2)
    # per layer: q 64*4*16, k and v 64*2*16 each, o 4*16*64, ffn 3*64*128
    per_layer = 64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128
    matmul = 2 * per_layer + 64 * 256
    attention = 2 * 2 * 4 * 16 * 32 / 2
    assert lm_job.model_flops_per_token(m, 32) == 6 * (matmul + attention)


def test_the_program_is_correct():
    res = _run(2 ** 31 + 21)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"count_gap", "grad_gap", "change_gap",
                                  "grad_diff"}
    assert math.isfinite(res["_readings"]["info.loss_gap"])


def test_the_control_is_not_correct():
    """The control and the faults planted in the reference, each judged
    by the harness's comparison in the program's place."""
    res = _run(2 ** 31 + 22, control=True)
    assert res["correct"], res["checks"]
    assert set(res["_variants"]) == {"control", "fault_half",
                                     "fault_altered"}
    for name, verdict in res["_variants"].items():
        assert not verdict["correct"], (name, verdict["checks"])


def _no_apply(monkeypatch):
    """A tick that returns the state unchanged."""
    from repro_torch.ps import engine

    monkeypatch.setattr(engine.ShardedTickEngine, "_build_fleet_applier",
                        lambda self, key: (lambda arena, gs, counts: None))


def _half_batch(monkeypatch):
    """Half of every batch's positions left out of the loss, the mean
    taken over the rest."""
    from repro_torch.models import transformer

    real = transformer.chunked_softmax_xent

    def xent(hidden, unembed, labels, **kw):
        labels = labels.clone()
        labels[:, labels.shape[1] // 2:] = -1
        return real(hidden, unembed, labels, **kw)

    monkeypatch.setattr(transformer, "chunked_softmax_xent", xent)


def _altered(monkeypatch):
    """The pushed gradient altered where it is packed: its first half
    scaled by 1.5."""
    from repro_torch.ps import engine

    real = engine._pack_slots

    def pack(layout, tree):
        g = real(layout, tree)
        g[: g.numel() // 2] *= 1.5
        return g

    monkeypatch.setattr(engine, "_pack_slots", pack)


@pytest.mark.parametrize("fault", [_no_apply, _half_batch, _altered])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run(2 ** 31 + 23)
    assert not res["correct"], res["checks"]
