"""The benchmark's plain reference on tiny vectors, against values worked
out by hand."""

import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from psbench.reference import adam as ra  # noqa: E402
from psbench.reference import service as rs  # noqa: E402


def test_adam_first_two_steps_move_by_lr_times_sign():
    # With one gradient repeated, m_hat = g and v_hat = g^2 at every
    # step, so each step moves p by lr * g / (|g| + eps).
    g = torch.tensor([1.0, -2.0, 0.5, 0.0])
    p = torch.zeros(4)
    m = torch.zeros(4)
    v = torch.zeros(4)
    p, m, v = ra.adam_step(p, m, v, g, 1, lr=0.1, b1=0.9, b2=0.999, eps=1e-8)
    assert torch.allclose(m, 0.1 * g)
    assert torch.allclose(v, 0.001 * g * g)
    assert torch.allclose(p, torch.tensor([-0.1, 0.1, -0.1, 0.0]), atol=1e-6)
    p, m, v = ra.adam_step(p, m, v, g, 2, lr=0.1, b1=0.9, b2=0.999, eps=1e-8)
    assert torch.allclose(m, 0.19 * g)
    assert torch.allclose(v, 0.001999 * g * g)
    assert torch.allclose(p, torch.tensor([-0.2, 0.2, -0.2, 0.0]), atol=1e-6)


def test_adam_bias_correction_by_hand():
    # t = 1, g = 3, lr 1, eps 0: m = 0.3, v = 0.009, m_hat = 3,
    # v_hat = 9, p = 10 - 3 / 3 = 9.
    p, m, v = ra.adam_step(torch.tensor([10.0]), torch.zeros(1),
                           torch.zeros(1), torch.tensor([3.0]), 1, lr=1.0,
                           b1=0.9, b2=0.999, eps=0.0)
    assert p.item() == pytest.approx(9.0, abs=1e-5)
    assert m.item() == pytest.approx(0.3)
    assert v.item() == pytest.approx(0.009)


def test_ef_bf16_carries_what_rounding_dropped():
    g = torch.tensor([1.0 + 2.0 ** -10])
    q, ef = ra.ef_round(g, torch.zeros(1), "bf16")
    assert q.item() == 1.0  # bf16 keeps 8 significant bits
    assert ef.item() == 2.0 ** -10
    q, ef = ra.ef_round(torch.zeros(1), ef, "bf16")
    assert q.item() == 2.0 ** -10 and ef.item() == 0.0


def test_ef_int8_block_by_hand():
    x = torch.zeros(1, ra.INT8_BLOCK)
    x[0, :4] = torch.tensor([1.0, 0.5, -0.3, 2.0 ** -9])
    q, ef = ra.ef_round(x, torch.zeros_like(x), "int8")
    # scale 1: 127 levels, 63.5 rounds half to even (64), -38.1 to -38,
    # 0.248 to 0
    want = torch.tensor([127.0, 64.0, -38.0, 0.0]) / 127.0
    assert torch.equal(q[0, :4], want)
    assert torch.equal(ef[0, :4], x[0, :4] - want)
    assert torch.equal(q[0, 4:], torch.zeros(ra.INT8_BLOCK - 4))


def test_ef_int8_zero_block_stays_zero():
    x = torch.zeros(2, ra.INT8_BLOCK)
    q, ef = ra.ef_round(x, x, "int8")
    assert not q.any() and not ef.any()


def test_no_compression_passes_gradient_through():
    g = torch.tensor([0.25, -1.0])
    q, ef = ra.ef_round(g, torch.ones(2), None)
    assert q is g and torch.equal(ef, torch.ones(2))


def _maps(payload, arena, n):
    return [{"payload": torch.tensor(payload), "arena": torch.tensor(arena),
             "n_payload": n}]


def test_layout_faults_counts_broken_packings():
    assert rs.layout_faults(_maps([0, 1, -1, 2], [4, 5, 6, 7], 3), 8) == 0
    # an element packed twice, an element missing
    assert rs.layout_faults(_maps([0, 0, -1, 2], [4, 5, 6, 7], 3), 8) == 1
    assert rs.layout_faults(_maps([0, 1, -1, -1], [4, 5, 6, 7], 3), 8) == 1
    # two packed lanes on one state lane, a lane off the state
    assert rs.layout_faults(_maps([0, 1, -1, 2], [4, 4, 6, 7], 3), 8) == 1
    assert rs.layout_faults(_maps([0, 1, -1, 2], [4, 5, 6, 8], 3), 8) == 1
    # two jobs on one lane
    two = _maps([0, 1], [0, 1], 2) + _maps([0, 1], [1, 2], 2)
    assert rs.layout_faults(two, 4) == 1


def test_gaps_relative_to_how_far_the_reference_moved():
    want = {"flat": torch.tensor([[1.0, 2.0]]),
            "init": torch.tensor([[0.0, 0.0]]),
            "mu": torch.tensor([[3.0, 4.0]]), "nu": torch.ones(1, 2)}
    job = {"valid": torch.tensor([[True, True]]),
           "prog": {"flat": torch.tensor([[1.0, 2.0]]),
                    "mu": torch.tensor([[3.0, 4.5]]),
                    "nu": torch.ones(1, 2)}}
    g = rs.gaps(job, want)
    assert g["flat"] == 0.0 and g["nu"] == 0.0
    assert g["mu"] == pytest.approx(0.5 / 5.0)
    job["valid"] = torch.tensor([[True, False]])  # the bad lane left out
    assert rs.gaps(job, want)["mu"] == 0.0


def test_sample_blocks_whole_blocks_from_the_seed():
    lens = [3 * ra.INT8_BLOCK + 5, ra.INT8_BLOCK]
    a = rs.sample_blocks(lens, 3, 7, "job")
    assert a == rs.sample_blocks(lens, 3, 7, "job")
    assert len(a) == 3 and len(set(a)) == 3
    for piece, first in a:
        assert first % ra.INT8_BLOCK == 0 and first < lens[piece]
    every = rs.sample_blocks(lens, 100, 7, "job")
    assert len(every) == 5  # ceil of each piece's blocks
    assert any(rs.sample_blocks(lens, 3, s, "job") != a for s in range(8))


def test_replay_matches_hand_steps_on_one_lane():
    job = {"id": "j", "lr": 0.1, "kind": None, "n_payload": 3,
           "payload_idx": torch.tensor([[2, -1]])}
    out = rs.replay(job, seed=5, init_scale=0.02, grad_scale=1e-3, ring=2,
                    steps=3, adam={"b1": 0.9, "b2": 0.999, "eps": 1e-8},
                    dtype=torch.float32, device=torch.device("cpu"))
    from psbench import inputs
    p = inputs.normal(3, 0.02, 5, "init", "j", device=torch.device("cpu"))[2]
    gs = [inputs.normal(3, 1e-3, 5, "grad", "j", r,
                        device=torch.device("cpu"))[2] for r in range(2)]
    m = v = 0.0
    for t in range(1, 4):
        g = float(gs[(t - 1) % 2])
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        p = p - 0.1 * (m / (1 - 0.9 ** t)) / (
            math.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
    assert out["flat"][0, 0].item() == pytest.approx(float(p), rel=1e-5)
    assert out["flat"][0, 1].item() == 0.0  # padding stays zero
