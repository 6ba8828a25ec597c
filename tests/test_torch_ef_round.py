"""The error-feedback round op (``repro_torch.kernels.ef_round``) held
against the eager round it took over from ``runtime._ef_round`` (the
owned rows of ``ef`` gathered, ``compression.ef_transform``, the residual
scattered back; ``ef_round_plain``), bit for bit in ``q`` and in ``ef``.

Each case also holds both against a numpy model of the CUDA kernel's
arithmetic (lane ``i`` of ``ef`` at ``rows[i // block] * block + i %
block``, one max-abs scale per 2048 lanes with the ragged tail left out,
the code through an int, ``q8 * s / 127``), so the kernel's formulation is
checked here too, signed zeros included.  The CUDA kernel itself runs only
on a card: ``test_ef_round_kernel_on_card`` holds it against the eager
round on the same CUDA tensors and against the CPU, and skips without one.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ef_round import ops
from repro_torch.kernels.ef_round.ref import ef_round_plain as eager_round
from repro_torch.ps.compression import BLOCK

ROW_BLOCK = 128
# Piece lengths: (rows of ROW_BLOCK with an owned-row table, lanes with the
# identity).  "short" is under one scale block, "ragged" not a multiple of
# it (5001 also not of 4), "zero_block" has an all-zero second scale block.
SIZES = {"short": (5, 1000), "ragged": (37, 5001), "zero_block": (50, 6444)}


def _bf16_round_trip(x: np.ndarray) -> np.ndarray:
    u = x.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def kernel_model(g, ef, kind, rows, block):
    """``csrc/ef_round.cu``'s arithmetic in numpy float32: (q, ef after)."""
    n = g.size
    i = np.arange(n)
    at = i if rows is None else rows[i // block] * block + i % block
    x = g + ef[at]
    if kind == "bf16":
        q = _bf16_round_trip(x)
    else:
        nb = -(-n // BLOCK)
        pad = np.zeros(nb * BLOCK, np.float32)
        pad[:n] = np.abs(x)
        m = pad.reshape(nb, BLOCK).max(axis=1)
        s = np.repeat(np.where(m > 0, m, np.float32(1)), BLOCK)[:n]
        c = np.rint(x / s * np.float32(127))
        c = np.clip(c, -127, 127).astype(np.int32).astype(np.float32)
        q = c * s / np.float32(127)
    out = ef.copy()
    out[at] = x - q
    return q, out


def _case(size, with_rows, seed=0):
    """(g, ef, rows or None, ef's lane of each piece lane), seeded: ``ef`` a
    residual-sized buffer with unowned rows around the owned ones (in no
    order), ``g`` a gradient; with ``zero_block`` lanes 2048..4095 of
    ``g + ef`` are zero."""
    rng = np.random.default_rng(seed)
    n_rows, n_id = SIZES[size]
    if with_rows:
        total = 2 * n_rows + 3
        rows = rng.permutation(total)[:n_rows].astype(np.int64)
        n = n_rows * ROW_BLOCK
        ef = (rng.standard_normal(total * ROW_BLOCK) * 1e-4
              ).astype(np.float32)
        i = np.arange(n)
        at = rows[i // ROW_BLOCK] * ROW_BLOCK + i % ROW_BLOCK
    else:
        rows, n = None, n_id
        ef = (rng.standard_normal(n) * 1e-4).astype(np.float32)
        at = np.arange(n)
    g = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    if size == "zero_block":
        g[BLOCK:2 * BLOCK] = 0.0
        ef[at[BLOCK:2 * BLOCK]] = 0.0
    return g, ef, rows, at


def _bits(t) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(t, np.float32)).view(np.int32)


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("with_rows", [True, False], ids=["rows", "identity"])
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_ef_round_equals_eager_round_bit_for_bit(kind, with_rows, size):
    g, ef, rows, at = _case(size, with_rows)
    owned = np.zeros(ef.size, bool)
    owned[at] = True
    g_t, ef_t = torch.from_numpy(g.copy()), torch.from_numpy(ef.copy())
    rows_t = None if rows is None else torch.from_numpy(rows)
    ef_eager = torch.from_numpy(ef.copy())
    q = ops.ef_round(g_t, ef_t, kind, rows_t, ROW_BLOCK)
    q_eager = eager_round(torch.from_numpy(g.copy()), ef_eager, kind, rows_t,
                          ROW_BLOCK)
    q_model, ef_model = kernel_model(g, ef, kind, rows, ROW_BLOCK)
    assert q.dtype == torch.float32 and q.shape == g_t.shape
    assert q.data_ptr() not in (g_t.data_ptr(), ef_t.data_ptr())
    np.testing.assert_array_equal(_bits(q), _bits(q_eager))
    np.testing.assert_array_equal(_bits(ef_t), _bits(ef_eager))
    np.testing.assert_array_equal(_bits(q), _bits(q_model))
    np.testing.assert_array_equal(_bits(ef_t), _bits(ef_model))
    np.testing.assert_array_equal(_bits(g_t), _bits(g))  # g only read
    np.testing.assert_array_equal(_bits(ef_t)[~owned], _bits(ef)[~owned])
    assert not np.array_equal(_bits(ef_t)[owned], _bits(ef)[owned])
    if kind == "int8":  # some negative lanes quantize to zero
        assert ((np.asarray(q) == 0) & (g + ef[at] < 0)).any()
    if size == "zero_block":
        assert not np.asarray(q)[BLOCK:2 * BLOCK].any()


def test_ef_round_refuses_what_it_cannot_take():
    g, ef, rows, _ = _case("short", True)
    g_t, ef_t, rows_t = map(torch.from_numpy, (g, ef, rows))
    launches = ops.ef_round.launches
    with pytest.raises(ValueError, match="unknown compression"):
        ops.ef_round(g_t, ef_t, "fp8", rows_t, ROW_BLOCK)
    with pytest.raises(ValueError, match="cannot hold"):
        ops.ef_round(g_t, ef_t, "int8", rows_t[:-1], ROW_BLOCK)
    with pytest.raises(ValueError, match="int64"):
        ops.ef_round(g_t, ef_t, "int8", rows_t.int(), ROW_BLOCK)
    with pytest.raises(ValueError, match="without rows"):
        ops.ef_round(g_t, ef_t, "int8", None, ROW_BLOCK)
    with pytest.raises(ValueError, match="float32"):
        ops.ef_round(g_t.double(), ef_t, "bf16", rows_t, ROW_BLOCK)
    assert ops.ef_round.launches == launches  # nothing launched


def test_ef_round_kernel_on_card():
    """The CUDA kernel against the eager round on the same CUDA tensors
    and against the CPU, bit for bit, on every CPU case and on a row
    width that is not a multiple of 4 (the kernel's single-lane path);
    one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    cases = [(kind, size, with_rows, ROW_BLOCK) for kind in ("int8", "bf16")
             for size in sorted(SIZES) for with_rows in (True, False)]
    cases += [("int8", "ragged", True, 6), ("bf16", "ragged", True, 6)]
    launches = ops.ef_round.launches
    for kind, size, with_rows, block in cases:
        g, ef, rows, _ = _case(size, with_rows)
        if with_rows and block != ROW_BLOCK:
            n = g.size // block * block
            g, ef = g[:n], ef[:ef.size // block * block]
            rows = np.random.default_rng(1).permutation(
                ef.size // block)[:n // block].astype(np.int64)
        rows_t = None if rows is None else torch.from_numpy(rows).to(dev)
        g_t = torch.from_numpy(g).to(dev)
        ef_t = torch.from_numpy(ef).to(dev)
        ef_eager = ef_t.clone()
        q = ops.ef_round(g_t, ef_t, kind, rows_t, block)
        q_eager = eager_round(g_t, ef_eager, kind, rows_t, block)
        ef_cpu = torch.from_numpy(ef.copy())
        q_cpu = eager_round(torch.from_numpy(g), ef_cpu, kind,
                            None if rows is None else torch.from_numpy(rows),
                            block)
        torch.cuda.synchronize()
        what = f"{kind} {size} rows={with_rows} block={block}"
        for a, b, name in ((q, q_eager, "q"), (ef_t, ef_eager, "ef"),
                           (q.cpu(), q_cpu, "q vs cpu"),
                           (ef_t.cpu(), ef_cpu, "ef vs cpu")):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (
                f"{what}: {name}")
        assert torch.equal(g_t.cpu(), torch.from_numpy(g)), what
    assert ops.ef_round.launches - launches == len(cases)
