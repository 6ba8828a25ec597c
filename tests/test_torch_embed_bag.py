"""The port's embedding bag (kernel K6; its plain version on the CPU) held
against the reference's Pallas kernel in interpret mode and its jnp
oracle, on the same numpy inputs.

Tolerances: rtol 1e-6 and atol 1e-6, the reference kernel test's own
(``tests/test_kernels.py``).  The plain version adds each bag's rows in l
order from zero in float32, as the Pallas grid does; the jnp oracle sums
in XLA's order.  A bfloat16 table widens exactly to float32, so it is
held at the same tolerance.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.embed_bag import ops as jops
from repro.kernels.embed_bag import ref as jref
from repro_torch.kernels.embed_bag import ops as tops
from repro_torch.kernels.embed_bag import ref as tref
from repro_torch.tree import array_to_tensor


def _inputs(seed, vocab, dim, bags, bag_len, dtype=np.float32):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((vocab, dim)).astype(dtype)
    idx = rng.integers(0, vocab, (bags, bag_len), dtype=np.int32)
    return table, idx


# The reference kernel test's shapes, then D = 18 and 50 (DIEN's and
# SASRec's widths, the kernel's scalar path) and DLRM's one-row bags.
SHAPES = [(512, 32, 16, 5), (1024, 128, 8, 1), (128, 64, 32, 20),
          (300, 18, 24, 7), (200, 50, 12, 3), (1000, 64, 40, 1)]


@pytest.mark.parametrize("vocab,dim,bags,bag_len", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(vocab, dim, bags, bag_len):
    table, idx = _inputs(vocab + bag_len, vocab, dim, bags, bag_len)
    want_k = np.asarray(jops.embedding_bag(jnp.asarray(table),
                                           jnp.asarray(idx), interpret=True))
    want_r = np.asarray(jref.embedding_bag_ref(jnp.asarray(table),
                                               jnp.asarray(idx)))
    got = tops.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (bags, dim)
    for want in (want_k, want_r):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_bf16_table_matches_reference_kernel():
    table, idx = _inputs(3, 256, 64, 16, 6, ml_dtypes.bfloat16)
    want = np.asarray(jops.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                         interpret=True))
    got = tops.embedding_bag(array_to_tensor(table), torch.from_numpy(idx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_plain_sums_in_l_order_from_zero():
    """Bit for bit the sequential float32 sum ((0 + r0) + r1) + ..., over a
    column slice of a wider id matrix and an unaligned table view."""
    table, idx = _inputs(5, 64, 18, 9, 4)
    buf = torch.from_numpy(np.concatenate([table, table[:, :1]], axis=1))
    view = buf[:, 1:][:, :18]  # row stride 19, offset by one element
    view.copy_(torch.from_numpy(table))
    ids = torch.from_numpy(np.concatenate([idx[:, ::-1], idx], axis=1))[:, 4:]
    got = tops.embedding_bag(view, ids)
    want = np.zeros((9, 18), np.float32)
    for l in range(4):
        want = want + table[idx[:, l]]
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", False),
                                           ("sum", True), ("mean", True)])
def test_ref_matches_reference_oracle(mode, weighted):
    table, idx = _inputs(7, 100, 16, 10, 5)
    w = np.random.default_rng(8).random((10, 5)).astype(np.float32)
    want = jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx),
                                  jnp.asarray(w) if weighted else None, mode)
    got = tref.embedding_bag_ref(torch.from_numpy(table),
                                 torch.from_numpy(idx),
                                 torch.from_numpy(w) if weighted else None,
                                 mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_wrapper_validates_inputs():
    table, idx = _inputs(9, 32, 8, 4, 3)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    with pytest.raises(TypeError, match="int32"):
        tops.embedding_bag(t, i.long())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tops.embedding_bag(t.double(), i)
    with pytest.raises(TypeError, match="int32"):
        tops.embedding_bag(t, i[:, 0])
    with pytest.raises(RuntimeError, match="forward only"):
        tops.embedding_bag(t.clone().requires_grad_(True), i)
    with torch.no_grad():
        tops.embedding_bag(t.clone().requires_grad_(True), i)
    assert tops.embedding_bag(t, i[:, :0]).abs().sum() == 0  # L = 0: zeros
    assert tops.embedding_bag.launches == 0  # CPU: the plain version
