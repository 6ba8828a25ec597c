"""The port's table-batched embedding bag (kernel K6 over T tables; its
plain version on the CPU) held against the reference's Pallas embedding
bag in interpret mode, table by table, and against the reference's DLRM
lookup, on the same numpy inputs; and DLRM's lookup Function
(``models.recsys._BagSums``) against the per-field route it replaced.

Tolerances: rtol 1e-6 and atol 1e-6 against the Pallas kernel, the
reference kernel test's own (``tests/test_kernels.py``): the plain
version adds each bag's rows in l order from zero in float32, as the
Pallas grid does.  Everything else is compared bit for bit: the batched
plain version is the single-table one written into (B, T, D); a float32
sum of one row is the row, as the reference's take is; and the
gradients take the same per-table calls as before.
"""

import ctypes

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.embed_bag import ops as jops
from repro.models import recsys as jrec
from repro_torch.kernels.embed_bag import ops as tops
from repro_torch.kernels.embed_bag import ref as tref
from repro_torch.models import recsys as trec
from repro_torch.tree import array_to_tensor

VOCABS = (40, 7, 300, 1000, 64)


class Table(ctypes.Structure):
    """csrc/embed_bag.cu's descriptor of one table."""

    _fields_ = [("base", ctypes.c_void_p), ("ld", ctypes.c_longlong),
                ("flags", ctypes.c_int), ("pad", ctypes.c_int)]


def _inputs(seed, n_tables, bags, bag_len, dim, dtype=np.float32):
    """T tables of mixed vocabularies and (B, T, L) int32 ids."""
    rng = np.random.default_rng(seed)
    vocabs = VOCABS[:n_tables]
    tables = [rng.standard_normal((v, dim)).astype(dtype) for v in vocabs]
    ids = np.stack([rng.integers(0, v, (bags, bag_len), dtype=np.int32)
                    for v in vocabs], axis=1)
    return tables, ids


def _tensors(tables, ids):
    return [array_to_tensor(t) for t in tables], torch.from_numpy(ids)


# (T, L, D, table dtype)
CASES = [(3, 1, 8, np.float32), (3, 7, 64, np.float32),
         (5, 1, 64, np.float32), (5, 7, 8, np.float32),
         (3, 7, 64, ml_dtypes.bfloat16), (5, 1, 8, ml_dtypes.bfloat16)]


@pytest.mark.parametrize("n_tables,bag_len,dim,dtype", CASES)
def test_batched_matches_reference_kernel_table_by_table(n_tables, bag_len,
                                                         dim, dtype):
    tables, ids = _inputs(n_tables * 10 + bag_len, n_tables, 24, bag_len, dim,
                          dtype)
    got = tops.embedding_bags(*_tensors(tables, ids))
    assert got.dtype == torch.float32 and got.shape == (24, n_tables, dim)
    for t, table in enumerate(tables):
        want = np.asarray(jops.embedding_bag(
            jnp.asarray(table), jnp.asarray(ids[:, t]), interpret=True))
        np.testing.assert_allclose(got[:, t].numpy(), want, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("n_tables,bag_len,dim,dtype", CASES)
def test_batched_equals_single_table_plain_bit_for_bit(n_tables, bag_len,
                                                       dim, dtype):
    tables, ids = _tensors(*_inputs(n_tables + bag_len + dim, n_tables, 17,
                                    bag_len, dim, dtype))
    got = tops.embedding_bags(tables, ids)
    for t, table in enumerate(tables):
        want = tref.embedding_bag_plain(table, ids[:, t])
        assert torch.equal(got[:, t], want)
    assert tops.embedding_bags.launches == 0  # CPU: the plain version


@pytest.mark.parametrize("n_tables", [3, 5])
def test_one_row_lookup_equals_reference_lookup_bit_for_bit(n_tables):
    tables, ids = _inputs(n_tables, n_tables, 50, 1, 16)
    ids = ids[:, :, 0]
    want = np.asarray(jrec.sharded_embedding_lookup(
        [jnp.asarray(t) for t in tables], jnp.asarray(ids)))
    got = tops.embedding_bags(*_tensors(tables, ids))
    assert got.numpy().tobytes() == want.tobytes()


def test_strided_id_views_equal_contiguous_ids():
    """A (B, T) view with strides (2 T', 2) of a wider id matrix, and a
    (B, T, L) view with a stride on every axis, give what the same ids
    made contiguous give."""
    tables, ids = _tensors(*_inputs(9, 3, 20, 4, 8))
    wide = torch.zeros((20, 6, 9), dtype=torch.int32)
    wide[:, ::2, ::2][:, :, :4] = ids
    view = wide[:, ::2, ::2][:, :, :4]
    assert not view.is_contiguous()
    assert torch.equal(tops.embedding_bags(tables, view),
                       tops.embedding_bags(tables, view.contiguous()))
    col = view[:, :, 1]
    assert torch.equal(tops.embedding_bags(tables, col),
                       tops.embedding_bags(tables, col.contiguous()))


def test_out_is_written_in_place():
    tables, ids = _tensors(*_inputs(4, 3, 10, 2, 8))
    buf = torch.full((10, 5, 8), 7.0)
    out = buf[:, 1:4]
    got = tops.embedding_bags(tables, ids, out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, tops.embedding_bags(tables, ids))
    assert bool((buf[:, 0] == 7.0).all() and (buf[:, 4] == 7.0).all())


def test_launch_groups_split_130_tables_into_three_in_order():
    assert tops.launch_groups(130) == [(0, 64), (64, 128), (128, 130)]
    assert tops.launch_groups(26) == [(0, 26)]
    assert tops.launch_groups(64) == [(0, 64)]
    tables = [torch.zeros((3 + i, 8)) for i in range(130)]
    groups = [(Table * (b - a)).from_buffer(
        tops.descriptors(tables[a:b], 16)) for a, b in tops.launch_groups(130)]
    assert [len(g) for g in groups] == [64, 64, 2]
    flat = [d for g in groups for d in g]
    assert [d.base for d in flat] == [t.data_ptr() for t in tables]
    assert all(d.ld == 8 and d.flags == 4 for d in flat)
    bf = Table.from_buffer(tops.descriptors(
        [torch.zeros((4, 16), dtype=torch.bfloat16)[:, 1:9]], 0))
    assert (bf.ld, bf.flags) == (16, 1)
    assert tops.descriptors([torch.zeros((4, 2))], 8)[2] == 2
    assert ctypes.sizeof(Table) == 24  # the kernel's static_assert


def _aligned(shape, dtype=torch.float32, offset=0):
    """A (V, D) view ``offset`` elements past a 64-byte-aligned base."""
    size = torch.tensor([], dtype=dtype).element_size()
    buf = torch.zeros(shape[0] * shape[1] + offset + 64 // size, dtype=dtype)
    skip = (-buf.data_ptr() % 64) // size + offset
    return buf[skip:skip + shape[0] * shape[1]].view(shape)


@pytest.mark.parametrize("dim,dtype,offset,out_stride,want", [
    (64, torch.float32, 0, 64, 16),  # DLRM's rows: float4
    (18, torch.float32, 0, 18, 8),  # 72-byte rows: float2
    (50, torch.float32, 0, 50, 8),
    (64, torch.float32, 1, 64, 0),  # an unaligned view: one element
    (64, torch.float32, 0, 66, 8),  # sums 8-byte aligned only
    (64, torch.bfloat16, 0, 64, 16),  # eight bfloat16
    (12, torch.bfloat16, 0, 12, 8),  # four bfloat16, a float4 of sums
    (12, torch.bfloat16, 0, 14, 0),  # whose store the output refuses
    (9, torch.float32, 0, 9, 0),
])
def test_piece_width_follows_alignment(dim, dtype, offset, out_stride, want):
    table = _aligned((10, dim), dtype, offset)
    out = _aligned((4, out_stride))
    assert tops.piece_bytes([table, table], out.data_ptr(), out_stride) == want


def test_wrapper_validates_inputs():
    tables, ids = _tensors(*_inputs(11, 3, 6, 2, 8))
    with pytest.raises(ValueError, match="every table"):
        tops.embedding_bags(tables[:2] + [torch.zeros((5, 4))], ids)
    with pytest.raises(TypeError, match="one dtype"):
        tops.embedding_bags(tables[:2] + [tables[2].bfloat16()], ids)
    with pytest.raises(TypeError, match="int32"):
        tops.embedding_bags(tables, ids.long())
    with pytest.raises(ValueError, match="fields"):
        tops.embedding_bags(tables[:2], ids)
    with pytest.raises(ValueError, match="on meta"):
        tops.embedding_bags(tables[:2] + [tables[2].to("meta")], ids)
    with pytest.raises(ValueError, match="ids on meta"):
        tops.embedding_bags(tables, ids.to("meta"))
    with pytest.raises(ValueError, match="out must be"):
        tops.embedding_bags(tables, ids, torch.zeros((6, 3, 9)))
    with pytest.raises(RuntimeError, match="forward only"):
        tops.embedding_bags([t.clone().requires_grad_(True)
                             for t in tables], ids)
    # Not the CPU and not CUDA: no kernel, and no plain fallback.
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tops.embedding_bags([t.to("meta") for t in tables], ids.to("meta"))
    assert tops.embedding_bags(tables, ids[:, :, :0]).abs().sum() == 0


class _PerFieldBag(torch.autograd.Function):
    """DLRM's former per-field lookup: a plain bag of one row per field
    forward, the fixed-order dense gradient of its rows backward."""

    @staticmethod
    def forward(ctx, table, indices):
        ctx.save_for_backward(indices)
        ctx.n_rows, ctx.dtype = table.shape[0], table.dtype
        return tref.embedding_bag_plain(table, indices)

    @staticmethod
    def backward(ctx, grad):
        indices, = ctx.saved_tensors
        b, n_len = indices.shape
        rows = grad.to(ctx.dtype)[:, None, :].expand(b, n_len, grad.shape[-1])
        return trec._dense_grad(rows, indices, ctx.n_rows), None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lookup", ["kernel", "plain"])
def test_bag_sums_gradient_equals_per_field_route_bit_for_bit(dtype, lookup):
    """``_BagSums`` over all fields (``sharded_embedding_lookup``) against
    the per-field route DLRM's lookup took before it, against the
    model's single-table ``embedding_bag`` per field, and against
    ``F.embedding``'s backward, with ids that repeat within and across
    bags: the forward values and every table's gradient bit for bit."""
    rng = np.random.default_rng(5)
    vocabs = (20, 5, 64)
    tables = [torch.from_numpy(rng.standard_normal((v, 12)).astype(
        np.float32)).to(dtype) for v in vocabs]
    ids = torch.from_numpy(np.stack(
        [rng.integers(0, min(v, 6), 40, dtype=np.int32) for v in vocabs],
        axis=1))
    cot = torch.from_numpy(rng.standard_normal((40, 3, 12)).astype(
        np.float32)).to(dtype)
    routes = {
        "batched": lambda ts: trec.sharded_embedding_lookup(ts, ids,
                                                            lookup=lookup),
        "former per field": lambda ts: torch.stack(
            [_PerFieldBag.apply(t, ids[:, i:i + 1]).to(dtype)
             for i, t in enumerate(ts)], dim=1),
        "embedding_bag per field": lambda ts: torch.stack(
            [trec.embedding_bag(t, ids[:, i:i + 1], lookup=lookup)
             for i, t in enumerate(ts)], dim=1),
        "F.embedding": lambda ts: torch.stack(
            [F.embedding(ids[:, i], t) for i, t in enumerate(ts)], dim=1),
    }
    outs, grads = {}, {}
    for name, fn in routes.items():
        ts = [t.clone().requires_grad_(True) for t in tables]
        outs[name] = fn(ts)
        outs[name].backward(cot)
        grads[name] = [t.grad for t in ts]
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for name in routes:
        assert outs[name].dtype == dtype
        assert torch.equal(outs[name].view(view), outs["batched"].view(view))
        for a, b in zip(grads[name], grads["batched"]):
            assert a.dtype == dtype
            assert torch.equal(a.view(view), b.view(view))
    assert torch.count_nonzero(grads["batched"][2][6:]) == 0
