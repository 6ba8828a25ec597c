"""Embedding bags (K6), dispatched by tensor device.

``embedding_bags(tables, ids)`` returns the (B, T, D) float32 sums
``out[b, t] = sum_l tables[t][ids[b, t, l]]`` over T tables of one width
and dtype: DLRM's whole lookup in one launch.  ``embedding_bag(table,
indices)`` is the single-table (B, D) call of the same kernel.  A CUDA
tensor goes through the hand-written kernel in ``csrc/embed_bag.cu``
(built on first use), which reads every table through its row stride (no
copy of a view) and the ids through all their strides (the (B, T) id
matrix, or a column slice of it, is read in place); a CPU tensor goes
through the plain version in :mod:`.ref`.  Each wrapper counts its
kernel launches in ``.launches``.  Forward only: neither package has a
backward kernel; ``models.recsys._BagSums`` wraps ``embedding_bags`` in
an autograd Function with a plain backward.  Ids outside [0, V) are the
caller's fault and are not checked (a check would synchronize with the
card).
"""

from __future__ import annotations

from array import array
from typing import List, Optional, Sequence, Tuple

import torch

from .. import _build
from . import ref

_FLOATS = (torch.float32, torch.bfloat16)
MAX_TABLES = 64  # descriptors a launch takes (csrc/embed_bag.cu kMaxTables)
_BF16 = 1  # descriptor flags: bfloat16, and the piece: 8 or 16 bytes
_PIECE_FLAG = {8: 2, 16: 4}


def launch_groups(n_tables: int) -> List[Tuple[int, int]]:
    """The [start, stop) table ranges of the launches for ``n_tables``
    tables, in order, at most MAX_TABLES each."""
    return [(i, min(i + MAX_TABLES, n_tables))
            for i in range(0, n_tables, MAX_TABLES)]


def _align(bits: int) -> int:
    """The larger of 16 and 8 that divides ``bits`` (addresses and byte
    strides or-ed together), else 0."""
    return 16 if bits % 16 == 0 else 8 if bits % 8 == 0 else 0


def piece_bytes(tables: Sequence[torch.Tensor], out_ptr: int,
                out_stride: int) -> int:
    """The kernel's load width, 16 or 8 bytes (0: one element a lane):
    the largest that every table's base, row stride and row width allow
    and whose float32 sums (16 bytes at most a store) the output, at
    ``out_ptr`` with a bag stride of ``out_stride`` floats, allows."""
    size = tables[0].element_size()
    d = tables[0].shape[1]
    bits = d * size
    for t in tables:
        bits |= t.data_ptr() | t.stride(0) * size
    piece = _align(bits)
    out = _align(out_ptr | out_stride * 4 | d * 4)
    while piece and min(16, piece * 4 // size) > out:
        piece //= 2
    return piece if piece >= 8 else 0


def descriptors(tables: Sequence[torch.Tensor], piece: int) -> array:
    """The tables' descriptors, csrc/embed_bag.cu's ``Table`` {base, row
    stride, int32 flags and 4 bytes of padding} as three int64 each (on a
    little-endian host); every table shares the flags (dtype, ``piece``
    bytes a load)."""
    flags = ((_BF16 if tables[0].dtype == torch.bfloat16 else 0)
             | _PIECE_FLAG.get(piece, 0))
    return array("q", [v for t in tables
                       for v in (t.data_ptr(), t.stride(0), flags)])


def _launch(tables, ids_ptr, sb, st, sl, n_bags, n_len, out, sob, sot, piece,
            device) -> None:
    """One launch over at most MAX_TABLES tables; ``out`` points at the
    first table's column."""
    fn = _build.entry("embed_bag", "embed_bags",
                      [_build.P, _build.I32, _build.P, _build.I64, _build.I64,
                       _build.I64, _build.I64, _build.I32, _build.I32,
                       _build.P, _build.I64, _build.I64, _build.P])
    desc = descriptors(tables, piece)
    _build.check(fn(desc.buffer_info()[0], len(tables), ids_ptr, sb, st, sl,
                    n_bags, n_len, tables[0].shape[1], out, sob, sot,
                    torch.cuda.current_stream(device).cuda_stream),
                 "embed_bags")


def _check_grad(tables) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        raise RuntimeError("embedding_bag is forward only (no backward "
                           "kernel exists): use models.recsys for "
                           "gradients, or call it without grad")


def _check(table: torch.Tensor, indices: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype not in _FLOATS:
        raise TypeError(f"table must be (V, D) float32 or bfloat16, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if indices.dim() != 2 or indices.dtype != torch.int32:
        raise TypeError(f"indices must be (B, L) int32, got {indices.dtype} "
                        f"{tuple(indices.shape)}")
    if indices.device != table.device:
        raise ValueError(f"indices on {indices.device}, table on "
                         f"{table.device}")
    _check_grad((table,))


def _cuda(device: torch.device, tables) -> None:
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if any(t.stride(1) != 1 for t in tables):
        raise ValueError("the tables need a contiguous last dim")


def embedding_bag(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """K6 on one table: table (V, D) float32 or bfloat16, indices (B, L)
    int32 -> (B, D) float32 sums, accumulated in l order from zero."""
    _check(table, indices)
    if table.device.type == "cpu":
        return ref.embedding_bag_plain(table, indices)
    _cuda(table.device, (table,))
    b, n_len = indices.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    embedding_bag.launches += 1
    _launch((table,), indices.data_ptr(), indices.stride(0), 0,
            indices.stride(1), b, n_len, out.data_ptr(), d, d,
            piece_bytes((table,), out.data_ptr(), d), table.device)
    return out


embedding_bag.launches = 0


def _check_bags(tables, ids, out) -> None:
    if not tables:
        raise ValueError("embedding_bags needs at least one table")
    first = tables[0]
    dtype, device = first.dtype, first.device
    if dtype not in _FLOATS:
        raise TypeError(f"tables must be float32 or bfloat16, got {dtype}")
    d = first.shape[-1]
    for i, t in enumerate(tables):
        if t.dim() != 2 or t.shape[1] != d:
            raise ValueError(f"table {i} is {tuple(t.shape)}: every table "
                             f"must be (V, {d})")
        if t.dtype != dtype:
            raise TypeError(f"table {i} is {t.dtype}, table 0 {dtype}: the "
                            f"tables must share one dtype")
        if t.device != device:
            raise ValueError(f"table {i} on {t.device}, table 0 on {device}")
    if ids.dtype != torch.int32 or ids.dim() not in (2, 3):
        raise TypeError(f"ids must be (B, T) or (B, T, L) int32, got "
                        f"{ids.dtype} {tuple(ids.shape)}")
    if ids.shape[1] != len(tables):
        raise ValueError(f"ids have {ids.shape[1]} fields for "
                         f"{len(tables)} tables")
    if ids.device != device:
        raise ValueError(f"ids on {ids.device}, tables on {device}")
    if out is not None and (
            out.dtype != torch.float32 or out.device != device
            or tuple(out.shape) != (ids.shape[0], len(tables), d)
            or out.stride(2) != 1 or (d > 1 and out.stride(1) != d)):
        raise ValueError(f"out must be ({ids.shape[0]}, {len(tables)}, {d}) "
                         f"float32 on {device}, rows of D contiguous")
    _check_grad(tables)


def embedding_bags(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6 over T tables: ``tables`` T tensors (V_t, D) of one dtype
    (float32 or bfloat16), ``ids`` (B, T) or (B, T, L) int32 with any
    strides -> (B, T, D) float32 sums (into ``out`` if given), each
    accumulated in l order from zero.  One launch per MAX_TABLES tables."""
    tables = list(tables)
    _check_bags(tables, ids, out)
    if ids.device.type == "cpu":
        return ref.embedding_bags_plain(tables, ids, out)
    _cuda(ids.device, tables)
    if ids.dim() == 2:
        ids = ids[:, :, None]
    b, n, n_len = ids.shape
    d = tables[0].shape[1]
    if out is None:
        out = torch.empty((b, n, d), dtype=torch.float32, device=ids.device)
    if b == 0 or d == 0:
        return out
    sob, sot = out.stride(0), d
    piece = piece_bytes(tables, out.data_ptr(), sob)
    sb, st, sl = ids.stride()
    for t0, t1 in launch_groups(n):
        embedding_bags.launches += 1
        _launch(tables[t0:t1], ids.data_ptr() + 4 * t0 * st, sb, st, sl, b,
                n_len, out.data_ptr() + 4 * t0 * sot, sob, sot, piece,
                ids.device)
    return out


embedding_bags.launches = 0
