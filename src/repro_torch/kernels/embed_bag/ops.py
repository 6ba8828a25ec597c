"""Embedding bag (K6), dispatched by tensor device.

``embedding_bag(table, indices)`` returns the (B, D) float32 sums
``out[b] = sum_l table[indices[b, l]]``.  A CUDA tensor goes through the
hand-written kernel in ``csrc/embed_bag.cu`` (built on first use), which
reads the table through its row stride (no copy of a view) and the
indices through both strides (a column slice of a wider id matrix is
read in place); a CPU tensor goes through the plain version in
:mod:`.ref`.  The wrapper counts its kernel launches in
``embedding_bag.launches``.  Forward only: neither package has a
backward kernel; ``models.recsys.embedding_bag`` wraps it in an autograd
Function with a plain backward.  Ids outside [0, V) are the caller's
fault and are not checked (a check would synchronize with the card).
"""

from __future__ import annotations

import torch

from .. import _build
from . import ref

_FLOATS = (torch.float32, torch.bfloat16)


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
    if torch.is_grad_enabled() and table.requires_grad:
        raise RuntimeError("embedding_bag is forward only (no backward "
                           "kernel exists): use models.recsys.embedding_bag "
                           "for gradients, or call it without grad")


def _vec_ok(table: torch.Tensor) -> int:
    """16-byte pieces: an aligned base, row stride and row width."""
    row = table.shape[1] * table.element_size()
    ld = table.stride(0) * table.element_size()
    return int(table.data_ptr() % 16 == 0 and ld % 16 == 0 and row % 16 == 0)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """K6: table (V, D) float32 or bfloat16, indices (B, L) int32 ->
    (B, D) float32 sums, accumulated in l order from zero."""
    _check(table, indices)
    if table.device.type == "cpu":
        return ref.embedding_bag_plain(table, indices)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    if table.stride(1) != 1:
        raise ValueError("the table needs a contiguous last dim")
    b, n_len = indices.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    fn = _build.entry("embed_bag", "embed_bag",
                      [_build.P, _build.I32, _build.I64, _build.P, _build.I64,
                       _build.I64, _build.I64, _build.I32, _build.I32,
                       _build.I32, _build.P, _build.P])
    embedding_bag.launches += 1
    _build.check(fn(table.data_ptr(), int(table.dtype == torch.bfloat16),
                    table.stride(0), indices.data_ptr(), indices.stride(0),
                    indices.stride(1), b, n_len, d, _vec_ok(table),
                    out.data_ptr(),
                    torch.cuda.current_stream(table.device).cuda_stream),
                 "embed_bag")
    return out


embedding_bag.launches = 0
