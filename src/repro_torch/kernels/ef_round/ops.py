"""One error-feedback round of a compressed push, dispatched by device.

``ef_round(g, ef, kind, rows, block)`` takes a job's packed gradient
piece ``g``, adds the residual held in its owned rows of ``ef``,
compresses and decompresses the sum (``kind`` "int8": one max-abs scale
per ``compression.BLOCK`` lanes of the piece; "bf16": a bfloat16 round
trip), writes the new residual back into those rows in place and returns
the decompressed gradient as a new float32 tensor.  ``g`` is only read,
and lanes of ``ef`` outside the owned rows are never touched.

CUDA tensors go through the hand-written kernel in ``csrc/ef_round.cu``
(one launch, one pass over the bytes) or the call raises; CPU tensors go
through the plain version in :mod:`.ref`.  The wrapper counts its
launches in ``ef_round.launches``.  Both equal
``compression.ef_transform`` between a row gather and a row scatter bit
for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...ps.compression import BLOCK
from .. import _build
from . import ref

KINDS = {"int8": 0, "bf16": 1}
# The kernel runs one CTA a scale block of kScaleBlock = 2048 lanes
# (csrc/ef_round.cu); the eager round's scale block must be the same.
assert BLOCK == 2048, f"csrc/ef_round.cu is built for 2048, not {BLOCK}"


def _check(g, ef, kind, rows, block):
    if kind not in KINDS:
        raise ValueError(f"unknown compression {kind!r}")
    for name, t in (("g", g), ("ef", ef)):
        if (t.dtype != torch.float32 or t.dim() != 1
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 (n,) "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if g.device != ef.device:
        raise ValueError(f"g is on {g.device}, ef on {ef.device}")
    n = g.shape[0]
    if rows is None:
        if ef.shape[0] != n:
            raise ValueError(f"without rows ef must hold the piece's {n} "
                             f"lanes, got {ef.shape[0]}")
        return
    if (rows.dtype != torch.int64 or rows.dim() != 1
            or rows.device != ef.device or not rows.is_contiguous()):
        raise ValueError("rows must be contiguous int64 (r,) on ef's device")
    if block <= 0 or ef.shape[0] % block or rows.shape[0] * block != n:
        raise ValueError(f"{rows.shape[0]} rows of {block} lanes of an ef "
                         f"of {ef.shape[0]} cannot hold a piece of {n}")


def ef_round(g: torch.Tensor, ef: torch.Tensor, kind: str,
             rows: Optional[torch.Tensor], block: int) -> torch.Tensor:
    """ONE error-feedback round of the packed piece ``g`` against rows
    ``rows`` (int64 block indices, ``block`` lanes each; None: all of
    ``ef``, lane for lane) of ``ef``: returns ``q`` and leaves the
    residual ``g + ef[rows] - q`` in those rows.  The rows must be the
    distinct owned blocks of a layout (they are not checked on the
    device)."""
    _check(g, ef, kind, rows, block)
    if ef.device.type == "cpu":
        return ref.ef_round_plain(g, ef, kind, rows, block)
    if ef.device.type != "cuda":
        raise ValueError(f"no kernel for device {ef.device}")
    n = g.shape[0]
    q = torch.empty(n, dtype=torch.float32, device=g.device)
    fn = _build.entry("ef_round", "ef_round",
                      [_build.P, _build.P, _build.P, _build.I32, _build.P,
                       _build.I64, _build.I32, _build.I32, _build.P])
    vec = int(n % 4 == 0 and (rows is None or block % 4 == 0)
              and all(t.data_ptr() % 16 == 0 for t in (g, ef, q)))
    ef_round.launches += 1
    _build.check(fn(g.data_ptr(), ef.data_ptr(),
                    None if rows is None else rows.data_ptr(), block,
                    q.data_ptr(), n, KINDS[kind], vec,
                    torch.cuda.current_stream(ef.device).cuda_stream),
                 "ef_round")
    return q


ef_round.launches = 0
