"""Run-copy relayout of a compiled MigrationDelta, dispatched by device.

``relayout(leaves, delta)`` executes a
:class:`repro_torch.ps.elastic.MigrationDelta` over every 1-D float32
state leaf (flat, mu, nu) at O(moved bytes):

  1. resize each leaf to the new length (in place when it keeps its
     length; a new buffer carrying the stationary lanes otherwise);
  2. stage every leaf's touched blocks into a SEPARATE packed buffer
     through the delta's per-lane source map (``relayout_stage``);
  3. write all leaves' staged tiles into their destination blocks in ONE
     launch (``relayout_scatter``).

CUDA tensors go through the hand-written kernels in ``csrc/relayout.cu``
or the call raises; CPU tensors go through the plain versions in
:mod:`.ref`.  Each kernel wrapper counts its launches in
``<wrapper>.launches``.  The result is bit-exact with the full-gather
oracle ``repro_torch.ps.elastic.migrate_flat_state`` on valid states
(non-payload lanes zero).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ...device import host_to_device
from .. import _build
from . import ref


def _resize(x: torch.Tensor, old_len: int, new_len: int) -> torch.Tensor:
    """Old buffer at the new length: itself when the length holds (the
    scatter then writes in place), zero-padded or truncated copies else."""
    if new_len == old_len:
        return x
    if new_len < old_len:
        return x[:new_len].clone()
    out = torch.zeros(new_len, dtype=x.dtype, device=x.device)
    out[:old_len] = x
    return out


def _check_leaves(leaves: Sequence[torch.Tensor], length: int, what: str):
    device = leaves[0].device
    for x in leaves:
        if (x.dtype != torch.float32 or x.dim() != 1 or x.shape[0] != length
                or x.device != device or not x.is_contiguous()):
            raise ValueError(
                f"{what} must be contiguous float32 ({length},) tensors on "
                f"one device, got {x.dtype} {tuple(x.shape)} on {x.device}")
    return device


def _ptr_table(ts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Device table of the leaves' data pointers (one launch, all leaves)."""
    return host_to_device(torch.tensor([t.data_ptr() for t in ts],
                                       dtype=torch.int64), device)


def relayout_stage(xs: Sequence[torch.Tensor],
                   src: torch.Tensor) -> List[torch.Tensor]:
    """Staging half of K2: ``x[src]`` where ``src >= 0`` else 0, packed,
    for every leaf, in one launch.  ``src`` is int32 (n,), -1 on lanes
    that carry no payload (:func:`stage_tables`)."""
    xs = list(xs)
    device = _check_leaves(xs, xs[0].shape[0], "leaves")
    n = int(src.shape[0])
    if src.dtype != torch.int32 or src.shape != (n,) or src.device != device:
        raise ValueError("src must be int32 (n,) on the leaves' device")
    if device.type == "cpu":
        return ref.stage_plain(xs, src)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    outs = [torch.empty(n, dtype=torch.float32, device=device) for _ in xs]
    fn = _build.entry("relayout", "relayout_stage",
                      [_build.P, _build.P, _build.I32, _build.P, _build.I64,
                       _build.P])
    xs_t, outs_t = _ptr_table(xs, device), _ptr_table(outs, device)
    relayout_stage.launches += 1
    _build.check(fn(xs_t.data_ptr(), outs_t.data_ptr(), len(xs),
                    src.data_ptr(), n,
                    torch.cuda.current_stream(device).cuda_stream),
                 "relayout_stage")
    return outs


relayout_stage.launches = 0


def relayout_scatter(bases: Sequence[torch.Tensor],
                     staged: Sequence[torch.Tensor], dst_blocks: torch.Tensor,
                     *, block: int) -> List[torch.Tensor]:
    """K2: tile i of every staged leaf into block ``dst_blocks[i]`` of its
    base, IN PLACE, all leaves in one launch.  Returns the bases."""
    bases, staged = list(bases), list(staged)
    if not bases or len(bases) != len(staged):
        raise ValueError("need one staged buffer per base")
    n_t = int(dst_blocks.shape[0])
    n = bases[0].shape[0]
    if n % block:
        raise ValueError(f"N={n} not a multiple of block={block}")
    device = _check_leaves(bases, n, "bases")
    if _check_leaves(staged, n_t * block, "staged buffers") != device:
        raise ValueError("staged buffers must be on the bases' device")
    if (dst_blocks.dtype != torch.int32 or dst_blocks.shape != (n_t,)
            or dst_blocks.device != device):
        raise ValueError("dst_blocks must be int32 (n_t,) on the bases' "
                         "device")
    if device.type == "cpu":
        return ref.scatter_plain(bases, staged, dst_blocks, block)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    fn = _build.entry("relayout", "relayout_scatter",
                      [_build.P, _build.P, _build.I32, _build.P, _build.I64,
                       _build.I32, _build.I32, _build.P])
    vec = int(block % 4 == 0 and all(t.data_ptr() % 16 == 0
                                     for t in bases + staged))
    b_t, s_t = _ptr_table(bases, device), _ptr_table(staged, device)
    relayout_scatter.launches += 1
    _build.check(fn(b_t.data_ptr(), s_t.data_ptr(), len(bases),
                    dst_blocks.data_ptr(), n_t, block, vec,
                    torch.cuda.current_stream(device).cuda_stream),
                 "relayout_scatter")
    return bases


relayout_scatter.launches = 0


def stage_tables(delta, device: torch.device):
    """The delta's staging map (``stage_map``: int32, -1 on lanes without
    payload) and destination blocks on ``device``."""
    return (host_to_device(delta.stage_map, device, torch.int32),
            host_to_device(delta.touched_blocks, device, torch.int32))


def relayout(leaves: Sequence[torch.Tensor], delta) -> List[torch.Tensor]:
    """Execute one compiled MigrationDelta over every given 1-D leaf.

    Returns the migrated leaves (length ``delta.new_len`` each), in order.
    A leaf that keeps its length is updated in place."""
    leaves = list(leaves)
    if delta.identity or not leaves:
        return leaves
    device = _check_leaves(leaves, delta.old_len, "leaves")
    bases = [_resize(x, delta.old_len, delta.new_len) for x in leaves]
    if not delta.touched_blocks.size:
        return bases  # pure resize: no content moves
    src, dst = stage_tables(delta, device)
    staged = relayout_stage(leaves, src)  # before any base is written
    return relayout_scatter(bases, staged, dst, block=delta.block)
