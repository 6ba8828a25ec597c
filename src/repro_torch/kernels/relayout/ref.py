"""Plain PyTorch versions of the relayout kernels, and the run-list oracle.

``stage_plain`` and ``scatter_plain`` compute exactly what the CUDA
kernels ``relayout_stage`` and ``relayout_scatter`` in ``csrc/relayout.cu``
compute; the CPU tests run them and ``chip_smoke.py`` holds the kernels
against them on the card.  ``relayout_ref`` applies a delta's runs with
plain slice assignment, as ``repro.kernels.relayout.ref.relayout_ref``
does.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def stage_plain(xs: Sequence[torch.Tensor],
                src: torch.Tensor) -> List[torch.Tensor]:
    """Final content of the touched blocks, packed: ``x[src]`` where
    ``src >= 0``, else zero, for every leaf."""
    zero = torch.zeros((), dtype=torch.float32, device=src.device)
    keep = src >= 0
    rows = src.clamp(min=0).long()
    return [torch.where(keep, x[rows], zero) for x in xs]


def scatter_plain(bases: Sequence[torch.Tensor],
                  staged: Sequence[torch.Tensor], dst: torch.Tensor,
                  block: int) -> List[torch.Tensor]:
    """Tile i of every staged leaf into block ``dst[i]`` of its base, in
    place; returns the bases."""
    rows = dst.long()
    for b, s in zip(bases, staged):
        b.view(-1, block)[rows] = s.view(-1, block)
    return list(bases)


def relayout_ref(leaves: Sequence[torch.Tensor], delta) -> List[torch.Tensor]:
    """Resize each buffer (pad zeros / truncate), zero the vacated runs,
    copy the moved runs from the ORIGINAL buffer; lanes outside every run
    are untouched.  Returns new tensors."""
    outs = []
    for x in leaves:
        base = torch.zeros(delta.new_len, dtype=x.dtype, device=x.device)
        n = min(delta.old_len, delta.new_len)
        base[:n] = x[:n]
        for dst, length in delta.zeros:
            base[dst : dst + length] = 0
        for src, dst, length in delta.moves:
            base[dst : dst + length] = x[src : src + length]
        outs.append(base)
    return outs
