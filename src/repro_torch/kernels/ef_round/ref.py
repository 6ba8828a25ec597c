"""Plain PyTorch version of the error-feedback round kernel.

``ef_round_plain`` computes exactly what ``ef_round`` in
``csrc/ef_round.cu`` computes: the owned rows of ``ef`` gathered,
``compression.ef_transform`` on them, and the residual scattered back in
place.  The CPU tests run it and ``chip_smoke.py`` holds the kernel
against it on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...ps.compression import ef_transform


def ef_round_plain(g: torch.Tensor, ef: torch.Tensor, kind: str,
                   rows: Optional[torch.Tensor], block: int) -> torch.Tensor:
    """``q`` of ``g + ef[rows]`` (a new tensor); the residual goes into
    those rows of ``ef`` in place (the whole of ``ef`` when ``rows`` is
    None)."""
    if rows is None:
        q, resid = ef_transform(g, ef, kind)
        ef.copy_(resid)
        return q
    view = ef.view(-1, block)
    q, resid = ef_transform(g, view[rows].reshape(-1), kind)
    view[rows] = resid.view(-1, block)
    return q
