"""Plain PyTorch versions of the embedding bag (K6).

:func:`embedding_bag_plain` computes exactly what the CUDA kernel in
``csrc/embed_bag.cu`` computes for one table: each bag's rows gathered in
l order, widened to float32 and added to a float32 sum that starts at
zero, every add correctly rounded, so the two agree bit for bit;
:func:`embedding_bags_plain` is the same per table, written into (B, T,
D).  The CPU tests run them; ``chip_smoke.py`` holds the kernel against
them on the card.
:func:`embedding_bag_ref` is the reference's oracle
(``repro.kernels.embed_bag.ref``), with its ``weights`` and ``mode``.
"""

from __future__ import annotations

import torch


def embedding_bag_plain(table: torch.Tensor,
                        indices: torch.Tensor) -> torch.Tensor:
    """table (V, D), indices (B, L) int -> (B, D) float32 sums."""
    b, n_len = indices.shape
    out = torch.zeros((b, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for i in range(n_len):
        out = out + torch.index_select(table, 0, indices[:, i]).float()
    return out


def embedding_bags_plain(tables, ids: torch.Tensor,
                         out=None) -> torch.Tensor:
    """tables: T tensors (V_t, D); ids (B, T) or (B, T, L) int -> (B, T,
    D) float32: ``embedding_bag_plain`` of each table's ids, into ``out``
    if given."""
    if ids.dim() == 2:
        ids = ids[:, :, None]
    if out is None:
        out = torch.empty((ids.shape[0], len(tables), tables[0].shape[1]),
                          dtype=torch.float32, device=ids.device)
    for t, table in enumerate(tables):
        out[:, t] = embedding_bag_plain(table, ids[:, t])
    return out


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      weights=None, mode: str = "sum") -> torch.Tensor:
    """table (V, D), indices (B, L) -> (B, D) bags in the table's dtype:
    the rows, times ``weights`` (B, L) if given, summed, and for
    ``mode="mean"`` divided by L."""
    rows = table[indices.long()]
    if weights is not None:
        rows = rows * weights[..., None]
    out = torch.sum(rows, dim=1)
    if mode == "mean":
        out = out / indices.shape[1]
    return out
