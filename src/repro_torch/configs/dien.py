"""dien: embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80 interaction=augru.
[arXiv:1809.03672; unverified]

Item/category vocab sized at 1M/10k (Taobao-scale, documented choice)."""

from __future__ import annotations

import dataclasses

from ..arch import ArchSpec
from ..models.recsys import DIENConfig


def config() -> DIENConfig:
    return DIENConfig(name="dien", n_items=1_000_000, n_cats=10_000,
                      embed_dim=18, seq_len=100, gru_dim=108,
                      mlp_dims=(200, 80))


def smoke_config() -> DIENConfig:
    return dataclasses.replace(config(), n_items=500, n_cats=50, embed_dim=6,
                               seq_len=12, gru_dim=20, mlp_dims=(24, 8))


def spec() -> ArchSpec:
    from .dlrm_rm2 import recsys_cells

    return ArchSpec(
        arch_id="dien",
        family="recsys",
        recsys_kind="dien",
        model=config(),
        cells=recsys_cells(),
        notes="GRU interest extraction + AUGRU; recurrence is lax.scan; "
              "retrieval runs per-candidate AUGRU (heavy, sharded).",
    )
