"""sasrec: embed_dim=50 n_blocks=2 n_heads=1 seq_len=50
interaction=self-attn-seq. [arXiv:1808.09781; paper]

Item vocabulary: the original paper evaluates on ML-1M (3.4k items); for
cluster-scale serving (retrieval_cand scores 1M candidates) the reference
sizes the item catalog at 1M rows (documented choice).
"""

from __future__ import annotations

import dataclasses

from ..arch import ArchSpec
from ..models.recsys import SASRecConfig


def config() -> SASRecConfig:
    return SASRecConfig(name="sasrec", n_items=1_000_000, embed_dim=50,
                        n_blocks=2, n_heads=1, seq_len=50)


def smoke_config() -> SASRecConfig:
    return dataclasses.replace(config(), n_items=500, embed_dim=16, seq_len=10)


def spec() -> ArchSpec:
    from .dlrm_rm2 import recsys_cells

    return ArchSpec(
        arch_id="sasrec",
        family="recsys",
        recsys_kind="sasrec",
        model=config(),
        cells=recsys_cells(),
        notes="Sequential self-attention recommender; retrieval = last-state "
              "dot against the item table.",
    )
