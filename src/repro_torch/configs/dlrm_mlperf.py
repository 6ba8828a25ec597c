"""dlrm-mlperf: MLPerf DLRM benchmark config (Criteo 1TB): n_dense=13
n_sparse=26 embed_dim=128 bot=13-512-256-128 top=1024-1024-512-256-1
interaction=dot. [arXiv:1906.00091; paper]

CRITEO_TB_VOCAB: the published per-field cardinalities of the Criteo
Terabyte dataset under MLPerf's max_ind_range=40M hashing (facebookresearch/
dlrm reference configuration).  Its tables, 187.8 M rows x 128 float32
(96 GB), do not fit one 80 GB card: the config is ported, not run there.
"""

from __future__ import annotations

from ..arch import ArchSpec
from ..models.recsys import DLRMConfig

CRITEO_TB_VOCAB = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63,
    38532951, 2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14,
    39979771, 25641295, 39664984, 585935, 12972, 108, 36,
)


def config() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-mlperf", n_dense=13, n_sparse=26, embed_dim=128,
        bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
        vocab_sizes=CRITEO_TB_VOCAB,
    )


def smoke_config() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-mlperf-smoke", n_dense=13, n_sparse=4, embed_dim=16,
        bot_mlp=(32, 16), top_mlp=(32, 16, 1), vocab_sizes=(1000, 50, 200, 3),
    )


def spec() -> ArchSpec:
    from .dlrm_rm2 import recsys_cells

    return ArchSpec(
        arch_id="dlrm-mlperf",
        family="recsys",
        recsys_kind="dlrm",
        model=config(),
        cells=recsys_cells(),
        notes="~188M embedding rows x 128 = 96 GB of tables; row-sharded "
              "over the full mesh (PS-style sharded EmbeddingBag).",
    )
