"""dlrm-rm2: n_dense=13 n_sparse=26 embed_dim=64 bot=13-512-256-64
top=512-512-256-1 interaction=dot. [arXiv:1906.00091; paper]

Vocab sizes: the RM2-class model from the DLRM paper does not pin table
sizes; the reference uses the public Criteo-Terabyte per-field
cardinalities capped at 10M rows (documented synthetic choice) -- the skew
across tables is the property that matters for the paper's per-tensor
aggregation placement.  Padded to 512-row multiples that is 54,072,832
rows x 64 float32: 13.84 GB of tables, which one 80 GB card holds with
their dense gradients and Adagrad accumulators.

The recsys cells' batches (``repro.configs.dlrm_rm2.recsys_cells``) are
plain constants here: ``train_batch``, ``serve_p99``, ``serve_bulk`` and
``retrieval_cand`` (one user against that many candidates).
"""

from __future__ import annotations

from ..models.recsys import DLRMConfig
from .dlrm_mlperf import CRITEO_TB_VOCAB

VOCAB = tuple(min(v, 10_000_000) for v in CRITEO_TB_VOCAB)

TRAIN_BATCH = 65_536
SERVE_P99 = 512
SERVE_BULK = 262_144
RETRIEVAL_CAND = 1_000_000


def config() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
        bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1),
        vocab_sizes=VOCAB,
    )


def smoke_config() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-rm2-smoke", n_dense=13, n_sparse=4, embed_dim=8,
        bot_mlp=(16, 8), top_mlp=(16, 1), vocab_sizes=(100, 50, 200, 1000),
    )
