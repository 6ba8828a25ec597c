"""granite-8b: 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152 --
llama-arch code model. [arXiv:2405.04324; hf]"""

from __future__ import annotations

import dataclasses

from ..arch import ArchSpec, lm_cells
from ..models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="granite-8b",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=49152,
        qkv_bias=False,
        tie_embeddings=True,
        norm="rmsnorm",
        rope_theta=10_000_000.0,
        max_seq_len=8192,
        dtype="bfloat16",
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=448,
        vocab=512, max_seq_len=128, dtype="float32", loss_chunk=16,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="granite-8b",
        family="lm",
        model=config(),
        cells=lm_cells(train_microbatches=2),
        notes="Mid-size dense llama-arch.",
    )
