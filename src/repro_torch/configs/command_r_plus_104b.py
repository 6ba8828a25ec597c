"""command-r-plus-104b: 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000 -- GQA, no-bias, parallel attention+FFN residual (Cohere arch),
LayerNorm, tied embeddings. [hf:CohereForAI/c4ai-command-r-plus; unverified]
"""

from __future__ import annotations

import dataclasses

from ..arch import ArchSpec, lm_cells
from ..models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="command-r-plus-104b",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=33792,
        vocab=256000,
        qkv_bias=False,
        tie_embeddings=True,
        parallel_block=True,
        norm="layernorm",
        rope_theta=75_000_000.0,
        max_seq_len=8192,
        dtype="bfloat16",
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=352,
        vocab=512, max_seq_len=128, dtype="float32", loss_chunk=16,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="command-r-plus-104b",
        family="lm",
        model=config(),
        cells=lm_cells(train_microbatches=16),
        notes="104B dense; largest dense cell; FSDP+TP+SP sharding.",
    )
