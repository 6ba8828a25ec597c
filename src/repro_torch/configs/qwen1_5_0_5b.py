"""qwen1.5-0.5b: 24L d_model=1024 16H (GQA kv=16 == MHA) d_ff=2816
vocab=151936 -- QKV bias, tied embeddings. [hf:Qwen/Qwen1.5-0.5B; hf]"""

from __future__ import annotations

import dataclasses

from ..arch import ArchSpec, lm_cells
from ..models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-0.5b",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab=151936,
        qkv_bias=True,
        tie_embeddings=True,
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        max_seq_len=32768,
        dtype="bfloat16",
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=176,
        vocab=512, max_seq_len=128, dtype="float32", loss_chunk=16,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="qwen1.5-0.5b",
        family="lm",
        model=config(),
        cells=lm_cells(train_microbatches=1),
        notes="Small dense LM; vocab dominates params (QKV bias exercised).",
    )
