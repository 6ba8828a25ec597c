"""granite-moe-1b-a400m: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from __future__ import annotations

import dataclasses

from ..models.moe import MoEConfig
from ..models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="granite-moe-1b-a400m",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=512,  # per-expert width
        vocab=49155,
        qkv_bias=False,
        tie_embeddings=True,
        norm="rmsnorm",
        rope_theta=10_000.0,
        max_seq_len=4096,
        dtype="bfloat16",
        moe=MoEConfig(n_experts=32, top_k=8, d_ff=512, capacity_factor=1.25),
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        vocab=512, max_seq_len=128, dtype="float32", loss_chunk=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=32, capacity_factor=1.5),
    )
