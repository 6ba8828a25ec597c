"""deepseek-v2-236b: 60L d_model=5120 128H, MLA (kv_lora=512, q_lora=1536,
nope=128, rope=64, v=128), MoE 160 routed top-6 (d_ff=1536) + 2 shared,
first layer dense (d_ff=12288), vocab=102400. [arXiv:2405.04434; hf]"""

from __future__ import annotations

import dataclasses

from ..models.moe import MoEConfig
from ..models.transformer import LMConfig, MLAConfig


def config() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,  # dense-layer FFN width (layer 0)
        vocab=102400,
        tie_embeddings=False,
        norm="rmsnorm",
        rope_theta=10_000.0,
        max_seq_len=16384,
        dtype="bfloat16",
        first_k_dense=1,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, d_ff=1536,
                      n_shared=2, d_ff_shared=3072, capacity_factor=1.25),
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, max_seq_len=128, dtype="float32", loss_chunk=16,
        first_k_dense=1,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=2,
                      d_ff_shared=64, capacity_factor=1.5),
    )
