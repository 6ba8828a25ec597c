"""Plain PyTorch version of the flash attention kernel (K7).

``flash_attention_plain`` computes what ``flash_attn_fwd`` in
``csrc/flash_attn.cu`` computes, with an exact float32 softmax instead of
the kernel's online one: q cast to float32 and scaled first, scores in
float32, causal alignment bottom-right (key j visible to query i when
j <= i + S_k - S_q, as ``repro.kernels.flash_attn.ref`` masks), the
probabilities times v in float32, the output cast to q's type.  It walks
the queries in chunks so that the scores never exceed ``chunk_q`` rows
(full scores at S = 32 768 and 16 heads would be 68.7 GB).  The CPU tests
run it; ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None,
                          chunk_q: int = 1024) -> torch.Tensor:
    """q: (B, S_q, HQ, D); k, v: (B, S_k, HK, D), HQ % HK == 0.
    Returns (B, S_q, HQ, D) in q's dtype."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    g = hq // hk
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(sk, device=q.device)
    out = torch.empty_like(q)
    for i0 in range(0, sq, chunk_q):
        i1 = min(sq, i0 + chunk_q)
        qg = (q[:, i0:i1].float() * scale).reshape(b, i1 - i0, hk, g, d)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
        if causal:
            q_pos = torch.arange(i0, i1, device=q.device) + (sk - sq)
            s = s.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
        out[:, i0:i1] = o.reshape(b, i1 - i0, hq, d).to(q.dtype)
    return out
