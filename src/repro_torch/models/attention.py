"""Attention (``repro.models.attention``), plain PyTorch.

- ``full_attention``: einsum GQA attention (S x S scores).
- ``chunked_attention``: online softmax over KV chunks, never S x S.
- ``decode_attention``: one new query token against a KV cache, positions
  at or past the cache's valid length masked.
- ``flash_attention``: the flash attention kernel K7 for CUDA tensors
  (its plain version for CPU tensors); the inference prefill's attention.

All take q (B,S,HQ,D) and k, v (B,S,HK,D) with HQ % HK == 0, and align
the causal mask to the END of the kv sequence, as the reference does.
The first three are plain tensor code in the reference too, not a Pallas
kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attn import ops as flash_ops
from ..ps import act_sharding as act

NEG_INF = -1e30


def _expand_kv(k, n_rep: int):
    """(B,S,HK,D) -> (B,S,HK*n_rep,D) by head repetition (GQA)."""
    if n_rep == 1:
        return k
    b, s, hk, d = k.shape
    return k[:, :, :, None, :].expand(b, s, hk, n_rep, d).reshape(
        b, s, hk * n_rep, d)


def full_attention(q, k, v, causal: bool = True,
                   scale: Optional[float] = None):
    """q: (B,S,HQ,D); k,v: (B,S,HK,D). Returns (B,S,HQ,D)."""
    b, sq, hq, d = q.shape
    hk = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    g = hq // hk
    qg = q.reshape(b, sq, hk, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg * scale, k).float()
    if causal:
        sk = k.shape[1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, v.shape[-1])


def chunked_attention(q, k, v, causal: bool = True, chunk_k: int = 1024,
                      scale: Optional[float] = None):
    """Online-softmax attention over KV chunks. Memory O(S * chunk).

    Under activation sharding (TP on the head dim), GQA KV heads are
    expanded to the query-head count so every intermediate carries the
    tp-sharded head dim (hk alone seldom divides the model axis), and
    the chunks run on each device's shards (``act.per_device``)."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    if act.enabled():
        if hk != hq:
            k = _expand_kv(k, hq // hk)
            v = _expand_kv(v, hq // hk)
        return act.per_device(
            lambda q, k, v: _chunked(q, k, v, causal, chunk_k, scale),
            ("dp", None, "tp", None), q, k, v)
    return _chunked(q, k, v, causal, chunk_k, scale)


def _chunked(q, k, v, causal, chunk_k, scale):
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = hq // hk
    n_chunks = max(1, sk // chunk_k)
    chunk_k = sk // n_chunks
    dv = v.shape[-1]
    qg = (q * scale).reshape(b, sq, hk, g, d)
    kc = k.reshape(b, n_chunks, chunk_k, hk, d)
    vc = v.reshape(b, n_chunks, chunk_k, hk, dv)
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    acc = torch.zeros((b, sq, hk, g, dv), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, hk, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hk, g, sq), dtype=torch.float32, device=q.device)
    for i in range(n_chunks):
        k_i, v_i = kc[:, i], vc[:, i]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_i).float()
        if causal:
            kv_pos = i * chunk_k + torch.arange(chunk_k, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + torch.einsum(
            "bhgqk,bkhd->bqhgd", p.to(v_i.dtype), v_i).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len=None,
                     scale: Optional[float] = None):
    """q: (B,1,HQ,D); caches: (B,Smax,HK,D); cache_len: an int or a (B,)
    tensor of valid lengths (positions >= cache_len are masked).  Returns
    (B,1,HQ,D)."""
    b, _, hq, d = q.shape
    smax, hk = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    g = hq // hk
    if g > 1:  # under a mesh: q's heads whole, to group them by kv head
        q = act.whole_dim(q, 2)
    qg = (q * scale).reshape(b, hk, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float()
    if cache_len is not None:
        pos = torch.arange(smax, device=q.device)
        if not isinstance(cache_len, int):  # per-row lengths
            cache_len = torch.as_tensor(cache_len, device=q.device)[:, None]
        valid = pos[None] < cache_len  # (1 or B, Smax)
        s = torch.where(valid[:, None, None], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bkhd->bhgd", (p / l).to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, hq, d)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Softmax attention through the flash attention kernel (K7) for CUDA
    tensors, its plain version for CPU tensors.  Same layout and causal
    alignment as :func:`full_attention`; forward only (inputs must not
    require grad)."""
    return flash_ops.flash_attention(q, k, v, causal=causal, scale=scale)
