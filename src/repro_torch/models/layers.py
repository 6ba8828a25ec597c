"""Shared layers (``repro.models.layers``), plain PyTorch.

Same arithmetic as the reference, op for op: norms in float32 and cast
back, RoPE on split halves, and the chunked cross-entropy that never
holds more than one sequence chunk's logits, with padded vocab columns
and ``-1`` labels masked.
"""

from __future__ import annotations

from typing import Optional

import torch


def layer_norm(x, gamma, beta, eps=1e-5):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * gamma + beta


def rms_norm(x, gamma, eps=1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * gamma).to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


def swiglu(x, w_gate, w_up, w_down):
    """LLaMA-style gated MLP: down( silu(x@gate) * (x@up) )."""
    return torch.einsum("...f,fd->...d", silu(x @ w_gate) * (x @ w_up),
                        w_down)


# ------------------------------------------------------------------- RoPE
def rope_frequencies(d_head: int, max_len: int, theta: float = 10000.0,
                     device=None):
    """cos/sin tables, each (max_len, d_head/2) float32."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    inv = 1.0 / (theta ** exps)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin, positions=None):
    """x: (..., S, H, D). cos/sin: (max_len, D/2). positions: (..., S) or
    None."""
    if positions is None:
        s = x.shape[-3]
        cos_p = cos[:s][:, None, :]
        sin_p = sin[:s][:, None, :]
    else:
        cos_p = cos[positions][..., None, :]
        sin_p = sin[positions][..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out1 = x1 * cos_p - x2 * sin_p
    out2 = x2 * cos_p + x1 * sin_p
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# ------------------------------------------------------- chunked cross-entropy
def chunked_softmax_xent(hidden, unembed, labels, chunk: int = 512,
                         label_smoothing: float = 0.0,
                         real_vocab: Optional[int] = None):
    """Cross-entropy over a huge vocab, one sequence chunk of logits at a
    time.  hidden: (B,S,D); unembed: (D,V); labels: (B,S) int.  Returns
    the mean loss (float32) over positions with label >= 0; with
    ``real_vocab`` < V the padding columns are masked to -1e30."""
    b, s, d = hidden.shape
    v = unembed.shape[-1]
    n_chunks = max(1, s // chunk)
    chunk = s // n_chunks  # require divisibility; configs ensure it
    hid = hidden.reshape(b, n_chunks, chunk, d)
    lab = labels.reshape(b, n_chunks, chunk)
    pad_mask = None
    if real_vocab is not None and real_vocab < v:
        pad_mask = torch.arange(v, device=hidden.device) < real_vocab
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        h, y = hid[:, i], lab[:, i]
        logits = torch.einsum("bcd,dv->bcv", h, unembed).float()
        if pad_mask is not None:
            logits = torch.where(pad_mask, logits, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            torch.clamp(y, min=0).long()[..., None])[..., 0]
        mask = (y >= 0).float()
        nll = (lse - gold) * mask
        if label_smoothing:
            nll = (1 - label_smoothing) * nll + label_smoothing * mask * (
                lse - torch.mean(logits, dim=-1))
        loss_sum = loss_sum + torch.sum(nll)
        count = count + torch.sum(mask)
    return loss_sum / torch.clamp(count, min=1.0)
