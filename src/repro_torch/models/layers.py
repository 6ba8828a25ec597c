"""Shared layers (``repro.models.layers``), plain PyTorch.

Same arithmetic as the reference, op for op: norms in float32 and cast
back, RoPE on split halves, the chunked cross-entropy that never holds
more than one sequence chunk's logits, with padded vocab columns and
``-1`` labels masked, and the recsys towers' MLP.  Beside them, which the
reference does not have: DeepSeek-V2's YaRN-scaled RoPE tables.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..ps import act_sharding as act


def normal_init(generator: torch.Generator, shape, stddev: float = 0.02,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """``stddev`` x N(0, 1) draws from ``generator`` (on ``device``), cast
    to ``dtype``.  The draws differ from ``jax.random``'s: carry the
    reference's weights across to compare the two."""
    x = torch.randn(shape, generator=generator, device=device)
    return x.mul_(stddev).to(dtype)


def mlp(x, weights: Sequence, biases: Sequence, act=torch.relu,
        final_act=None):
    """Plain MLP used by the recsys towers: ``act`` between layers,
    ``final_act`` (if any) after the last."""
    h = x
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = h @ w + b
        if i < len(weights) - 1:
            h = act(h)
        elif final_act is not None:
            h = final_act(h)
    return h


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
@dataclass(frozen=True)
class YaRN:
    """YaRN's RoPE scaling (arXiv:2309.00071) as DeepSeek-V2 configures it
    (``rope_scaling`` of type ``yarn``; Hugging Face's
    ``DeepseekV2YarnRotaryEmbedding``): the frequencies between the two
    correction dims ramp from the original ones to ones ``factor`` times
    lower, cos and sin are scaled by ``mscale(factor, mscale) /
    mscale(factor, mscale_all_dim)``, and MLA's softmax scale by
    ``mscale(factor, mscale_all_dim) ** 2``."""

    factor: float
    original_max_len: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


def yarn_mscale(scale: float, m: float) -> float:
    """YaRN's magnitude correction ``0.1 m ln(scale) + 1``; 1 at scale <= 1."""
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_range(d_head: int, theta: float, y: YaRN):
    """(low, high): the dims whose frequencies make ``beta_fast`` and
    ``beta_slow`` turns over the original length, floored and ceiled,
    clamped to [0, d_head - 1]."""
    def corr(turns):
        return (d_head * math.log(y.original_max_len / (2 * math.pi * turns))
                / (2 * math.log(theta)))
    return (max(math.floor(corr(y.beta_fast)), 0),
            min(math.ceil(corr(y.beta_slow)), d_head - 1))


def _inv_freq(d_head: int, theta: float, scaling: Optional[YaRN], device):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    if scaling is None:
        return 1.0 / (theta ** exps)
    low, high = yarn_range(d_head, theta, scaling)
    ramp = torch.clamp((torch.arange(d_head // 2, dtype=torch.float32,
                                     device=device) - low)
                       / max(high - low, 1e-3), 0.0, 1.0)
    extra = 1.0 / (theta ** exps)
    inter = 1.0 / (scaling.factor * theta ** exps)
    return inter * ramp + extra * (1.0 - ramp)


def _cos_sin(ang, scaling: Optional[YaRN]):
    cos, sin = torch.cos(ang), torch.sin(ang)
    if scaling is not None:
        gain = (yarn_mscale(scaling.factor, scaling.mscale)
                / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
        if gain != 1.0:
            cos, sin = cos * gain, sin * gain
    return cos, sin


def rope_row(position: int, d_head: int, theta: float = 10000.0,
             device=None, scaling: Optional[YaRN] = None):
    """cos/sin tables with a single row for ``position`` (the decode path:
    no ``(max_len, d/2)`` table per step).  Returns ((1, d/2), (1, d/2))
    float32."""
    inv = _inv_freq(d_head, theta, scaling, device)
    ang = torch.tensor(float(position), dtype=torch.float32,
                       device=device) * inv
    cos, sin = _cos_sin(ang, scaling)
    return cos[None], sin[None]


def rope_frequencies(d_head: int, max_len: int, theta: float = 10000.0,
                     device=None, scaling: Optional[YaRN] = None):
    """cos/sin tables, each (max_len, d_head/2) float32."""
    inv = _inv_freq(d_head, theta, scaling, device)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    return _cos_sin(torch.outer(t, inv), scaling)


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
    # Under a mesh the sequence-parallel hidden is gathered first: a
    # DTensor view cannot split a sharded dim into fewer chunks than
    # shards (GSPMD reshards inside the reference's scan instead).
    hidden = act.constrain(hidden, "dp", None, None)
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
        logits = act.constrain(logits, "dp", None, "tp")  # vocab over tp
        if pad_mask is not None:
            logits = torch.where(pad_mask, logits, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        if act.enabled():
            # vocab-sharded logits: select the label column by a mask and
            # a sum (one nonzero term: the same value), which DTensor
            # shards along the vocab; its gather from a sharded dim fails
            hit = torch.arange(v, device=hidden.device) == y[..., None]
            gold = torch.where(hit, logits, 0.0).sum(-1)
        else:
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
