"""A Llama-architecture decoder (granite-8b-code-base's), plain float32:
its weights drawn from the seed, its loss, and three Adam steps.

The architecture as published: token embedding; per layer RMSNorm,
grouped-query attention with RoPE on split halves and a causal softmax,
the residual, RMSNorm, the SwiGLU feed-forward, the residual; a final
RMSNorm and the tied embedding as the output head; the mean next-token
cross-entropy.  Weights are named as the port names its leaves, so one
draw per name feeds both sides.

``quant="fp8"`` is the control: every matrix product's operands rounded
to float8 e4m3 (a scale per tensor), the step below the bfloat16 the
configuration states; gradients pass the rounding unchanged.  ``fault``
plants a training step's faults in the reference, to read what they do
to the compared numbers at the cell's own size: ``"half"`` leaves the
second half of every row's positions out of the loss (the mean taken
over the rest), ``"altered"`` scales the gradient of the first half of
the leaves by 1.5 where it is produced.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import inputs
from .adam import adam_step


def leaf_specs(m: Dict) -> List[Tuple[str, Tuple[int, ...], float, str]]:
    """(name, shape, init std, dtype) of every weight; std 0 is a norm
    gain of ones.  Matrices are bf16, norm gains float32."""
    L, d = m["num_hidden_layers"], m["hidden_size"]
    hq, hk = m["num_attention_heads"], m["num_key_value_heads"]
    dh, f, v = m["head_dim"], m["intermediate_size"], m["vocab_size"]
    return [
        ("embed", (v, d), d ** -0.5, "bfloat16"),
        ("final_norm/g", (d,), 0.0, "float32"),
        ("layers/attn/w_k", (L, d, hk, dh), d ** -0.5, "bfloat16"),
        ("layers/attn/w_o", (L, hq, dh, d), (hq * dh) ** -0.5, "bfloat16"),
        ("layers/attn/w_q", (L, d, hq, dh), d ** -0.5, "bfloat16"),
        ("layers/attn/w_v", (L, d, hk, dh), d ** -0.5, "bfloat16"),
        ("layers/ffn/w_down", (L, f, d), f ** -0.5, "bfloat16"),
        ("layers/ffn/w_gate", (L, d, f), d ** -0.5, "bfloat16"),
        ("layers/ffn/w_up", (L, d, f), d ** -0.5, "bfloat16"),
        ("layers/ln1/g", (L, d), 0.0, "float32"),
        ("layers/ln2/g", (L, d), 0.0, "float32"),
    ]


def draw(name: str, shape, std: float, dtype: str, seed: int,
         device) -> torch.Tensor:
    """One weight, drawn on ``device`` in one call, in its stored dtype."""
    if std == 0.0:
        return torch.ones(shape, dtype=torch.float32, device=device)
    n = math.prod(shape)
    return inputs.normal(n, std, seed, "weight", name, device=device).view(
        shape).to(getattr(torch, dtype))


def batch_tokens(m: Dict, rows: int, seq: int, seed: int, index: int,
                 device) -> torch.Tensor:
    """Batch ``index`` of the synthetic corpus: (rows, seq + 1) token ids,
    uniform over the vocabulary; inputs are [:, :-1], labels [:, 1:]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(inputs.sub_seed(seed, "batch", index))
    return torch.randint(0, m["vocab_size"], (rows, seq + 1), generator=gen,
                         device=device)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _mm(quant: Optional[str]):
    if quant is None:
        return lambda x: x
    if quant == "fp8":
        return _Fp8.apply
    raise ValueError(f"unknown quantisation {quant!r}")


def _rms(x, g, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def _rope(x, theta):
    """Rotate each head's split halves by the position's angles."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                       device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).to(x.dtype)[:, None, :]
    sin = torch.sin(ang).to(x.dtype)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def loss(w: Dict[str, torch.Tensor], tokens, m: Dict,
         quant: Optional[str] = None, half: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` (rows, seq + 1); with
    ``half`` over the first half of each row's positions only."""
    q8 = _mm(quant)
    eps, theta = m["rms_norm_eps"], m["rope_theta"]
    hq, hk = m["num_attention_heads"], m["num_key_value_heads"]
    x = w["embed"][tokens[:, :-1]]
    b, s, _ = x.shape
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    for i in range(m["num_hidden_layers"]):
        h = q8(_rms(x, w["layers/ln1/g"][i], eps))
        q = torch.einsum("bsd,dhe->bshe", h, q8(w["layers/attn/w_q"][i]))
        k = torch.einsum("bsd,dhe->bshe", h, q8(w["layers/attn/w_k"][i]))
        v = torch.einsum("bsd,dhe->bshe", h, q8(w["layers/attn/w_v"][i]))
        q, k = _rope(q, theta), _rope(k, theta)
        qg = q.reshape(b, s, hk, hq // hk, -1) * q.shape[-1] ** -0.5
        scores = torch.einsum("bqhgd,bkhd->bhgqk", q8(qg), q8(k))
        probs = torch.softmax(scores.masked_fill(~causal, -math.inf), -1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", q8(probs), q8(v))
        o = o.reshape(b, s, hq, -1)
        x = x + torch.einsum("bshe,hed->bsd", q8(o),
                             q8(w["layers/attn/w_o"][i]))
        h = q8(_rms(x, w["layers/ln2/g"][i], eps))
        a = F.silu(h @ q8(w["layers/ffn/w_gate"][i])) * (
            h @ q8(w["layers/ffn/w_up"][i]))
        x = x + q8(a) @ q8(w["layers/ffn/w_down"][i])
    h = q8(_rms(x, w["final_norm/g"], eps))
    logits = h @ q8(w["embed"]).T
    labels = tokens[:, 1:]
    if half:
        labels = labels.clone()
        labels[:, s // 2:] = -100
    return F.cross_entropy(logits.reshape(b * s, -1), labels.reshape(-1),
                           ignore_index=-100)


SAMPLE = 65536  # first-gradient elements compared a leaf


def gradient_sample(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Per leaf, up to SAMPLE flat element indices drawn from the seed,
    at which the first gradients are compared element by element."""
    out = {}
    for name, shape, _, _ in leaf_specs(m):
        n = math.prod(shape)
        idx = inputs.rng(seed, "gradient sample", name).choice(
            n, size=min(SAMPLE, n), replace=False)
        out[name] = torch.from_numpy(idx.astype("int64")).to(device)
    return out


def train3(m: Dict, *, seed: int, batches, lr: float, adam: Dict, device,
           picks: Dict[str, torch.Tensor], quant: Optional[str] = None,
           fault: Optional[str] = None):
    """Three Adam steps from the seed's weights on ``batches`` (three
    token tensors).  Returns (losses, each leaf's first-gradient norm,
    each leaf's parameter-change norm after the three, each leaf's first
    gradient at the ``picks`` indices)."""
    w0 = {n: draw(n, shape, std, dt, seed, device).float()
          for n, shape, std, dt in leaf_specs(m)}
    w = {n: t.clone().requires_grad_(True) for n, t in w0.items()}
    mom = {n: (torch.zeros_like(t), torch.zeros_like(t)) for n, t in w.items()}
    losses, grad_norm, sample = [], {}, {}
    altered = set(list(w)[: len(w) // 2]) if fault == "altered" else set()
    for t, tokens in enumerate(batches, start=1):
        lval = loss(w, tokens, m, quant, half=fault == "half")
        grads = torch.autograd.grad(lval, list(w.values()))
        grads = [g * 1.5 if n in altered else g for n, g in zip(w, grads)]
        losses.append(float(lval.detach()))
        with torch.no_grad():
            for (n, p), g in zip(list(w.items()), grads):
                if t == 1:
                    grad_norm[n] = float(torch.linalg.vector_norm(g.double()))
                    sample[n] = g.reshape(-1)[picks[n]]
                mu, nu = mom[n]
                new, mu, nu = adam_step(p.detach(), mu, nu, g, t, lr=lr,
                                        **adam)
                mom[n] = (mu, nu)
                w[n] = new.requires_grad_(True)
        del grads, lval
    change = {n: float(torch.linalg.vector_norm((w[n].detach() - w0[n])
                                                .double()))
              for n in w}
    return losses, grad_norm, change, sample


def norm_gaps(got: Dict[str, float], want: Dict[str, float],
              skip=()) -> Tuple[float, str]:
    """The worst leaf's gap between two norms, |got - want|, against the
    larger of that leaf's reference norm and the median leaf's."""
    keys = [k for k in want if k not in skip]
    med = sorted(want[k] for k in keys)[len(keys) // 2]
    worst, at = 0.0, ""
    for k in keys:
        gap = abs(got[k] - want[k]) / max(want[k], med)
        if gap >= worst:
            worst, at = gap, k
    return worst, at
