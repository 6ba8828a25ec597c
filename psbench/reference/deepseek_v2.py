"""DeepSeek-V2-Lite's decoder (arXiv:2405.04434; Hugging Face's
``deepseek_v2`` model type), plain float32: its weights drawn from the
seed, its loss, and three Adam steps.

The architecture as published: an untied token embedding; per layer
RMSNorm, multi-head latent attention without q compression (q straight
from x; k and v expanded from a normed 512-wide latent; a 64-wide
rotated key shared by all heads; YaRN-scaled RoPE on split halves and
the softmax scale times YaRN's mscale squared), the residual, RMSNorm,
then the leading layers' dense SwiGLU or the MoE: a softmax router over
every routed expert, the top k by score as gates (times the routed
scaling factor, not renormalised), the held experts' capacity-limited
SwiGLU and the shared experts' SwiGLU, then the residual; a final
RMSNorm, the output head, the mean next-token cross-entropy plus each
MoE layer's sequence-wise balance loss.  Attention runs in blocks of
queries, each against the keys up to its end, so the check fits at a
4,096-token row.

A device holds some of the routed experts (``experts_held_first`` and
``n_routed_experts``, of the router's ``router_experts``), as one of
expert parallelism's devices does: the router scores all of them and
only the held experts' part of the routed output is added.  Capacity is
per expert, of the whole layer: each expert takes the first
``int(capacity_factor * T * k / E)`` of its choices in token-major order
(token by token, each token's choices by rank) and drops the rest.

``quant`` and ``fault`` are as in :mod:`.lm`: float8 products for the
control, and half of each row out of the loss or half of the leaves'
gradients scaled by 1.5 for the planted faults.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import inputs
from .adam import adam_step
from .lm import _mm, _rms, draw

QUERY_BLOCK = 512  # queries a block of the attention


def _attn_specs(m: Dict, lead: Tuple[int, ...]):
    d, h = m["hidden_size"], m["num_attention_heads"]
    r, nope = m["kv_lora_rank"], m["qk_nope_head_dim"]
    rope, dv = m["qk_rope_head_dim"], m["v_head_dim"]
    mat = m["torch_dtype"]
    return [
        ("attn/kv_norm", lead + (r,), 0.0, "float32"),
        ("attn/w_dkv", lead + (d, r), d ** -0.5, mat),
        ("attn/w_kr", lead + (d, rope), d ** -0.5, mat),
        ("attn/w_o", lead + (h, dv, d), (h * dv) ** -0.5, mat),
        ("attn/w_q", lead + (d, h, nope + rope), d ** -0.5, mat),
        ("attn/w_uk", lead + (r, h, nope), r ** -0.5, mat),
        ("attn/w_uv", lead + (r, h, dv), r ** -0.5, mat),
        ("ln1/g", lead + (d,), 0.0, "float32"),
        ("ln2/g", lead + (d,), 0.0, "float32"),
    ]


def leaf_specs(m: Dict) -> List[Tuple[str, Tuple[int, ...], float, str]]:
    """(name, shape, init std, dtype) of every weight; std 0 is a norm
    gain of ones.  Matrices are in ``torch_dtype``; norm gains and the
    router float32.
    The leading dense layers are ``dense_layer_<i>/...``, the MoE layers
    stacked under ``layers/...``."""
    d, v = m["hidden_size"], m["vocab_size"]
    f, fe = m["intermediate_size"], m["moe_intermediate_size"]
    fs = m["n_shared_experts"] * fe
    e, held = m["router_experts"], m["n_routed_experts"]
    n_dense, mat = m["first_k_dense_replace"], m["torch_dtype"]
    lead = (m["num_hidden_layers"] - n_dense,)
    specs = [("embed", (v, d), d ** -0.5, mat),
             ("final_norm/g", (d,), 0.0, "float32"),
             ("unembed", (d, v), d ** -0.5, mat)]
    for i in range(n_dense):
        specs += [(f"dense_layer_{i}/{n}", s, std, dt)
                  for n, s, std, dt in _attn_specs(m, ()) + [
                      ("ffn/w_down", (f, d), f ** -0.5, mat),
                      ("ffn/w_gate", (d, f), d ** -0.5, mat),
                      ("ffn/w_up", (d, f), d ** -0.5, mat)]]
    specs += [(f"layers/{n}", s, std, dt) for n, s, std, dt in
              _attn_specs(m, lead) + [
                  ("moe/router", lead + (d, e), d ** -0.5, "float32"),
                  ("moe/shared_down", lead + (fs, d), fs ** -0.5, mat),
                  ("moe/shared_gate", lead + (d, fs), d ** -0.5, mat),
                  ("moe/shared_up", lead + (d, fs), d ** -0.5, mat),
                  ("moe/w_down", lead + (held, fe, d), fe ** -0.5, mat),
                  ("moe/w_gate", lead + (held, d, fe), d ** -0.5, mat),
                  ("moe/w_up", lead + (held, d, fe), d ** -0.5, mat)]]
    return sorted(specs)


def yarn_mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_constants(m: Dict) -> Dict[str, float]:
    """YaRN's correction range (low, high), its cos/sin gain and the
    attention's softmax scale, from the configuration's ``rope_scaling``
    as Hugging Face's ``DeepseekV2YarnRotaryEmbedding`` and
    ``DeepseekV2Attention`` compute them."""
    y, dim = m["rope_scaling"], m["qk_rope_head_dim"]
    base, orig = m["rope_theta"], y["original_max_position_embeddings"]

    def corr(turns):
        return dim * math.log(orig / (turns * 2 * math.pi)) / (
            2 * math.log(base))

    low = max(math.floor(corr(y["beta_fast"])), 0)
    high = min(math.ceil(corr(y["beta_slow"])), dim - 1)
    all_dim = yarn_mscale(y["factor"], y["mscale_all_dim"])
    scale = (m["qk_nope_head_dim"] + dim) ** -0.5 * all_dim * all_dim
    return {"low": low, "high": high,
            "gain": yarn_mscale(y["factor"], y["mscale"]) / all_dim,
            "mscale_all_dim": all_dim, "scale": scale}


def _yarn_tables(m: Dict, s: int, device):
    """YaRN's cos and sin (s, rope / 2), computed in float64."""
    dim, base = m["qk_rope_head_dim"], m["rope_theta"]
    c = yarn_constants(m)
    i = torch.arange(dim // 2, dtype=torch.float64, device=device)
    extra = base ** (-2.0 * i / dim)
    inter = extra / m["rope_scaling"]["factor"]
    ramp = ((i - c["low"]) / max(c["high"] - c["low"], 1e-3)).clamp(0, 1)
    inv = inter * ramp + extra * (1 - ramp)
    ang = torch.arange(s, dtype=torch.float64, device=device)[:, None] * inv
    return ((torch.cos(ang) * c["gain"]).float(),
            (torch.sin(ang) * c["gain"]).float())


def _rope(x, cos, sin):
    """Rotate each head's split halves; x (b, s, h, rope)."""
    x1, x2 = x.chunk(2, dim=-1)
    cos, sin = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mla(w, h, m, cos, sin, q8, eps):
    """Latent attention of (b, s, d) normed inputs, causal, in blocks of
    queries."""
    b, s, _ = h.shape
    nope, rope = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    q = torch.einsum("bsd,dhe->bshe", h, q8(w["attn/w_q"]))
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], cos, sin)], dim=-1)
    ckv = q8(_rms(h @ q8(w["attn/w_dkv"]), w["attn/kv_norm"], eps))
    k_rope = _rope((h @ q8(w["attn/w_kr"]))[:, :, None, :], cos, sin)
    k_nope = torch.einsum("bsr,rhe->bshe", ckv, q8(w["attn/w_uk"]))
    v = torch.einsum("bsr,rhe->bshe", ckv, q8(w["attn/w_uv"]))
    k = torch.cat([k_nope, k_rope.expand(-1, -1, k_nope.shape[2], -1)], -1)
    q, k, v = q8(q * yarn_constants(m)["scale"]), q8(k), q8(v)
    outs = []
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, s)
        scores = torch.einsum("bqhe,bkhe->bhqk", q[:, q0:q1], k[:, :q1])
        seen = (torch.arange(q1, device=h.device)[None, :]
                <= torch.arange(q0, q1, device=h.device)[:, None])
        probs = torch.softmax(scores.masked_fill(~seen, -math.inf), -1)
        outs.append(torch.einsum("bhqk,bkhe->bqhe", q8(probs), v[:, :q1]))
    o = torch.cat(outs, dim=1)
    return torch.einsum("bshe,hed->bsd", q8(o), q8(w["attn/w_o"]))


def _swiglu(x, gate, up, down, q8):
    return q8(F.silu(x @ q8(gate)) * (x @ q8(up))) @ q8(down)


def capacity(m: Dict, tokens: int) -> int:
    """Each routed expert's capacity over ``tokens`` tokens."""
    return max(1, int(m["capacity_factor"] * tokens
                      * m["num_experts_per_tok"] / m["router_experts"]))


def moe(w, h, m, q8, routes: Optional[list] = None):
    """The MoE FFN of (b, s, d) normed inputs: (the held experts' routed
    part plus the shared experts, the sequence-wise balance loss).  Each
    token's top-k expert ids are appended to ``routes`` if given."""
    b, s, d = h.shape
    e, k = m["router_experts"], m["num_experts_per_tok"]
    first, held = m["experts_held_first"], m["n_routed_experts"]
    x = h.reshape(b * s, d)
    probs = torch.softmax(x @ q8(w["moe/router"]), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    if m["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * m["routed_scaling_factor"]
    if routes is not None:
        routes.append(idx.detach())
    cap = capacity(m, b * s)
    y = torch.zeros_like(x)
    for ex in range(first, first + held):
        # this expert's choices in token-major order; the first cap kept
        at = (idx == ex).reshape(-1).nonzero()[:cap, 0]
        tok, rank = at // k, at % k
        out = _swiglu(x[tok], w["moe/w_gate"][ex - first],
                      w["moe/w_up"][ex - first], w["moe/w_down"][ex - first],
                      q8)
        y = y.index_add(0, tok, out * gates[tok, rank, None])
    y = y + _swiglu(x, w["moe/shared_gate"], w["moe/shared_up"],
                    w["moe/shared_down"], q8)
    hits = torch.zeros((b, e), device=h.device).scatter_add_(
        1, idx.reshape(b, s * k), torch.ones((b, s * k), device=h.device))
    ce = hits / (s * k / e)
    balance = (ce * probs.reshape(b, s, e).mean(1)).sum(1).mean()
    return y.reshape(b, s, d), m["aux_loss_alpha"] * balance


def _layer_weights(w, m: Dict, i: int) -> Dict[str, torch.Tensor]:
    n_dense = m["first_k_dense_replace"]
    if i < n_dense:
        pre = f"dense_layer_{i}/"
        return {n[len(pre):]: t for n, t in w.items() if n.startswith(pre)}
    return {n[len("layers/"):]: t[i - n_dense] for n, t in w.items()
            if n.startswith("layers/")}


def forward(w: Dict[str, torch.Tensor], tokens, m: Dict,
            quant: Optional[str] = None, routes: Optional[list] = None):
    """(logits (rows, seq, vocab) of ``tokens`` (rows, seq), the MoE
    layers' balance losses summed)."""
    q8 = _mm(quant)
    eps = m["rms_norm_eps"]
    x = w["embed"][tokens]
    b, s, _ = x.shape
    cos, sin = _yarn_tables(m, s, x.device)
    aux = torch.zeros((), device=x.device)
    for i in range(m["num_hidden_layers"]):
        lw = _layer_weights(w, m, i)
        x = x + _mla(lw, q8(_rms(x, lw["ln1/g"], eps)), m, cos, sin, q8, eps)
        h = q8(_rms(x, lw["ln2/g"], eps))
        if i < m["first_k_dense_replace"]:
            x = x + _swiglu(h, lw["ffn/w_gate"], lw["ffn/w_up"],
                            lw["ffn/w_down"], q8)
        else:
            y, balance = moe(lw, h, m, q8, routes)
            x, aux = x + y, aux + balance
    return q8(_rms(x, w["final_norm/g"], eps)) @ q8(w["unembed"]), aux


def loss(w: Dict[str, torch.Tensor], tokens, m: Dict,
         quant: Optional[str] = None, half: bool = False,
         routes: Optional[list] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` (rows, seq + 1) plus
    the MoE layers' balance losses; with ``half`` the cross-entropy is
    over the first half of each row's positions only."""
    logits, aux = forward(w, tokens[:, :-1], m, quant, routes)
    b, s, _ = logits.shape
    labels = tokens[:, 1:]
    if half:
        labels = labels.clone()
        labels[:, s // 2:] = -100
    return F.cross_entropy(logits.reshape(b * s, -1), labels.reshape(-1),
                           ignore_index=-100) + aux


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
           fault: Optional[str] = None, routes: Optional[list] = None):
    """Three Adam steps from the seed's weights on ``batches`` (three
    token tensors).  Returns (losses, each leaf's first-gradient norm,
    each leaf's parameter-change norm after the three, each leaf's first
    gradient at the ``picks`` indices); the first step's top-k expert
    ids, one (tokens, k) tensor a MoE layer, go to ``routes`` if given."""
    w0 = {n: draw(n, shape, std, dt, seed, device).float()
          for n, shape, std, dt in leaf_specs(m)}
    w = {n: t.clone().requires_grad_(True) for n, t in w0.items()}
    mom = {n: (torch.zeros_like(t), torch.zeros_like(t)) for n, t in w.items()}
    losses, grad_norm, sample = [], {}, {}
    altered = set(list(w)[: len(w) // 2]) if fault == "altered" else set()
    for t, tokens in enumerate(batches, start=1):
        lval = loss(w, tokens, m, quant, half=fault == "half",
                    routes=routes if t == 1 else None)
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


def route_flips(got: List[torch.Tensor], want: List[torch.Tensor]) -> float:
    """The share of (token, MoE layer) whose set of top-k experts differs
    between two routings (lists of (tokens, k) ids, one a layer)."""
    differ = sum(int((a.sort(-1).values != b.to(a.device).sort(-1).values)
                     .any(-1).sum()) for a, b in zip(got, want))
    return differ / sum(a.shape[0] for a in got)
