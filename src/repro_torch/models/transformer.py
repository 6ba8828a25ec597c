"""Decoder-only LM, dense path (``repro.models.transformer``).

GQA with optional QKV bias, RoPE, RMS/LayerNorm, the parallel
attention+FFN block, tied or separate unembedding, the layers kept as
stacked ``(L, ...)`` leaves (the reference's ``lax.scan`` layout) and run
one at a time (remat through ``torch.utils.checkpoint`` when
``cfg.remat``), microbatched gradient accumulation and the chunked
cross-entropy.  Parameters are plain nested dicts with the reference's
leaf keys, shapes and dtypes, so weights carry across and
``build_flat_plan`` lays out both packages alike.

One device: the reference's activation-sharding constraints
(``act.constrain``) have nothing to do here.  Matrix products are
``torch.einsum`` / ``@``, as the reference leaves them to XLA.  MoE, MLA
and the serving steps (``make_serve_step``, ``make_prefill``) are not
ported yet (ROADMAP.md, Queue 1 item 15).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..tree import tree_leaves, tree_leaves_by_key, tree_with_leaves
from ..tree import value_and_grad
from . import attention as attn_lib
from .layers import (
    apply_rope,
    chunked_softmax_xent,
    layer_norm,
    rms_norm,
    rope_frequencies,
    silu,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1 item 15)")


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    parallel_block: bool = False  # command-r: x + attn(norm x) + ffn(norm x)
    norm: str = "rmsnorm"  # or "layernorm"
    rope_theta: float = 10000.0
    max_seq_len: int = 8192
    moe: Optional[Any] = None  # MoE: not ported yet
    first_k_dense: int = 0
    mla: Optional[Any] = None  # MLA: not ported yet
    dtype: str = "float32"
    remat: bool = True
    loss_chunk: int = 512
    attn_chunk_k: int = 0  # 0 -> full attention; >0 -> online-softmax chunks

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (embedding rows and logit
        columns); the cross-entropy masks the padding columns."""
        return -(-self.vocab // 256) * 256

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def param_count(self) -> int:
        """Total parameters, from a ``meta`` init (no memory)."""
        return sum(t.numel()
                   for t in tree_leaves(init_params(self, device="meta")))


def _check_dense(cfg: LMConfig) -> None:
    if cfg.moe is not None:
        raise _not_ported("the MoE FFN")
    if cfg.mla is not None:
        raise _not_ported("MLA attention")


# =============================================================== init
class _Init:
    """Seeded normal draws on one device (``meta``: shapes only)."""

    def __init__(self, device: torch.device, generator):
        self.device = device
        self.gen = None
        if device.type != "meta":
            self.gen = generator
            if self.gen is None:
                self.gen = torch.Generator(device=device)
                self.gen.manual_seed(0)

    def normal(self, shape, scale: float, dtype) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        return (scale * torch.randn(shape, generator=self.gen,
                                    device=self.device)).to(dtype)

    def full(self, shape, value: float, dtype) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


def _norm_params(cfg, init: _Init, lead, d):
    g = {"g": init.full(lead + (d,), 1.0, torch.float32)}
    if cfg.norm == "layernorm":
        g["b"] = init.full(lead + (d,), 0.0, torch.float32)
    return g


def _apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["g"], p["b"]).to(x.dtype)
    return rms_norm(x, p["g"])


def _init_attn(cfg: LMConfig, init: _Init, lead) -> Dict[str, Any]:
    d, hq, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype
    s = d ** -0.5
    p = {
        "w_q": init.normal(lead + (d, hq, dh), s, dt),
        "w_k": init.normal(lead + (d, hk, dh), s, dt),
        "w_v": init.normal(lead + (d, hk, dh), s, dt),
        "w_o": init.normal(lead + (hq, dh, d), (hq * dh) ** -0.5, dt),
    }
    if cfg.qkv_bias:
        p["b_q"] = init.full(lead + (hq, dh), 0.0, dt)
        p["b_k"] = init.full(lead + (hk, dh), 0.0, dt)
        p["b_v"] = init.full(lead + (hk, dh), 0.0, dt)
    return p


def _init_dense_ffn(cfg: LMConfig, init: _Init, lead) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    return {
        "w_gate": init.normal(lead + (d, f), d ** -0.5, dt),
        "w_up": init.normal(lead + (d, f), d ** -0.5, dt),
        "w_down": init.normal(lead + (f, d), f ** -0.5, dt),
    }


def _init_layer(cfg: LMConfig, init: _Init, lead=()) -> Dict[str, Any]:
    """One block's params; with ``lead = (L,)`` L blocks stacked."""
    p = {"ln1": _norm_params(cfg, init, lead, cfg.d_model),
         "attn": _init_attn(cfg, init, lead)}
    if not cfg.parallel_block:
        p["ln2"] = _norm_params(cfg, init, lead, cfg.d_model)
    p["ffn"] = _init_dense_ffn(cfg, init, lead)
    return p


def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter tree (same leaf keys, shapes, dtypes),
    with weights drawn from ``generator`` (a seeded ``torch.Generator``
    on ``device``; seed 0 if None).  The draws differ from
    ``jax.random``'s: carry the reference's weights across with
    ``ps.runtime.tree_from_numpy`` to compare the two.  ``device="meta"``
    builds the shapes only."""
    _check_dense(cfg)
    dev = resolve_device(device)
    init = _Init(dev, generator)
    dt = cfg.torch_dtype
    params: Dict[str, Any] = {
        "embed": init.normal((cfg.padded_vocab, cfg.d_model),
                             cfg.d_model ** -0.5, dt),
        "final_norm": _norm_params(cfg, init, (), cfg.d_model),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init.normal((cfg.d_model, cfg.padded_vocab),
                                        cfg.d_model ** -0.5, dt)
    for i in range(cfg.first_k_dense):
        params[f"dense_layer_{i}"] = _init_layer(cfg, init)
    n_scan = cfg.n_layers - cfg.first_k_dense
    if n_scan > 0:
        params["layers"] = _init_layer(cfg, init, (n_scan,))
    return params


# ============================================================ forward pieces
def _attention_block(cfg: LMConfig, p, x, cos, sin, positions=None):
    """x: (B,S,d) -> (B,S,d). Training/prefill path."""
    s = x.shape[1]
    q = torch.einsum("bsd,dhe->bshe", x, p["w_q"])
    k = torch.einsum("bsd,dhe->bshe", x, p["w_k"])
    v = torch.einsum("bsd,dhe->bshe", x, p["w_v"])
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    if cfg.attn_chunk_k and s > cfg.attn_chunk_k:
        o = attn_lib.chunked_attention(q, k, v, causal=True,
                                       chunk_k=cfg.attn_chunk_k)
    else:
        o = attn_lib.full_attention(q, k, v, causal=True)
    return torch.einsum("bshe,hed->bsd", o, p["w_o"])


def _ffn_block(cfg: LMConfig, p, x):
    """Dense FFN on (B,S,d). Returns (out, aux_loss)."""
    if "ffn" not in p:
        raise _not_ported("the MoE FFN")
    f = p["ffn"]
    h = silu(x @ f["w_gate"]) * (x @ f["w_up"])
    return h @ f["w_down"], torch.zeros((), dtype=torch.float32,
                                        device=x.device)


def _layer_fn(cfg: LMConfig, p, x, cos, sin, positions=None):
    """One transformer block. Returns (x_out, aux_loss)."""
    if cfg.parallel_block:
        h = _apply_norm(cfg, p["ln1"], x)
        a = _attention_block(cfg, p["attn"], h, cos, sin, positions)
        f, aux = _ffn_block(cfg, p, h)
        return x + (a + f), aux
    a = _attention_block(cfg, p["attn"], _apply_norm(cfg, p["ln1"], x), cos,
                         sin, positions)
    x = x + a
    f, aux = _ffn_block(cfg, p, _apply_norm(cfg, p["ln2"], x))
    return x + f, aux


def _unstack(stacked) -> list:
    """The stacked ``(L, ...)`` layer tree as L per-layer trees.  One
    ``unbind`` per leaf, so the backward pass stacks the L gradients once
    instead of adding L zero-padded copies."""
    parts = {k: t.unbind(0) for k, t in tree_leaves_by_key(stacked).items()}
    n = len(next(iter(parts.values())))
    return [tree_with_leaves(stacked, {k: v[i] for k, v in parts.items()})
            for i in range(n)]


def forward_hidden(cfg: LMConfig, params, tokens) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """tokens: (B,S) -> hidden (B,S,d), total aux loss."""
    _check_dense(cfg)
    # The embedding gather.  ``F.embedding``'s backward sums repeated
    # tokens in a fixed order; an indexing gather's backward accumulates
    # them in parallel, in an order that changes from run to run.
    x = F.embedding(tokens.long(), params["embed"])
    cos, sin = rope_frequencies(cfg.head_dim, tokens.shape[1],
                                cfg.rope_theta, device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.first_k_dense):
        x, aux = _layer_fn(cfg, params[f"dense_layer_{i}"], x, cos, sin)
        aux_total = aux_total + aux
    if "layers" in params:
        for layer_p in _unstack(params["layers"]):
            if cfg.remat:
                x, aux = checkpoint(_layer_fn, cfg, layer_p, x, cos, sin,
                                    use_reentrant=False)
            else:
                x, aux = _layer_fn(cfg, layer_p, x, cos, sin)
            aux_total = aux_total + aux
    return _apply_norm(cfg, params["final_norm"], x), aux_total


def _unembed(cfg: LMConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def loss_fn(cfg: LMConfig, params, batch) -> torch.Tensor:
    """batch: {'tokens': (B,S), 'labels': (B,S)} -> scalar fp32 loss."""
    hidden, aux = forward_hidden(cfg, params, batch["tokens"])
    ce = chunked_softmax_xent(hidden, _unembed(cfg, params), batch["labels"],
                              chunk=min(cfg.loss_chunk, hidden.shape[1]),
                              real_vocab=cfg.vocab)
    return ce + aux


def make_train_step(cfg: LMConfig, optimizer, n_microbatches: int = 1,
                    grad_accum_dtype=torch.float32, grad_shardings=None):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {'params', 'opt'}; batch tokens (B,S).  With n_microbatches >
    1 the gradients accumulate in ``grad_accum_dtype`` over the
    microbatches (B must divide evenly) and the optimizer runs once.
    ``grad_shardings`` pins gradient layouts on a mesh in the reference;
    on one device there is nothing to pin and it must be None.
    """
    if grad_shardings is not None:
        raise ValueError("grad_shardings: the port runs on one device")
    grad_fn = value_and_grad(lambda p, b: loss_fn(cfg, p, b))

    def train_step(state, batch):
        params = state["params"]
        if n_microbatches == 1:
            loss, grads = grad_fn(params, batch)
        else:
            b = batch["tokens"].shape[0]
            mb = b // n_microbatches
            toks = batch["tokens"].reshape(n_microbatches, mb, -1)
            labs = batch["labels"].reshape(n_microbatches, mb, -1)
            acc = {k: torch.zeros(p.shape, dtype=grad_accum_dtype,
                                  device=p.device)
                   for k, p in tree_leaves_by_key(params).items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=toks.device)
            for i in range(n_microbatches):
                l, g = grad_fn(params, {"tokens": toks[i],
                                        "labels": labs[i]})
                loss = loss + l
                for k, gi in tree_leaves_by_key(g).items():
                    acc[k] += gi.to(grad_accum_dtype)
                del g
            loss = loss / n_microbatches
            grads = tree_with_leaves(
                params, {k: a / n_microbatches for k, a in acc.items()})
        new_params, new_opt = optimizer.step(params, grads, state["opt"])
        return {"params": new_params, "opt": new_opt}, {"loss": loss}

    return train_step


def make_serve_step(cfg: LMConfig):
    raise _not_ported("make_serve_step (KV-cache decode)")


def make_prefill(cfg: LMConfig):
    raise _not_ported("make_prefill")
