"""Decoder-only LM (``repro.models.transformer``): the five LM
architectures of the reference.

GQA with optional QKV bias, MLA compressed-KV attention with its
absorbed decode (deepseek-v2; with or without q compression), the MoE FFN
with shared experts (``models/moe.py``; granite-moe, deepseek-v2) after
``first_k_dense`` leading dense layers, RoPE (YaRN-scaled where the
config says, as DeepSeek-V2-Lite's; ``rope_tables`` builds every path's
tables), RMS/LayerNorm, the parallel attention+FFN block, tied or
separate unembedding, the layers kept as stacked ``(L,
...)`` leaves (the reference's ``lax.scan`` layout) and run one at a time
(remat through ``torch.utils.checkpoint`` when ``cfg.remat``),
microbatched gradient accumulation, the chunked cross-entropy, and
serving: the KV-cache decode step (``init_kv_cache``,
``make_serve_step``) and the inference prefill (``make_prefill``), whose
GQA attention runs through the flash attention kernel K7.  Parameters are
plain nested dicts with the reference's leaf keys, shapes and dtypes, so
weights carry across and ``build_flat_plan`` lays out both packages alike.

The reference's activation-sharding constraints sit at its points
(``act.constrain``: q/k/v/o, the FFN hidden, the residual stream, the
logits) and redistribute DTensors under ``act.activate(mesh)``; the MoE
FFN then takes the expert-parallel ``moe_ffn_sharded``.  With no
context each hook returns its argument after one thread-local read, and
the one-device paths are unchanged.  Matrix products are
``torch.einsum`` / ``@``, as the reference leaves them to XLA.  The
attention and FFN parts of a layer are spans (``repro_torch.tracing``):
``mla.proj``, ``attn.core``, ``attn.out``, ``ffn.dense`` and the MoE's
``moe.*``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, ClassVar, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..ps import act_sharding as act
from ..ps.sharding import spec_by_key
from ..tracing import span
from ..tree import tree_leaves, tree_leaves_by_key, tree_map
from ..tree import tree_with_leaves
from ..tree import value_and_grad
from . import attention as attn_lib
from .layers import (
    YaRN,
    apply_rope,
    chunked_softmax_xent,
    layer_norm,
    rms_norm,
    rope_frequencies,
    rope_row,
    silu,
    yarn_mscale,
)
from .moe import (MoEConfig, init_moe_params, moe_ffn, moe_ffn_grouped_sharded,
                  moe_ffn_sharded)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: Optional[int] = 1536  # None: q straight from x (V2-Lite)
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


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
    moe: Optional[MoEConfig] = None
    first_k_dense: int = 0  # leading layers use dense FFN even in MoE models
    mla: Optional[MLAConfig] = None
    dtype: str = "float32"
    remat: bool = True
    loss_chunk: int = 512
    attn_chunk_k: int = 0  # 0 -> full attention; >0 -> online-softmax chunks
    moe_capacity_factor_override: Optional[float] = None
    moe_groups: int = 1  # GShard-style dispatch groups
    # What ``YaRNLMConfig`` sets; not a field here, so the config compares
    # field for field with the reference's.
    rope_scaling: ClassVar[Optional[YaRN]] = None

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def rope_dim(self) -> int:
        """Width the RoPE tables are built at: MLA's ``qk_rope_dim``."""
        return self.mla.qk_rope_dim if self.mla else self.head_dim

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

    @property
    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        total = self.param_count
        if self.moe is None:
            return total
        m = self.moe
        per_expert = 3 * self.d_model * m.d_ff
        n_moe_layers = self.n_layers - self.first_k_dense
        inactive = n_moe_layers * (m.n_experts - m.top_k) * per_expert
        return total - inactive


@dataclass(frozen=True)
class YaRNLMConfig(LMConfig):
    """An ``LMConfig`` whose RoPE is YaRN-scaled (DeepSeek-V2-Lite's)."""

    rope_scaling: Optional[YaRN] = None


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
    if cfg.mla is not None:
        m = cfg.mla
        dqk = m.qk_nope_dim + m.qk_rope_dim
        r, rq = m.kv_lora_rank, m.q_lora_rank
        if rq is None:
            q = {"w_q": init.normal(lead + (d, hq, dqk), s, dt)}
        else:
            q = {"w_dq": init.normal(lead + (d, rq), s, dt),
                 "q_norm": init.full(lead + (rq,), 1.0, torch.float32),
                 "w_uq": init.normal(lead + (rq, hq, dqk), rq ** -0.5, dt)}
        return {
            **q,
            "w_dkv": init.normal(lead + (d, r), s, dt),
            "kv_norm": init.full(lead + (r,), 1.0, torch.float32),
            "w_kr": init.normal(lead + (d, m.qk_rope_dim), s, dt),
            "w_uk": init.normal(lead + (r, hq, m.qk_nope_dim), r ** -0.5, dt),
            "w_uv": init.normal(lead + (r, hq, m.v_head_dim), r ** -0.5, dt),
            "w_o": init.normal(lead + (hq, m.v_head_dim, d),
                               (hq * m.v_head_dim) ** -0.5, dt),
        }
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


def _init_layer(cfg: LMConfig, init: _Init, lead=(),
                dense: bool = False) -> Dict[str, Any]:
    """One block's params; with ``lead = (L,)`` L blocks stacked.  A
    dense block (or any block of a config without MoE) has the dense FFN,
    the others the MoE leaves."""
    p = {"ln1": _norm_params(cfg, init, lead, cfg.d_model),
         "attn": _init_attn(cfg, init, lead)}
    if not cfg.parallel_block:
        p["ln2"] = _norm_params(cfg, init, lead, cfg.d_model)
    if dense or cfg.moe is None:
        p["ffn"] = _init_dense_ffn(cfg, init, lead)
    else:
        p["moe"] = init_moe_params(init.normal, cfg.d_model, cfg.moe,
                                   cfg.torch_dtype, lead)
    return p


def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter tree (same leaf keys, shapes, dtypes),
    with weights drawn from ``generator`` (a seeded ``torch.Generator``
    on ``device``; seed 0 if None).  The draws differ from
    ``jax.random``'s: carry the reference's weights across with
    ``ps.runtime.tree_from_numpy`` to compare the two.  ``device="meta"``
    builds the shapes only."""
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
        params[f"dense_layer_{i}"] = _init_layer(cfg, init, dense=True)
    n_scan = cfg.n_layers - cfg.first_k_dense
    if n_scan > 0:
        params["layers"] = _init_layer(cfg, init, (n_scan,))
    return params


# ============================================================ forward pieces
# How the training/prefill path computes attention: "plain" is the
# reference's choice by config (chunked above ``attn_chunk_k``, else full);
# "flash" is the flash attention kernel K7 (forward only: the prefill).
# K7 computes one head dim for q, k and v, so MLA (q/k wider than v) has
# only the plain route.
ATTENTION = ("plain", "flash")


def _check_attention(cfg: LMConfig, attention: str) -> None:
    if attention not in ATTENTION:
        raise ValueError(f"attention must be one of {ATTENTION}, got "
                         f"{attention!r}")
    if attention == "flash" and cfg.mla is not None:
        raise ValueError("attention='flash': MLA's q/k and v head dims "
                         "differ and K7 takes one; MLA runs 'plain'")


def _plain_attention(cfg: LMConfig, q, k, v, scale=None):
    if cfg.attn_chunk_k and q.shape[1] > cfg.attn_chunk_k:
        return attn_lib.chunked_attention(q, k, v, causal=True,
                                          chunk_k=cfg.attn_chunk_k,
                                          scale=scale)
    return attn_lib.full_attention(q, k, v, causal=True, scale=scale)


def _heads_proj(x, w):
    """``einsum("bsd,dhe->bshe", x, w)``.  Under a mesh, heads that do
    not divide the model axis (GQA's kv heads) are projected on each
    device: the input at its data shard, the (small) weight whole, the
    output replicated over ``model``.  DTensor would shard the product's
    flat (heads x head dim) columns over ``model`` and then cannot split
    them into heads, in the forward or in the weight's gradient."""
    ctx = act._current()
    if ctx is None or not isinstance(x, DTensor) or \
            w.shape[1] % act.mesh_size(ctx, "tp") == 0:
        return torch.einsum("bsd,dhe->bshe", x, w)
    mesh = ctx["mesh"]
    rows = act.resolve(ctx, x.shape, ("dp",))
    x_loc = act.local_in(x, mesh, rows)
    w_loc = act.local_in(w, mesh, (Replicate(),) * mesh.ndim, tuple(
        Partial() if p.is_shard() else Replicate() for p in rows))
    y = torch.einsum("bsd,dhe->bshe", x_loc, w_loc)
    return act.local_out(y, mesh, rows, tuple(x.shape[:2]) + w.shape[1:])


def _out_proj(o, w_o):
    """``einsum("bshe,hed->bsd", o, w_o)``.  Under a mesh it is the
    row-parallel product on each device: o at its (data, heads) shard,
    w_o's matching heads with d whole, the result a pending sum over
    ``model`` that the caller's constraint reduce-scatters.  (A DTensor
    einsum would flatten the sharded batch and heads together.)"""
    ctx = act._current()
    if ctx is None or not isinstance(o, DTensor):
        return torch.einsum("bshe,hed->bsd", o, w_o)
    mesh, names = ctx["mesh"], ctx["all"]
    o_pl = act.resolve(ctx, o.shape, ("dp", None, "tp", None))
    tp = names.index(ctx["tp"][0])
    heads = o_pl[tp].is_shard()
    w_pl = tuple(Shard(0) if i == tp and heads else Replicate()
                 for i in range(mesh.ndim))
    w_grad = tuple(Partial() if o_pl[i].is_shard() and i != tp else w_pl[i]
                   for i in range(mesh.ndim))
    y = torch.einsum("bshe,hed->bsd", act.local_in(o, mesh, o_pl),
                     act.local_in(w_o, mesh, w_pl, w_grad))
    y_pl = tuple(Partial() if i == tp and heads else
                 (o_pl[i] if i != tp else Replicate())
                 for i in range(mesh.ndim))
    return act.local_out(y, mesh, y_pl, tuple(o.shape[:2]) + w_o.shape[2:])


def _attention_block(cfg: LMConfig, p, x, cos, sin, positions=None,
                     attention: str = "plain"):
    """x: (B,S,d) -> (B,S,d). Training/prefill path."""
    if cfg.mla is not None:
        return _mla_attention(cfg, p, x, cos, sin, positions)
    # Under a mesh the sequence-parallel input is gathered first (the SP
    # -> TP step GSPMD inserts in the reference).
    x = act.constrain(x, "dp", None, None)
    q, k, v = (_heads_proj(x, p[n]) for n in ("w_q", "w_k", "w_v"))
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    q = act.constrain(q, "dp", None, "tp", None)  # TP over query heads
    k = act.constrain(k, "dp", None, "tp", None)
    v = act.constrain(v, "dp", None, "tp", None)
    with span("attn.core"):
        if attention == "flash":
            o = attn_lib.flash_attention(q, k, v, causal=True)
        else:
            o = _plain_attention(cfg, q, k, v)
    o = act.constrain(o, "dp", None, "tp", None)
    with span("attn.out"):
        return _out_proj(o, p["w_o"])


def rope_tables(cfg: LMConfig, device, length: int = 0,
                position: Optional[int] = None):
    """The config's RoPE cos/sin tables (YaRN-scaled where it says) for
    positions [0, length), or a single row for ``position`` (decode):
    every path that rotates takes its tables here."""
    if position is not None:
        return rope_row(position, cfg.rope_dim, cfg.rope_theta,
                        device=device, scaling=cfg.rope_scaling)
    return rope_frequencies(cfg.rope_dim, length, cfg.rope_theta,
                            device=device, scaling=cfg.rope_scaling)


def _mla_scale(cfg: LMConfig) -> float:
    """MLA's softmax scale: ``(nope + rope) ** -0.5``, times YaRN's
    ``mscale(factor, mscale_all_dim) ** 2`` where the config scales."""
    m, y = cfg.mla, cfg.rope_scaling
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    if y is not None and y.mscale_all_dim:
        scale = scale * yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def _mla_q(cfg: LMConfig, p, x):
    """MLA's queries (B,S,H,nope+rope): through the low-rank projection
    and its norm, or straight from x where ``q_lora_rank`` is None."""
    if cfg.mla.q_lora_rank is None:
        return (x @ p["w_q"].flatten(-2)).unflatten(-1, p["w_q"].shape[-2:])
    cq = rms_norm(x @ p["w_dq"], p["q_norm"])
    return torch.einsum("bsr,rhe->bshe", cq, p["w_uq"])


def _mla_attention(cfg: LMConfig, p, x, cos, sin, positions=None):
    """MLA, un-absorbed (training and prefill): q through its low-rank
    projection (or straight from x), k/v expanded from the compressed
    latent, ``k_rope`` shared by all heads; scale ``_mla_scale``."""
    m = cfg.mla
    b, s, _ = x.shape
    # the sequence-parallel input gathered first, as the GQA path does (a
    # DTensor matmul flattens B and S, which it cannot while S is split)
    x = act.constrain(x, "dp", None, None)
    with span("mla.proj"):
        q = _mla_q(cfg, p, x)  # (B,S,H,nope+rope)
        q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim],
                                     dim=-1)
        # q's rope part and the shared k_rope (B,S,1,rope) rotated in one
        # call, as H + 1 heads
        rot = apply_rope(torch.cat([q_rope, (x @ p["w_kr"])[:, :, None, :]],
                                   dim=2), cos, sin, positions)
        q_rope, k_rope = rot[:, :, :cfg.n_heads], rot[:, :, cfg.n_heads:]

        ckv = rms_norm(x @ p["w_dkv"], p["kv_norm"])  # (B,S,r)
        k_nope = torch.einsum("bsr,rhe->bshe", ckv, p["w_uk"])
        v = torch.einsum("bsr,rhe->bshe", ckv, p["w_uv"])

        q_full = act.constrain(torch.cat([q_nope, q_rope], dim=-1),
                               "dp", None, "tp", None)
        k_full = act.constrain(torch.cat(
            [k_nope, k_rope.expand(b, s, cfg.n_heads, m.qk_rope_dim)],
            dim=-1), "dp", None, "tp", None)
        v = act.constrain(v, "dp", None, "tp", None)
    with span("attn.core"):
        o = _plain_attention(cfg, q_full, k_full, v, _mla_scale(cfg))
    with span("attn.out"):
        return _out_proj(o, p["w_o"])


def _ffn_block(cfg: LMConfig, p, x):
    """Dense or MoE FFN on (B,S,d). Returns (out, aux_loss)."""
    if "ffn" in p:
        f = p["ffn"]
        x = act.constrain(x, "dp", None, None)  # SP -> TP, as attention's
        with span("ffn.dense"):
            h = silu(x @ f["w_gate"]) * (x @ f["w_up"])
            h = act.constrain(h, "dp", None, "tp")  # TP over FFN hidden
            return h @ f["w_down"], torch.zeros((), dtype=torch.float32,
                                                device=x.device)
    b, s, d = x.shape
    cfg_moe = cfg.moe
    if cfg.moe_capacity_factor_override is not None:
        cfg_moe = dataclasses.replace(
            cfg_moe, capacity_factor=cfg.moe_capacity_factor_override)
    ctx = act._current()
    if ctx is not None and (cfg_moe.seq_aux or cfg_moe.experts_held):
        raise NotImplementedError("under a mesh the MoE runs all experts "
                                  "with the Switch-style balance loss")
    if (ctx is not None
            and cfg_moe.n_experts % act.mesh_size(ctx, "tp") == 0):
        if b % act.mesh_size(ctx, "dp") == 0:
            # SP-preserving all-to-all expert parallelism: tokens leave
            # their (dp, tp) shard only through the EP exchange.
            return moe_ffn_sharded(x, p["moe"], cfg_moe)
        if isinstance(x, DTensor) and s % act.mesh_size(ctx, "tp") == 0:
            # sequence-parallel tokens whose batch does not divide the
            # data axes: moe_ffn's groups in a per-device region
            return moe_ffn_grouped_sharded(x, p["moe"], cfg_moe,
                                           n_groups=cfg.moe_groups)
    y, aux = moe_ffn(x.reshape(b * s, d), p["moe"], cfg_moe,
                     n_groups=cfg.moe_groups, n_seqs=b)
    return y.reshape(b, s, d), aux


def _layer_fn(cfg: LMConfig, p, x, cos, sin, positions=None,
              attention: str = "plain"):
    """One transformer block. Returns (x_out, aux_loss)."""
    if cfg.parallel_block:
        h = _apply_norm(cfg, p["ln1"], x)
        a = _attention_block(cfg, p["attn"], h, cos, sin, positions,
                             attention)
        f, aux = _ffn_block(cfg, p, h)
        return x + act.constrain(a + f, "dp", "tp", None), aux
    a = _attention_block(cfg, p["attn"], _apply_norm(cfg, p["ln1"], x), cos,
                         sin, positions, attention)
    x = x + act.constrain(a, "dp", "tp", None)
    f, aux = _ffn_block(cfg, p, _apply_norm(cfg, p["ln2"], x))
    return x + act.constrain(f, "dp", "tp", None), aux


def _unstack(stacked) -> list:
    """The stacked ``(L, ...)`` layer tree as L per-layer trees.  One
    ``unbind`` per leaf, so the backward pass stacks the L gradients once
    instead of adding L zero-padded copies.  Under a mesh a leaf sharded
    along L is gathered first (``act.whole_dim``)."""
    parts = {k: act.whole_dim(t, 0).unbind(0)
             for k, t in tree_leaves_by_key(stacked).items()}
    n = len(next(iter(parts.values())))
    return [tree_with_leaves(stacked, {k: v[i] for k, v in parts.items()})
            for i in range(n)]


def forward_hidden(cfg: LMConfig, params, tokens, attention: str = "plain"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B,S) -> hidden (B,S,d), total aux loss.  ``attention``
    picks the attention of every layer (see ``ATTENTION``); remat applies
    only where autograd records the forward, and not under a
    ``torch.func`` transform (the service engines' ``grad_and_value``),
    which ``torch.utils.checkpoint`` does not support."""
    _check_attention(cfg, attention)
    # The embedding gather.  ``F.embedding``'s backward sums repeated
    # tokens in a fixed order; an indexing gather's backward accumulates
    # them in parallel, in an order that changes from run to run.
    x = F.embedding(tokens.long(), _embed_table(cfg, params))
    x = act.constrain(x, "dp", "tp", None)  # sequence-parallel residual
    cos, sin = rope_tables(cfg, x.device, tokens.shape[1])
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.first_k_dense):
        x, aux = _layer_fn(cfg, params[f"dense_layer_{i}"], x, cos, sin,
                           attention=attention)
        x = act.constrain(x, "dp", "tp", None)
        aux_total = aux_total + aux
    if "layers" in params:
        remat = (cfg.remat and torch.is_grad_enabled()
                 and not torch._C._are_functorch_transforms_active())
        for layer_p in _unstack(params["layers"]):
            x = act.constrain(x, "dp", "tp", None)
            if remat:
                x, aux = checkpoint(_layer_fn, cfg, layer_p, x, cos, sin,
                                    None, attention, use_reentrant=False)
            else:
                x, aux = _layer_fn(cfg, layer_p, x, cos, sin,
                                   attention=attention)
            aux_total = aux_total + aux
    return _apply_norm(cfg, params["final_norm"], x), aux_total


def _embed_table(cfg: LMConfig, params):
    """The embedding table; a tied one under a mesh with its gradient
    pinned to its layout at each of its two uses (``act.pin_grad``)."""
    if cfg.tie_embeddings:
        return act.pin_grad(params["embed"])
    return params["embed"]


def _unembed(cfg: LMConfig, params):
    return (_embed_table(cfg, params).T if cfg.tie_embeddings
            else params["unembed"])


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
    ``grad_shardings`` (a params-shaped tree of DTensor placement tuples,
    or None) pins the gradients and the accumulator of DTensor params to
    those placements: needed where parameters replicate along an axis
    (EP expert weights) but gradients must stay sharded (ZeRO-1).
    """
    grad_fn = value_and_grad(lambda p, b: loss_fn(cfg, p, b))
    pins = None if grad_shardings is None else spec_by_key(grad_shardings)

    def pin(grads):
        if pins is None:
            return grads
        return tree_with_leaves(grads, {
            k: (g.redistribute(g.device_mesh, pins[k])
                if isinstance(g, DTensor) and g.placements != pins[k]
                else g)
            for k, g in tree_leaves_by_key(grads).items()})

    def train_step(state, batch):
        params = state["params"]
        if n_microbatches == 1:
            loss, grads = grad_fn(params, batch)
            grads = pin(grads)
        else:
            b = batch["tokens"].shape[0]
            mb = b // n_microbatches
            acc = tree_leaves_by_key(pin(tree_map(
                lambda p: torch.zeros_like(p, dtype=grad_accum_dtype),
                params)))
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(n_microbatches):
                # rows i*mb onwards (a slice, not a reshape: a DTensor
                # cannot unflatten a batch sharded wider than the count)
                l, g = grad_fn(params, {
                    k: act.constrain(batch[k][i * mb:(i + 1) * mb], "dp",
                                     None) for k in ("tokens", "labels")})
                loss = loss + l
                for k, gi in tree_leaves_by_key(pin(g)).items():
                    acc[k] += gi.to(grad_accum_dtype)
                del g
            loss = loss / n_microbatches
            grads = tree_with_leaves(
                params, {k: a / n_microbatches for k, a in acc.items()})
        new_params, new_opt = optimizer.step(params, grads, state["opt"])
        return {"params": new_params, "opt": new_opt}, {"loss": loss}

    return train_step


# ================================================================= serving
def _inference():
    """``torch.inference_mode()``; ``no_grad()`` under a mesh context,
    since DTensor cannot run on inference tensors."""
    return torch.no_grad() if act.enabled() else torch.inference_mode()


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int,
                  device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's cache tree, zeroed, in the model's dtype: ``{"scan":
    {"k", "v"}: (L, B, max_len, HK, Dh)}``, or for MLA the compressed
    latent ``{"ckv": (L, B, max_len, kv_lora_rank), "k_rope": (L, B,
    max_len, qk_rope_dim)}``, plus ``"dense"`` for the leading dense
    layers, and ``"length"``, the number of valid positions, a host int
    (the reference's int32 scalar)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    if cfg.mla is not None:
        widths = {"ckv": (cfg.mla.kv_lora_rank,),
                  "k_rope": (cfg.mla.qk_rope_dim,)}
    else:
        widths = {name: (cfg.n_kv_heads, cfg.head_dim)
                  for name in ("k", "v")}

    def mk(n_layers):
        return {name: torch.zeros((n_layers, batch, max_len) + w, dtype=dt,
                                  device=dev)
                for name, w in widths.items()}

    cache: Dict[str, Any] = {"scan": mk(cfg.n_layers - cfg.first_k_dense)}
    if cfg.first_k_dense:
        cache["dense"] = mk(cfg.first_k_dense)
    cache["length"] = 0
    return cache


def _decode_attn_gqa(cfg, p, x, cache_len: int, cos, sin, cache_k, cache_v):
    """x: (B,1,d); caches (B,Smax,HK,Dh), written in place at position
    ``cache_len``.  Returns the attention output (B,1,d).  cos/sin are
    single-row tables for the current position (index 0)."""
    pos = torch.zeros((x.shape[0], 1), dtype=torch.long, device=x.device)
    q, k, v = (_heads_proj(x, p[n]) for n in ("w_q", "w_k", "w_v"))
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = apply_rope(q, cos, sin, pos)
    k = apply_rope(k, cos, sin, pos)
    cache_k[:, cache_len:cache_len + 1] = k
    cache_v[:, cache_len:cache_len + 1] = v
    o = attn_lib.decode_attention(q, cache_k, cache_v, cache_len + 1)
    return _out_proj(o, p["w_o"])


def _decode_attn_mla(cfg, p, x, cache_len: int, cos, sin, cache_ckv,
                     cache_kr):
    """MLA absorbed decode: attention in the latent space, no k/v
    expansion.  x: (B,1,d); caches (B,Smax,r) and (B,Smax,rope), written
    in place at ``cache_len``.  W_uk is absorbed into q (scores =
    (q_nope W_uk^T) . ckv + q_rope . k_rope) and W_uv applied after the
    softmax-weighted latent sum.  Returns (B,1,d)."""
    m = cfg.mla
    b = x.shape[0]
    pos = torch.zeros((b, 1), dtype=torch.long, device=x.device)
    q = _mla_q(cfg, p, x)[:, 0]  # (B,H,nope+rope)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope[:, None], cos, sin, pos)[:, 0]

    ckv_new = rms_norm(x @ p["w_dkv"], p["kv_norm"])  # (B,1,r)
    kr_new = apply_rope((x @ p["w_kr"])[:, :, None, :], cos, sin,
                        pos)[:, :, 0]  # (B,1,rope)
    cache_ckv[:, cache_len:cache_len + 1] = ckv_new
    cache_kr[:, cache_len:cache_len + 1] = kr_new

    q_lat = torch.einsum("bhe,rhe->bhr", q_nope, p["w_uk"])  # (B,H,r)
    scale = _mla_scale(cfg)
    s = (torch.einsum("bhr,bkr->bhk", q_lat, cache_ckv)
         + torch.einsum("bhe,bke->bhk", q_rope, cache_kr)).float() * scale
    valid = torch.arange(cache_ckv.shape[1], device=x.device) < cache_len + 1
    s = torch.where(valid[None, None], s, attn_lib.NEG_INF)
    pr = torch.softmax(s, dim=-1).to(cache_ckv.dtype)
    o_lat = torch.einsum("bhk,bkr->bhr", pr, cache_ckv)  # (B,H,r)
    o = torch.einsum("bhr,rhe->bhe", o_lat, p["w_uv"])  # (B,H,v_dim)
    if isinstance(o, DTensor):  # the row-parallel product per device
        return _out_proj(o[:, None], p["w_o"])
    return torch.einsum("bhe,hed->bd", o, p["w_o"])[:, None]


def make_serve_step(cfg: LMConfig):
    """decode: (params, cache, tokens (B,1)) -> (logits (B,V) float32, the
    same cache tree with ``length`` advanced).  The new position's cache
    entries (k and v, or MLA's ckv and k_rope) are written in place."""
    if cfg.mla is not None:
        decode_attn, names = _decode_attn_mla, ("ckv", "k_rope")
    else:
        decode_attn, names = _decode_attn_gqa, ("k", "v")

    def serve_step(params, cache, tokens):
        length = int(cache["length"])
        if length >= cache["scan"][names[0]].shape[2]:
            raise ValueError(f"KV cache full ({length} positions)")
        with _inference():
            x = F.embedding(tokens.long(), params["embed"])  # (B,1,d)
            # reduce a vocab-sharded lookup at once, as forward_hidden does
            x = act.constrain(x, "dp", "tp", None)
            cos, sin = rope_tables(cfg, x.device, position=length)

            def run_layer(p, x, layer_cache):
                # under a mesh each block's pending sum is reduced before
                # the residual add, as _layer_fn's constraints do
                h = _apply_norm(cfg, p["ln1"], x)
                a = decode_attn(cfg, p["attn"], h, length, cos, sin,
                                *layer_cache)
                a = act.constrain(a, "dp", "tp", None)
                if cfg.parallel_block:
                    f, _ = _ffn_block(cfg, p, h)
                    return x + a + act.constrain(f, "dp", "tp", None)
                x = x + a
                f, _ = _ffn_block(cfg, p, _apply_norm(cfg, p["ln2"], x))
                return x + act.constrain(f, "dp", "tp", None)

            def layer_caches(group, i):
                return [cache[group][name][i] for name in names]

            for i in range(cfg.first_k_dense):
                x = run_layer(params[f"dense_layer_{i}"], x,
                              layer_caches("dense", i))
            if "layers" in params:
                for i, layer_p in enumerate(_unstack(params["layers"])):
                    x = run_layer(layer_p, x, layer_caches("scan", i))
            h = _apply_norm(cfg, params["final_norm"], x)
            logits = (h[:, 0] @ _unembed(cfg, params)).float()
        cache["length"] = length + 1
        return logits[:, :cfg.vocab], cache

    return serve_step


def make_prefill(cfg: LMConfig, attention: Optional[str] = None):
    """prefill: (params, tokens (B,S)) -> last-token logits (B,V) float32,
    the inference forward (no loss; the ``prefill_32k`` shape).  By
    default its attention is the flash attention kernel K7 where the
    config's attention is GQA, and the plain attention (chunked or full,
    as the config says) for MLA, whose q/k and v head dims differ while
    K7 takes one, as the reference runs jnp attention there.
    ``attention="plain"`` takes the training path's attention for
    comparison; ``"flash"`` on an MLA config raises ValueError."""
    if attention is None:
        attention = "plain" if cfg.mla is not None else "flash"
    _check_attention(cfg, attention)

    def prefill(params, tokens):
        with _inference():
            hidden, _ = forward_hidden(cfg, params, tokens,
                                       attention=attention)
            logits = (hidden[:, -1] @ _unembed(cfg, params)).float()
        return logits[:, :cfg.vocab]

    return prefill
