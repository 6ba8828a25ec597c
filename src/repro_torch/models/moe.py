"""Mixture-of-Experts FFN (``repro.models.moe``): token-choice top-k
routing with capacity-based, GShard-style grouped dispatch, plain PyTorch.

The semantics are the reference's ``moe_ffn``, the path it takes on one
device with no mesh: per group a floor capacity ``max(1, int(cf * tg * k
/ E))``, slot ranks from a stable sort over all k choices of the group's
tokens (token-major), overflow into slot C, which is dropped, and a
gate-weighted combine summed over the k choices in ``x.dtype``.  The
reference scatter-adds into an ``(g, E, C + 1, d)`` buffer; every kept
(group, expert, slot) is written exactly once, since the ranks are
distinct, and only the dropped slot C ever sums.  So one index write of
all k choices gives the same buffer, with no accumulation, which keeps it
deterministic on CUDA.  The expert products are ``torch.einsum``, as the
reference leaves them to XLA; nothing here is a kernel of its own.

The expert-parallel ``moe_ffn_sharded`` (``shard_map`` over a mesh) is
not ported (ROADMAP.md, Queue 1 item 16).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import silu


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden width
    n_shared: int = 0
    d_ff_shared: int = 0  # total shared-expert hidden width (= n_shared * d_ff usually)
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_z_coef: float = 1e-3
    normalize_gates: bool = True  # DeepSeek/Mixtral renormalize top-k probs


def expert_positions(eid: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Position of each slot within its expert's queue, preserving slot
    order.  ``eid``: (..., N) integer expert ids; returns the ranks, same
    shape and dtype (a stable sort and exclusive segment starts along the
    last axis)."""
    n = eid.shape[-1]
    order = torch.argsort(eid, dim=-1, stable=True)
    sorted_eid = torch.gather(eid, -1, order).long()
    counts = torch.zeros(eid.shape[:-1] + (n_experts,), dtype=torch.long,
                         device=eid.device)
    counts.scatter_add_(-1, eid.long(), torch.ones_like(sorted_eid))
    starts = torch.cumsum(counts, -1) - counts  # exclusive
    rank_sorted = (torch.arange(n, device=eid.device)
                   - torch.gather(starts, -1, sorted_eid))
    return torch.empty_like(eid).scatter_(-1, order,
                                          rank_sorted.to(eid.dtype))


def route(x, router_w, cfg: MoEConfig):
    """Router: returns (gates (T,k) float32, idx (T,k) int64, aux_loss,
    z_loss)."""
    logits = x.float() @ router_w.float()  # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.normalize_gates:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    pe = probs.mean(0)  # (E,)
    fe = F.one_hot(idx[:, 0], cfg.n_experts).float().mean(0)
    aux = cfg.n_experts * torch.sum(fe * pe)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return gates, idx, aux, z


def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig,
            capacity: Optional[int] = None, n_groups: int = 1
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (y (T, d), aux losses scalar float32).

    Tokens are split into ``n_groups`` groups (one if ``n_groups`` does
    not divide T), each with its own capacity C."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = n_groups if t % n_groups == 0 else 1
    tg = t // g
    if capacity is None:
        capacity = max(1, int(cfg.capacity_factor * tg * k / e))

    gates, idx, aux, z = route(x, params["router"], cfg)

    # Per-group slot positions within each expert queue, over all k
    # choices of the group's tokens.
    idx_g = idx.reshape(g, tg, k)
    gates_g = gates.reshape(g, tg, k)
    pos_g = expert_positions(idx_g.reshape(g, tg * k), e).reshape(g, tg, k)
    slot = torch.clamp(pos_g, max=capacity)  # overflow -> slot C (dropped)
    gidx = torch.arange(g, device=x.device)[:, None, None]

    # Dispatch: one index write of every (token, choice); the kept slots
    # are distinct, only slot C is written more than once.
    xg = x.reshape(g, tg, 1, d).expand(g, tg, k, d)
    buf = torch.zeros((g, e, capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    buf = buf.index_put((gidx, idx_g, slot), xg)[:, :, :capacity]

    # Expert computation (SwiGLU).
    h = torch.einsum("gecd,edf->gecf", buf, params["w_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    out = torch.einsum("gecf,efd->gecd", silu(h) * u, params["w_down"])
    out = torch.cat([out, out.new_zeros((g, e, 1, d))], dim=2)

    # Combine: k gathers, gate-weighted, summed in x.dtype.
    gidx = gidx[:, :, 0]
    y = torch.zeros((g, tg, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + (gates_g[:, :, j, None].to(x.dtype)
                 * out[gidx, idx_g[:, :, j], slot[:, :, j]])
    y = y.reshape(t, d)

    # Shared experts (always-on path, DeepSeek-style).
    if cfg.d_ff_shared > 0:
        sh = silu(x @ params["shared_gate"]) * (x @ params["shared_up"])
        y = y + sh @ params["shared_down"]

    losses = cfg.aux_loss_coef * aux + cfg.router_z_coef * z
    return y, losses


def init_moe_params(normal, d_model: int, cfg: MoEConfig, dtype,
                    lead=()) -> dict:
    """The reference's MoE leaves (``init_moe_params``: same keys, shapes
    and dtypes, ``router`` float32 whatever ``dtype``), each prefixed by
    ``lead`` (the stacked layers), drawn by ``normal(shape, scale,
    dtype)``."""
    scale_in = d_model ** -0.5
    e, f = cfg.n_experts, cfg.d_ff
    p = {
        "router": normal(lead + (d_model, e), scale_in, torch.float32),
        "w_gate": normal(lead + (e, d_model, f), scale_in, dtype),
        "w_up": normal(lead + (e, d_model, f), scale_in, dtype),
        "w_down": normal(lead + (e, f, d_model), f ** -0.5, dtype),
    }
    if cfg.d_ff_shared > 0:
        fs = cfg.d_ff_shared
        p["shared_gate"] = normal(lead + (d_model, fs), scale_in, dtype)
        p["shared_up"] = normal(lead + (d_model, fs), scale_in, dtype)
        p["shared_down"] = normal(lead + (fs, d_model), fs ** -0.5, dtype)
    return p
