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

Under an activation-sharding context (``ps.act_sharding``) the hooks
below redistribute DTensors as the reference's ``act.constrain`` points
do, and ``moe_ffn_sharded`` is the reference's expert-parallel path: a
per-device region with an all-to-all over the ``model`` axis.
``moe_ffn_grouped_sharded`` is ``moe_ffn``'s grouped semantics in a
per-device region, for sequence-parallel tokens whose batch does not
divide the data axes.  With no context every hook returns its argument
and nothing changes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from ..ps import act_sharding as act
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
    pos_g = act.per_device(lambda i: expert_positions(i, e), (),
                           idx_g.reshape(g, tg * k)).reshape(g, tg, k)
    slot = torch.clamp(pos_g, max=capacity)  # overflow -> slot C (dropped)
    gidx = torch.arange(g, device=x.device)[:, None, None]

    # Dispatch: one index write of every (token, choice); the kept slots
    # are distinct, only slot C is written more than once.
    xg = act.constrain(x.reshape(g, tg, d), "dp", None, None)
    xg = xg.reshape(g, tg, 1, d).expand(g, tg, k, d)
    buf = torch.zeros((g, e, capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    buf = buf.index_put((gidx, idx_g, slot), xg)[:, :, :capacity]
    buf = act.constrain(buf, "dp", "tp", None, None)  # the EP exchange

    # Expert computation (SwiGLU), experts over "model".
    h = torch.einsum("gecd,edf->gecf", buf, params["w_gate"])
    h = act.constrain(h, "dp", "tp", None, None)
    u = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    out = torch.einsum("gecf,efd->gecd", silu(h) * u, params["w_down"])
    out = act.constrain(out, "dp", "tp", None, None)
    out = torch.cat([out, out.new_zeros((g, e, 1, d))], dim=2)
    out = act.constrain(out, "dp", None, None, None)  # back to group-local

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
        sh = act.constrain(sh, "dp", "tp")
        y = y + sh @ params["shared_down"]

    losses = cfg.aux_loss_coef * aux + cfg.router_z_coef * z
    return y, losses


def moe_ffn_sharded(x3d, params: dict, cfg: MoEConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over the context's mesh (the reference's
    production path); x3d (B, S, d) with B divisible by the data axes and
    E by the ``model`` axis.  Returns (y (B, S, d), aux losses scalar),
    both DTensors.

    Tokens stay in their sequence-parallel layout (B over the data axes,
    S over ``model`` where it divides).  Per device: routing on its own
    tokens, capacity dispatch into an (E, C_loc + 1, d) buffer, an
    all-to-all over ``model`` so that each rank receives the rows bound
    for its E/tp experts from every peer, the local expert products, the
    all-to-all back, and the gate-weighted combine.  Capacity is per
    device, ``C_loc = ceil(cf * t_loc * k / E)`` (the reference's
    ``-(-int(cf * t_loc * k) // E)``), not ``moe_ffn``'s per-group floor.
    The router's load-balance and z statistics are summed over the ranks
    that split the tokens.  The collectives are the autograd-capable
    functional ones, so training runs through it.  Where S does not
    divide by ``model`` (decode), every ``model`` rank routes the same
    tokens, as the reference's do; that path is forward only.
    """
    ctx = act._current()
    mesh = ctx["mesh"]
    names = ctx["all"]
    tp_dim = names.index(ctx["tp"][0])
    dp_dims = [names.index(a) for a in ctx["dp"]]
    n_tp = mesh.shape[tp_dim]
    x3d = act.as_dtensor(x3d, mesh)
    b, s, d = x3d.shape
    e, k = cfg.n_experts, cfg.top_k
    if e % n_tp:
        raise ValueError(f"experts {e} must divide the model axis {n_tp}")
    s_sharded = s % n_tp == 0
    split = dp_dims + ([tp_dim] if s_sharded else [])

    def pl(shard_dims_of: dict, default):
        out = [default] * mesh.ndim
        for md, p in shard_dims_of.items():
            out[md] = p
        return out

    tok = act.resolve(ctx, (b, s, d), ("dp", "tp" if s_sharded else None))
    x_loc = act.local_in(x3d, mesh, tok)
    router = act.local_in(params["router"], mesh,
                          [Replicate()] * mesh.ndim,
                          pl({md: Partial() for md in split}, Replicate()))
    w_pl = pl({tp_dim: Shard(0)}, Replicate())
    w_grad = pl({**{md: Partial() for md in dp_dims}, tp_dim: Shard(0)},
                Replicate())
    w_gate, w_up, w_down = (act.local_in(params[n], mesh, w_pl, w_grad)
                            for n in ("w_gate", "w_up", "w_down"))

    # Routing on this rank's tokens.
    bl, sl, _ = x_loc.shape
    t_loc = bl * sl
    x2 = x_loc.reshape(t_loc, d)
    gates, idx, aux, z = _route_on_ranks(x2, router, cfg, mesh, split,
                                         b * s)
    gates = gates.to(x2.dtype)

    # Dispatch into (E, C_loc + 1, d); overflow lands in slot C (dropped).
    cap = max(1, -(-int(cfg.capacity_factor * t_loc * k) // e))
    eid = idx.reshape(-1)
    pos = expert_positions(eid, e)
    slot = torch.clamp(pos, max=cap)
    x_rep = x2[:, None, :].expand(t_loc, k, d).reshape(-1, d)
    buf = x2.new_zeros((e, cap + 1, d)).index_put((eid, slot), x_rep)
    send = buf[:, :cap].reshape(n_tp, e // n_tp, cap, d).contiguous()

    # EP exchange: each peer gets its experts' rows; mine come back.
    group = (mesh, tp_dim)
    recv = funcol.wait_tensor(funcol.all_to_all_single_autograd(
        send, None, None, group))
    rows = recv.transpose(0, 1).reshape(e // n_tp, n_tp * cap, d)
    h = torch.einsum("ecd,edf->ecf", rows, w_gate)
    u = torch.einsum("ecd,edf->ecf", rows, w_up)
    out = torch.einsum("ecf,efd->ecd", silu(h) * u, w_down)
    back = out.reshape(e // n_tp, n_tp, cap, d).transpose(0, 1).contiguous()
    mine = funcol.wait_tensor(funcol.all_to_all_single_autograd(
        back, None, None, group)).reshape(e, cap, d)
    out_full = torch.cat([mine, mine.new_zeros((e, 1, d))], dim=1)

    picked = out_full[eid, slot].reshape(t_loc, k, d)
    y = torch.einsum("tk,tkd->td", gates, picked).reshape(bl, sl, d)
    y = act.local_out(y, mesh, tok, (b, s, d))

    if cfg.d_ff_shared > 0:
        y = y + _shared_experts(x3d, params)

    losses = cfg.aux_loss_coef * aux + cfg.router_z_coef * z
    return y, act.local_out(losses, mesh, [Replicate()] * mesh.ndim)


def _route_on_ranks(x2, router, cfg: MoEConfig, mesh, dims, n_tokens: int,
                    part=slice(None)):
    """``route`` of this rank's tokens ``x2`` (T, d): gates (float32) and
    expert ids (T, k), and the aux and z losses from the router
    statistics of ``x2[part]`` summed over the mesh dims ``dims``, whose
    ranks hold the ``n_tokens`` tokens' parts between them."""
    e = cfg.n_experts
    logits = x2.float() @ router.float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.normalize_gates:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    stats = torch.cat([
        probs[part].sum(0), F.one_hot(idx[part, 0], e).float().sum(0),
        torch.square(torch.logsumexp(logits[part], dim=-1)).sum()[None]])
    stats = act.sum_over(stats, mesh, dims) / float(n_tokens)
    return gates, idx, e * torch.sum(stats[e:2 * e] * stats[:e]), stats[2 * e]


def _shared_experts(x3d, params):
    """The shared experts on (B, S, d) DTensor tokens: the input gathered
    over its sequence first and the output reduce-scattered back to it
    (a DTensor matmul flattens B and S, forward and backward, which it
    cannot while S is split), the hidden over ``model``."""
    x3d = act.constrain(x3d, "dp", None, None)
    sh = silu(x3d @ params["shared_gate"]) * (x3d @ params["shared_up"])
    sh = act.constrain(sh, "dp", None, "tp")
    return act.constrain(sh @ params["shared_down"], "dp", "tp", None)


def moe_ffn_grouped_sharded(x3d, params: dict, cfg: MoEConfig,
                            n_groups: int = 1
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn(x3d.reshape(B * S, d), params, cfg, n_groups=n_groups)``
    over the context's mesh, for E divisible by the ``model`` axis.
    Returns (y (B, S, d), aux losses scalar), both DTensors.

    The path ``_ffn_block`` takes where the batch does not divide the data
    axes and the tokens are sequence-parallel over ``model``: DTensor
    cannot place ``moe_ffn``'s dispatch there (its expert products view a
    sharded dim).  In a per-device region every rank takes all the tokens,
    so the groups, their floor capacity, the routing, the slot ranks and
    the dropped set are ``moe_ffn``'s on the whole batch.  Each ``model``
    rank dispatches only the (token, choice) pairs bound for its E/tp
    experts (the rest into a dummy expert that is cut off), runs its
    experts and combines their rows: a sum pending over ``model``, which
    the caller's constraint reduce-scatters.  The data ranks repeat the
    work.  The router's statistics are summed over ``model`` from each
    rank's slice of the tokens, so the aux losses' gradient is split as
    the combine's is.  Values equal ``moe_ffn``'s at float tolerance (the
    combine's sum splits over the ranks)."""
    ctx = act._current()
    mesh = ctx["mesh"]
    tp_dim = ctx["all"].index(ctx["tp"][0])
    n_tp = mesh.shape[tp_dim]
    x3d = act.as_dtensor(x3d, mesh)
    b, s, d = x3d.shape
    e, k = cfg.n_experts, cfg.top_k
    if e % n_tp:
        raise ValueError(f"experts {e} must divide the model axis {n_tp}")
    t = b * s
    g = n_groups if t % n_groups == 0 else 1
    tg = t // g
    capacity = max(1, int(cfg.capacity_factor * tg * k / e))

    rep = [Replicate()] * mesh.ndim
    over_tp = list(rep)
    over_tp[tp_dim] = Partial()
    experts = list(rep)
    experts[tp_dim] = Shard(0)
    x2 = act.local_in(x3d, mesh, rep, over_tp).reshape(t, d)
    router = act.local_in(params["router"], mesh, rep, over_tp)
    w_gate, w_up, w_down = (act.local_in(params[n], mesh, experts)
                            for n in ("w_gate", "w_up", "w_down"))

    # Routing of every token, as moe_ffn's ``route``; the statistics of
    # this rank's slice of the tokens, summed over model.
    r = mesh.get_coordinate()[tp_dim]
    gates, idx, aux, z = _route_on_ranks(
        x2, router, cfg, mesh, [tp_dim], t,
        slice(r * t // n_tp, (r + 1) * t // n_tp))

    # Slot ranks per group over all k choices; this rank's experts only.
    e_loc = e // n_tp
    idx_g = idx.reshape(g, tg, k)
    gates_g = gates.reshape(g, tg, k)
    pos_g = expert_positions(idx_g.reshape(g, tg * k), e).reshape(g, tg, k)
    slot = torch.clamp(pos_g, max=capacity)
    mine = idx_g - r * e_loc
    mine = torch.where((mine >= 0) & (mine < e_loc), mine, e_loc)
    gidx = torch.arange(g, device=x2.device)[:, None, None]
    xg = x2.reshape(g, tg, 1, d).expand(g, tg, k, d)
    buf = x2.new_zeros((g, e_loc + 1, capacity + 1, d))
    buf = buf.index_put((gidx, mine, slot), xg)[:, :e_loc, :capacity]

    h = torch.einsum("gecd,edf->gecf", buf, w_gate)
    u = torch.einsum("gecd,edf->gecf", buf, w_up)
    out = torch.einsum("gecf,efd->gecd", silu(h) * u, w_down)
    out = F.pad(out, (0, 0, 0, 1, 0, 1))  # the dropped slot, the dummy

    gidx = gidx[:, :, 0]
    y = x2.new_zeros((g, tg, d))
    for j in range(k):
        y = y + (gates_g[:, :, j, None].to(x2.dtype)
                 * out[gidx, mine[:, :, j], slot[:, :, j]])
    y = act.local_out(y.reshape(b, s, d), mesh, over_tp, (b, s, d))
    y = act.constrain(y, "dp", "tp", None)

    if cfg.d_ff_shared > 0:
        y = y + _shared_experts(x3d, params)

    losses = cfg.aux_loss_coef * aux + cfg.router_z_coef * z
    return y, act.local_out(losses, mesh, rep)


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
