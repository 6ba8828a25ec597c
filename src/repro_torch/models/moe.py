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
``DeepSeekMoEConfig`` adds DeepSeek-V2's sequence-wise balance loss and
the experts one device holds, whose part ``_held_experts_ffn`` computes
(the reference has neither).

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
from typing import ClassVar, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from ..ps import act_sharding as act
from ..tracing import count, span
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
    # What ``DeepSeekMoEConfig`` sets; not fields here, so the config
    # compares field for field with the reference's.
    seq_aux: ClassVar[bool] = False
    experts_held: ClassVar[Optional[Tuple[int, int]]] = None

    @property
    def held(self) -> Tuple[int, int]:
        """(first, count) of the experts held here."""
        return self.experts_held or (0, self.n_experts)


@dataclass(frozen=True)
class DeepSeekMoEConfig(MoEConfig):
    """DeepSeek-V2's gate and balance loss, and the share of the experts
    one device of expert parallelism holds."""

    # The sequence-wise balance loss in place of the Switch-style one:
    # per sequence, each expert's share of the S * k choices over its
    # even share times its mean router probability, summed over experts,
    # averaged over sequences (weighted by aux_loss_coef).
    seq_aux: bool = False
    # (first, count): the experts this device holds, of all n_experts the
    # router scores; None holds them all.  See ``moe_ffn``.
    experts_held: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        if self.experts_held is not None:
            first, n = self.experts_held
            if not (0 <= first and 1 <= n and first + n <= self.n_experts):
                raise ValueError(f"experts_held {self.experts_held} must "
                                 f"lie within the {self.n_experts} experts")


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


def route(x, router_w, cfg: MoEConfig, n_seqs: int = 1):
    """Router: returns (gates (T,k) float32, idx (T,k) int64, aux_loss,
    z_loss).  ``x`` holds ``n_seqs`` sequences of T / n_seqs tokens one
    after another (the sequence-wise balance loss reads them)."""
    logits = x.float() @ router_w.float()  # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.normalize_gates:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    if cfg.seq_aux:
        aux = _seq_balance(probs, idx, cfg.n_experts, n_seqs)
    else:
        # Switch-style load-balance loss: E * sum_e f_e * P_e
        pe = probs.mean(0)  # (E,)
        fe = F.one_hot(idx[:, 0], cfg.n_experts).float().mean(0)
        aux = cfg.n_experts * torch.sum(fe * pe)
    z = (torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
         if cfg.router_z_coef else logits.new_zeros(()))
    return gates, idx, aux, z


def _seq_balance(probs, idx, e: int, n_seqs: int):
    """DeepSeek-V2's sequence-wise balance loss, before its coefficient:
    mean over sequences of sum_e ce_e * mean_t probs[t, e], where ce_e is
    expert e's count among the sequence's S * k choices over S * k / E."""
    t, k = idx.shape
    s = t // n_seqs
    hits = torch.zeros((n_seqs, e), dtype=torch.float32, device=idx.device)
    hits.scatter_add_(1, idx.reshape(n_seqs, s * k),
                      torch.ones((n_seqs, s * k), device=idx.device))
    ce = hits / (s * k / e)
    return (ce * probs.reshape(n_seqs, s, e).mean(1)).sum(1).mean()


def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig,
            capacity: Optional[int] = None, n_groups: int = 1,
            n_seqs: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (y (T, d), aux losses scalar float32).

    Tokens are split into ``n_groups`` groups (one if ``n_groups`` does
    not divide T), each with its own capacity C.  ``x`` holds ``n_seqs``
    sequences one after another (for ``cfg.seq_aux``).  With
    ``cfg.experts_held`` short of all the experts, ``_held_experts_ffn``
    computes this device's part.  While a profiler records in a
    ``tracing.counting`` block, the held experts' choices kept and
    dropped by capacity are counted (``moe.kept``, ``moe.dropped``)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = n_groups if t % n_groups == 0 else 1
    tg = t // g
    if capacity is None:
        capacity = max(1, int(cfg.capacity_factor * tg * k / e))

    with span("moe.route"):
        gates, idx, aux, z = route(x, params["router"], cfg, n_seqs)
    if cfg.held[1] < e:
        y = _held_experts_ffn(x, params, cfg, capacity, g, gates, idx)
    else:
        with span("moe.dispatch"):
            # Per-group slot positions within each expert queue, over
            # all k choices of the group's tokens.
            idx_g = idx.reshape(g, tg, k)
            gates_g = gates.reshape(g, tg, k)
            pos_g = act.per_device(lambda i: expert_positions(i, e), (),
                                   idx_g.reshape(g, tg * k)).reshape(g, tg, k)
            slot = torch.clamp(pos_g, max=capacity)  # overflow: slot C
            gidx = torch.arange(g, device=x.device)[:, None, None]
            count("moe.kept", lambda: (pos_g < capacity).sum())
            count("moe.dropped", lambda: (pos_g >= capacity).sum())

            # Dispatch: one index write of every (token, choice); the kept
            # slots are distinct, only slot C is written more than once.
            xg = act.constrain(x.reshape(g, tg, d), "dp", None, None)
            xg = xg.reshape(g, tg, 1, d).expand(g, tg, k, d)
            buf = torch.zeros((g, e, capacity + 1, d), dtype=x.dtype,
                              device=x.device)
            buf = buf.index_put((gidx, idx_g, slot), xg)[:, :, :capacity]
            buf = act.constrain(buf, "dp", "tp", None, None)  # the EP exchange

        with span("moe.experts"):
            # Expert computation (SwiGLU), experts over "model".
            h = torch.einsum("gecd,edf->gecf", buf, params["w_gate"])
            h = act.constrain(h, "dp", "tp", None, None)
            u = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
            out = torch.einsum("gecf,efd->gecd", silu(h) * u,
                               params["w_down"])
            out = act.constrain(out, "dp", "tp", None, None)
            out = torch.cat([out, out.new_zeros((g, e, 1, d))], dim=2)
            out = act.constrain(out, "dp", None, None, None)  # group-local

        with span("moe.combine"):
            # Combine: k gathers, gate-weighted, summed in x.dtype.
            gidx = gidx[:, :, 0]
            y = torch.zeros((g, tg, d), dtype=x.dtype, device=x.device)
            for j in range(k):
                y = y + (gates_g[:, :, j, None].to(x.dtype)
                         * out[gidx, idx_g[:, :, j], slot[:, :, j]])
            y = y.reshape(t, d)

    # Shared experts (always-on path, DeepSeek-style).
    if cfg.d_ff_shared > 0:
        with span("moe.shared"):
            sh = silu(x @ params["shared_gate"]) * (x @ params["shared_up"])
            sh = act.constrain(sh, "dp", "tp")
            y = y + sh @ params["shared_down"]

    losses = cfg.aux_loss_coef * aux
    if cfg.router_z_coef:
        losses = losses + cfg.router_z_coef * z
    return y, losses


def _held_experts_ffn(x, params, cfg: MoEConfig, capacity: int, g: int,
                      gates, idx):
    """The routed part of ``moe_ffn``'s output that the held experts give,
    as one device of expert parallelism computes it (no exchange): the
    slot ranks and the capacity are the whole layer's (each choice's rank
    is the number of earlier choices of its group, token-major, for the
    same expert), and only the held experts' kept choices are dispatched,
    computed and combined.  Every choice has a row of its own in one
    table: a kept one its expert's slot, any other a spare row of zeros,
    so the dispatch writes and the combine's backward adds into distinct
    rows (no sort, no host sync, deterministic)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    first, n_held = cfg.held
    tg = t // g
    with span("moe.dispatch"):
        choice = idx.reshape(g, tg * k)
        # (g, E, tg * k): a running count along each expert's row
        hits = choice[:, None, :] == torch.arange(e, device=x.device)[:, None]
        pos = hits.cumsum(2).gather(1, choice[:, None, :])[:, 0] - 1
        local = choice - first
        held = (local >= 0) & (local < n_held)
        kept = held & (pos < capacity)
        count("moe.kept", lambda: kept.sum())
        count("moe.dropped", lambda: held.sum() - kept.sum())
        n_cells = g * n_held * capacity
        group = torch.arange(g, device=x.device)[:, None]
        spare = torch.arange(g * tg * k, device=x.device).view(g, tg * k)
        cell = torch.where(kept, (group * n_held + local) * capacity + pos,
                           n_cells + spare).reshape(-1)
        rows = x[:, None, :].expand(t, k, d).reshape(t * k, d)
        buf = x.new_zeros((n_cells + t * k, d)).index_put((cell,), rows)
        buf = buf[:n_cells].view(g, n_held, capacity, d)
    with span("moe.experts"):
        out = (silu(buf @ params["w_gate"]) * (buf @ params["w_up"])
               ) @ params["w_down"]
    with span("moe.combine"):
        table = torch.cat([out.reshape(n_cells, d), out.new_zeros((t * k, d))])
        picked = table.index_select(0, cell).view(t, k, d)
        return torch.bmm(gates.to(x.dtype).view(t, 1, k), picked).view(t, d)


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
    dtype)``; the expert leaves hold ``cfg.experts_held``'s count."""
    scale_in = d_model ** -0.5
    e, f, held = cfg.n_experts, cfg.d_ff, cfg.held[1]
    p = {
        "router": normal(lead + (d_model, e), scale_in, torch.float32),
        "w_gate": normal(lead + (held, d_model, f), scale_in, dtype),
        "w_up": normal(lead + (held, d_model, f), scale_in, dtype),
        "w_down": normal(lead + (held, f, d_model), f ** -0.5, dtype),
    }
    if cfg.d_ff_shared > 0:
        fs = cfg.d_ff_shared
        p["shared_gate"] = normal(lead + (d_model, fs), scale_in, dtype)
        p["shared_up"] = normal(lead + (d_model, fs), scale_in, dtype)
        p["shared_down"] = normal(lead + (fs, d_model), fs ** -0.5, dtype)
    return p
