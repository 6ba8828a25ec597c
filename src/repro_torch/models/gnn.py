"""GIN (``repro.models.gnn``): the Graph Isomorphism Network
(arXiv:1810.00826) with sum aggregation, for node classification
(full-graph and sampled-subgraph training) and graph classification
(batched small graphs, sum readout).

Message passing is a segment sum, ``agg[i] = sum_{(j->i) in E} h[j]``:
the reference's ``jax.ops.segment_sum(h[src], dst, N)`` (SpMM by
scatter; it has no Pallas kernel).  Here it is :class:`Aggregation`, a
``torch.autograd.Function`` over two orders of the edge list built once
per graph on its device:

  * forward, the sources of each node's in-edges in **dst-sorted** order
    (a stable sort, so each node keeps its edges' order), their rows
    gathered and summed per node;
  * backward, the gradient of ``h`` is a sum over each node's out-edges:
    the same over the **src-sorted** order.

No step scatters with atomics.  ``index_add_``, ``scatter_add_`` and the
backward of ``h[src]`` sum in an order that changes from run to run on
CUDA, so two identical steps would give different gradients; here they
agree bit for bit (``recsys._dense_grad`` is the same pattern).  The
gather and the sum are one ``F.embedding_bag(mode="sum")`` over the
sorted index, whose kernel sums each (bag, column) in order from zero
in one thread: ``index_select`` of the E message rows followed by
``torch.segment_reduce`` over the same bags gives the same bits, but
holds an (E, d) tensor (15.8 GB at ogb_products' d 64) and took 3.4x
as long on the H100 (``chip_smoke.py`` phase u times both).  A
power-law graph has very long segments (node 0 of ``ogb_products``
takes ~1.1 % of all edges, ~0.68 M), which one thread a column would
sum alone, so a segment longer than ``chunk`` rows is summed as bags of
``chunk`` rows, then each segment's bags in order by
``torch.segment_reduce``: still a fixed order.  With no segment longer
than ``chunk`` it is one sum, equal to ``index_add_`` of the messages
in edge order on the CPU bit for bit.

Masked edges (``edge_mask`` False) are left out of both orders.  The
reference multiplies their messages by 0, so each adds an exact +-0 to
its node's sum: leaving it out changes no bit but a zero's sign.

The graph readout is the same :class:`Aggregation` with ``src`` the node
ids and ``dst`` the graph ids.  :func:`with_aggregation` builds a
batch's plans once, so a full-graph step that reuses its batch sorts the
edges once in all; without them each forward builds its own.

Under an activation-sharding context (``ps.act_sharding``) with DTensor
inputs, the mesh dry-run's cells, a plan cannot be built: its sorts and
its dropping of masked edges need values, which ``meta`` tensors lack.
There the aggregation is the reference's static-shape form in a
per-device region over each rank's edge shard (:class:`MeshAggregation`:
``h[src]`` with ``h`` whole, ``index_add`` into zeros, a masked edge
into a row that is cut off, the pending sum over the edge-splitting
ranks reduced to ``h``'s layout), and the readout the same over each
rank's node rows (:func:`mesh_readout`).  Autograd gives their
backward.  ``index_add`` sums in an order of its own on CUDA, so on the
card this branch matches the one-device plan at float tolerance, not
bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..device import resolve_device
from ..ps import act_sharding as act
from ..tree import (array_to_tensor, tree_leaves_by_key, tree_with_leaves,
                    value_and_grad)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
AGG_CHUNK = 256  # rows a first-level partial sum covers at most


@dataclass(frozen=True)
class GINConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 64
    d_feat: int = 1433
    n_classes: int = 7
    learnable_eps: bool = True  # eps=learnable per the assigned config
    task: str = "node"  # "node" | "graph"
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


# ---------------------------------------------------------------- init
def init_params(cfg: GINConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    """The reference's tree: ``layers``, a list of ``{w1, b1, w2, b2,
    eps}`` (``eps`` a 0-d float32), then ``head_w`` and ``head_b``; the
    weights ``d_in ** -0.5`` x N(0, 1) from ``generator`` (seed 0 if
    None) on ``device`` (the card unless ``"cpu"``; ``"meta"``: shapes
    only).  The draws differ from ``jax.random``'s: carry the
    reference's weights across with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    if dev.type != "meta" and generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    def normal(shape, scale):
        if dev.type == "meta":
            return torch.empty(shape, dtype=dt, device=dev)
        x = torch.randn(shape, generator=generator, device=dev)
        return x.mul_(scale).to(dt)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    layers, d_in = [], cfg.d_feat
    for _ in range(cfg.n_layers):
        layers.append({
            "w1": normal((d_in, cfg.d_hidden), d_in ** -0.5),
            "b1": zeros(cfg.d_hidden),
            "w2": normal((cfg.d_hidden, cfg.d_hidden), cfg.d_hidden ** -0.5),
            "b2": zeros(cfg.d_hidden),
            "eps": zeros(dtype=torch.float32),
        })
        d_in = cfg.d_hidden
    return {"layers": layers,
            "head_w": normal((cfg.d_hidden, cfg.n_classes),
                             cfg.d_hidden ** -0.5),
            "head_b": zeros(cfg.n_classes)}


def params_from_numpy(cfg: GINConfig, arrays, device=None) -> Dict:
    """The reference's parameters (numpy or jax arrays) as the port's
    tree on ``device``, bit for bit, by the shared leaf keys; raises if a
    key, shape or dtype differs from ``cfg``'s tree."""
    dev = resolve_device(device)
    want = tree_leaves_by_key(init_params(cfg, device="meta"))
    got = {k: array_to_tensor(v)
           for k, v in tree_leaves_by_key(arrays).items()}
    if set(got) != set(want):
        raise ValueError(f"leaf keys differ: {sorted(set(got) ^ set(want))}")
    for k, t in got.items():
        if t.shape != want[k].shape or t.dtype != want[k].dtype:
            raise ValueError(f"{k}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(want[k].shape)} {want[k].dtype}")
    return tree_with_leaves(init_params(cfg, device="meta"),
                            {k: t.to(dev) for k, t in got.items()})


# -------------------------------------------------------- the segment sum
class _Segments:
    """``out[s] = sum of x[gather[j]]`` over the ``j`` whose key is
    ``s``, in ``j``'s order: the gather index in key-sorted order, the
    offsets of its bags (a segment longer than ``chunk`` split into
    bags of ``chunk``) and, with long segments, the offsets of each
    segment's bags."""

    def __init__(self, keys: torch.Tensor, gather: torch.Tensor, n: int,
                 chunk: int):
        dev = keys.device
        sorted_keys, order = torch.sort(keys.long(), stable=True)
        self.rows = gather.long()[order]
        bounds = torch.searchsorted(sorted_keys,
                                    torch.arange(n + 1, device=dev))
        del sorted_keys, order
        # Each segment as ceil(length / chunk) bags (an empty one as one
        # empty bag); the second sum adds each segment's bags.
        n_chunks = torch.clamp((bounds[1:] - bounds[:-1] + chunk - 1)
                               // chunk, min=1)
        total = int(n_chunks.sum())
        if total == n:  # no segment longer than chunk: one sum
            self.offsets, self.chunk_offsets = bounds, None
            return
        first = torch.cumsum(n_chunks, 0) - n_chunks
        seg = torch.repeat_interleave(torch.arange(n, device=dev), n_chunks,
                                      output_size=total)
        starts = bounds[:-1][seg] + (torch.arange(total, device=dev)
                                     - first[seg]) * chunk
        self.offsets = torch.cat([starts, bounds[-1:]])
        self.chunk_offsets = torch.cat([first, bounds.new_tensor([total])])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        # Each bag's rows gathered and summed in order, from zero, by one
        # thread a column: no (E, d) message tensor, no atomics.
        out = F.embedding_bag(self.rows, x, self.offsets, mode="sum",
                              include_last_offset=True)
        if self.chunk_offsets is not None:
            out = torch.segment_reduce(out, "sum", offsets=self.chunk_offsets,
                                       axis=0, unsafe=True)
        return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, agg):
        ctx.agg = agg
        return agg.by_dst(h.contiguous())

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        return ctx.agg.by_src(grad.contiguous()), None


class Aggregation:
    """``out[i] = sum over edges (j -> i) of h[j]`` for ``h`` of ``n_in``
    rows, ``out`` of ``n_out`` (the reference's ``segment_sum(h[src],
    dst, n_out)``), deterministic in both directions; edges whose
    ``mask`` is False left out.  Built once from the edge list on its
    device (two stable sorts, a host sync), called on any ``h`` of that
    graph."""

    def __init__(self, src, dst, n_out: int, n_in: Optional[int] = None,
                 mask=None, chunk: int = AGG_CHUNK):
        n_in = n_out if n_in is None else n_in
        src, dst = torch.as_tensor(src), torch.as_tensor(dst)
        if mask is not None:
            keep = torch.as_tensor(mask, device=src.device).bool()
            src, dst = src[keep], dst[keep]
        for name, ids, n in (("src", src, n_in), ("dst", dst, n_out)):
            if ids.numel() and not 0 <= int(ids.min()) <= int(ids.max()) < n:
                raise ValueError(f"edge {name} ids outside [0, {n})")
        self.n_in = n_in
        self.by_dst = _Segments(dst, src, n_out, chunk)  # forward
        self.by_src = _Segments(src, dst, n_in, chunk)  # backward

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        if h.shape[0] != self.n_in:
            raise ValueError(f"h has {h.shape[0]} rows, the graph "
                             f"{self.n_in} nodes")
        return _SegmentSum.apply(h, self)


def readout(graph_ids, n_graphs: int) -> Aggregation:
    """The sum readout ``segment_sum(h, graph_ids, n_graphs)``."""
    graph_ids = torch.as_tensor(graph_ids)
    nodes = torch.arange(graph_ids.shape[0], device=graph_ids.device)
    return Aggregation(nodes, graph_ids, n_graphs, n_in=graph_ids.shape[0])


# ------------------------------------------------------ the mesh branch
def _on_mesh(x) -> bool:
    return act._current() is not None and isinstance(x, DTensor)


class _GatherAdd(torch.autograd.Function):
    """``zeros(n, d).index_add(0, dst, h.index_select(0, src))`` on plain
    tensors; backward, the transposed sum ``zeros_like(h).index_add(0,
    src, grad.index_select(0, dst))``.  Only the edge ids are saved, not
    the (E, d) messages that ``index_add``'s own backward would keep."""

    @staticmethod
    def forward(ctx, h, src, dst, n: int):
        ctx.save_for_backward(src, dst)
        ctx.n_in = h.shape[0]
        return h.new_zeros((n, h.shape[1])).index_add_(
            0, dst, h.index_select(0, src))

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        src, dst = ctx.saved_tensors
        grad_h = grad.new_zeros((ctx.n_in, grad.shape[1])).index_add_(
            0, src, grad.index_select(0, dst))
        return grad_h, None, None, None


class MeshAggregation:
    """:class:`Aggregation`'s counterpart under an activation-sharding
    context: the reference's ``segment_sum(h[src] * mask, dst, n_out)``
    in a per-device region.  Each rank takes its shard of the edges (over
    every mesh axis where their count divides, else all of them), gathers
    their sources from ``h`` made whole and ``index_add``s them into an
    ``(n_out + 1, d)`` zero tensor, a masked edge into the extra row,
    which is cut off (:class:`_GatherAdd`: no (E, d) tensor outlives the
    forward or the backward).  That is a sum pending over the ranks that
    split the edges, which leaves the region reduced to ``h``'s own layout (a
    reduce-scatter where ``h``'s rows are sharded, an all-reduce where
    they are replicated)."""

    def __init__(self, src, dst, n_out: int, mask=None):
        self.src, self.dst, self.mask, self.n_out = src, dst, mask, n_out

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        ctx = act._current()
        mesh = ctx["mesh"]
        e_pl = act.resolve(ctx, self.src.shape, ("all",))
        split = tuple(Partial() if p.is_shard() else Replicate()
                      for p in e_pl)
        h_loc = act.local_in(h, mesh, (Replicate(),) * mesh.ndim, split)
        src = act.local_in(self.src, mesh, e_pl)
        dst = act.local_in(self.dst, mesh, e_pl)
        if self.mask is not None:
            dst = torch.where(act.local_in(self.mask, mesh, e_pl), dst,
                              self.n_out)
        out = _GatherAdd.apply(h_loc, src, dst, self.n_out + 1)[:self.n_out]
        agg = act.local_out(out, mesh, split, (self.n_out, h.shape[1]))
        return agg.redistribute(mesh, h.placements)


def mesh_readout(h, graph_ids, n_graphs: int):
    """The sum readout under an activation-sharding context: each rank
    ``index_add``s its rows of ``h`` into a ``(n_graphs, d)`` zero tensor
    by their graph ids (taken at ``h``'s row layout), and the sum pending
    over the ranks that split the rows is reduce-scattered to the graphs
    over the data axes (the labels' layout)."""
    ctx = act._current()
    mesh = ctx["mesh"]
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate()
                 for p in h.placements)
    h_loc = act.local_in(h, mesh, rows)
    ids = act.local_in(graph_ids, mesh, rows)
    out = h_loc.new_zeros((n_graphs, h_loc.shape[1])).index_add(0, ids,
                                                                 h_loc)
    pooled = act.local_out(out, mesh, tuple(
        Partial() if p.is_shard() else Replicate() for p in rows),
        (n_graphs, h.shape[1]))
    return pooled.redistribute(mesh, act.resolve(ctx, pooled.shape,
                                                 ("dp",)))


def _aggregation(edge_src, edge_dst, n_nodes: int, edge_mask, h):
    """The aggregation of one forward: a :class:`MeshAggregation` under a
    context with DTensor ``h``, else an :class:`Aggregation` plan."""
    if _on_mesh(h):
        return MeshAggregation(edge_src, edge_dst, n_nodes, mask=edge_mask)
    return Aggregation(edge_src, edge_dst, n_nodes, mask=edge_mask)


def with_aggregation(cfg: GINConfig, batch: Dict) -> Dict:
    """``batch`` with its plans (``"agg"``, and ``"readout"`` for the
    graph task) built once on the batch's device; as it is under an
    activation-sharding context with DTensor feats, whose forward takes
    the mesh branch."""
    if _on_mesh(batch["feats"]):
        return batch
    out = dict(batch)
    out["agg"] = Aggregation(batch["edge_src"], batch["edge_dst"],
                             batch["feats"].shape[0],
                             mask=batch.get("edge_mask"))
    if cfg.task == "graph":
        out["readout"] = readout(batch["graph_ids"],
                                 batch["labels"].shape[0])
    return out


# -------------------------------------------------------------- the model
def gin_layer(p, h, edge_src, edge_dst, n_nodes: int, edge_mask=None,
              agg: Optional[Aggregation] = None):
    """h' = MLP((1 + eps) * h + sum_{j in N(i)} h_j)."""
    if agg is None:
        agg = _aggregation(edge_src, edge_dst, n_nodes, edge_mask, h)
    z = (1.0 + p["eps"]).to(h.dtype) * h + agg(h)
    z = torch.relu(z @ p["w1"] + p["b1"])
    return torch.relu(z @ p["w2"] + p["b2"])


def forward(cfg: GINConfig, params, feats, edge_src, edge_dst,
            edge_mask=None, agg: Optional[Aggregation] = None):
    """feats: (N, d_feat); edges: (E,) src/dst.  Returns node states (N,
    d).  One plan serves every layer."""
    n = feats.shape[0]
    if agg is None:
        agg = _aggregation(edge_src, edge_dst, n, edge_mask, feats)
    h = feats.to(cfg.torch_dtype)
    for p in params["layers"]:
        h = gin_layer(p, h, edge_src, edge_dst, n, edge_mask, agg)
    return h


def node_logits(cfg: GINConfig, params, feats, edge_src, edge_dst,
                edge_mask=None, agg: Optional[Aggregation] = None):
    h = forward(cfg, params, feats, edge_src, edge_dst, edge_mask, agg)
    return h @ params["head_w"] + params["head_b"]


def graph_logits(cfg: GINConfig, params, feats, edge_src, edge_dst,
                 graph_ids, n_graphs: int, edge_mask=None,
                 agg: Optional[Aggregation] = None,
                 pool: Optional[Aggregation] = None):
    """Sum-readout per graph then classify (batched small molecules)."""
    h = forward(cfg, params, feats, edge_src, edge_dst, edge_mask, agg)
    if pool is None and _on_mesh(h):
        pooled = mesh_readout(h, graph_ids, n_graphs)
    else:
        pooled = (readout(graph_ids, n_graphs) if pool is None else pool)(h)
    return pooled @ params["head_w"] + params["head_b"]


def _nll(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]


def node_loss(cfg: GINConfig, params, batch) -> torch.Tensor:
    """batch: feats (N,d), edge_src/dst (E,), labels (N,), label_mask
    (N,), optional edge_mask (E,) and ``agg``."""
    logits = node_logits(cfg, params, batch["feats"], batch["edge_src"],
                         batch["edge_dst"], batch.get("edge_mask"),
                         batch.get("agg"))
    nll = _nll(logits, torch.clamp(batch["labels"], min=0))
    mask = batch["label_mask"].float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def graph_loss(cfg: GINConfig, params, batch) -> torch.Tensor:
    """batch: feats (N,d), edges, graph_ids (N,), labels (G,), optional
    ``agg`` and ``readout``."""
    logits = graph_logits(cfg, params, batch["feats"], batch["edge_src"],
                          batch["edge_dst"], batch["graph_ids"],
                          batch["labels"].shape[0], batch.get("edge_mask"),
                          batch.get("agg"), batch.get("readout"))
    return torch.mean(_nll(logits, batch["labels"]))


def loss_fn(cfg: GINConfig, params, batch) -> torch.Tensor:
    if cfg.task == "graph":
        return graph_loss(cfg, params, batch)
    return node_loss(cfg, params, batch)


def make_train_step(cfg: GINConfig, optimizer):
    """train_step(state, batch) -> (state, {"loss"}); state = {"params",
    "opt"}.  Pass a batch through :func:`with_aggregation` to sort its
    edges once for every step that reuses it."""
    grad_fn = value_and_grad(lambda p, b: loss_fn(cfg, p, b))

    def train_step(state, batch):
        loss, grads = grad_fn(state["params"], batch)
        new_params, new_opt = optimizer.step(state["params"], grads,
                                             state["opt"])
        return {"params": new_params, "opt": new_opt}, {"loss": loss}

    return train_step
