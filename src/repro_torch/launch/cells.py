"""Cells (``repro.launch.cells``): (arch x shape x mesh) -> a step
function, its ``meta`` arguments and their shardings.

A ``LoweredCell`` carries the function, its arguments as ``meta`` tensors
(shapes and dtypes, no memory), their specs (``ps.sharding``: one per
leaf; ``in_placements`` gives them as DTensor placements), the donated
arguments, and the roofline metadata (model flops per step).  ``lower``
places arguments on the mesh as DTensors and runs the function under the
activation-sharding context: on ``meta`` over the production meshes'
fake process group (the dry-run), or on real tensors over the host mesh.
The batches, shapes, optimizers and flop formulas are the reference's,
so a sharding fix here fixes every consumer.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from ..arch import ArchSpec, ShapeCell
from ..configs import registry
from ..optim import adagrad, adam
from ..ps import act_sharding as act
from ..ps import sharding as shd
from ..tree import _leaf_key, _tree_items, tree_with_leaves
from .mesh import axis_sizes


@dataclass
class LoweredCell:
    arch: str
    shape: str
    fn: Callable
    args: Tuple[Any, ...]  # meta tensors (trees)
    in_shardings: Tuple[Any, ...]  # spec trees, one per argument
    donate_argnums: Tuple[int, ...]
    model_flops_per_step: float  # 6ND (dense) / 6 N_active D (MoE); fwd-only for serving
    mesh: Any = None
    act_shard: bool = True  # activation-sharding constraints (SP/TP/EP)
    notes: str = ""

    def in_placements(self):
        """``in_shardings`` as trees of DTensor placement tuples."""
        return tuple(_map_specs(lambda s: shd.placements(self.mesh, s), t)
                     for t in self.in_shardings)

    def place(self, args=None):
        """``args`` (default: the cell's ``meta`` arguments) as DTensors at
        ``in_shardings``.  A meta tensor becomes its local shard's shape;
        a real tensor, held whole by every rank, is sliced locally."""
        args = self.args if args is None else args
        return tuple(_place_tree(self.mesh, a, s)
                     for a, s in zip(args, self.in_shardings))

    def lower(self, args=None):
        """Run the cell's function once on ``place(args)`` under the
        activation-sharding context; returns its outputs."""
        placed = self.place(args)
        with act.activate(self.mesh, enabled=self.act_shard), \
                implicit_replication():
            return self.fn(*placed)


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    if hasattr(specs, "_fields"):
        return type(specs)(*(_map_specs(fn, v) for v in specs))
    return fn(specs)


def _local_shape(mesh, shape, spec):
    sizes = axis_sizes(mesh)
    out = list(shape)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = 1
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            n *= sizes[a]
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"by {n} ({axis})")
        out[dim] //= n
    return out


def _place(mesh, t, spec):
    if not isinstance(t, torch.Tensor):
        return t  # host ints (optimizer count, cache length)
    pl = shd.placements(mesh, spec)
    if t.device.type == "meta":
        local = torch.empty(_local_shape(mesh, t.shape, spec),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def _place_tree(mesh, tree, specs):
    by_key = shd.spec_by_key(specs)
    return tree_with_leaves(tree, {
        _leaf_key(p): _place(mesh, leaf, by_key[_leaf_key(p)])
        for p, leaf in _tree_items(tree)})


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _n_devices(mesh) -> int:
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n


def get_spec(arch: str) -> ArchSpec:
    return registry.spec(arch)


# ==================================================================== LM cells
def _lm_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> LoweredCell:
    from ..models import transformer as tf

    cfg = dataclasses.replace(spec.model, **cell.model_overrides)
    n_params = cfg.param_count
    n_active = cfg.active_param_count

    params = tf.init_params(cfg, device="meta")
    p_shard = shd.param_shardings(mesh, params, "lm")

    if cell.kind == "train":
        opt = adam(3e-4)
        n_micro = cell.run_overrides.get("n_microbatches", 1)
        accum_dt = torch.bfloat16 if n_params > 5e10 else torch.float32
        opt_state = opt.init(params)
        o_shard = shd.opt_state_shardings(mesh, opt_state, "lm")
        # Gradients follow the optimizer-state layout (ZeRO-1).
        step = tf.make_train_step(
            cfg, opt, n_microbatches=n_micro, grad_accum_dtype=accum_dt,
            grad_shardings=_map_specs(lambda s: shd.placements(mesh, s),
                                      o_shard.mu))
        state = {"params": params, "opt": opt_state}
        s_shard = {"params": p_shard, "opt": o_shard}
        batch = {"tokens": _meta((cell.batch, cell.seq), torch.int32),
                 "labels": _meta((cell.batch, cell.seq), torch.int32)}
        b_shard = shd.batch_shardings(mesh, batch)
        flops = 6.0 * n_active * cell.batch * cell.seq
        return LoweredCell(spec.arch_id, cell.name, step, (state, batch),
                           (s_shard, b_shard), (0,), flops, mesh=mesh)

    if cell.kind == "prefill":
        # jnp attention in the reference's cell: the plain (chunked) one
        fn = tf.make_prefill(cfg, attention="plain")
        toks = _meta((cell.batch, cell.seq), torch.int32)
        t_shard = shd.batch_shardings(mesh, toks)
        flops = 2.0 * n_active * cell.batch * cell.seq
        return LoweredCell(spec.arch_id, cell.name, fn, (params, toks),
                           (p_shard, t_shard), (), flops, mesh=mesh)

    if cell.kind == "decode":
        fn = tf.make_serve_step(cfg)
        cache = tf.init_kv_cache(cfg, cell.batch, cell.seq, device="meta")
        c_shard = shd.kv_cache_shardings(mesh, cache, cell.batch)
        toks = _meta((cell.batch, 1), torch.int32)
        t_shard = shd.batch_shardings(mesh, toks)
        flops = 2.0 * n_active * cell.batch  # one token per sequence
        return LoweredCell(spec.arch_id, cell.name, fn,
                           (params, cache, toks), (p_shard, c_shard, t_shard),
                           (1,), flops, mesh=mesh)

    raise ValueError(f"unknown LM cell kind {cell.kind}")


# =================================================================== GNN cells
def _gnn_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> LoweredCell:
    from ..configs import gin_tu
    from ..models import gnn

    cfg = gin_tu.model_for_shape(cell.name)
    sh = cell.extras
    n_dev = _n_devices(mesh)
    dp = shd.data_axes(mesh)
    axes_all = shd.all_axes(mesh)

    params = gnn.init_params(cfg, device="meta")
    p_shard = shd.param_shardings(mesh, params, "gnn")
    opt = adam(1e-3)
    step = gnn.make_train_step(cfg, opt)
    opt_state = opt.init(params)
    o_shard = shd.opt_state_shardings(mesh, opt_state, "gnn")

    if cell.name == "molecule":
        n_nodes = sh["batch"] * sh["n_nodes"]  # 128 x 30
        n_edges = _round_up(sh["batch"] * sh["n_edges"], n_dev)
        batch = {
            "feats": _meta((n_nodes, sh["d_feat"]), torch.float32),
            "edge_src": _meta((n_edges,), torch.int32),
            "edge_dst": _meta((n_edges,), torch.int32),
            "edge_mask": _meta((n_edges,), torch.bool),
            "graph_ids": _meta((n_nodes,), torch.int32),
            "labels": _meta((sh["batch"],), torch.int32),
        }
        b_shard = {"feats": (dp,), "edge_src": (axes_all,),
                   "edge_dst": (axes_all,), "edge_mask": (axes_all,),
                   "graph_ids": (dp,), "labels": (dp,)}
    else:
        if cell.name == "minibatch_lg":
            # fanout-(15,10) padded block sizes around 1024 seeds
            n_nodes = 1024 * (1 + 15 + 150)  # 169,984
            n_edges = 1024 * (15 + 150)  # 168,960
        else:
            n_nodes = _round_up(sh["n_nodes"], n_dev)
            n_edges = _round_up(sh["n_edges"], n_dev)
        feats_shard = ((axes_all,) if n_nodes % n_dev == 0
                       and n_nodes >= (1 << 16) else ())
        rows = (axes_all,) if n_nodes % n_dev == 0 else ()
        batch = {
            "feats": _meta((n_nodes, sh["d_feat"]), torch.float32),
            "edge_src": _meta((n_edges,), torch.int32),
            "edge_dst": _meta((n_edges,), torch.int32),
            "edge_mask": _meta((n_edges,), torch.bool),
            "labels": _meta((n_nodes,), torch.int32),
            "label_mask": _meta((n_nodes,), torch.bool),
        }
        b_shard = {"feats": feats_shard, "edge_src": (axes_all,),
                   "edge_dst": (axes_all,), "edge_mask": (axes_all,),
                   "labels": rows, "label_mask": rows}

    state = {"params": params, "opt": opt_state}
    s_shard = {"params": p_shard, "opt": o_shard}
    # GNN "model flops": 2 x (edges x d + nodes x d_feat x d) x layers x 3
    d = cfg.d_hidden
    flops = 3.0 * 2.0 * cfg.n_layers * (
        batch["edge_src"].shape[0] * d
        + batch["feats"].shape[0] * (cfg.d_feat if cfg.n_layers else d) * d)
    return LoweredCell(spec.arch_id, cell.name, step, (state, batch),
                       (s_shard, b_shard), (0,), flops, mesh=mesh)


# ================================================================ RecSys cells
def _recsys_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> LoweredCell:
    from ..models import recsys

    cfg = spec.model
    dp = shd.data_axes(mesh)
    kind = spec.recsys_kind

    if kind == "dlrm":
        init = functools.partial(recsys.dlrm_init, cfg)
        loss = lambda p, b: recsys.dlrm_loss(cfg, p, b)
        opt = adagrad(0.01)
        dense_flops = 2 * sum(
            a * b for a, b in zip((cfg.n_dense,) + cfg.bot_mlp[:-1],
                                  cfg.bot_mlp)
        ) + 2 * sum(
            a * b for a, b in zip(
                (cfg.bot_mlp[-1] + cfg.n_pairs,) + cfg.top_mlp[:-1],
                cfg.top_mlp))

        def batch_of(b):
            return {"dense": _meta((b, cfg.n_dense), torch.float32),
                    "sparse": _meta((b, cfg.n_sparse), torch.int32),
                    "labels": _meta((b,), torch.float32)}

        fwd = lambda p, b: recsys.dlrm_forward(cfg, p, b["dense"],
                                               b["sparse"])
    elif kind == "sasrec":
        init = functools.partial(recsys.sasrec_init, cfg)
        loss = lambda p, b: recsys.sasrec_loss(cfg, p, b)
        opt = adam(1e-3)
        dense_flops = 2 * cfg.seq_len * (
            cfg.n_blocks * (4 * cfg.embed_dim ** 2 + 2 * cfg.embed_dim ** 2)
            + cfg.seq_len * cfg.embed_dim * cfg.n_blocks)

        def batch_of(b):
            return {"seq": _meta((b, cfg.seq_len), torch.int32),
                    "pos": _meta((b, cfg.seq_len), torch.int32),
                    "neg": _meta((b, cfg.seq_len), torch.int32)}

        fwd = lambda p, b: recsys.sasrec_states(cfg, p, b["seq"])[:, -1]
    else:  # dien
        init = functools.partial(recsys.dien_init, cfg)
        loss = lambda p, b: recsys.dien_loss(cfg, p, b)
        opt = adam(1e-3)
        dense_flops = 2 * cfg.seq_len * (
            6 * (cfg.d_in + cfg.gru_dim) * cfg.gru_dim  # GRU + AUGRU
            + (cfg.gru_dim + cfg.d_in) * 80)

        def batch_of(b):
            return {"hist_items": _meta((b, cfg.seq_len), torch.int32),
                    "hist_cats": _meta((b, cfg.seq_len), torch.int32),
                    "target_item": _meta((b,), torch.int32),
                    "target_cat": _meta((b,), torch.int32),
                    "labels": _meta((b,), torch.float32)}

        fwd = lambda p, b: recsys.dien_forward(cfg, p, b)

    params = init(device="meta")
    p_shard = shd.param_shardings(mesh, params, "recsys")

    if cell.kind == "train":
        step = recsys.make_train_step(loss, opt)
        opt_state = opt.init(params)
        o_shard = shd.opt_state_shardings(mesh, opt_state, "recsys")
        batch = batch_of(cell.batch)
        b_shard = shd.batch_shardings(mesh, batch)
        state = {"params": params, "opt": opt_state}
        s_shard = {"params": p_shard, "opt": o_shard}
        flops = 3.0 * cell.batch * dense_flops
        return LoweredCell(spec.arch_id, cell.name, step, (state, batch),
                           (s_shard, b_shard), (0,), flops, mesh=mesh)

    if cell.kind == "forward":
        batch = batch_of(cell.batch)
        b_shard = shd.batch_shardings(mesh, batch)
        flops = float(cell.batch) * dense_flops
        return LoweredCell(spec.arch_id, cell.name, fwd, (params, batch),
                           (p_shard, b_shard), (), flops, mesh=mesh)

    if cell.kind == "retrieval":
        n_cand = cell.extras["n_candidates"]
        cand = (dp,)
        if kind == "sasrec":
            # Retrieval encodes ONE history then dots against N candidates.
            dense_flops = 2 * cfg.embed_dim
        if kind == "dlrm":
            fn = lambda p, d1, us, c: recsys.dlrm_retrieval(cfg, p, d1, us, c)
            args = (params, _meta((1, cfg.n_dense), torch.float32),
                    _meta((1, cfg.n_sparse - 1), torch.int32),
                    _meta((n_cand,), torch.int32))
            ins = (p_shard, (), (), cand)
        elif kind == "sasrec":
            fn = lambda p, seq, c: recsys.sasrec_retrieval(cfg, p, seq, c)
            args = (params, _meta((1, cfg.seq_len), torch.int32),
                    _meta((n_cand,), torch.int32))
            ins = (p_shard, (), cand)
        else:
            fn = lambda p, hi, hc, ci, cc: recsys.dien_retrieval(
                cfg, p, hi, hc, ci, cc)
            args = (params, _meta((cfg.seq_len,), torch.int32),
                    _meta((cfg.seq_len,), torch.int32),
                    _meta((n_cand,), torch.int32),
                    _meta((n_cand,), torch.int32))
            ins = (p_shard, (), (), cand, cand)
        flops = float(n_cand) * dense_flops
        return LoweredCell(spec.arch_id, cell.name, fn, args, ins, (), flops,
                           mesh=mesh)

    raise ValueError(f"unknown recsys cell kind {cell.kind}")


def build_cell(arch: str, shape: str, mesh) -> LoweredCell:
    spec = get_spec(arch)
    cell = spec.cell(shape)
    if spec.family == "lm":
        return _lm_cell(spec, cell, mesh)
    if spec.family == "gnn":
        return _gnn_cell(spec, cell, mesh)
    return _recsys_cell(spec, cell, mesh)


def all_cells():
    for arch in sorted(registry.ARCHS):
        spec = get_spec(arch)
        for shape in spec.cells:
            yield arch, shape
