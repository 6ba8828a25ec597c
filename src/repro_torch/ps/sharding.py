"""Per-tensor sharding assignment (``repro.ps.sharding``): the data-plane
realisation of the paper on a mesh.

The control plane decides, per tensor, where its aggregation (gradient
reduction + optimizer update) lives.  On a mesh that is a sharding
choice: a tensor's optimizer state and master copy live on their owner
shards (``model``/``data`` axes), gradients reduce onto them (push) and
parameters gather back (pull).

A spec is the reference's ``PartitionSpec`` as a plain tuple, one entry
per tensor dim: ``None``, an axis name, or a tuple of axis names; ``()``
replicates.  Rules are name + shape based, with divisibility guards: a
dim is sharded over an axis only when evenly divisible, else the next
candidate dim is tried; tensors under ``REPLICATE_BELOW`` elements stay
replicated.  Leaf names are the ``/``-joined dict keys (``tree._leaf_key``).
``placements`` turns a spec into DTensor placements on a DeviceMesh.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

from torch.distributed.tensor import Replicate, Shard

from ..launch.mesh import axis_names, axis_sizes
from ..tree import _leaf_key, _tree_items, tree_map, tree_with_leaves

AxisName = Union[str, Tuple[str, ...]]
Spec = Tuple[Optional[AxisName], ...]

REPLICATE_BELOW = 1 << 16  # tensors under 64k elements are not worth sharding


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _axis_size(mesh, axis: AxisName) -> int:
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def _divisible(dim: int, mesh, axis: AxisName) -> bool:
    return dim % _axis_size(mesh, axis) == 0


def data_axes(mesh) -> AxisName:
    """The batch axes: ("pod","data") multi-pod, "data" single-pod."""
    return ("pod", "data") if "pod" in axis_names(mesh) else "data"


def all_axes(mesh) -> Tuple[str, ...]:
    return axis_names(mesh)


def _spec(mesh, shape: Sequence[int], *assign: Tuple[int, AxisName]) -> Spec:
    """A spec putting each axis on a dim if divisible."""
    parts: list = [None] * len(shape)
    for dim, axis in assign:
        if (dim < len(shape) and parts[dim] is None
                and _divisible(shape[dim], mesh, axis)):
            parts[dim] = axis
    return tuple(parts)


def _lm_rule(mesh, name: str, shape: Tuple[int, ...], opt: bool = False
             ) -> Spec:
    dp, tp = data_axes(mesh), "model"
    nd = len(shape)
    last = name.rsplit("/", 1)[-1]
    stacked = 1 if "layers" in name else 0  # stacked leaves lead with L

    if _numel(shape) < REPLICATE_BELOW:
        return ()
    if last == "embed":
        return _spec(mesh, shape, (0, tp), (1, dp))
    if last == "unembed":
        return _spec(mesh, shape, (0, dp), (1, tp))
    if last in ("w_q", "w_k", "w_v"):
        # (lead?, d, h, dh): heads over tp if divisible, else head_dim
        s = _spec(mesh, shape, (stacked + 0, dp), (stacked + 1, tp))
        if s[stacked + 1] is None and _divisible(shape[stacked + 2], mesh,
                                                 tp):
            s = s[:stacked + 2] + (tp,) + s[stacked + 3:]
        return s
    if last == "w_o":
        # (lead?, h, dh, d)
        s = _spec(mesh, shape, (stacked + 0, tp), (stacked + 2, dp))
        if s[stacked + 0] is None and _divisible(shape[stacked + 1], mesh,
                                                 tp):
            s = s[:stacked + 1] + (tp,) + s[stacked + 2:]
        return s
    if last in ("w_gate", "w_up"):
        if nd - stacked == 3:  # MoE experts (lead?, E, d, f): EP + FSDP
            return _spec(mesh, shape, (stacked + 0, tp), (stacked + 1, dp))
        return _spec(mesh, shape, (stacked + 0, dp), (stacked + 1, tp))
    if last == "w_down":
        if nd - stacked == 3:  # (lead?, E, f, d)
            return _spec(mesh, shape, (stacked + 0, tp), (stacked + 2, dp))
        return _spec(mesh, shape, (stacked + 0, tp), (stacked + 1, dp))
    if last in ("shared_gate", "shared_up"):
        return _spec(mesh, shape, (stacked + 0, dp), (stacked + 1, tp))
    if last == "shared_down":
        return _spec(mesh, shape, (stacked + 0, tp), (stacked + 1, dp))
    if last == "router":
        return _spec(mesh, shape, (stacked + 0, dp))
    # MLA projections
    if last in ("w_dq", "w_dkv"):
        return _spec(mesh, shape, (stacked + 0, dp), (stacked + 1, tp))
    if last == "w_kr":
        return _spec(mesh, shape, (stacked + 0, dp))
    if last in ("w_uq", "w_uk", "w_uv"):
        # (lead?, rank, H, dh)
        return _spec(mesh, shape, (stacked + 0, dp), (stacked + 1, tp))
    # Fallback: shard the two largest dims over tp/dp where divisible.
    dims = sorted(range(nd), key=lambda i: -shape[i])
    s: list = [None] * nd
    if _divisible(shape[dims[0]], mesh, tp):
        s[dims[0]] = tp
    for d in dims[1:]:
        if s[d] is None and _divisible(shape[d], mesh, dp):
            s[d] = dp
            break
    return tuple(s)


def _recsys_rule(mesh, name: str, shape: Tuple[int, ...]) -> Spec:
    rows_axes = all_axes(mesh)
    if _numel(shape) < REPLICATE_BELOW:
        return ()
    last = name.rsplit("/", 1)[-1]
    if "tables" in name or last in ("item_emb", "cat_emb"):
        # Huge embedding tables: row-shard over the full mesh (PS-style).
        if _divisible(shape[0], mesh, rows_axes):
            return (rows_axes,)
        if _divisible(shape[0], mesh, "model"):  # pad-free fallback
            return ("model",)
        return ()
    # Dense tower weights: data-parallel compute, sharded only when large.
    dp = data_axes(mesh)
    if len(shape) == 2 and _divisible(shape[0], mesh, dp) and shape[0] >= 512:
        return _spec(mesh, shape, (0, dp), (1, "model"))
    return ()


def _gnn_rule(mesh, name: str, shape: Tuple[int, ...]) -> Spec:
    return ()  # GIN weights are tiny; graph tensors are sharded, not params


_RULES = {"lm": _lm_rule, "recsys": _recsys_rule, "gnn": _gnn_rule}


def _map_named(fn, tree):
    """``fn(name, leaf)`` over a tree's tensor leaves, same structure."""
    return tree_with_leaves(tree, {_leaf_key(p): fn(_leaf_key(p), leaf)
                                   for p, leaf in _tree_items(tree)})


def param_shardings(mesh, params, family: str):
    """Tree of specs matching ``params`` (tensors or anything with
    ``.shape``, e.g. a ``meta`` init)."""
    rule = _RULES[family]
    return _map_named(lambda n, leaf: rule(mesh, n, tuple(leaf.shape)),
                      params)


def opt_state_shardings(mesh, opt_state, family: str):
    """Optimizer state: moments follow their parameter's rule (the same
    leaf names appear under ``mu``/``nu``/``accum``), host scalars and
    0-dim leaves replicate.  ``opt_state`` is an optimizer's state
    NamedTuple; the result is the same NamedTuple of spec trees."""
    rule = _RULES[family]

    def assign(name, leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return ()
        if family == "lm":
            return rule(mesh, name, tuple(leaf.shape), opt=True)
        return rule(mesh, name, tuple(leaf.shape))

    return type(opt_state)(*(
        _map_named(assign, part) if isinstance(part, dict) else ()
        for part in opt_state))


def batch_shardings(mesh, batch, batch_dim_axes: Optional[AxisName] = None):
    """Shard the leading (batch) dim of every batch leaf over the data
    axes when divisible; replicate otherwise."""
    axes = batch_dim_axes if batch_dim_axes is not None else data_axes(mesh)

    def assign(leaf):
        if len(leaf.shape) == 0 or not _divisible(leaf.shape[0], mesh, axes):
            return ()
        return (axes,)

    return tree_map(assign, batch)


def kv_cache_shardings(mesh, cache, batch: int):
    """KV caches, layout (L, B, S, ...): batch over the data axes when
    divisible (and the sequence over ``model``); otherwise shard the
    cache length.  ``length`` (a host int) replicates."""
    dp = data_axes(mesh)

    def assign(leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return ()
        b_, s_ = leaf.shape[1], leaf.shape[2]
        if _divisible(b_, mesh, dp):
            spec: list = [None, dp, None] + [None] * (len(leaf.shape) - 3)
            if _divisible(s_, mesh, "model"):
                spec[2] = "model"
            return tuple(spec)
        # batch=1 (long-context): shard seq over every axis we can.
        axes = all_axes(mesh)
        if _divisible(s_, mesh, axes):
            return (None, None, axes)
        if _divisible(s_, mesh, "model"):
            return (None, None, "model")
        return ()

    return {k: (tree_map(assign, v) if isinstance(v, dict) else ())
            for k, v in cache.items()}


def replicated(mesh, tree):
    return tree_map(lambda _: (), tree)


def spec_by_key(specs) -> dict:
    """``{leaf key: spec}`` of a spec tree: dicts, lists and NamedTuples
    are containers, a plain tuple is a spec."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, list) or hasattr(t, "_fields"):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out[_leaf_key(path)] = t

    walk(specs, ())
    return out


def placements(mesh, spec: Spec) -> tuple:
    """A spec as DTensor placements, one per mesh dim: a tensor dim over
    an axis is ``Shard(dim)`` on that mesh dim; over a tuple of axes,
    ``Shard(dim)`` on each of them, in mesh order (row-major, as the
    reference's ``PartitionSpec``); every other mesh dim, and a mesh dim
    of size 1 (a shard over one device is the whole), ``Replicate()``."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(dim)
    return tuple(out)
