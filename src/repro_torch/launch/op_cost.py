"""Per-device cost of a PyTorch program from its operators: the
counterpart of the reference's ``hlo_cost.py`` and ``hlo_stats.py``.

PyTorch has no HLO text.  ``OpCost`` is a ``TorchDispatchMode`` that sees
every ATen operator a function runs, on **local** shapes: an operator on
DTensors is handed back to DTensor (``NotImplemented``), which runs it as
operators on each rank's local shards and as the collectives its
redistributions need, and those come back here one by one.  The
global-shape operators that DTensor's sharding propagation runs on fake
tensors to learn output shapes are skipped.  So the totals are per
device, as the reference's partitioned HLO shapes are.

Costs per operator (the reference's rules):

  mm, addmm, bmm, baddbmm   flops = 2 * numel(result) * contracted size;
                            ``torch.einsum`` and ``@`` arrive as these
  views, detach, empty      free (the reference's ``_FREE_OPS``): a view
                            costs nothing and its consumer reads it at
                            its own size, so a slice counts at slice size
  index/gather ops          2 x result bytes (rows read and written)
  index_put / scatter ops   2 x update bytes + result bytes
  collectives               result bytes, counted, and the ring traffic
                            from the group size G: all-reduce
                            2 (G-1)/G x bytes, all-gather (G-1)/G x out,
                            reduce-scatter (G-1) x out, all-to-all
                            (G-1)/G x bytes
  any other operator        bytes = result + operands

Python loops run every trip, so every layer, chunk and microbatch is
seen once per trip: the trip-count weighting that ``hlo_cost.py`` exists
for (XLA's cost analysis visits a ``while`` body once) has no
counterpart, and nothing here parses HLO text (``hlo_stats.py``).

``live_peak_bytes`` estimates the peak of device memory from the outputs
of operators that allocate (not views) while they stay alive, plus
``base_bytes`` (the arguments); a view that outlives its base is not
counted, nor is the allocator's fragmentation.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

_DOTS = {
    aten.mm: lambda a: a[0].shape[-1],
    aten.bmm: lambda a: a[0].shape[-1],
    aten.addmm: lambda a: a[1].shape[-1],
    aten.baddbmm: lambda a: a[1].shape[-1],
}
_FREE = {
    aten.detach, aten.alias, aten.lift_fresh, aten.empty, aten.empty_like,
    aten.empty_strided, aten.new_empty, aten.new_empty_strided,
    aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
}
_GATHERS = {
    aten.index, aten.index_select, aten.gather, aten.embedding,
    aten.take_along_dim,
}
_SCATTERS = {
    aten.index_put, aten.index_put_, aten._index_put_impl_, aten.scatter,
    aten.scatter_, aten.scatter_add, aten.scatter_add_, aten.index_add,
    aten.index_add_, aten.embedding_dense_backward,
}
# functional collective -> (kind, position of the group-size or group-name
# argument)
_C10D = torch.ops._c10d_functional
_COLLECTIVES = {
    _C10D.all_reduce: "all-reduce",
    _C10D.all_reduce_coalesced: "all-reduce",
    _C10D.all_gather_into_tensor: "all-gather",
    _C10D.all_gather_into_tensor_coalesced: "all-gather",
    _C10D.reduce_scatter_tensor: "reduce-scatter",
    _C10D.reduce_scatter_tensor_coalesced: "reduce-scatter",
    _C10D.all_to_all_single: "all-to-all",
}
if hasattr(torch.ops, "_dtensor") and hasattr(torch.ops._dtensor,
                                               "shard_dim_alltoall"):
    # DTensor's Shard(i) -> Shard(j) on one mesh dim
    _COLLECTIVES[torch.ops._dtensor.shard_dim_alltoall] = "all-to-all"
_COLLECTIVE_FREE = {_C10D.wait_tensor, _C10D._wrap_tensor_autograd} \
    if hasattr(_C10D, "_wrap_tensor_autograd") else {_C10D.wait_tensor}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_traffic(kind: str, nbytes: float, g: int) -> float:
    """Ring-algorithm bytes a device moves for a collective whose result
    is ``nbytes`` on a group of ``g`` (``hlo_stats.py``'s multipliers)."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * nbytes
    if kind == "all-gather":
        return (g - 1) / g * nbytes
    if kind == "reduce-scatter":
        return float(g - 1) * nbytes
    if kind == "all-to-all":
        return (g - 1) / g * nbytes
    return float(nbytes)


def _group_size(args) -> int:
    """The group of a functional collective: its last argument names it
    (the ``group_size`` before it, where the op takes one)."""
    name = args[-1]
    return dist.distributed_c10d._resolve_process_group(name).size()


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_traffic: Dict[str, float] = field(default_factory=dict)
    coll_raw: Dict[str, float] = field(default_factory=dict)
    coll_counts: Dict[str, float] = field(default_factory=dict)
    ops: Dict[str, int] = field(default_factory=dict)

    @property
    def total_collective(self) -> float:
        return sum(self.coll_traffic.values())

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_traffic_bytes": self.coll_traffic,
            "collective_raw_bytes": self.coll_raw,
            "collective_counts": self.coll_counts,
            "total_collective_bytes": self.total_collective,
        }


class OpCost(TorchDispatchMode):
    """``with OpCost() as c: fn(...)``; then ``c.cost`` (a ``Cost``) and
    ``c.live_peak_bytes``."""

    def __init__(self, base_bytes: int = 0):
        super().__init__()
        self.cost = Cost()
        self._ops = defaultdict(int)
        self.cost.ops = self._ops
        self.live_bytes = base_bytes
        self.live_peak_bytes = base_bytes
        self.coll_links = []  # (kind, result bytes, group name) per call

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def _track(self, outs) -> None:
        for t in outs:
            n = _nbytes(t)
            if n:
                self.live_bytes += n
                weakref.finalize(t, self._release, n)
        self.live_peak_bytes = max(self.live_peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it as local ops
        out = func(*args, **kwargs)
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [a for a in tree_leaves(out) if isinstance(a, torch.Tensor)]
        fake = torch._subclasses.fake_tensor.FakeTensor
        if any(isinstance(t, fake) for t in ins + outs):
            return out  # sharding propagation on global shapes
        packet = func._overloadpacket
        c = self.cost
        if packet in _FREE or packet in _COLLECTIVE_FREE or func.is_view:
            return out
        self._ops[str(packet)] += 1
        out_bytes = sum(_nbytes(t) for t in outs)
        if packet in _COLLECTIVES:
            kind = _COLLECTIVES[packet]
            g = _group_size(args)
            c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
            c.coll_raw[kind] = c.coll_raw.get(kind, 0) + out_bytes
            c.coll_traffic[kind] = (c.coll_traffic.get(kind, 0.0)
                                    + collective_traffic(kind, out_bytes, g))
            c.bytes += out_bytes
            self.coll_links.append((kind, out_bytes, args[-1]))
            self._track(outs)
            return out
        if packet in _DOTS:
            c.flops += 2.0 * outs[0].numel() * _DOTS[packet](args)
        if packet in _GATHERS:
            c.bytes += 2 * out_bytes
        elif packet in _SCATTERS:
            upd = ins[-1] if packet not in (aten.index_put, aten.index_put_,
                                            aten._index_put_impl_) \
                else args[2]
            c.bytes += 2 * _nbytes(upd) + out_bytes
        else:
            c.bytes += out_bytes + sum(_nbytes(t) for t in ins)
        if not func._schema.is_mutable:  # in-place results alias inputs
            self._track(outs)
        return out


def analyze(fn, *args, base_bytes: int = 0, **kwargs):
    """``fn(*args, **kwargs)`` under ``OpCost``: returns (its outputs,
    the ``OpCost``)."""
    with OpCost(base_bytes) as oc:
        out = fn(*args, **kwargs)
    return out, oc
