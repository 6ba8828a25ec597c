"""Activation-sharding constraints (``repro.ps.act_sharding``),
injectable per mesh.

Model code calls ``constrain(x, "dp", None, "tp", ...)`` with symbolic
axis roles.  Inside ``activate(mesh)`` the roles resolve to the mesh's
axes and a DTensor is redistributed to those placements (the reference's
``with_sharding_constraint``); a tensor that is not a DTensor (the local
tensors of a per-device region) passes through.  With no context
``constrain`` returns its argument itself, after one thread-local read,
so the one-device paths are untouched.  Dims that do not divide evenly
by the axis size stay unsharded, so the same model code serves every
mesh.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..launch.mesh import axis_names, axis_sizes

_STATE = threading.local()


def _current():
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def activate(mesh, enabled: bool = True):
    """Enable activation constraints for code run inside this context.

    Roles: "dp" -> batch/data axes (("pod","data") if present), "tp" ->
    "model", "all" -> every axis.
    """
    names = axis_names(mesh)
    dp = ("pod", "data") if "pod" in names else ("data",)
    prev = _current()
    _STATE.ctx = {"mesh": mesh, "dp": dp, "tp": ("model",), "all": names,
                  "sizes": axis_sizes(mesh)} if enabled else None
    try:
        yield
    finally:
        _STATE.ctx = prev


def resolve(ctx, shape, roles) -> tuple:
    """DTensor placements for ``roles`` (one per leading dim of ``shape``)
    on the context's mesh: each mesh axis (of more than one device) of a
    role whose dim divides by the role's size shards that dim; every
    other mesh dim replicates."""
    names, sizes = ctx["all"], ctx["sizes"]
    out: list = [Replicate()] * len(names)
    for dim, role in enumerate(roles):
        if role is None or dim >= len(shape):
            continue
        axes = ctx[role]
        n = 1
        for a in axes:
            n *= sizes[a]
        if shape[dim] % n == 0:
            for a in axes:
                if sizes[a] > 1:  # a size-1 axis holds the whole dim
                    out[names.index(a)] = Shard(dim)
    return tuple(out)


def constrain(x, *roles: Optional[str]):
    """Redistribute DTensor ``x`` to the placements of ``roles`` (or
    None per dim) under a context; otherwise return ``x``."""
    ctx = _current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    want = resolve(ctx, x.shape, roles)
    if x.placements == want:
        return x
    return x.redistribute(ctx["mesh"], want)


def whole_dim(x, dim: int):
    """DTensor ``x`` gathered along ``dim`` where it is sharded there (a
    DTensor cannot unbind or view a sharded dim); anything else as is."""
    if not isinstance(x, DTensor) or not any(
            p.is_shard(dim) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_shard(dim) else p for p in x.placements))


def enabled() -> bool:
    return _current() is not None


class _PinGrad(torch.autograd.Function):
    """``x`` as it is; its gradient redistributed to ``x``'s placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and grad.placements != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def pin_grad(x):
    """``x``; under a context, for a DTensor ``x``, an alias whose
    gradient arrives at ``x``'s own placements.  A tensor used twice (a
    tied embedding: the lookup and the output projection) gets two
    gradients in different layouts, pending sums over different mesh
    dims, and adding them would need a redistribution from a shard to a
    pending sum, which some torch versions lack; pinned, each is reduced
    to ``x``'s layout first."""
    if _current() is None or not isinstance(x, DTensor):
        return x
    return _PinGrad.apply(x)


def mesh_size(ctx, role: str) -> int:
    """The number of devices a role spans."""
    n = 1
    for a in ctx[role]:
        n *= ctx["sizes"][a]
    return n


# ------------------------------------------------------ per-device regions
# The reference's ``shard_map`` regions: DTensors enter as their local
# shards at the region's placements, the body runs on plain tensors with
# explicit collectives, and the results leave as DTensors again.

def as_dtensor(x, mesh):
    """``x`` itself if it is a DTensor; else ``x`` taken as the same
    global value on every rank (replicated), without communication."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_in(x, mesh, placements, grad_placements=None):
    """The local shard of ``x`` at ``placements`` (redistributed first if
    it lies otherwise).  ``grad_placements`` says what the region's
    gradient of that shard is (default: ``placements``); a replicated
    weight used on a slice of the tokens gets a ``Partial()`` gradient
    over the mesh dims that split the tokens."""
    x = as_dtensor(x, mesh)
    if x.placements != tuple(placements):
        x = x.redistribute(mesh, placements)
    return x.to_local(grad_placements=grad_placements)


def local_out(x, mesh, placements, shape=None):
    """A region's local result as a DTensor at ``placements``; ``shape``
    is the global shape where it differs from the evenly sharded one."""
    if shape is None:
        return DTensor.from_local(x, mesh, placements, run_check=False)
    stride = []
    acc = 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return DTensor.from_local(x, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def per_device(fn, roles, *xs):
    """``fn(*xs)``; under a context with DTensor inputs, ``fn`` on the
    local shards of every input at the placements ``roles`` resolve to on
    ``xs[0]``'s shape, its output a DTensor at those placements.  For a
    computation independent per shard (attention per (batch row, head),
    an interaction per row): no communication inside, and no operator
    that DTensor would have to place."""
    ctx = _current()
    if ctx is None or not isinstance(xs[0], DTensor):
        return fn(*xs)
    mesh = ctx["mesh"]
    pl = resolve(ctx, xs[0].shape, roles)
    out = fn(*(local_in(x, mesh, pl) for x in xs))
    shape = list(out.shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            shape[p.dim] *= mesh.shape[i]
    return local_out(out, mesh, pl, tuple(shape))


def flat_rank(mesh) -> int:
    """This rank's row-major index over every mesh axis: its position in
    the process group of the whole mesh."""
    coord = mesh.get_coordinate()
    flat = 0
    for c, n in zip(coord, mesh.shape):
        flat = flat * n + c
    return flat


def world_group(mesh):
    """The process group of every rank of ``mesh`` in row-major order:
    the default group, which a mesh from ``launch.mesh`` spans."""
    if mesh.size() != dist.get_world_size() or flat_rank(mesh) != \
            dist.get_rank():
        raise ValueError("the mesh must span the default process group "
                         "in row-major rank order (launch.mesh builds it "
                         "so)")
    return dist.group.WORLD


class _SumOver(torch.autograd.Function):
    """Sum over the ranks of some mesh dims; the gradient passes through
    unchanged (every rank goes on with the same sum, so the gradient of
    each rank's share is the gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        for d in dims:
            if mesh.shape[d] > 1:
                x = funcol.wait_tensor(funcol.all_reduce(x, "sum",
                                                         (mesh, d)))
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def sum_over(x, mesh, dims):
    return _SumOver.apply(x, mesh, tuple(dims))
