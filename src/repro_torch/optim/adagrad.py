"""Adagrad (``repro.optim.adagrad``): the classic PS-era optimizer,
standard for DLRM's embedding tables.

The reference's grouping, ``a = a + g*g`` then
``p - (lr*g) / (sqrt(a) + eps)``, in float32 whatever the parameter dtype,
each operation correctly rounded.  On the CPU the sqrt is taken in float64
and rounded once: PyTorch's vectorized float32 CPU sqrt can miss the
correctly rounded result by 1 ulp (XLA's and CUDA's do not).

The update is written IN PLACE into p and the accumulator, and ``step``
returns the same tensors, as the fused Adam does: at DLRM-RM2's 13.84 GB
of tables a functional step would hold two copies of the tables and of
the accumulators at once.  ``count`` is a host int.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..tree import tree_leaves_by_key, tree_map
from .base import Optimizer


class AdagradState(NamedTuple):
    accum: Any
    count: int


def _adagrad_update(p, g, a, lr: float, eps: float) -> None:
    g32 = g.float()
    a.add_(torch.square(g32))
    root = (torch.sqrt(a.double()).float() if a.device.type == "cpu"
            else torch.sqrt(a))
    upd = (lr * g32).div_(root.add_(eps))
    if p.dtype == torch.float32:
        p.sub_(upd)
    else:
        p.copy_(p.float().sub_(upd))


def adagrad(lr: float, eps: float = 1e-10,
            initial_accum: float = 0.0) -> Optimizer:
    def init(params):
        return AdagradState(
            accum=tree_map(lambda p: torch.full(p.shape, initial_accum,
                                                dtype=torch.float32,
                                                device=p.device), params),
            count=0)

    def step(params, grads, state):
        gs, accs = tree_leaves_by_key(grads), tree_leaves_by_key(state.accum)
        with torch.no_grad():
            for k, p in tree_leaves_by_key(params).items():
                _adagrad_update(p, gs[k], accs[k], lr, eps)
        return params, AdagradState(state.accum, state.count + 1)

    return Optimizer(init=init, step=step, name="adagrad")
