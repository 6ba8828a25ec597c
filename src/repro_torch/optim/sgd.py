"""SGD with optional momentum and weight decay (``repro.optim.sgd``).

The reference's grouping, leaf by leaf: ``g + wd * p.astype(g.dtype)``,
then ``momentum * m + g``, then ``p - lr * u.astype(p.dtype)``, each
operation rounded to the leaf's dtype.  A Python scalar times a JAX
array is taken in the array's dtype (weak typing: ``0.1 * x`` of a bf16
``x`` multiplies by bf16(0.1)), so each scalar here is a 0-d tensor of
the other operand's dtype; PyTorch would multiply a bf16 tensor by the
float32 scalar.  Each step returns new tensors.  ``count`` is a host
int, as ``AdamState``'s is.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..tree import tree_leaves_by_key, tree_with_leaves
from .base import Optimizer, tree_zeros_like


class SgdState(NamedTuple):
    momentum: Any
    count: int


def _times(scalar: float, t: torch.Tensor) -> torch.Tensor:
    """``scalar * t`` with ``scalar`` rounded to ``t``'s dtype first."""
    return torch.full((), scalar, dtype=t.dtype, device=t.device) * t


def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0
        ) -> Optimizer:
    def init(params):
        mom = tree_zeros_like(params) if momentum else None
        return SgdState(momentum=mom, count=0)

    def step(params, grads, state):
        ps, gs = tree_leaves_by_key(params), tree_leaves_by_key(grads)
        with torch.no_grad():
            if weight_decay:
                gs = {k: g + _times(weight_decay, ps[k].to(g.dtype))
                      for k, g in gs.items()}
            new_mom = None
            if momentum:
                ms = tree_leaves_by_key(state.momentum)
                gs = {k: _times(momentum, ms[k]) + g for k, g in gs.items()}
                new_mom = tree_with_leaves(state.momentum, gs)
            new_params = tree_with_leaves(params, {
                k: p - _times(lr, gs[k].to(p.dtype)) for k, p in ps.items()})
        return new_params, SgdState(new_mom, state.count + 1)

    return Optimizer(init=init, step=step, name="sgd")
