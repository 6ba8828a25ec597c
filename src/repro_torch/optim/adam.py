"""Adam / AdamW (``repro.optim.adam``).

Moments are float32 whatever the parameter dtype (bf16 params train in
mixed precision); the update runs in float32 and is cast back.

``fused=False`` is plain PyTorch in the reference's ``_adam_update``
grouping: bias correction by division by ``1 - b**t``, ``lr`` applied
last.  It returns new tensors.  ``fused=True`` runs kernel K5 per leaf
(``agg_adam.ops.adam_update``: reciprocal-multiply bias correction,
``(lr*mu_hat)/(sqrt(nu_hat)+eps)``), which writes p, mu and nu IN PLACE
and returns them.  The two groupings differ in the last bits, as they do
in the reference.

``count`` is a host int, so neither path needs a device sync for the
bias corrections.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..kernels.agg_adam import ops as agg_ops
from ..tree import tree_leaves_by_key, tree_with_leaves
from .base import Optimizer, tree_zeros_like


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: int


def _adam_update(p, g, mu, nu, count: int, lr, b1, b2, eps, wd):
    """The reference's unfused update (``adam.py:25``), plain PyTorch.
    ``1 - b**t`` is the float32 scalar of ``agg_ops._bias_denom``, held as
    a 0-dim tensor on the device: a divisor that is a host scalar would
    let CUDA's ``div`` multiply by its reciprocal instead."""
    g32 = g.float()
    mu = b1 * mu + (1 - b1) * g32
    nu = b2 * nu + (1 - b2) * torch.square(g32)
    d1, d2 = (torch.full((), float(agg_ops._bias_denom(count, b)),
                         dtype=torch.float32, device=p.device)
              for b in (b1, b2))
    mu_hat = mu / d1
    nu_hat = nu / d2
    upd = mu_hat / (torch.sqrt(nu_hat) + eps)
    if wd:
        upd = upd + wd * p.float()
    new_p = (p.float() - lr * upd).to(p.dtype)
    return new_p, mu, nu


def adam(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    fused: bool = False,
) -> Optimizer:
    def init(params):
        return AdamState(mu=tree_zeros_like(params, torch.float32),
                         nu=tree_zeros_like(params, torch.float32), count=0)

    def step(params, grads, state):
        count = state.count + 1
        if fused:
            def upd(p, g, mu, nu):
                return agg_ops.adam_update(p, g.contiguous(), mu, nu, count,
                                           lr=lr, b1=b1, b2=b2, eps=eps,
                                           wd=weight_decay)
        else:
            def upd(p, g, mu, nu):
                return _adam_update(p, g, mu, nu, count, lr, b1, b2, eps,
                                    weight_decay)

        gs, mus, nus = (tree_leaves_by_key(t)
                        for t in (grads, state.mu, state.nu))
        with torch.no_grad():
            out = {k: upd(p, gs[k], mus[k], nus[k])
                   for k, p in tree_leaves_by_key(params).items()}
        new_params, new_mu, new_nu = (
            tree_with_leaves(params, {k: o[i] for k, o in out.items()})
            for i in range(3))
        return new_params, AdamState(new_mu, new_nu, count)

    return Optimizer(init=init, step=step, name="adam")


def adamw(lr: float, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)._replace(name="adamw")
