"""Plain PyTorch versions of the Adam kernels.

Each function computes exactly what its CUDA kernel in
``csrc/agg_adam.cu`` computes, operation for operation: eager PyTorch runs
every elementwise op as its own correctly rounded kernel (no FMA
contraction), in ``repro.ps.runtime._adam_math``'s grouping, with the
hyperparameters taken from the same ``(K, HP_COLS)`` table.  The CPU
tests run these; ``chip_smoke.py`` holds each kernel against them on the
card.
"""

from __future__ import annotations

from typing import Tuple

import torch

HP_COLS = 16  # (lr, b1, 1-b1, b2, 1-b2, eps, bc1, bc2, wd, pad...) per job


def grad_sum(g: torch.Tensor) -> torch.Tensor:
    """(M,) as is, or (W, M) worker rows summed in the order w = 0..W-1."""
    if g.dim() == 1:
        return g
    s = g[0]
    for k in range(1, g.shape[0]):
        s = s + g[k]
    return s


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (the kernel's ``__fsqrt_rn``, XLA's
    sqrt).  PyTorch's vectorized CPU sqrt can miss by 1 ulp; the float64
    sqrt rounded once to float32 is exact-rounded, since 53 >= 2*24 + 2."""
    return torch.sqrt(x.double()).float()


def adam_rows(hp: torch.Tensor, p: torch.Tensor, g: torch.Tensor,
              mu0: torch.Tensor, nu0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adam on ``(n, block)`` rows; ``hp`` is ``(n, HP_COLS)``, one
    hyperparameter row per block row (or ``(1, HP_COLS)`` for all)."""
    col = [hp[:, c : c + 1] for c in range(9)]
    lr, b1, omb1, b2, omb2, eps, bc1, bc2, wd = col
    mu = b1 * mu0 + omb1 * g
    nu = b2 * nu0 + omb2 * g * g
    mu_hat = mu * bc1
    nu_hat = nu * bc2
    upd = (lr * mu_hat) / (_sqrt_rn(nu_hat) + eps)
    if bool((wd != 0).any()):
        upd = torch.where(wd != 0, upd + (lr * wd) * p, upd)
    return p - upd, mu, nu


def aggregate_adam_multijob_fused_plain(p, g, mu, nu, hp, block_idx,
                                        job_slot, *, block: int):
    """K1: every owned block ``block_idx[i]`` of the full p/mu/nu updated
    IN PLACE with packed gradient tile i and hp row ``job_slot[i]``."""
    rows = block_idx.long()
    g2 = grad_sum(g).view(-1, block)
    new_p, new_mu, new_nu = adam_rows(
        hp[job_slot.long()], p.view(-1, block)[rows], g2,
        mu.view(-1, block)[rows], nu.view(-1, block)[rows])
    p.view(-1, block)[rows] = new_p
    mu.view(-1, block)[rows] = new_mu
    nu.view(-1, block)[rows] = new_nu
    return p, mu, nu


def aggregate_adam_blocks_plain(p, g, mu, nu, hp, block_idx, *, block: int,
                                p_packed: bool):
    """K3: one job's owned blocks (hp is its ``(1, HP_COLS)`` row); p full
    or packed, mu/nu full; returns PACKED (new_p, new_mu, new_nu)."""
    rows = block_idx.long()
    pp = p.view(-1, block) if p_packed else p.view(-1, block)[rows]
    new_p, new_mu, new_nu = adam_rows(
        hp, pp, grad_sum(g).view(-1, block), mu.view(-1, block)[rows],
        nu.view(-1, block)[rows])
    return new_p.reshape(-1), new_mu.reshape(-1), new_nu.reshape(-1)


def aggregate_adam_plain(p, g, mu, nu, hp):
    """K5: dense Adam over every lane of p/mu/nu (any shape, contiguous),
    IN PLACE.  ``g`` is p-shaped or a (W,)-stack of p-shaped rows, float32
    or bfloat16, summed in float32 in the order w = 0..W-1; p is float32
    or bfloat16, updated in float32 and rounded once to its dtype."""
    g32 = g.float()
    g32 = grad_sum(g32.reshape(g.shape[0], -1) if g.dim() == p.dim() + 1
                   else g32.reshape(-1))
    new_p, new_mu, new_nu = adam_rows(
        hp, p.float().reshape(1, -1), g32.reshape(1, -1), mu.reshape(1, -1),
        nu.reshape(1, -1))
    p.copy_(new_p.reshape(p.shape))
    mu.copy_(new_mu.reshape(mu.shape))
    nu.copy_(new_nu.reshape(nu.shape))
    return p, mu, nu
