"""Adam and error-feedback compression, textbook forms, in the dtype of
the tensors given: float32 for the reference, bfloat16 for its control.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

INT8_BLOCK = 2048  # lanes sharing one int8 scale


def adam_step(p, m, v, g, t: int, *, lr: float, b1: float, b2: float,
              eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step at 1-based step ``t`` (Kingma and Ba, Algorithm 1)."""
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * (g * g)
    m_hat = m / (1.0 - b1 ** t)
    v_hat = v / (1.0 - b2 ** t)
    return p - lr * m_hat / (torch.sqrt(v_hat) + eps), m, v


def round_trip(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` through the compressed form and back.  ``x`` is (rows,
    INT8_BLOCK) for int8: each row is one quantisation block (max-abs
    scale, 127 levels a side, half to even).  Both divisions are true
    divisions (by a tensor: on the card a division by a host scalar
    becomes a multiply by its reciprocal)."""
    if kind == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if kind == "int8":
        scale = x.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        levels = torch.full((), 127.0, dtype=x.dtype, device=x.device)
        q = torch.round(x / scale * levels).clamp(-127.0, 127.0)
        return q * scale / levels
    raise ValueError(f"unknown compression {kind!r}")


def ef_round(g: torch.Tensor, ef: torch.Tensor, kind: Optional[str]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round: the gradient to apply and the new
    residual.  Without ``kind`` the gradient passes as it is."""
    if not kind:
        return g, ef
    x = g + ef
    q = round_trip(x, kind)
    return q, x - q
