"""Gradient compression for the push path, with error feedback (PyTorch).

The counterpart of ``repro.ps.compression``: block-wise int8
quantisation (one max-abs scale per ``BLOCK`` lanes) or a bf16 round
trip, and the error-feedback round that carries each round's residual
into the next round's gradient (EF-SGD), so the compressed chain stays
convergent.  ``compress_decompress`` returns the dequantized value; the
wire cost of the compressed form is ``wire_bytes``.

The functions here are plain PyTorch on every device.  The service's
error-feedback round (``runtime._ef_round``) runs them on the CPU; on a
card it goes through the hand-written kernel of
``repro_torch.kernels.ef_round``, one pass that equals ``ef_transform``
between a row gather and a row scatter bit for bit (the reference writes
no kernel here).  The arithmetic keeps the reference's grouping
(``x / scale * 127``, then ``q * scale / 127``) and rounds half to even,
so on the CPU the port equals the reference's eager path bit for bit.
Every division is by a tensor on the operand's device, never by a host
scalar: CUDA's ``div`` turns a host-scalar divisor into a multiply by
its reciprocal, which would round differently from the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

BLOCK = 2048

# Wire-size model (bytes per element on a real deployment): fp32 ships 4,
# bf16 ships 2, int8 ships 1 plus one fp32 scale per BLOCK-sized block.
_SCALE_BYTES = 4


def wire_bytes(n: int, kind: Optional[str], block: int = BLOCK) -> int:
    """Bytes an ``n``-element packed gradient costs on the wire under
    ``kind`` (None = uncompressed fp32)."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if not kind:
        return 4 * n
    if kind == "bf16":
        return 2 * n
    if kind == "int8":
        return n + _SCALE_BYTES * (-(-n // block) if n else 0)
    raise ValueError(f"unknown compression {kind!r}")


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """``x`` as (ceil(n / block), block) rows, zero-padded at the end (a
    view when ``n`` is a multiple of ``block``)."""
    n = x.shape[0]
    nb = -(-n // block)
    if nb * block != n:
        x = F.pad(x, (0, nb * block - n))
    return x.view(nb, block)


def _block_scales(x: torch.Tensor, block: int) -> torch.Tensor:
    """Each block's largest |x| (zero padding is safe: a max of
    absolute values)."""
    return _blocks(x.abs(), block).amax(dim=1)


def _safe(scales: torch.Tensor) -> torch.Tensor:
    """Scales with 0 replaced by 1 (a zero block quantizes to zeros)."""
    return torch.where(scales > 0, scales, torch.ones_like(scales))


def _c127(x: torch.Tensor) -> torch.Tensor:
    return torch.full((), 127.0, dtype=torch.float32, device=x.device)


def quantize_int8(x: torch.Tensor, block: int = BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N,) float32 -> (q int8 (N,), scales (ceil(N / block),)):
    ``q = clip(round(x / scale * 127), -127, 127)``, half to even."""
    n = x.shape[0]
    scales = _block_scales(x, block)
    q = torch.round(_blocks(x, block) / _safe(scales)[:, None] * 127.0)
    q = q.clamp_(-127.0, 127.0).to(torch.int8).reshape(-1)[:n]
    return q, scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    block: int = BLOCK) -> torch.Tensor:
    """``q * scale / 127`` in float32, the reference's grouping."""
    n = q.shape[0]
    out = _blocks(q.to(torch.float32), block) * _safe(scales)[:, None]
    return out.div_(_c127(out)).reshape(-1)[:n]


def compress_decompress(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Round trip through the compressed representation."""
    if kind == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if kind == "int8":
        q, s = quantize_int8(x)
        return dequantize_int8(q, s)
    raise ValueError(f"unknown compression {kind!r}")


def ef_transform(g: torch.Tensor, ef: torch.Tensor, kind: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONE error-feedback round: ``(g, ef) -> (q, resid)`` with
    ``g' = g + ef``, ``q = compress_decompress(g')``, ``resid = g' - q``.
    Both arguments are only read; the results are new tensors.  The
    runtime's compressed steps and both engines' appliers run this one
    function (through ``runtime._ef_round``, whose kernel on a card
    equals it bit for bit), so their compressed trajectories agree bit
    for bit."""
    g = g + ef
    q = compress_decompress(g, kind)
    return q, g - q


class ErrorFeedback:
    """Stateful wrapper for host-side loops (tests, examples)."""

    def __init__(self, shape, device=None):
        self.residual = torch.zeros(shape, dtype=torch.float32,
                                    device=device)

    def step(self, grad: torch.Tensor, kind: str) -> torch.Tensor:
        q, self.residual = ef_transform(grad, self.residual, kind)
        return q
