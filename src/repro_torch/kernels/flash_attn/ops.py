"""Flash attention forward (K7), dispatched by tensor device.

``flash_attention(q, k, v)`` takes the model layout (B, S, H, D).  A CUDA
tensor goes through the hand-written kernels in ``csrc/flash_attn.cu``
(built on first use), which read the inputs through their strides (no
transpose, no padding copy: ragged S is masked inside the kernel) and
index the kv head of each query head themselves (GQA).  bfloat16 runs on
Hopper's tensor cores (``flash_fwd_wgmma``: TMA, wgmma, warp-specialised
warpgroups) at head widths 64 and 128, and needs 16-byte aligned bases and
strides (TMA's condition); the prefill's q, k, v have them, and a view
without them is copied to a fresh contiguous tensor first.  float32 runs
in SIMT arithmetic at 16, 32, 64 and 128.  Any other width raises.  A CPU
tensor goes through the plain version in :mod:`.ref`.  The wrapper counts
its kernel launches in ``flash_attention.launches``.  Forward only:
neither package has a backward kernel, so an input that requires grad is
refused.

:func:`tile_schedule` is the bfloat16 kernel's walk over key tiles, in the
kernel's own formulas, for the tests.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from . import ref

# The compiled head widths of each kernel.
HEAD_DIMS = {torch.bfloat16: (64, 128), torch.float32: (16, 32, 64, 128)}
# The bfloat16 kernel's tiles (csrc/flash_attn.cu, Tiles<D>): query rows a
# block (64 a consumer warpgroup) and keys a K/V tile.
BF16_TILES = {64: (192, 128), 128: (128, 128)}
_FLOATS = tuple(HEAD_DIMS)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward only (no backward "
                           "kernel exists): call it on tensors that do not "
                           "require grad, e.g. under torch.inference_mode()")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, S_q, HQ, D) and k, v (B, S_k, HK, "
                         f"D), got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    b, sq, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         f" (same B and D, HQ a multiple of HK)")
    if q.dtype not in _FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if causal and sq > k.shape[1]:
        raise ValueError(f"causal attention needs S_q <= S_k (every query "
                         f"sees at least one key), got {sq} > {k.shape[1]}")


def _check_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What only the CUDA kernels refuse: a head width they were not
    compiled for, a strided head dim, no keys."""
    d = q.shape[-1]
    if d not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"{q.dtype} head dim {d} not compiled (have "
                         f"{HEAD_DIMS[q.dtype]})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last (head) dim")
    if k.shape[1] == 0:
        raise ValueError("no keys (S_k = 0)")


def _rows_aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0 and all(s > 0 and s % 8 == 0
                                          for s in t.stride()[:3])


def tile_schedule(sq: int, sk: int, bq: int, bk: int, causal: bool):
    """For each query tile of ``bq`` rows, (n_tiles, n_unmasked): the
    kernel visits key tiles [0, n_tiles) of ``bk`` keys, and computes no
    mask for tiles [0, n_unmasked), those visible whole to every row of
    the query tile; the rest cross the diagonal or S_k."""
    offset = sk - sq
    out = []
    for q0 in range(0, sq, bq):
        kv_end = min(sk, q0 + bq + offset) if causal else sk
        full = min(sk, q0 + offset + 1) if causal else sk
        out.append((-(-kv_end // bk), full // bk))
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """K7: softmax(q k^T * scale) v per head, causal aligned bottom-right,
    fp32 accumulators.  q (B, S_q, HQ, D), k and v (B, S_k, HK, D), float32
    or bfloat16 -> (B, S_q, HQ, D) in q's dtype."""
    _check(q, k, v, causal)
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return ref.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_kernel(q, k, v)
    if q.dtype == torch.bfloat16:
        q, k, v = (t if _rows_aligned16(t)
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.entry("flash_attn", "flash_attn_fwd",
                      [_build.P] * 4 + [_build.I32] * 7 + [_build.I64] * 12
                      + [_build.F32, _build.I32, _build.P])
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flash_attention.launches += 1
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    int(q.dtype == torch.bfloat16), b, hq, hk, sq, sk, d,
                    *strides, scale, int(causal), stream),
                 "flash_attn_fwd")
    return out


flash_attention.launches = 0
