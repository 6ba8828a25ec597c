"""Wrappers for the multi-job Adam kernels, dispatched by tensor device.

A CUDA tensor goes through the hand-written kernel in ``csrc/agg_adam.cu``
(built on first use) or the call raises; a CPU tensor, which the caller
asked for, goes through the plain version in :mod:`.ref`.  Each kernel
wrapper counts its launches in ``<wrapper>.launches``.

The per-job hyperparameter table (:func:`multi_job_hp`) is computed in ONE
place, on the host, and shared by the kernel and the plain version, so
the two agree bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ...device import host_to_device
from .. import _build
from . import ref
from .ref import HP_COLS

Floats = Union[float, Sequence[float]]


def _per_job(val: Floats, n_jobs: int) -> Tuple[float, ...]:
    """Broadcast a scalar hyperparameter to a length-K tuple of floats."""
    if isinstance(val, (int, float)):
        return (float(val),) * n_jobs
    vals = tuple(float(v) for v in val)
    if len(vals) != n_jobs:
        raise ValueError(f"{len(vals)} hyperparameter values for {n_jobs} jobs")
    return vals


def _bias_corr(count: int, b: float) -> np.float32:
    """``1 / (1 - b**t)`` in float32, as the reference's scalar XLA
    computation gives it: the power rounded once to float32 (evaluated in
    float64 first), then the subtraction and division in float32."""
    pw = np.float32(np.float64(np.float32(b)) ** int(count))
    return np.float32(1.0) / (np.float32(1.0) - pw)


def multi_job_hp(counts: Sequence[int], *, lr: Floats, b1: Floats = 0.9,
                 b2: Floats = 0.999, eps: Floats = 1e-8,
                 wd: Floats = 0.0) -> torch.Tensor:
    """The ``(K, HP_COLS)`` float32 table ``[lr, b1, 1-b1, b2, 1-b2, eps,
    bc1, bc2, wd, 0...]`` (CPU).  ``1-b`` is folded in python doubles and
    the bias corrections use each job's 1-based step count, as
    ``repro.kernels.agg_adam.ops.multi_job_hp`` does."""
    k = len(counts)
    lrs, b1s = _per_job(lr, k), _per_job(b1, k)
    b2s, epss, wds = _per_job(b2, k), _per_job(eps, k), _per_job(wd, k)
    hp = np.zeros((k, HP_COLS), np.float32)
    for j in range(k):
        hp[j, :9] = (lrs[j], b1s[j], 1.0 - b1s[j], b2s[j], 1.0 - b2s[j],
                     epss[j], _bias_corr(counts[j], b1s[j]),
                     _bias_corr(counts[j], b2s[j]), wds[j])
    return torch.from_numpy(hp)


def _check_f32(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_i32(name: str, t: torch.Tensor, n: int, device) -> None:
    if t.dtype != torch.int32 or t.shape != (n,) or t.device != device:
        raise ValueError(f"{name} must be int32 of shape ({n},) on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return torch.cuda.current_stream(device).cuda_stream


def _vec_ok(block: int, *tensors: torch.Tensor) -> int:
    """float4 path: whole float4s per block and 16-byte aligned buffers."""
    return int(block % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def aggregate_adam_multijob_fused(p, g, mu, nu, hp, block_idx, job_slot, *,
                                  block: int):
    """K1, one service tick: Adam for every owned block ``block_idx[i]`` of
    the FULL p/mu/nu (N,), written back in place, with packed gradient
    tile i of ``g`` ((M,) or (W, M), M = n_own * block) and hp row
    ``job_slot[i]``.  Returns (p, mu, nu), the same tensors."""
    device = p.device
    n = p.shape[-1]
    n_own = int(block_idx.shape[0])
    for name, t in (("p", p), ("mu", mu), ("nu", nu), ("g", g), ("hp", hp)):
        _check_f32(name, t, device)
    if p.dim() != 1 or mu.shape != (n,) or nu.shape != (n,) or n % block:
        raise ValueError(f"p/mu/nu must be (N,) with N % {block} == 0, got "
                         f"{tuple(p.shape)} {tuple(mu.shape)} {tuple(nu.shape)}")
    if g.dim() not in (1, 2) or g.shape[-1] != n_own * block:
        raise ValueError(f"g must be (M,) or (W, M) with M = {n_own}*{block},"
                         f" got {tuple(g.shape)}")
    if hp.dim() != 2 or hp.shape[1] != HP_COLS:
        raise ValueError(f"hp must be (K, {HP_COLS}), got {tuple(hp.shape)}")
    _check_i32("block_idx", block_idx, n_own, device)
    _check_i32("job_slot", job_slot, n_own, device)
    if device.type == "cpu":
        return ref.aggregate_adam_multijob_fused_plain(
            p, g, mu, nu, hp, block_idx, job_slot, block=block)
    stream = _stream(device)
    fn = _build.entry("agg_adam", "agg_adam_multijob_fused",
                     [_build.P] * 4 + [_build.I64, _build.I32]
                     + [_build.P] * 3 + [_build.I64, _build.I32, _build.I32,
                                         _build.P])
    w = 1 if g.dim() == 1 else int(g.shape[0])
    aggregate_adam_multijob_fused.launches += 1
    _build.check(fn(p.data_ptr(), mu.data_ptr(), nu.data_ptr(), g.data_ptr(),
                    n_own * block, w, hp.data_ptr(), block_idx.data_ptr(),
                    job_slot.data_ptr(), n_own, block,
                    _vec_ok(block, p, mu, nu, g), stream),
                 "agg_adam_multijob_fused")
    return p, mu, nu


aggregate_adam_multijob_fused.launches = 0


def aggregate_adam_blocks(p, g, mu, nu, hp, block_idx, *, block: int,
                          p_packed: bool):
    """K3, one job's block step: Adam over the owned blocks ``block_idx``
    of the FULL mu/nu (N,), with p full (N,) or packed (M,) as
    ``p_packed`` says (explicit: when the job owns every block M == N and
    the two layouts differ only in order) and hp the job's
    ``(1, HP_COLS)`` row.  Returns PACKED (new_p, new_mu, new_nu)."""
    device = mu.device
    n = mu.shape[-1]
    n_own = int(block_idx.shape[0])
    m = n_own * block
    for name, t in (("p", p), ("mu", mu), ("nu", nu), ("g", g), ("hp", hp)):
        _check_f32(name, t, device)
    if mu.dim() != 1 or nu.shape != (n,) or n % block:
        raise ValueError(f"mu/nu must be (N,) with N % {block} == 0")
    if p.shape != ((m,) if p_packed else (n,)):
        raise ValueError(f"p must be {'packed' if p_packed else 'full'} "
                         f"({m if p_packed else n},), got {tuple(p.shape)}")
    if g.dim() not in (1, 2) or g.shape[-1] != m:
        raise ValueError(f"g must be (M,) or (W, M) with M = {m}, "
                         f"got {tuple(g.shape)}")
    if hp.shape != (1, HP_COLS):
        raise ValueError(f"hp must be (1, {HP_COLS}), got {tuple(hp.shape)}")
    _check_i32("block_idx", block_idx, n_own, device)
    if device.type == "cpu":
        return ref.aggregate_adam_blocks_plain(
            p, g, mu, nu, hp, block_idx, block=block, p_packed=p_packed)
    stream = _stream(device)
    fn = _build.entry("agg_adam", "agg_adam_blocks",
                     [_build.P, _build.I32, _build.P, _build.I64, _build.I32]
                     + [_build.P] * 4 + [_build.I64, _build.I32]
                     + [_build.P] * 3 + [_build.I32, _build.P])
    out = [torch.empty(m, dtype=torch.float32, device=device)
           for _ in range(3)]
    w = 1 if g.dim() == 1 else int(g.shape[0])
    aggregate_adam_blocks.launches += 1
    _build.check(fn(p.data_ptr(), int(p_packed), g.data_ptr(), m, w,
                    mu.data_ptr(), nu.data_ptr(), hp.data_ptr(),
                    block_idx.data_ptr(), n_own, block,
                    *(o.data_ptr() for o in out),
                    _vec_ok(block, p, mu, nu, g), stream),
                 "agg_adam_blocks")
    return tuple(out)


aggregate_adam_blocks.launches = 0


def scatter_rows(buf: torch.Tensor, packed: torch.Tensor, block_idx,
                 block: int) -> torch.Tensor:
    """Write packed block tiles onto their owned rows of ``buf``, in place
    (the post-apply scatter the fused launch makes redundant)."""
    rows = torch.as_tensor(block_idx, device=buf.device).long()
    buf.view(-1, block)[rows] = packed.view(-1, block)
    return buf


def multi_job_adam_update_fused(p, gs, mu, nu, counts, *, block_idx,
                                job_sizes, block: int, lr, b1=0.9, b2=0.999,
                                eps=1e-8, wd=0.0, job_slot=None):
    """One service tick: K co-resident jobs' Adam updates in ONE launch,
    written in place into the FULL shared p/mu/nu.

    ``block_idx`` concatenates the jobs' owned-block lists
    (``job_sizes[j]`` blocks for job j, in the order of ``counts`` and of
    any per-job hyperparameter sequences); it and the optional
    ``job_slot`` map may be host arrays or int32 tensors already on the
    device (the engine uploads them once per applier).  ``gs`` is the
    per-job sequence of packed gradients, concatenated here every tick as
    the reference does, or one pre-concatenated vector.
    """
    device = p.device
    job_sizes = tuple(int(s) for s in job_sizes)
    if sum(job_sizes) != int(block_idx.shape[0]) or len(job_sizes) != len(counts):
        raise ValueError(f"job_sizes {job_sizes} do not match block_idx "
                         f"{tuple(block_idx.shape)} / {len(counts)} counts")
    if isinstance(gs, (list, tuple)):
        g_cat = torch.cat(list(gs), dim=-1) if len(gs) > 1 else gs[0]
    else:
        g_cat = gs
    if job_slot is None:
        job_slot = np.repeat(np.arange(len(job_sizes), dtype=np.int32),
                             np.asarray(job_sizes, np.int64))
    hp = host_to_device(multi_job_hp(counts, lr=lr, b1=b1, b2=b2, eps=eps, wd=wd),
                   device)
    return aggregate_adam_multijob_fused(
        p, g_cat, mu, nu, hp, host_to_device(block_idx, device, torch.int32),
        host_to_device(job_slot, device, torch.int32), block=block)


def block_adam_update(p, g_packed, mu, nu, count, *, block_idx, block: int,
                      lr, b1=0.9, b2=0.999, eps=1e-8, wd=0.0,
                      p_packed: bool = True):
    """Shared-space block-owned update of one job (kernel K3): returns
    PACKED (new_p, new_mu, new_nu) for the caller to scatter back."""
    device = mu.device
    hp = host_to_device(multi_job_hp([count], lr=lr, b1=b1, b2=b2, eps=eps, wd=wd),
                   device)
    return aggregate_adam_blocks(
        p, g_packed, mu, nu, hp, host_to_device(block_idx, device, torch.int32),
        block=block, p_packed=p_packed)
