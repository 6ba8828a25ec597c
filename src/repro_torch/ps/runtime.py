"""Shared-service data plane on one flat parameter space (PyTorch).

The counterpart of ``repro.ps.runtime``.  The control plane's compiled
:class:`~repro_torch.ps.plan.FlatPlan` lays every registered job's
tensors into one flat space; a job's step

  pull    gathers its owned ``block_align`` blocks (one row gather),
  push    packs its gradients into the same packed domain,
  update  runs Adam on its owned lanes only -- O(job bytes) -- through the
          block kernel K3, and scatters the results back.

The standalone single-job space (:func:`build_flat_plan`,
:func:`init_ps_state`, ``make_ps_train_step(job_id=None)``) pulls the
whole tree, pushes the whole float32 gradient and runs the dense kernel
K5 over every lane.

Parameter trees are nested dicts / lists / tuples of tensors.  Their leaf
keys are those of the reference (dict keys, sorted, and list indices
joined by ``/``), so one plan lays out both packages lane for lane, and
:func:`tree_from_numpy` / :func:`state_from_numpy` carry the reference's
weights and shared state across.

PyTorch applies updates in place: the steps write the shared flat/mu/nu
buffers directly, and every value handed to a caller (pulls,
``unflatten_tree``) is a copy that never aliases live state.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.assignment import (
    balanced_shard_assignment,
    round_robin_shard_assignment,
)
from ..core.types import AggTask, JobProfile
from ..device import host_to_device
from ..kernels.agg_adam import ops as agg_ops
from ..kernels.agg_adam import ref as agg_ref
from ..tree import (  # noqa: F401  (re-exported for the runtime's users)
    _leaf_key,
    _tree_items,
    _tree_rebuild,
    abstract_tree,
    array_to_tensor,
    tree_leaves_by_key,
    tree_map,
    value_and_grad,
)
from .plan import FlatPlan, Segment, TensorSpec, segment_mask

_NP_OF_TORCH = {torch.float32: np.float32, torch.float64: np.float64,
                torch.float16: np.float16, torch.int32: np.int32,
                torch.int64: np.int64, torch.bool: np.bool_}
_TORCH_OF_NP = {np.dtype(v): k for k, v in _NP_OF_TORCH.items()}


def numpy_dtype(dtype: torch.dtype):
    """The dtype a TensorSpec stores for a torch dtype: numpy's, so plans
    and manifests stay identical to the reference's.  numpy has no
    bfloat16, so a bfloat16 leaf keeps ``torch.bfloat16``, which
    ``plan.dtype_name`` names ``"bfloat16"`` as the reference does."""
    if dtype == torch.bfloat16:
        return dtype
    return np.dtype(_NP_OF_TORCH[dtype])


def torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_OF_NP[np.dtype(dtype)]


# ------------------------------------------------------------- pytrees
def tree_specs(tree) -> List[TensorSpec]:
    """Per-leaf TensorSpecs in flatten order, with numpy dtypes."""
    return [TensorSpec(_leaf_key(path), tuple(leaf.shape),
                       numpy_dtype(leaf.dtype))
            for path, leaf in _tree_items(tree)]


def tree_from_numpy(tree, device) -> Any:
    """A reference parameter tree (numpy / jax arrays, bfloat16 included)
    as torch tensors on ``device``, bit for bit, with the same leaf keys."""
    return tree_map(lambda x: array_to_tensor(x).to(device), tree)


def state_from_numpy(state: Dict[str, Any], device) -> Dict[str, Any]:
    """A reference state as the port's: tensors on ``device``, the shared
    state's per-job ``counts`` and the single-job ``count`` as ints."""
    out = {k: array_to_tensor(v).to(device)
           for k, v in state.items() if k not in ("counts", "count")}
    if "count" in state:
        out["count"] = int(np.asarray(state["count"]))
    else:
        out["counts"] = {j: int(np.asarray(c))
                         for j, c in state.get("counts", {}).items()}
    return out


def job_profile_from_tree(
    job_id: str,
    tree,
    iteration_duration: float = 1.0,
    n_workers: int = 2,
    required_servers: int = 1,
    agg_throughput: float = 7e9,
    model: str = "custom",
) -> Tuple[JobProfile, Dict[int, TensorSpec]]:
    """Control-plane JobProfile + data-plane specs for a parameter tree:
    one AggTask per leaf, ``tensor_id`` = leaf index, ``exec_time`` =
    nbytes / agg_throughput."""
    specs = dict(enumerate(tree_specs(tree)))
    tasks = [
        AggTask(job_id, i, spec.key, nbytes=spec.size * 4,
                exec_time=spec.size * 4 / agg_throughput)
        for i, spec in specs.items()
    ]
    profile = JobProfile(job_id, model, iteration_duration, tasks,
                         n_workers=n_workers,
                         required_servers=required_servers)
    return profile, specs


def build_flat_plan(abstract_params, n_shards: int, mode: str = "balanced",
                    pad_to: int = 128, job_id: str = "flat") -> FlatPlan:
    """Standalone single-job plan (``runtime.py:112``): each tensor goes to
    a shard by the control plane's placement scheme, then the shards'
    segments are laid contiguously."""
    tasks: List[AggTask] = []
    meta: Dict[int, Tuple[str, Tuple[int, ...], Any, int]] = {}
    for i, (path, leaf) in enumerate(_tree_items(abstract_params)):
        shape = tuple(leaf.shape)
        size = int(np.prod(shape)) if shape else 1
        tasks.append(AggTask(job_id, i, _leaf_key(path), nbytes=size * 4,
                             exec_time=float(size)))
        meta[i] = (_leaf_key(path), shape, numpy_dtype(leaf.dtype), size)
    job = JobProfile(job_id, job_id, 1.0, tasks, required_servers=n_shards)
    if mode == "balanced":
        shards = balanced_shard_assignment(job, n_shards)
    elif mode == "round_robin":
        shards = round_robin_shard_assignment(job, n_shards)
    else:
        raise ValueError(f"unknown placement mode {mode!r}")
    segments: List[Segment] = []
    shard_sizes = []
    for s in range(n_shards):
        off = 0
        for task in shards[s]:
            key, shape, dtype, size = meta[task.tensor_id]
            segments.append(Segment(key, s, off, size, shape, dtype,
                                    job_id=job_id, tensor_id=task.tensor_id))
            off += size
        shard_sizes.append(off)
    shard_len = max(1, -(-max(shard_sizes) // pad_to) * pad_to)
    return FlatPlan(n_shards=n_shards, shard_len=shard_len,
                    segments=tuple(segments), block_align=pad_to)


# ------------------------------------------------------- flat <-> trees
def flatten_tree(plan: FlatPlan, tree, job_id: Optional[str] = None,
                 device=None) -> torch.Tensor:
    """Pack a tree into the plan's full flat layout (float32); with
    ``job_id`` only that job's segments are filled, other lanes zero."""
    by_key = tree_leaves_by_key(tree)
    if device is None:
        device = next(iter(by_key.values())).device
    flat = torch.zeros(plan.total_len, dtype=torch.float32, device=device)
    for seg in plan.segments:
        if job_id is None or seg.job_id == job_id:
            start = plan.start(seg)
            flat[start : start + seg.size] = by_key[seg.key].reshape(-1)
    return flat


def unflatten_tree(plan: FlatPlan, flat: torch.Tensor, abstract_params,
                   job_id: Optional[str] = None):
    """Unpack (a job's segments of) the flat vector into a tree (pull).
    Each leaf is a COPY: live state is updated in place."""
    slices = {}
    for seg in plan.segments:
        if job_id is None or seg.job_id == job_id:
            start = plan.start(seg)
            slices[seg.key] = (flat[start : start + seg.size]
                               .reshape(seg.shape)
                               .to(torch_dtype(seg.dtype), copy=True))
    return _tree_rebuild(abstract_params, lambda key, _: slices[key])


def _rows(layout, device) -> torch.Tensor:
    return host_to_device(layout.blocks, device, torch.int64)


def _gather_owned(layout, vec: torch.Tensor) -> torch.Tensor:
    """A job's owned lanes of a full flat buffer: ONE block-row gather, a
    new tensor (a copy even when the job owns the whole space)."""
    if layout.covers_all:
        return vec.clone()
    return vec.view(-1, layout.block)[_rows(layout, vec.device)].reshape(-1)


def _scatter_owned(layout, vec: torch.Tensor, packed) -> torch.Tensor:
    """Write a packed job-local vector onto the job's owned lanes of a full
    flat buffer, in place (ONE block-row scatter).  Returns ``vec``."""
    packed = torch.as_tensor(packed, dtype=vec.dtype, device=vec.device)
    if layout.covers_all:
        vec.copy_(packed.reshape(vec.shape))
        return vec
    vec.view(-1, layout.block)[_rows(layout, vec.device)] = \
        packed.reshape(-1, layout.block)
    return vec


def _unpack_slots(layout, packed: torch.Tensor, abstract_params):
    """Packed job-local vector -> tree (views of ``packed``)."""
    by_key = {key: packed[start : start + size].reshape(shape)
              .to(torch_dtype(dtype))
              for key, start, size, shape, dtype in layout.slots}
    return _tree_rebuild(abstract_params, lambda key, _: by_key[key])


def _pack_slots(layout, tree) -> torch.Tensor:
    """Tree -> packed job-local float32 vector (zeros on intra-block
    padding)."""
    by_key = tree_leaves_by_key(tree)
    device = next(iter(by_key.values())).device if by_key else None
    packed = torch.zeros(layout.packed_len, dtype=torch.float32, device=device)
    for key, start, size, _, _ in layout.slots:
        packed[start : start + size] = by_key[key].reshape(-1)
    return packed


# ------------------------------------------------------------------ PS step
def _adam_math(p32, g, mu0, nu0, count: int, *, lr, b1, b2, eps):
    """One fp32 Adam update in EXACTLY the kernels' arithmetic form
    (reciprocal-multiply bias correction, ``(lr*mu_hat)/(sqrt+eps)``,
    ``1-b`` folded in doubles), with the hyperparameter row from the ONE
    table builder the kernels use.  Returns (new_p, mu, nu)."""
    hp = host_to_device(agg_ops.multi_job_hp([count], lr=lr, b1=b1, b2=b2,
                                             eps=eps), p32.device)
    new_p, mu, nu = agg_ref.adam_rows(hp, p32.reshape(1, -1),
                                      g.reshape(1, -1), mu0.reshape(1, -1),
                                      nu0.reshape(1, -1))
    return new_p.reshape(-1), mu.reshape(-1), nu.reshape(-1)


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1 item {item})")


def make_ps_train_step(
    model_loss: Callable[[Any, Any], torch.Tensor],
    plan: FlatPlan,
    abstract_params,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    push_compression: Optional[str] = None,
    fused_kernel: bool = False,
    job_id: Optional[str] = None,
    update_mode: str = "block",  # 'block' (O(job)) | 'masked' (oracle)
):
    """Build a PS-mode train step ``(state, batch) -> (state, {"loss"})``,
    updating ``state``'s buffers in place.

    ``job_id=None`` is the single-job step over a :func:`build_flat_plan`
    space, state ``{flat, mu, nu, count}`` (:func:`init_ps_state`): pull
    the whole tree, autograd, push the float32 flat gradient, and Adam
    over every lane -- kernel K5 in one launch with ``fused_kernel=True``,
    the plain ``_adam_math`` without.

    With a ``job_id``, the step is that job's in a shared space:
    ``update_mode="block"`` runs in the job's packed domain (one gather,
    one pack, Adam over its owned lanes through kernel K3, one scatter per
    buffer).  ``fused_kernel`` is accepted for the reference's signature
    and changes nothing: the block step always runs K3, whose wrapper
    takes the plain version only for CPU tensors.
    ``update_mode="masked"`` is the full-space oracle: Adam over every
    lane with the plain ``_adam_math``, kept only on the job's payload
    lanes.
    """
    if update_mode not in ("block", "masked"):
        raise ValueError(f"unknown update_mode {update_mode!r}")
    if push_compression:
        raise _not_in_slice("push_compression", "4")
    if job_id is None:
        return _make_single_job_step(model_loss, plan, abstract_params,
                                     lr=lr, b1=b1, b2=b2, eps=eps,
                                     fused_kernel=fused_kernel)
    if update_mode == "block":
        return _make_block_step(model_loss, plan, abstract_params, lr=lr,
                                b1=b1, b2=b2, eps=eps, job_id=job_id)
    mask_np = segment_mask(plan, job_id)

    def step(state, batch):
        flat = state["flat"]
        mask = host_to_device(mask_np, flat.device)
        params = unflatten_tree(plan, flat, abstract_params, job_id)
        grads, loss = torch.func.grad_and_value(model_loss)(params, batch)
        gflat = flatten_tree(plan, grads, job_id, device=flat.device)
        count = state["counts"][job_id] + 1
        new_flat, mu, nu = _adam_math(flat, gflat, state["mu"], state["nu"],
                                      count, lr=lr, b1=b1, b2=b2, eps=eps)
        flat.copy_(torch.where(mask, new_flat, flat))
        state["mu"].copy_(torch.where(mask, mu, state["mu"]))
        state["nu"].copy_(torch.where(mask, nu, state["nu"]))
        return (dict(state, counts=dict(state["counts"], **{job_id: count})),
                {"loss": loss})

    return step


def _make_single_job_step(model_loss, plan, abstract_params, *, lr, b1, b2,
                          eps, fused_kernel):
    """The single-job step (``runtime.py:361-420`` with ``job_id=None``)."""
    grad_fn = value_and_grad(model_loss)

    def step(state, batch):
        flat = state["flat"]
        params = unflatten_tree(plan, flat, abstract_params)  # PULL
        loss, grads = grad_fn(params, batch)
        gflat = flatten_tree(plan, grads, device=flat.device)  # PUSH, fp32
        del params, grads
        count = state["count"] + 1
        if fused_kernel:
            agg_ops.adam_update(flat, gflat, state["mu"], state["nu"], count,
                                lr=lr, b1=b1, b2=b2, eps=eps, wd=0.0)
        else:
            new = _adam_math(flat, gflat, state["mu"], state["nu"], count,
                             lr=lr, b1=b1, b2=b2, eps=eps)
            for name, t in zip(("flat", "mu", "nu"), new):
                state[name].copy_(t)
        return dict(state, count=count), {"loss": loss}

    return step


def _make_block_step(model_loss, plan, abstract_params, *, lr, b1, b2, eps,
                     job_id):
    """O(job-bytes) step over the job's packed domain through kernel K3;
    co-resident jobs' lanes are never read or written."""
    layout = plan.job_layout(job_id)

    def step(state, batch):
        flat = state["flat"]
        packed_p = _gather_owned(layout, flat)  # PULL: one row gather
        params = _unpack_slots(layout, packed_p, abstract_params)
        grads, loss = torch.func.grad_and_value(model_loss)(params, batch)
        g = _pack_slots(layout, grads)  # PUSH: one packed vector
        count = state["counts"][job_id] + 1
        # K3 reads the owned blocks of the FULL mu/nu itself; p goes in
        # packed, since the pull already materialized it.
        new_p, mu, nu = agg_ops.block_adam_update(
            packed_p, g, state["mu"], state["nu"], count,
            block_idx=layout.blocks, block=layout.block, lr=lr, b1=b1,
            b2=b2, eps=eps, wd=0.0, p_packed=True)
        _scatter_owned(layout, flat, new_p)
        _scatter_owned(layout, state["mu"], mu)
        _scatter_owned(layout, state["nu"], nu)
        return (dict(state, counts=dict(state["counts"], **{job_id: count})),
                {"loss": loss})

    return step


def init_ps_state(plan: FlatPlan, params, push_compression=None
                  ) -> Dict[str, Any]:
    """Single-job state on the params' device: the flat buffer holds
    exactly this job's tensors (float32), fresh moments, ``count`` 0."""
    if push_compression:
        raise _not_in_slice("push_compression", "4")
    flat = flatten_tree(plan, params)
    return {"flat": flat, "mu": torch.zeros_like(flat),
            "nu": torch.zeros_like(flat), "count": 0}


def init_shared_state(plan: FlatPlan, device) -> Dict[str, Any]:
    """Empty shared state for a compiled multi-job plan: zero flat/mu/nu
    (separate buffers) and no step counters; jobs are seeded with
    :func:`seed_job_params`."""
    state: Dict[str, Any] = {
        name: torch.zeros(plan.total_len, dtype=torch.float32, device=device)
        for name in ("flat", "mu", "nu")}
    state["counts"] = {}
    return state


def seed_job_params(plan: FlatPlan, state, job_id: str, params):
    """Write a job's initial parameters into its owned blocks of the
    shared space, with fresh (zero) Adam moments and step counter; other
    jobs' lanes are untouched.  Updates the buffers in place; each buffer
    gets its own zeros (never one shared tensor) so mu and nu cannot
    alias."""
    layout = plan.job_layout(job_id)
    flat = state["flat"]
    _scatter_owned(layout, flat, _pack_slots(layout, params).to(flat.device))
    for name in ("mu", "nu"):
        _scatter_owned(layout, state[name],
                       torch.zeros(layout.packed_len, dtype=torch.float32,
                                   device=flat.device))
    return dict(state, counts=dict(state["counts"], **{job_id: 0}))
