"""ServicePlan: the single source of truth between control and data plane.

The control plane (repro.core.service.ParameterService) decides which
Aggregator hosts each ``(job_id, tensor_id)`` aggregation task; the data
plane executes pull/push/update against a *flat parameter space* laid out
across aggregator shards.  This module is the bridge: it compiles the live
``Aggregator.tasks`` mapping into a :class:`FlatPlan` whose segments are
keyed by ``(job_id, tensor_key)``, so one flat aggregation space can host
segments from *many* registered jobs at once and a replan is just a pair of
plans handed to ``repro.ps.elastic.migrate_flat_state``.

Kept deliberately JAX-free (numpy + core types only): the simulator and the
control plane can compile and diff plans without touching a device.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TensorSpec:
    """Data-plane metadata for one aggregation task's tensor."""

    key: str  # pytree path key within the job's parameter tree
    shape: Tuple[int, ...]
    dtype: Any  # numpy dtype; torch.bfloat16 where numpy has none

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


@dataclass(frozen=True)
class Segment:
    """One tensor's slice of the flat aggregation space.

    ``(job_id, key)`` is the identity used across replans; ``tensor_id``
    ties the segment back to the control plane's AggTask.
    """

    key: str
    shard: int
    offset: int  # element offset within the shard
    size: int
    shape: Tuple[int, ...]
    dtype: Any
    job_id: str = "flat"
    tensor_id: int = -1

    @property
    def skey(self) -> Tuple[str, str]:
        """Job-qualified identity, stable across replans."""
        return (self.job_id, self.key)


@dataclass(frozen=True)
class JobLayout:
    """Precompiled O(job)-cost access structure for one job of a plan.

    Everything here is plain numpy, computed once at plan time, so the hot
    path never rescans segments: ``own_idx`` drives the pull gather and the
    update scatter, ``blocks`` drives the block-owned Pallas kernel's
    scalar-prefetch grid, and ``slots`` place each tensor inside the packed
    (job-local) vector.
    """

    job_id: str
    block: int  # element granularity of block ownership
    n_total_blocks: int  # blocks in the whole flat space
    blocks: np.ndarray  # (n_blocks,) int32 owned block ids, ascending
    own_idx: np.ndarray  # (n_blocks*block,) int32 flat indices of owned lanes
    slots: Tuple[Tuple[str, int, int, Tuple[int, ...], Any], ...]
    # per segment, in packed order: (key, packed_start, size, shape, dtype)

    @property
    def packed_len(self) -> int:
        """Length of the packed (block-padded) job-local vector."""
        return int(self.own_idx.size)

    @property
    def payload_elements(self) -> int:
        return sum(size for _, _, size, _, _ in self.slots)

    @property
    def covers_all(self) -> bool:
        """True when the job owns every block of the flat space (single-job
        plans): gather/scatter degenerate to the identity."""
        return self.blocks.size == self.n_total_blocks


@dataclass(frozen=True)
class FlatPlan:
    """Physical layout of one shared flat aggregation space.

    ``shard_ids`` names the Aggregator backing each shard (empty for
    synthetic single-job plans built by ``build_flat_plan``).
    ``block_align`` is the element granularity at which each job's run of
    segments within a shard is padded (and the shard length rounded), so
    every ``block_align``-sized block of the flat space holds at most ONE
    job's payload -- the invariant the block-owned update path relies on.

    Per-job access structures (:meth:`payload_index`, :meth:`job_layout`)
    are compiled lazily and cached on the plan, so the data plane's hot
    path costs O(job bytes) instead of O(total space) per step.
    """

    n_shards: int
    shard_len: int  # padded elements per shard
    segments: Tuple[Segment, ...]  # in (shard, offset) order
    shard_ids: Tuple[str, ...] = ()
    block_align: int = 1  # job-run padding granularity (1 = legacy layout)

    @property
    def total_len(self) -> int:
        return self.n_shards * self.shard_len

    @property
    def payload_elements(self) -> int:
        return sum(s.size for s in self.segments)

    @cached_property
    def shard_segments(self) -> Tuple[Tuple[int, ...], ...]:
        """Per-shard segment indices in offset order (precomputed once, so
        flatten/unflatten are O(n_segments) instead of O(shards*segments))."""
        buckets: List[List[int]] = [[] for _ in range(self.n_shards)]
        for i, seg in enumerate(self.segments):
            buckets[seg.shard].append(i)
        for b in buckets:
            b.sort(key=lambda i: self.segments[i].offset)
        return tuple(tuple(b) for b in buckets)

    @cached_property
    def by_skey(self) -> Dict[Tuple[str, str], Segment]:
        return {s.skey: s for s in self.segments}

    @cached_property
    def job_ids(self) -> Tuple[str, ...]:
        seen: Dict[str, None] = {}
        for s in self.segments:
            seen.setdefault(s.job_id, None)
        return tuple(seen)

    def segments_of(self, job_id: str) -> Tuple[Segment, ...]:
        return tuple(s for s in self.segments if s.job_id == job_id)

    def start(self, seg: Segment) -> int:
        """Absolute element offset of a segment in the flat vector."""
        return seg.shard * self.shard_len + seg.offset

    # --------------------------------------- precompiled access structures
    @cached_property
    def _lane_owner(self) -> np.ndarray:
        """Per-lane owner: index into ``job_ids``, -1 on padding lanes."""
        owner = np.full(self.total_len, -1, np.int32)
        jix = {j: i for i, j in enumerate(self.job_ids)}
        for seg in self.segments:
            s = self.start(seg)
            owner[s : s + seg.size] = jix[seg.job_id]
        return owner

    @cached_property
    def _access_cache(self) -> Dict[Any, Any]:
        return {}

    def payload_index(self, job_id: Optional[str] = None) -> np.ndarray:
        """Flat positions of (the job's) payload lanes, in segment order.

        Exact per-lane gather/scatter map -- the fallback access structure
        when a plan is not block-exclusive (hand-built / legacy layouts);
        the hot path uses the coarser, memcpy-friendly :meth:`job_layout`
        blocks instead.  Cached per job; read-only.
        """
        key = ("payload", job_id)
        idx = self._access_cache.get(key)
        if idx is None:
            parts = [
                np.arange(self.start(s), self.start(s) + s.size, dtype=np.int32)
                for s in self.segments
                if job_id is None or s.job_id == job_id
            ]
            idx = (np.concatenate(parts) if parts
                   else np.zeros((0,), np.int32))
            idx.setflags(write=False)
            self._access_cache[key] = idx
        return idx

    def job_layout(self, job_id: str, block: Optional[int] = None) -> JobLayout:
        """Compile (and cache) the job's block-owned access structure.

        ``block`` defaults to the plan's ``block_align``.  Raises
        ``ValueError`` if the plan's layout is not block-exclusive at that
        granularity (some block mixes two jobs' payload), in which case the
        masked O(total-space) path is the only correct one.
        """
        block = self.block_align if block is None else block
        key = ("layout", job_id, block)
        cached = self._access_cache.get(key)
        if cached is not None:
            return cached
        if job_id not in self.job_ids:
            raise ValueError(f"job {job_id!r} has no segments in this plan")
        if block < 1 or self.shard_len % block:
            raise ValueError(
                f"block={block} does not divide shard_len={self.shard_len}")
        jix = list(self.job_ids).index(job_id)
        per_block = self._lane_owner.reshape(-1, block)
        mine = (per_block == jix).any(axis=1)
        foreign = ((per_block >= 0) & (per_block != jix)).any(axis=1)
        if bool((mine & foreign).any()):
            raise ValueError(
                f"plan is not block-exclusive at block={block}: job "
                f"{job_id!r} shares a block with another job (legacy "
                f"unaligned layout? recompile with block_align >= block)")
        blocks = np.nonzero(mine)[0].astype(np.int32)
        own_idx = (blocks[:, None].astype(np.int64) * block
                   + np.arange(block)).reshape(-1).astype(np.int32)
        slots = []
        for seg in self.segments:
            if seg.job_id != job_id:
                continue
            # The key in the table's own dtype: a Python int key makes
            # numpy cast the whole int32 table on every call (O(lanes) per
            # segment -- minutes at the paper workloads' sizes).
            pstart = int(np.searchsorted(
                own_idx, own_idx.dtype.type(self.start(seg))))
            slots.append((seg.key, pstart, seg.size, seg.shape, seg.dtype))
        slots.sort(key=lambda s: s[1])
        blocks.setflags(write=False)
        own_idx.setflags(write=False)
        layout = JobLayout(job_id=job_id, block=block,
                           n_total_blocks=self.total_len // block,
                           blocks=blocks, own_idx=own_idx,
                           slots=tuple(slots))
        self._access_cache[key] = layout
        return layout


@dataclass(frozen=True)
class ShardedJobLayout:
    """One job's access structure across ALL the shard spaces hosting it.

    ``layouts[i]`` is the per-shard :class:`JobLayout` inside shard space
    ``shard_ids[i]``; ``slots`` is the job's packed slot table over the
    CONCATENATION of those per-shard packed vectors (in ``shard_ids``
    order), so ``_pack_slots`` / ``_unpack_slots`` work on the combined
    vector unchanged.  ``piece_offsets[i] : piece_offsets[i] + piece
    length`` slices shard ``i``'s packed piece out of the combined vector.
    """

    job_id: str
    shard_ids: Tuple[str, ...]  # hosting Aggregators, in shard order
    shard_indices: Tuple[int, ...]  # indices into ShardedPlan.shards
    layouts: Tuple[JobLayout, ...]
    slots: Tuple[Tuple[str, int, int, Tuple[int, ...], Any], ...]
    piece_offsets: Tuple[int, ...]  # combined-vector start of each piece

    @property
    def packed_len(self) -> int:
        return sum(l.packed_len for l in self.layouts)

    @property
    def n_shards(self) -> int:
        return len(self.layouts)


@dataclass(frozen=True)
class ShardedPlan:
    """N per-Aggregator shard spaces (the sharded data plane's layout).

    Where :class:`FlatPlan` flattens every job into ONE shared space with a
    uniform ``shard_len`` (padding every Aggregator to the largest), a
    ShardedPlan gives each live Aggregator its OWN flat space -- a
    single-shard FlatPlan sized to that Aggregator's content -- so shard
    count changes what actually executes: each shard space ticks, migrates,
    and checkpoints independently, keyed by its stable ``agg_id``.
    """

    shards: Tuple[FlatPlan, ...]  # each n_shards=1, shard_ids=(agg_id,)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @cached_property
    def shard_ids(self) -> Tuple[str, ...]:
        return tuple(sp.shard_ids[0] for sp in self.shards)

    @property
    def total_len(self) -> int:
        return sum(sp.total_len for sp in self.shards)

    @property
    def payload_elements(self) -> int:
        return sum(sp.payload_elements for sp in self.shards)

    @cached_property
    def job_ids(self) -> Tuple[str, ...]:
        seen: Dict[str, None] = {}
        for sp in self.shards:
            for j in sp.job_ids:
                seen.setdefault(j, None)
        return tuple(seen)

    @cached_property
    def _index_of(self) -> Dict[str, int]:
        return {sid: i for i, sid in enumerate(self.shard_ids)}

    def index_of(self, shard_id: str) -> Optional[int]:
        """Shard index backing ``shard_id`` (None if not in this plan)."""
        return self._index_of.get(shard_id)

    def shard_of(self, shard_id: str) -> FlatPlan:
        return self.shards[self._index_of[shard_id]]

    @cached_property
    def by_skey(self) -> Dict[Tuple[str, str], Tuple[str, Segment]]:
        """(job_id, key) -> (shard_id, segment): cross-shard identity map."""
        out: Dict[Tuple[str, str], Tuple[str, Segment]] = {}
        for sid, sp in zip(self.shard_ids, self.shards):
            for seg in sp.segments:
                out[seg.skey] = (sid, seg)
        return out

    def job_shards(self, job_id: str) -> Tuple[int, ...]:
        """Indices of the shards hosting any of the job's segments."""
        return tuple(i for i, sp in enumerate(self.shards)
                     if job_id in sp.job_ids)

    # --------------------------------------------- concatenated fleet view
    @cached_property
    def concat_offsets(self) -> Tuple[int, ...]:
        """Element offset of each shard space in the CONCATENATED fleet
        view (``shard_ids`` order): the base the single-launch fleet tick
        adds to a shard's local indices to address all lanes' state as
        one buffer."""
        offs: List[int] = []
        off = 0
        for sp in self.shards:
            offs.append(off)
            off += sp.total_len
        return tuple(offs)

    @cached_property
    def uniform_block_align(self) -> Optional[int]:
        """The common ``block_align`` of every shard space, or ``None``
        when shards disagree -- one fused fleet launch needs a single
        global block granularity across the concatenated view."""
        aligns = {sp.block_align for sp in self.shards}
        return aligns.pop() if len(aligns) == 1 else None

    def concat_view(self, shard_ids: Optional[Sequence[str]] = None
                    ) -> Tuple[Tuple[int, ...], int, int]:
        """(element offsets, total length, block) of the concatenated view
        over the given lanes (default: every shard, == ``concat_offsets``).

        Each shard's ``shard_len`` is a multiple of its ``block_align``,
        so with a uniform alignment the offsets are block-aligned and a
        shard-local block ``b`` maps to global block
        ``offset // block + b`` -- the per-block half of the fused fleet
        tick's scalar-prefetched table.  Raises ``ValueError`` when the
        participating shards do not share one ``block_align``.
        """
        if shard_ids is None:
            ids = list(self.shard_ids)
            shards = list(self.shards)
        else:
            ids = list(shard_ids)
            shards = [self.shard_of(sid) for sid in shard_ids]
        aligns = {sp.block_align for sp in shards}
        if len(aligns) != 1:
            by_align: Dict[int, List[str]] = {}
            for sid, sp in zip(ids, shards):
                by_align.setdefault(sp.block_align, []).append(sid)
            detail = "; ".join(
                f"block_align={a}: {', '.join(sids)}"
                for a, sids in sorted(by_align.items()))
            raise ValueError(
                f"concatenated view needs one block granularity across "
                f"the participating shards, but they disagree -- "
                f"{detail}.  Tick the fleet with fleet_tick='per_shard' "
                f"(one launch group per lane tolerates mixed "
                f"granularities), or recompile the plan with a uniform "
                f"pad_to to restore the single fused launch")
        block = aligns.pop()
        offs: List[int] = []
        off = 0
        for sp in shards:
            offs.append(off)
            off += sp.total_len
        return tuple(offs), off, block

    @cached_property
    def _layout_cache(self) -> Dict[str, ShardedJobLayout]:
        return {}

    def job_layout(self, job_id: str) -> ShardedJobLayout:
        """Compile (and cache) the job's cross-shard access structure."""
        cached = self._layout_cache.get(job_id)
        if cached is not None:
            return cached
        hosting = self.job_shards(job_id)
        if not hosting:
            raise ValueError(f"job {job_id!r} has no segments in this plan")
        layouts = tuple(self.shards[i].job_layout(job_id) for i in hosting)
        slots: List[Tuple[str, int, int, Tuple[int, ...], Any]] = []
        offsets: List[int] = []
        off = 0
        for l in layouts:
            offsets.append(off)
            for key, pstart, size, shape, dtype in l.slots:
                slots.append((key, off + pstart, size, shape, dtype))
            off += l.packed_len
        layout = ShardedJobLayout(
            job_id=job_id,
            shard_ids=tuple(self.shard_ids[i] for i in hosting),
            shard_indices=hosting, layouts=layouts, slots=tuple(slots),
            piece_offsets=tuple(offsets),
        )
        self._layout_cache[job_id] = layout
        return layout


def compile_sharded_plan(
    aggregators: Sequence[Any],
    specs: Optional[Mapping[str, Mapping[int, TensorSpec]]] = None,
    pad_to: int = 128,
) -> ShardedPlan:
    """Compile the live assignment into per-Aggregator shard spaces.

    Each Aggregator becomes ONE single-shard FlatPlan laid out exactly as
    :func:`compile_service_plan` lays that Aggregator out (same job-run
    alignment, same segment order), but with ``shard_len`` padded to the
    shard's OWN content instead of the fleet-wide maximum -- so with one
    Aggregator the shard space is bit-identical to the flat plan's, and
    with many there is no cross-shard padding coupling at all.
    """
    specs = specs or {}
    shards: List[FlatPlan] = []
    for agg in aggregators:
        segments: List[Segment] = []
        off = 0
        prev_job: Optional[str] = None
        for (job_id, tensor_id), task in sorted(agg.tasks.items()):
            if prev_job is not None and job_id != prev_job:
                off = -(-off // pad_to) * pad_to  # align the job-run start
            prev_job = job_id
            spec = specs.get(job_id, {}).get(tensor_id)
            if spec is None:
                n = max(1, task.nbytes // 4)
                spec = TensorSpec(task.name, (n,), np.float32)
            segments.append(
                Segment(spec.key, 0, off, spec.size, tuple(spec.shape),
                        spec.dtype, job_id=job_id, tensor_id=tensor_id)
            )
            off += spec.size
        shard_len = max(1, -(-max(1, off) // pad_to) * pad_to)
        shards.append(FlatPlan(
            n_shards=1, shard_len=shard_len, segments=tuple(segments),
            shard_ids=(getattr(agg, "agg_id", f"shard{len(shards)}"),),
            block_align=pad_to,
        ))
    return ShardedPlan(shards=tuple(shards))


def sharded_plan_to_json(plan: ShardedPlan) -> Dict[str, Any]:
    return {"shards": [plan_to_json(sp) for sp in plan.shards]}


def sharded_plan_from_json(obj: Mapping[str, Any]) -> ShardedPlan:
    return ShardedPlan(
        shards=tuple(plan_from_json(sp) for sp in obj["shards"]))


def plan_padding_waste(plan: FlatPlan) -> float:
    """Fraction of the flat space that is padding (imbalance cost)."""
    if plan.total_len <= 0:
        return 0.0
    return 1.0 - plan.payload_elements / plan.total_len


def segment_mask(plan: FlatPlan, job_id: Optional[str] = None) -> np.ndarray:
    """Boolean mask over the flat vector: True on (the job's) payload lanes."""
    mask = np.zeros(plan.total_len, dtype=bool)
    for seg in plan.segments:
        if job_id is None or seg.job_id == job_id:
            start = plan.start(seg)
            mask[start : start + seg.size] = True
    return mask


# ----------------------------------------------------------------- compile
def compile_service_plan(
    aggregators: Sequence[Any],
    specs: Optional[Mapping[str, Mapping[int, TensorSpec]]] = None,
    pad_to: int = 128,
) -> FlatPlan:
    """Compile the live control-plane assignment into a multi-job FlatPlan.

    One shard per Aggregator, in the given (stable) order; within a shard,
    segments are laid contiguously in ``(job_id, tensor_id)`` order so the
    layout is a pure function of the assignment.  Each job's run of
    segments is padded up to a ``pad_to`` boundary, so every ``pad_to``
    block of the flat space belongs to at most one job -- the invariant
    behind the block-owned O(job-bytes) update path (``job_layout``).
    ``specs`` supplies real shapes/dtypes per ``job_id -> tensor_id``;
    tasks without a bound spec (control-plane-only jobs, e.g. in the
    simulator) fall back to a 1-D float32 tensor sized from
    ``AggTask.nbytes``.
    """
    specs = specs or {}
    segments: List[Segment] = []
    shard_sizes: List[int] = []
    shard_ids: List[str] = []
    for shard, agg in enumerate(aggregators):
        off = 0
        prev_job: Optional[str] = None
        for (job_id, tensor_id), task in sorted(agg.tasks.items()):
            if prev_job is not None and job_id != prev_job:
                off = -(-off // pad_to) * pad_to  # align the job-run start
            prev_job = job_id
            spec = specs.get(job_id, {}).get(tensor_id)
            if spec is None:
                n = max(1, task.nbytes // 4)
                spec = TensorSpec(task.name, (n,), np.float32)
            segments.append(
                Segment(spec.key, shard, off, spec.size, tuple(spec.shape),
                        spec.dtype, job_id=job_id, tensor_id=tensor_id)
            )
            off += spec.size
        shard_sizes.append(off)
        shard_ids.append(getattr(agg, "agg_id", f"shard{shard}"))
    largest = max(shard_sizes, default=0)
    shard_len = max(1, -(-max(1, largest) // pad_to) * pad_to)
    return FlatPlan(
        n_shards=len(shard_ids),
        shard_len=shard_len,
        segments=tuple(segments),
        shard_ids=tuple(shard_ids),
        block_align=pad_to,
    )


# --------------------------------------------------------------- migration
def plan_migration_bytes(
    old: FlatPlan, new: FlatPlan, bytes_per_element: int = 12
) -> int:
    """Bytes that cross Aggregators between two plans (master copy + both
    Adam moments at 4 B each by default).

    Ownership is compared by ``shard_ids`` (the backing Aggregator) when
    both plans carry them: a shard *index* shift -- e.g. an emptied
    Aggregator dropping out of the list -- does not move any bytes off the
    segments' actual host.  Synthetic plans without shard_ids fall back to
    index comparison.  Segments only present in one plan are job
    arrivals/exits, not migrations, and are not counted."""
    by_id = bool(old.shard_ids) and bool(new.shard_ids)

    def owner(plan: FlatPlan, seg: Segment):
        return plan.shard_ids[seg.shard] if by_id else seg.shard

    moved = 0
    old_by = old.by_skey
    for seg in new.segments:
        prev = old_by.get(seg.skey)
        if prev is not None and owner(old, prev) != owner(new, seg):
            moved += seg.size * bytes_per_element
    return moved


# ----------------------------------------------------------- serialization
def dtype_name(dtype) -> str:
    """numpy's name for a segment dtype.  numpy has no bfloat16: the port
    keeps ``torch.bfloat16`` for it and names it as the reference does."""
    if str(dtype) == "torch.bfloat16":
        return "bfloat16"
    return np.dtype(dtype).name


def dtype_from_name(name: str):
    if name == "bfloat16":
        import torch

        return torch.bfloat16
    return np.dtype(name)


def plan_to_json(plan: FlatPlan) -> Dict[str, Any]:
    return {
        "n_shards": plan.n_shards,
        "shard_len": plan.shard_len,
        "shard_ids": list(plan.shard_ids),
        "block_align": plan.block_align,
        "segments": [
            {
                "key": s.key,
                "shard": s.shard,
                "offset": s.offset,
                "size": s.size,
                "shape": list(s.shape),
                "dtype": dtype_name(s.dtype),
                "job_id": s.job_id,
                "tensor_id": s.tensor_id,
            }
            for s in plan.segments
        ],
    }


def plan_from_json(obj: Mapping[str, Any]) -> FlatPlan:
    segments = tuple(
        Segment(
            key=s["key"],
            shard=int(s["shard"]),
            offset=int(s["offset"]),
            size=int(s["size"]),
            shape=tuple(s["shape"]),
            dtype=dtype_from_name(s["dtype"]),
            job_id=s.get("job_id", "flat"),
            tensor_id=int(s.get("tensor_id", -1)),
        )
        for s in obj["segments"]
    )
    return FlatPlan(
        n_shards=int(obj["n_shards"]),
        shard_len=int(obj["shard_len"]),
        segments=segments,
        shard_ids=tuple(obj.get("shard_ids", ())),
        block_align=int(obj.get("block_align", 1)),
    )


def plan_dumps(plan: FlatPlan) -> str:
    return json.dumps(plan_to_json(plan))


def plan_loads(text: str) -> FlatPlan:
    return plan_from_json(json.loads(text))
