"""Plan-pair migrations of the flat shared state (PyTorch).

The counterpart of ``repro.ps.elastic``, flat half.  Two executors re-lay
a state from one FlatPlan to another:

``migrate_flat_state``
    The full-gather ORACLE: one permutation gather over the whole new
    space, O(total bytes), returning new tensors.

``migrate_flat_state_delta``
    The shipped O(moved-bytes) path: a :class:`MigrationDelta` compiled
    per plan pair names the moved runs and vacated lanes, and the
    relayout kernels (``repro_torch.kernels.relayout``) stage and scatter
    only the touched blocks of flat/mu/nu (and ``ef``) in one launch each.
    Bit-exact
    with the oracle on valid states (non-payload lanes zero).  A buffer
    that keeps its length is updated IN PLACE.

``migrate_sharded_state``
    The sharded fleet's transition: each surviving shard space migrates
    through its own delta (the same kernels), a joining shard starts at
    zero, and segments that changed Aggregator arrive with one index
    write per leaf.  The input states are only read: the new states are
    written into fresh buffers (the runtime's next fleet arena), so an
    aborted replan leaves the caller's states whole.

``compile_migration_delta`` builds the delta from the plans' segments:
a common segment moves rigidly (one shift for all its lanes), so the
runs, the vacated intervals and the touched blocks follow from
O(segments) interval arithmetic, and only the per-lane staging map costs
O(touched lanes).  It produces the reference's ``MigrationDelta`` field
for field (the tests hold it to that on randomized plan pairs) without
the reference's O(total lanes) int64 arrays, which at the paper
workloads' 634 M lanes would take tens of GB of host memory per replan.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import host_to_device
from .plan import FlatPlan, ShardedPlan, plan_migration_bytes


class PlanPerm(NamedTuple):
    """Precompiled (old -> new) lane permutation for one plan pair."""

    idx: np.ndarray  # (new.total_len,) int64 source lanes
    keep: np.ndarray  # (new.total_len,) bool: covered by a common segment
    all_kept: bool
    identity: bool  # the move is a no-op (every lane stays put)


class MigrationDelta(NamedTuple):
    """Compiled plan-pair transition: only what CHANGES, as runs.

    ``moves`` are maximal contiguous runs of kept lanes whose flat
    position changed (constant shift within a run); ``zeros`` are runs of
    lanes that held old payload at a position no common segment covers in
    the new plan and must read zero afterwards.  ``touched_blocks`` are
    the new-plan ``block_align`` blocks any run intersects, with
    ``stage_map`` the per-lane source map of exactly those blocks (packed,
    block order) as the staging kernel reads it: int32, -1 on lanes that
    carry no payload.  ``touched_jobs`` are the jobs whose segment layout
    differs between the plans (arrivals and exits included): only they
    are quiesced by a replan.  The reference's ``stage_src`` (int64, 0
    where empty) and ``stage_keep`` (bool) are derived from ``stage_map``
    on demand, so a compile writes 4 bytes per staged lane instead of 9.
    """

    old_len: int
    new_len: int
    block: int  # new plan's block_align
    moves: Tuple[Tuple[int, int, int], ...]  # (src, dst, length) runs
    zeros: Tuple[Tuple[int, int], ...]  # (dst, length) runs
    touched_jobs: Tuple[str, ...]
    touched_blocks: np.ndarray  # new-plan block ids hit by moves/zeros
    stage_map: np.ndarray  # (n_touched*block,) int32 source lane, -1 empty
    moved_elements: int
    zeroed_elements: int

    @property
    def stage_src(self) -> np.ndarray:
        """(n_touched*block,) int64 source lane per lane, 0 where empty."""
        return np.maximum(self.stage_map, 0).astype(np.int64)

    @property
    def stage_keep(self) -> np.ndarray:
        """(n_touched*block,) bool: the lane carries payload."""
        return self.stage_map >= 0

    @property
    def identity(self) -> bool:
        """Nothing to execute: same length, no moves, nothing vacated."""
        return (self.old_len == self.new_len and not self.moves
                and not self.zeros)

    @property
    def n_runs(self) -> int:
        return len(self.moves) + len(self.zeros)

    def moved_bytes(self, bytes_per_element: int = 12) -> int:
        """Bytes the delta path copies (master + both moments at 4 B)."""
        return self.moved_elements * bytes_per_element


# ------------------------------------------------------- bounded pair cache
class _PlanPairCache:
    """Size-bounded LRU for per-plan-pair structures (perms + deltas):
    evicts least-recently-used entries once the numpy payload exceeds
    ``max_bytes``, so a long-lived service cannot leak one structure per
    replan."""

    def __init__(self, max_bytes: int = 256 << 20):
        self.max_bytes = int(max_bytes)
        self._entries: "OrderedDict[Any, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def _nbytes(value: Any) -> int:
        # Every entry pays a floor (its key pins two FlatPlans) plus its
        # numpy AND python-tuple payload.
        def size(v: Any) -> int:
            n = getattr(v, "nbytes", None)
            if n is not None:
                return int(n)
            if isinstance(v, tuple):
                return 56 + sum(size(x) for x in v)
            return 32

        fields = getattr(value, "_fields", None)
        payload = (sum(size(getattr(value, f)) for f in fields)
                   if fields else size(value))
        return 1024 + payload

    def get(self, key):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[0]

    def put(self, key, value) -> None:
        nbytes = self._nbytes(value)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, (_, freed) = self._entries.popitem(last=False)
                self._bytes -= freed
                self.evictions += 1

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }

    def resize(self, max_bytes: int) -> None:
        with self._lock:
            self.max_bytes = int(max_bytes)
            while self._bytes > self.max_bytes and self._entries:
                _, (_, freed) = self._entries.popitem(last=False)
                self._bytes -= freed
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0


_PAIR_CACHE = _PlanPairCache()


def plan_cache_stats() -> Dict[str, int]:
    """Hits/misses/evictions/bytes of the per-plan-pair structure cache."""
    return _PAIR_CACHE.stats()


def set_plan_cache_limit(max_bytes: int) -> None:
    """Bound the per-plan-pair cache; evicts immediately if over."""
    _PAIR_CACHE.resize(max_bytes)


def clear_plan_cache() -> None:
    _PAIR_CACHE.clear()


def _plan_perm(old: FlatPlan, new: FlatPlan) -> PlanPerm:
    """(idx, keep) with new_flat[i] = old_flat[idx[i]] where keep[i], else
    0.  Lanes not covered by a common segment get keep=False.  O(total
    lanes): the oracle's structure, cached per plan pair."""
    key = ("perm", old, new)
    cached = _PAIR_CACHE.get(key)
    if cached is not None:
        return cached
    old_by_key = old.by_skey
    idx = np.zeros(new.total_len, dtype=np.int64)
    keep = np.zeros(new.total_len, dtype=bool)
    for seg in new.segments:
        o = old_by_key.get(seg.skey)
        if o is None:
            continue  # new job's segment: zero-initialized
        if o.size != seg.size:
            raise ValueError(
                f"segment {seg.skey} changed size {o.size} -> {seg.size}")
        src = old.start(o)
        dst = new.start(seg)
        idx[dst : dst + seg.size] = np.arange(src, src + seg.size)
        keep[dst : dst + seg.size] = True
    all_kept = bool(keep.all())
    identity = (
        all_kept
        and old.total_len == new.total_len
        and bool((idx == np.arange(new.total_len)).all())
    )
    idx.setflags(write=False)
    keep.setflags(write=False)
    perm = PlanPerm(idx, keep, all_kept, identity)
    _PAIR_CACHE.put(key, perm)
    return perm


def _job_layout_sigs(plan: FlatPlan) -> Dict[str, Tuple]:
    """Per-job layout fingerprint: absolute (start, size, key) of every
    segment, the block granularity, and whether the job owns EVERY block
    of the space.  Equal fingerprints mean the job's lanes, blocks and
    packed slots are identical in both plans.  O(segments log segments)."""
    block = max(1, plan.block_align)
    n_blocks_total = -(-plan.total_len // block)
    sigs: Dict[str, list] = {}
    spans: Dict[str, list] = {}
    for seg in plan.segments:
        start = plan.start(seg)
        sigs.setdefault(seg.job_id, []).append((start, seg.size, seg.key))
        spans.setdefault(seg.job_id, []).append(
            (start // block, (start + seg.size - 1) // block + 1))
    out = {}
    for j, v in sigs.items():
        n_owned, end = 0, -1
        for lo, hi in sorted(spans[j]):  # merged half-open block intervals
            lo = max(lo, end)
            if hi > lo:
                n_owned += hi - lo
                end = hi
        out[j] = (block, n_owned == n_blocks_total, tuple(sorted(v)))
    return out


def plan_transition_summary(old: FlatPlan, new: FlatPlan):
    """Segment-level view of a plan transition, O(segments): returns
    ``(moved_elements, touched_jobs)``, equal to the delta's."""
    key = ("summary", old, new)
    cached = _PAIR_CACHE.get(key)
    if cached is not None:
        return cached
    old_by_key = old.by_skey
    moved = 0
    for seg in new.segments:
        o = old_by_key.get(seg.skey)
        if o is None:
            continue
        if o.size != seg.size:
            raise ValueError(
                f"segment {seg.skey} changed size {o.size} -> {seg.size}")
        if old.start(o) != new.start(seg):
            moved += seg.size
    old_sigs = _job_layout_sigs(old)
    new_sigs = _job_layout_sigs(new)
    touched = tuple(sorted(
        j for j in set(old_sigs) | set(new_sigs)
        if old_sigs.get(j) != new_sigs.get(j)))
    summary = (moved, touched)
    _PAIR_CACHE.put(key, summary)
    return summary


def _merged(intervals) -> List[Tuple[int, int]]:
    """Sorted half-open intervals with touching/overlapping ones merged."""
    out: List[List[int]] = []
    for lo, hi in sorted(i for i in intervals if i[1] > i[0]):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _subtract(a: List[Tuple[int, int]], b: List[Tuple[int, int]]):
    """Merged intervals ``a`` minus merged intervals ``b``."""
    out, j = [], 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while lo < hi and k < len(b) and b[k][0] < hi:
            if b[k][0] > lo:
                out.append((lo, b[k][0]))
            lo = max(lo, b[k][1])
            k += 1
        if lo < hi:
            out.append((lo, hi))
    return out


def compile_migration_delta(old: FlatPlan, new: FlatPlan) -> MigrationDelta:
    """Compile the O(moved-bytes) transition for one plan pair (cached).

    Built from segments: every common segment keeps one shift (old start
    minus new start), so ``moves`` are the common segments with a
    non-zero shift, merged where they abut in the new space with equal
    shift; ``zeros`` are the old payload intervals not covered by a
    common segment in the new plan, below both lengths.  Equal, field for
    field, to ``repro.ps.elastic.compile_migration_delta``.
    """
    key = ("delta", old, new)
    cached = _PAIR_CACHE.get(key)
    if cached is not None:
        return cached
    old_len, new_len = old.total_len, new.total_len
    old_by_key = old.by_skey
    common = []  # (new start, size, shift) of every common segment
    for seg in new.segments:
        o = old_by_key.get(seg.skey)
        if o is None:
            continue
        if o.size != seg.size:
            raise ValueError(
                f"segment {seg.skey} changed size {o.size} -> {seg.size}")
        dst = new.start(seg)
        common.append((dst, seg.size, old.start(o) - dst))
    common.sort()

    runs: List[List[int]] = []  # [dst, length, shift]
    for dst, size, shift in common:
        if shift == 0 or size == 0:
            continue
        if runs and runs[-1][0] + runs[-1][1] == dst and runs[-1][2] == shift:
            runs[-1][1] += size
        else:
            runs.append([dst, size, shift])
    moves = tuple((d + s, d, n) for d, n, s in runs)

    limit = min(old_len, new_len)
    payload = _merged((old.start(s), old.start(s) + s.size)
                      for s in old.segments)
    kept = _merged((d, d + n) for d, n, _ in common)
    zeros = tuple((lo, hi - lo) for lo, hi in _subtract(
        [(lo, min(hi, limit)) for lo, hi in payload if lo < limit], kept))

    block = max(1, int(new.block_align))
    spans = [(d, n) for _, d, n in moves] + list(zeros)
    if spans:
        touched_blocks = np.unique(np.concatenate([
            np.arange(d // block, (d + n - 1) // block + 1, dtype=np.int64)
            for d, n in spans]))
    else:
        touched_blocks = np.zeros(0, np.int64)
    touched_blocks = touched_blocks.astype(np.int32)

    # Per-lane source map of the touched blocks only (kernel staging).
    # Runs of consecutive touched blocks are contiguous spans of the new
    # space (at most one per move/zero run), so each common segment
    # fills its overlap with each span as one arange.
    tb = touched_blocks.astype(np.int64)
    stage_map = np.full(tb.size * block, -1, dtype=np.int32)
    if tb.size and old_len >= 2**31:
        raise ValueError(f"old_len={old_len} lanes do not fit the int32 "
                         f"staging map")
    if tb.size:
        first = np.concatenate([[0], np.nonzero(np.diff(tb) != 1)[0] + 1])
        last = np.concatenate([first[1:] - 1, [tb.size - 1]])
        span_lo, span_hi = tb[first] * block, (tb[last] + 1) * block
        span_off = first * block
        for d, n, shift in common:
            i = int(np.searchsorted(span_hi, d, side="right"))
            while i < span_lo.size and span_lo[i] < d + n:
                lo = max(d, int(span_lo[i]))
                hi = min(d + n, int(span_hi[i]), new_len)
                if lo < hi:
                    o = int(span_off[i]) + lo - int(span_lo[i])
                    stage_map[o : o + hi - lo] = np.arange(
                        lo + shift, hi + shift, dtype=np.int32)
                i += 1

    _, touched_jobs = plan_transition_summary(old, new)
    for arr in (touched_blocks, stage_map):
        arr.setflags(write=False)
    delta = MigrationDelta(
        old_len=old_len, new_len=new_len, block=block, moves=moves,
        zeros=zeros, touched_jobs=touched_jobs,
        touched_blocks=touched_blocks, stage_map=stage_map,
        moved_elements=sum(n for _, _, n in moves),
        zeroed_elements=sum(n for _, n in zeros),
    )
    _PAIR_CACHE.put(key, delta)
    return delta


def migrate_flat_state(state: Dict[str, Any], old: FlatPlan, new: FlatPlan):
    """Full-gather migration oracle, O(total bytes): every 1-D leaf of
    length ``old.total_len`` is gathered onto the new layout as a NEW
    tensor (the input is never written); counters pass through.  Equal
    plans, and permutations that turn out to be the identity, return the
    state untouched."""
    if old == new:
        return state
    perm = _plan_perm(old, new)
    if perm.identity:
        return state
    out = dict(state)
    for k, x in state.items():
        if not isinstance(x, torch.Tensor) or x.dim() != 1 \
                or x.shape[0] != old.total_len:
            continue
        idx = host_to_device(perm.idx, x.device, torch.int64)
        moved = x[idx]
        if not perm.all_kept:
            keep = host_to_device(perm.keep, x.device, torch.bool)
            moved = torch.where(keep, moved, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
        out[k] = moved
    return out


def migrate_flat_state_delta(state: Dict[str, Any], old: FlatPlan,
                             new: FlatPlan, *,
                             delta: Optional[MigrationDelta] = None):
    """O(moved-bytes) migration: execute only the compiled delta's runs,
    all 1-D leaves (flat, mu, nu) in one relayout pass.  Bit-exact with
    :func:`migrate_flat_state` on valid states.  Leaves that keep their
    length are updated in place."""
    if old == new:
        return state
    if delta is None:
        delta = compile_migration_delta(old, new)
    if delta.identity:
        return state
    from ..kernels.relayout import ops as relayout_ops

    keys = [k for k, v in state.items()
            if isinstance(v, torch.Tensor) and v.dim() == 1
            and v.shape[0] == delta.old_len]
    moved = relayout_ops.relayout([state[k] for k in keys], delta)
    return dict(state, **dict(zip(keys, moved)))


# ------------------------------------------------------- sharded transitions
# The 1-D leaves of every shard space's state; a fleet with compressed
# jobs adds the error-feedback buffer "ef".
LEAVES = ("flat", "mu", "nu")


def sharded_transition_summary(old: ShardedPlan, new: ShardedPlan):
    """Segment-level view of a SHARDED plan transition, O(segments):
    ``(moved_elements, touched_jobs)``.  A segment moved iff its
    ``(shard_id, offset)`` home changed (a shard joining or leaving does
    not move the segments that stayed on their own Aggregator);
    ``touched_jobs`` diffs each job's per-shard layout fingerprint, keyed
    by the stable ``agg_id``.  Equal to ``migrate_sharded_state``'s
    executed accounting."""
    key = ("ssummary", old, new)
    cached = _PAIR_CACHE.get(key)
    if cached is not None:
        return cached
    old_by = old.by_skey
    moved = 0
    for sid, sp in zip(new.shard_ids, new.shards):
        for seg in sp.segments:
            prev = old_by.get(seg.skey)
            if prev is None:
                continue
            psid, pseg = prev
            if pseg.size != seg.size:
                raise ValueError(
                    f"segment {seg.skey} changed size "
                    f"{pseg.size} -> {seg.size}")
            if psid != sid or pseg.offset != seg.offset:
                moved += seg.size

    def sigs(plan: ShardedPlan) -> Dict[str, Dict[str, Tuple]]:
        out: Dict[str, Dict[str, Tuple]] = {}
        for sid, sp in zip(plan.shard_ids, plan.shards):
            for j, sig in _job_layout_sigs(sp).items():
                out.setdefault(j, {})[sid] = sig
        return out

    old_sigs, new_sigs = sigs(old), sigs(new)
    touched = tuple(sorted(
        j for j in set(old_sigs) | set(new_sigs)
        if old_sigs.get(j) != new_sigs.get(j)))
    summary = (moved, touched)
    _PAIR_CACHE.put(key, summary)
    return summary


def _relayout_into(src: List[torch.Tensor], dst: List[torch.Tensor],
                   delta: MigrationDelta) -> None:
    """One shard's delta executed from ``src`` (only read) into the zeroed
    ``dst`` leaves of the new length: the lanes both lengths share are
    copied, then the touched blocks are staged from ``src`` and scattered
    into ``dst`` by K2 -- what ``relayout`` leaves in place, written into
    new buffers instead."""
    from ..kernels.relayout import ops as relayout_ops

    n = min(delta.old_len, delta.new_len)
    for x, y in zip(src, dst):
        y[:n].copy_(x[:n])
    if not delta.touched_blocks.size:
        return
    src_map, dst_blocks = relayout_ops.stage_tables(delta, dst[0].device)
    staged = relayout_ops.relayout_stage(src, src_map)
    relayout_ops.relayout_scatter(dst, staged, dst_blocks, block=delta.block)


def _run_index(runs, device) -> torch.Tensor:
    """The lanes of ``(start, length)`` runs, concatenated, as one int64
    index built on ``device`` (no O(lanes) host array)."""
    starts = torch.tensor([s for s, _ in runs], dtype=torch.int64)
    sizes = torch.tensor([n for _, n in runs], dtype=torch.int64)
    total = int(sizes.sum())
    first = torch.cumsum(sizes, 0) - sizes  # run i's place in the concat
    idx = torch.repeat_interleave((starts - first).to(device),
                                  sizes.to(device), output_size=total)
    return idx.add_(torch.arange(total, dtype=torch.int64, device=device))


def migrate_sharded_state(
    states: Dict[str, Dict[str, torch.Tensor]],
    old: ShardedPlan,
    new: ShardedPlan,
    *,
    out: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    fault_injector=None,
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], int, Tuple[str, ...]]:
    """Re-lay per-shard states (``agg_id`` -> flat/mu/nu[/ef] of the
    shard's ``total_len``) onto a new ShardedPlan:

      * every SURVIVING shard (same ``agg_id`` in both plans) runs its own
        :class:`MigrationDelta` through K2, O(its moved bytes) on top of
        one copy of the lanes it keeps;
      * a shard that joined the fleet starts at zero;
      * segments that changed Aggregator arrive with ONE sorted, unique
        index write per leaf (plain PyTorch, as the reference does it
        outside its kernel).

    ``out`` maps each new shard id to its zeroed destination state (the
    runtime passes views of its next fleet arena); without it every shard
    gets fresh zero buffers: a surviving shard's own leaves, a joining
    shard flat/mu/nu, and ``ef`` when any input state has one.  A
    destination leaf is filled from the sources that have it and stays
    zero where one lacks it, as the reference leaves a leaf absent on a
    source shard.  The input ``states`` are only read, so a
    failure at any point leaves the caller's states whole; nothing
    commits until the caller installs the result.  A ``fault_injector``
    is asked before anything moves (``on_migration``) and after each
    shard of the new plan is relaid (``on_migration_progress``).

    Returns ``(new_states, moved_elements, touched_jobs)``; the count and
    the touched set equal :func:`sharded_transition_summary`'s."""
    desc = f"sharded:{old.n_shards}->{new.n_shards}"
    if fault_injector is not None:
        fault_injector.on_migration(desc)
    device = next(iter(states.values()))["flat"].device
    joining = LEAVES + (("ef",) if any(
        "ef" in st for st in states.values()) else ())
    moved = 0
    touched: set = set()
    new_states: Dict[str, Dict[str, torch.Tensor]] = {}
    old_ids = set(old.shard_ids)
    old_by = old.by_skey
    for sid, sp in zip(new.shard_ids, new.shards):
        prev = states.get(sid) if sid in old_ids else None
        st = (out[sid] if out is not None else
              {k: torch.zeros(sp.total_len, dtype=torch.float32,
                              device=device)
               for k in (tuple(prev) if prev is not None else joining)})
        if prev is not None:
            delta = compile_migration_delta(old.shard_of(sid), sp)
            keys = [k for k in st if k in prev]
            _relayout_into([prev[k] for k in keys], [st[k] for k in keys],
                           delta)
            moved += delta.moved_elements
            touched.update(delta.touched_jobs)
        # Cross-shard arrivals: their destination lanes are zero after
        # the shard's own delta (no common segment covers them there).
        # Segments are in offset order, so the index is sorted and unique.
        arrivals = []
        for seg in sp.segments:
            prev_home = old_by.get(seg.skey)
            if prev_home is None or prev_home[0] == sid:
                continue  # a new job's segment, or covered by the delta
            arrivals.append((seg, *prev_home))
            moved += seg.size
            touched.add(seg.job_id)
        if arrivals:
            idx = _run_index([(seg.offset, seg.size)
                              for seg, _, _ in arrivals], device)
            for k in st:
                if any(k not in states[psid] for _, psid, _ in arrivals):
                    continue  # absent on a source shard: stays zero
                vals = torch.cat([
                    states[psid][k][pseg.offset : pseg.offset + pseg.size]
                    for _, psid, pseg in arrivals])
                st[k].index_copy_(0, idx, vals)
                del vals
            del idx
        new_states[sid] = st
        if fault_injector is not None:
            fault_injector.on_migration_progress(len(new_states), desc)
    # Jobs that only lived on REMOVED shards (or left) are touched too.
    _, sum_touched = sharded_transition_summary(old, new)
    touched.update(sum_touched)
    return new_states, moved, tuple(sorted(touched))


def migration_bytes(old: FlatPlan, new: FlatPlan,
                    bytes_per_element: int = 12) -> int:
    """Bytes that actually cross shards (master copy + both Adam moments)."""
    return plan_migration_bytes(old, new, bytes_per_element)
