"""The port's delta migration held against the reference's: the compiled
MigrationDelta field for field, and the relayout (staging + scatter, the
plain versions of kernel K2 on the CPU) bit for bit, on randomized
arrival / exit / rebalance / no-op plan pairs built as the reference's
own delta tests build them.  A migration only copies values, so every
comparison here is exact."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import ParameterService as JService
from repro.kernels.relayout import ref as jrelayout_ref
from repro.ps import elastic as jelastic
from repro.ps import runtime as jruntime
from repro.ps.plan import segment_mask
from repro_torch.core import ParameterService as TService
from repro_torch.kernels.relayout import ops as trelayout
from repro_torch.kernels.relayout import ref as trelayout_ref
from repro_torch.ps import elastic as telastic
from repro_torch.ps import runtime as truntime
from repro_torch.ps.plan import FlatPlan, Segment

OPS = ("arrival", "exit", "rebalance", "noop")


def _sizes_tree(seed, sizes):
    rng = np.random.default_rng(seed)
    return {f"t{i}": rng.standard_normal(n).astype(np.float32)
            for i, n in enumerate(sizes)}


def _register(svcs, jid, tree, required=2, busy=0.45):
    """Register one job with the reference service and the port's, from
    the same numpy tree."""
    nbytes = sum(4 * v.size for v in tree.values())
    jsvc, tsvc = svcs
    profile, specs = jruntime.job_profile_from_tree(
        jid, jax.tree_util.tree_map(jax.numpy.asarray, tree),
        required_servers=required, agg_throughput=nbytes / busy)
    jsvc.register_job(profile, specs=specs)
    profile, specs = truntime.job_profile_from_tree(
        jid, truntime.tree_from_numpy(tree, "cpu"),
        required_servers=required, agg_throughput=nbytes / busy)
    tsvc.register_job(profile, specs=specs)


def _plan_pair(seed, op, n_jobs, pad):
    """(reference old, new), (port old, new) for one randomized
    transition -- the generator of tests/test_migration_delta.py."""
    rng = np.random.default_rng(seed)
    svcs = (JService(total_budget=16, n_clusters=1, plan_pad_to=pad),
            TService(total_budget=16, n_clusters=1, plan_pad_to=pad))
    for i in range(n_jobs):
        sizes = tuple(int(rng.integers(5, 90))
                      for _ in range(int(rng.integers(1, 4))))
        _register(svcs, f"j{i}", _sizes_tree(seed + i, sizes),
                  required=int(rng.integers(1, 3)))
    old = [s.compile_plan() for s in svcs]
    if op == "arrival":
        probe = tuple(int(rng.integers(4, 60))
                      for _ in range(int(rng.integers(1, 3))))
        _register(svcs, "probe", _sizes_tree(seed + 99, probe), required=1)
    elif op == "exit" and n_jobs > 1:
        victim = f"j{int(rng.integers(0, n_jobs))}"
        for s in svcs:
            s.job_exit(victim)
    elif op == "rebalance":
        for s in svcs:
            s.periodic_rebalance()
    new = [s.compile_plan() for s in svcs]
    return (old[0], new[0]), (old[1], new[1])


def _valid_state(plan, rng):
    """Random values on payload lanes, zero elsewhere (numpy)."""
    mask = segment_mask(plan)
    return {name: np.where(mask, rng.standard_normal(plan.total_len), 0.0)
            .astype(np.float32) for name in ("flat", "mu", "nu")}


def assert_deltas_equal(t, j):
    for f in j._fields:
        a, b = getattr(t, f), getattr(j, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


CASES = [(seed, op) for seed in range(6) for op in OPS]


@pytest.mark.parametrize("seed,op", CASES)
def test_delta_equals_reference_and_relayout_bit_exact(seed, op):
    rng = np.random.default_rng(1000 + seed)
    n_jobs = int(rng.integers(1, 4))
    pad = [8, 16, 128][seed % 3]
    (jold, jnew), (told, tnew) = _plan_pair(seed, op, n_jobs, pad)
    assert dataclasses.astuple(tnew)[:2] == dataclasses.astuple(jnew)[:2]

    jdelta = jelastic.compile_migration_delta(jold, jnew)
    tdelta = telastic.compile_migration_delta(told, tnew)
    assert_deltas_equal(tdelta, jdelta)
    # The port's own field: the reference's map folded into int32 with -1.
    assert tdelta.stage_map.dtype == np.int32
    np.testing.assert_array_equal(
        tdelta.stage_map, np.where(jdelta.stage_keep, jdelta.stage_src, -1))
    assert (telastic.plan_transition_summary(told, tnew)
            == jelastic.plan_transition_summary(jold, jnew))

    state = _valid_state(jold, rng)
    want_ref = jrelayout_ref.relayout_ref(
        [state[k] for k in ("flat", "mu", "nu")], jdelta)
    want_mig = jelastic.migrate_flat_state_delta(
        {k: jax.numpy.asarray(v) for k, v in state.items()}, jold, jnew)
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    oracle = telastic.migrate_flat_state(tstate, told, tnew)
    got = telastic.migrate_flat_state_delta(
        {k: v.clone() for k, v in tstate.items()}, told, tnew)
    for i, k in enumerate(("flat", "mu", "nu")):
        np.testing.assert_array_equal(got[k].numpy(), want_ref[i])
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want_mig[k]))
        np.testing.assert_array_equal(got[k].numpy(), oracle[k].numpy())
    # The oracle never writes its input.
    for k in tstate:
        np.testing.assert_array_equal(tstate[k].numpy(), state[k])


def test_stage_and_scatter_plain_match_run_list_oracle():
    """K2's plain halves (stage, then scatter into the resized base) equal
    the run-list oracle on a transition that moves and vacates lanes."""
    (_, _), (told, tnew) = _plan_pair(3, "exit", 3, 16)
    delta = telastic.compile_migration_delta(told, tnew)
    assert delta.moves or delta.zeros
    rng = np.random.default_rng(5)
    leaves = [torch.from_numpy(v) for v in _valid_state(told, rng).values()]
    want = trelayout_ref.relayout_ref(leaves, delta)
    got = trelayout.relayout([x.clone() for x in leaves], delta)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_relayout_in_place_when_length_holds():
    """A same-length transition (two jobs' runs swap places, one run lands
    on the other's source lanes) rewrites the given buffers in place, and
    staging keeps the overlapping runs right."""
    def plan(a_off, b_off):
        segs = (Segment("w", 0, a_off, 8, (8,), np.float32, job_id="a"),
                Segment("w", 0, b_off, 12, (12,), np.float32, job_id="b"))
        return FlatPlan(n_shards=1, shard_len=32,
                        segments=tuple(sorted(segs, key=lambda s: s.offset)),
                        block_align=8)

    old, new = plan(0, 16), plan(16, 0)
    delta = telastic.compile_migration_delta(old, new)
    assert delta.old_len == delta.new_len and delta.moves
    state = _valid_state(old, np.random.default_rng(0))
    x = torch.from_numpy(state["flat"].copy())
    out = trelayout.relayout([x], delta)[0]
    assert out is x
    want = telastic.migrate_flat_state(
        {"flat": torch.from_numpy(state["flat"])}, old, new)["flat"]
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_plan_cache_bounded():
    telastic.clear_plan_cache()
    telastic.set_plan_cache_limit(4096)
    try:
        for seed in range(4):
            (_, _), (told, tnew) = _plan_pair(seed, "arrival", 2, 8)
            telastic.compile_migration_delta(told, tnew)
        assert telastic.plan_cache_stats()["bytes"] <= 4096 or \
            telastic.plan_cache_stats()["entries"] == 1
        assert telastic.plan_cache_stats()["evictions"] > 0
    finally:
        telastic.set_plan_cache_limit(256 << 20)
        telastic.clear_plan_cache()
