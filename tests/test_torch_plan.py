"""The port's copy of the control plane compiles the SAME plans as the
reference: the same jobs (profiles built from the same trees, one in jax
arrays and one in torch tensors) through arrivals, exits and rebalances
give equal segments, shard lengths, block alignment and per-job owned
blocks, and equal JSON."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ParameterService as JService
from repro.ps import plan as jplan
from repro.ps import runtime as jruntime
from repro_torch.core import ParameterService as TService
from repro_torch.ps import plan as tplan
from repro_torch.ps import runtime as truntime


def _trees(seed, n_jobs):
    rng = np.random.default_rng(seed)
    trees = {}
    for i in range(n_jobs):
        trees[f"j{i}"] = {
            "dense": {"w": rng.standard_normal(
                (int(rng.integers(2, 9)), int(rng.integers(2, 9))))
                .astype(np.float32),
                "b": rng.standard_normal(int(rng.integers(1, 40)))
                .astype(np.float32)},
            "layers": [rng.standard_normal(int(rng.integers(5, 70)))
                       .astype(np.float32)
                       for _ in range(int(rng.integers(1, 4)))],
        }
    return trees


def _register_both(svcs, jid, tree, required):
    nbytes = sum(4 * v.size for v in jax.tree_util.tree_leaves(tree))
    jsvc, tsvc = svcs
    prof, specs = jruntime.job_profile_from_tree(
        jid, jax.tree_util.tree_map(jnp.asarray, tree),
        required_servers=required, agg_throughput=nbytes / 0.45)
    jsvc.register_job(prof, specs=specs)
    prof, specs = truntime.job_profile_from_tree(
        jid, truntime.tree_from_numpy(tree, "cpu"),
        required_servers=required, agg_throughput=nbytes / 0.45)
    tsvc.register_job(prof, specs=specs)


def assert_plans_equal(t, j):
    assert (t.n_shards, t.shard_len, t.block_align, t.shard_ids) == \
        (j.n_shards, j.shard_len, j.block_align, j.shard_ids)
    assert len(t.segments) == len(j.segments)
    for a, b in zip(t.segments, j.segments):
        assert dataclasses.astuple(a)[:6] == dataclasses.astuple(b)[:6]
        assert np.dtype(a.dtype) == np.dtype(b.dtype)
        assert (a.job_id, a.tensor_id) == (b.job_id, b.tensor_id)
    assert t.job_ids == j.job_ids
    for job in j.job_ids:
        lt, lj = t.job_layout(job), j.job_layout(job)
        np.testing.assert_array_equal(lt.blocks, lj.blocks)
        np.testing.assert_array_equal(lt.own_idx, lj.own_idx)
        assert [s[:3] for s in lt.slots] == [s[:3] for s in lj.slots]
    assert tplan.plan_to_json(t) == jplan.plan_to_json(j)


@pytest.mark.parametrize("seed", range(4))
def test_plans_equal_through_arrival_exit_rebalance(seed):
    pad = (8, 16, 128, 32)[seed]
    svcs = (JService(total_budget=16, n_clusters=1, plan_pad_to=pad),
            TService(total_budget=16, n_clusters=1, plan_pad_to=pad))
    trees = _trees(seed, 3)
    for i, (jid, tree) in enumerate(trees.items()):
        _register_both(svcs, jid, tree, required=1 + i % 2)
        assert_plans_equal(svcs[1].compile_plan(), svcs[0].compile_plan())
    _register_both(svcs, "probe", _trees(seed + 50, 1)["j0"], required=1)
    assert_plans_equal(svcs[1].compile_plan(), svcs[0].compile_plan())
    for s in svcs:
        s.job_exit("j1")
    assert_plans_equal(svcs[1].compile_plan(), svcs[0].compile_plan())
    for s in svcs:
        s.periodic_rebalance()
    assert_plans_equal(svcs[1].compile_plan(), svcs[0].compile_plan())


def test_tree_specs_use_reference_keys_and_numpy_dtypes():
    tree = _trees(9, 1)["j0"]
    jspecs = jruntime.tree_specs(jax.tree_util.tree_map(jnp.asarray, tree))
    tspecs = truntime.tree_specs(truntime.tree_from_numpy(tree, "cpu"))
    assert [(s.key, s.shape) for s in tspecs] == \
        [(s.key, s.shape) for s in jspecs]
    assert all(isinstance(s.dtype, np.dtype) for s in tspecs)
    assert [np.dtype(s.dtype) for s in tspecs] == \
        [np.dtype(s.dtype) for s in jspecs]
    assert truntime.numpy_dtype(torch.float32) == np.float32


def test_plan_json_round_trip_with_torch_specs():
    svc = TService(total_budget=16, n_clusters=1, plan_pad_to=16)
    tree = truntime.tree_from_numpy(_trees(3, 1)["j0"], "cpu")
    prof, specs = truntime.job_profile_from_tree("a", tree,
                                                 required_servers=2)
    svc.register_job(prof, specs=specs)
    plan = svc.compile_plan()
    assert tplan.plan_loads(tplan.plan_dumps(plan)) == plan
