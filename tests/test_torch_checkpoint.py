"""Checkpoints of the port (``repro_torch.checkpoint``) in the reference's
on-disk format, held against ``repro.checkpoint`` on the same
numpy-seeded trees.

Mirrors ``tests/test_checkpoint.py`` (atomicity, integrity, retention,
resume) and the checkpoint cases of ``tests/test_sharded.py``,
``tests/test_service_plan.py`` and ``tests/test_faults.py``, plus the
cross-package cases: a reference checkpoint restores in the port and a
port checkpoint in the reference bit for bit, float32 and int32 trees
and a sharded PS checkpoint with ``ef`` alike, with the same manifest
keys, shapes and dtypes.  A bfloat16 leaf goes reference -> port only:
the port writes the reference's bytes (a ``<V2`` array), which the
reference itself cannot read back on this jax.  A restore into a live
sharded runtime writes into the fleet arena's views (every lane stays a
view), and a checkpoint of another fleet size migrates into the arena,
held against the gather oracle (every job's parameters).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.core import ParameterService as JService
from repro.ps.service_runtime import ShardedServiceRuntime as JSharded
from repro_torch.checkpoint import (
    CheckpointManager,
    all_steps,
    latest_step,
    load_aux,
    restore_checkpoint,
    restore_ps_checkpoint,
    restore_sharded_checkpoint,
    save_checkpoint,
    save_ps_checkpoint,
    save_sharded_checkpoint,
)
from repro_torch.core import ParameterService as TService
from repro_torch.ps.faults import HEALTHY
from repro_torch.ps.runtime import tree_from_numpy
from repro_torch.ps.service_runtime import ShardedServiceRuntime as TSharded


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((32, 8)).astype(np.float32),
            "nested": {"b": np.arange(5, dtype=np.float32),
                       "l": [rng.standard_normal(3).astype(np.float32),
                             np.arange(4, dtype=np.int32)]},
            "count": np.asarray(3, np.int32)}


def _torch_tree(seed=0):
    return tree_from_numpy(_np_tree(seed), "cpu")


def _meta(tree):
    def meta(x):
        dtype = (x.dtype if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.empty(0, x.dtype)).dtype)
        return torch.empty(tuple(x.shape), dtype=dtype, device="meta")

    return jax.tree_util.tree_map(meta, tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _assert_tree_bits(got, want):
    g, w = list(_leaves(got)), list(_leaves(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))


def _manifest(path, step):
    return json.loads((path / f"step_{step:08d}" / "manifest.json")
                      .read_text())["leaves"]


# --------------------------------------------------------------- substrate
def test_save_restore_roundtrip(tmp_path):
    tree = _torch_tree()
    save_checkpoint(tmp_path, 7, tree)
    assert latest_step(tmp_path) == 7
    out = restore_checkpoint(tmp_path, 7, _meta(tree), device="cpu")
    _assert_tree_bits(out, tree)


def test_int_and_bf16_leaves_round_trip(tmp_path):
    """A host int (a step counter) is an int32 scalar on disk and an int
    again after the restore; a bfloat16 tensor keeps its bits."""
    bf = torch.randn(7, generator=torch.Generator().manual_seed(0)
                     ).to(torch.bfloat16)
    tree = {"n": 11, "x": bf}
    save_checkpoint(tmp_path, 1, tree)
    leaves = _manifest(tmp_path, 1)
    assert (leaves["n"]["dtype"], leaves["n"]["shape"]) == ("int32", [])
    assert leaves["x"]["dtype"] == "bfloat16"
    out = restore_checkpoint(tmp_path, 1, {"n": 0, "x": bf}, device="cpu")
    assert out["n"] == 11 and isinstance(out["n"], int)
    assert torch.equal(out["x"].view(torch.int16), bf.view(torch.int16))
    with pytest.raises(ValueError):
        save_checkpoint(tmp_path, 2, {"n": 2**40})


def test_tmp_dirs_are_not_checkpoints(tmp_path):
    (tmp_path / "step_00000009.tmp").mkdir(parents=True)
    assert latest_step(tmp_path) is None  # a torn save never shadows


def test_corruption_detected(tmp_path):
    d = save_checkpoint(tmp_path, 1, _torch_tree())
    victim = next(d.glob("leaf_*.npy"))
    data = bytearray(victim.read_bytes())
    data[-1] ^= 0xFF
    victim.write_bytes(bytes(data))
    with pytest.raises(IOError):
        restore_checkpoint(tmp_path, 1, _meta(_torch_tree()), device="cpu")
    restore_checkpoint(tmp_path, 1, _meta(_torch_tree()), device="cpu",
                       verify=False)  # hashes off: no check


def test_shape_mismatch_and_missing_leaf_detected(tmp_path):
    save_checkpoint(tmp_path, 1, _torch_tree())
    bad = _meta(_torch_tree())
    bad["w"] = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path, 1, bad, device="cpu")
    with pytest.raises(KeyError):
        restore_checkpoint(tmp_path, 1, {"nope": torch.empty(1)},
                           device="cpu")


def test_retention_keeps_last_n(tmp_path):
    for s in range(5):
        save_checkpoint(tmp_path, s, _torch_tree(), keep_last=2)
    assert all_steps(tmp_path) == [3, 4]


def test_manager_resume_cycle_saves_finished_copies(tmp_path):
    """The manager's host copies are finished before ``maybe_save``
    returns: an in-place update right after it never reaches the file."""
    mgr = CheckpointManager(tmp_path, save_every=2, keep_last=3)
    tree = _torch_tree()
    for step in range(6):
        for leaf in _leaves(tree):
            if leaf.dtype == torch.float32:
                leaf.add_(1.0)
        mgr.maybe_save(step, tree)
        tree["nested"]["b"].add_(100.0)  # in place, after the save call
        tree["nested"]["b"].sub_(100.0)
    mgr.wait()
    step, restored = mgr.restore_latest(_meta(_torch_tree()), device="cpu")
    assert step == 4  # the last multiple of save_every
    np.testing.assert_array_equal(restored["nested"]["b"].numpy(),
                                  np.arange(5, dtype=np.float32) + 5)
    assert mgr.restore_latest(_meta(tree), device="cpu")[0] == 4
    assert CheckpointManager(tmp_path / "none").restore_latest(
        _meta(tree), device="cpu") == (None, None)


# ------------------------------------------------------------ cross-package
def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _np_tree(1)
    jck.save_checkpoint(tmp_path, 3, jax.tree_util.tree_map(jnp.asarray,
                                                            tree))
    out = restore_checkpoint(tmp_path, 3, _meta(tree), device="cpu")
    _assert_tree_bits(out, tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """Same keys, file order, shapes, dtypes and bytes (hashes) as the
    reference's own save of the same tree; the reference restores it."""
    tree = _np_tree(2)
    save_checkpoint(tmp_path / "port", 3, tree_from_numpy(tree, "cpu"))
    jck.save_checkpoint(tmp_path / "ref", 3,
                        jax.tree_util.tree_map(jnp.asarray, tree))
    ours, theirs = _manifest(tmp_path / "port", 3), \
        _manifest(tmp_path / "ref", 3)
    assert list(ours) == list(theirs)
    for k in ours:
        for f in ("file", "shape", "dtype", "sha256"):
            assert ours[k][f] == theirs[k][f], (k, f)
    out = jck.restore_checkpoint(
        tmp_path / "port", 3,
        jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape,
                                                              x.dtype), tree))
    _assert_tree_bits(out, tree)


def test_bf16_leaf_reference_to_port_and_same_bytes(tmp_path):
    x = np.random.default_rng(3).standard_normal(9).astype(np.float32)
    jbf = jnp.asarray(x).astype(jnp.bfloat16)
    jck.save_checkpoint(tmp_path / "ref", 1, {"p": jbf})
    tbf = torch.from_numpy(x).to(torch.bfloat16)
    out = restore_checkpoint(tmp_path / "ref", 1, {"p": tbf}, device="cpu")
    assert torch.equal(out["p"].view(torch.int16), tbf.view(torch.int16))
    save_checkpoint(tmp_path / "port", 1, {"p": tbf})
    assert (_manifest(tmp_path / "port", 1)["p"]
            == {**_manifest(tmp_path / "ref", 1)["p"]})


def test_train_state_keys_match_the_reference(tmp_path):
    """A NamedTuple (an optimizer state) is keyed by field as jax keys
    it (``opt/.mu/w``), in field order, so train checkpoints cross."""
    from repro.optim import adam as jadam
    from repro_torch.optim import adam as tadam

    w = np.random.default_rng(4).standard_normal((3, 2)).astype(np.float32)
    jstate = {"params": {"w": jnp.asarray(w)}}
    jstate["opt"] = jadam(1e-3).init(jstate["params"])
    tstate = {"params": {"w": torch.from_numpy(w)}}
    tstate["opt"] = tadam(1e-3).init(tstate["params"])
    jck.save_checkpoint(tmp_path / "ref", 1, jstate)
    save_checkpoint(tmp_path / "port", 1, tstate)
    ours, theirs = _manifest(tmp_path / "port", 1), \
        _manifest(tmp_path / "ref", 1)
    assert list(ours) == list(theirs) == [
        "opt/.mu/w", "opt/.nu/w", "opt/.count", "params/w"]
    back = restore_checkpoint(tmp_path / "ref", 1, tstate, device="cpu")
    assert back["opt"].count == 0 and isinstance(back["opt"].count, int)
    assert torch.equal(back["params"]["w"], tstate["params"]["w"])


# ----------------------------------------------------------- PS checkpoints
def _flat_services(order):
    from repro_torch.ps.runtime import job_profile_from_tree

    svc = TService(total_budget=16, n_clusters=1, plan_pad_to=16)
    trees = {"a": {"b": _np_tree(5)["nested"]["b"]},
             "b": {"x": _np_tree(6)["w"]}, "z": {"y": _np_tree(7)["w"]}}
    for j in order:
        t = tree_from_numpy(trees[j], "cpu")
        prof, specs = job_profile_from_tree(
            j, t, required_servers=2,
            agg_throughput=sum(4 * v.numel() for v in t.values()) / 0.45)
        svc.register_job(prof, specs=specs)
    return svc, trees


def test_ps_checkpoint_restores_across_packings_through_k2(tmp_path,
                                                           monkeypatch):
    """A checkpoint taken under one packing restores under another
    through the delta path (the relayout wrappers run), every tensor and
    moment reading back identically, ``ef`` and counts included."""
    from repro_torch.kernels.relayout import ops as rl_ops
    from repro_torch.ps.runtime import (
        init_shared_state,
        seed_job_params,
        unflatten_tree,
    )

    calls = []
    real = rl_ops.relayout_scatter
    monkeypatch.setattr(rl_ops, "relayout_scatter",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    svc_ab, trees = _flat_services(("a", "b"))
    svc_ba, _ = _flat_services(("z", "b", "a"))
    trees.pop("z")
    plan_a, plan_b = svc_ab.compile_plan(), svc_ba.compile_plan()
    assert plan_a != plan_b
    state = init_shared_state(plan_a, "cpu", needs_ef=True)
    for j in ("a", "b"):
        state = seed_job_params(plan_a, state, j,
                                tree_from_numpy(trees[j], "cpu"))
    mask = torch.from_numpy(np.asarray(plan_a.payload_index()))
    for i, k in enumerate(("mu", "ef")):
        vals = torch.randn(mask.numel(),
                           generator=torch.Generator().manual_seed(i))
        state[k][mask] = vals
    state["counts"] = {"a": 4, "b": 2}
    save_ps_checkpoint(tmp_path, 3, plan_a, state)
    saved_plan, same = restore_ps_checkpoint(tmp_path, 3, device="cpu")
    assert saved_plan == plan_a and same["counts"] == {"a": 4, "b": 2}
    for k in ("flat", "mu", "nu", "ef"):
        assert torch.equal(same[k], state[k])
    got_plan, restored = restore_ps_checkpoint(tmp_path, 3, plan=plan_b,
                                               device="cpu")
    assert got_plan == plan_b and calls
    for j, t in trees.items():
        for k in ("flat", "mu", "ef"):
            a = unflatten_tree(plan_a, state[k], tree_from_numpy(t, "cpu"),
                               job_id=j)
            b = unflatten_tree(plan_b, restored[k],
                               tree_from_numpy(t, "cpu"), job_id=j)
            for key in a:
                assert torch.equal(a[key], b[key])


def test_ps_checkpoint_crosses_packages_both_ways(tmp_path):
    """A shared flat state with int32 counters and ef: reference save ->
    port restore, port save -> reference restore, bit for bit."""
    from repro.ps.plan import plan_from_json as j_from_json
    from repro_torch.ps.plan import plan_to_json

    svc, _ = _flat_services(("a", "b"))
    plan = svc.compile_plan()
    jplan = j_from_json(plan_to_json(plan))
    rng = np.random.default_rng(8)
    state = {k: rng.standard_normal(plan.total_len).astype(np.float32)
             for k in ("flat", "mu", "nu", "ef")}
    jstate = dict({k: jnp.asarray(v) for k, v in state.items()},
                  counts={"a": jnp.asarray(3, jnp.int32),
                          "b": jnp.asarray(5, jnp.int32)})
    jck.save_ps_checkpoint(tmp_path / "ref", 2, jplan, jstate)
    got_plan, tstate = restore_ps_checkpoint(tmp_path / "ref", 2,
                                             device="cpu")
    assert plan_to_json(got_plan) == plan_to_json(plan)
    assert tstate["counts"] == {"a": 3, "b": 5}
    for k, v in state.items():
        np.testing.assert_array_equal(tstate[k].numpy().view(np.int32),
                                      v.view(np.int32))
    save_ps_checkpoint(tmp_path / "port", 2, plan, tstate)
    assert list(_manifest(tmp_path / "port", 2)) == \
        list(_manifest(tmp_path / "ref", 2))
    _, back = jck.restore_ps_checkpoint(tmp_path / "port", 2)
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(back[k]).view(np.int32),
                                      v.view(np.int32))
    assert {j: int(c) for j, c in back["counts"].items()} == {"a": 3, "b": 5}


# ------------------------------------------------------ sharded checkpoints
def _tree(seed, sizes):
    rng = np.random.default_rng(seed)
    return {f"t{i}": rng.standard_normal(n).astype(np.float32)
            for i, n in enumerate(sizes)}


TREES = {"a": _tree(0, (48, 16, 32)), "b": _tree(1, (32, 16)),
         "c": _tree(2, (48, 16))}
TARGETS = {j: {k: np.ones_like(v) for k, v in t.items()}
           for j, t in TREES.items()}


def _loss_torch(params, batch):
    return sum(torch.sum((params[k] - batch["target"][k]) ** 2)
               for k in params)


def _loss_jax(params, batch):
    return sum(jnp.sum((params[k] - batch["target"][k]) ** 2)
               for k in params)


def _fleet(port, n_shards=2, compressed=("a",), engine=True):
    svc = (TService if port else JService)(total_budget=16, n_clusters=1,
                                           plan_pad_to=16)
    rt = TSharded(svc, device="cpu") if port else JSharded(svc, jit=False)
    eng = None
    if engine:
        eng = (rt.attach_engine(max_staleness=0) if port
               else rt.attach_engine(max_staleness=0, jit=False))
    for j, t in TREES.items():
        rt.add_job(j, tree_from_numpy(t, "cpu") if port
                   else jax.tree_util.tree_map(jnp.asarray, t),
                   _loss_torch if port else _loss_jax, lr=0.05,
                   required_servers=1,
                   agg_throughput=sum(4 * v.size for v in t.values()) / 0.2,
                   **({"push_compression": "int8"} if j in compressed
                      else {}))
    if n_shards > 1:
        svc.scale_out(n_shards - 1)
    return rt, eng


def _batch(j, port):
    t = TARGETS[j]
    return {"target": tree_from_numpy(t, "cpu") if port
            else jax.tree_util.tree_map(jnp.asarray, t)}


def _drive(eng, n, port, jobs=TREES):
    for _ in range(n):
        for j in jobs:
            eng.step(j, _batch(j, port))
    eng.drain()


def _views_ok(rt):
    offsets = dict(zip(rt.shard_ids, rt.splan.concat_view()[0]))
    for sid, st in rt.states.items():
        assert set(st) == set(rt.arena)
        for k, v in st.items():
            assert v._base is rt.arena[k]
            assert v.data_ptr() - rt.arena[k].data_ptr() == 4 * offsets[sid]


def _clone_arena(rt):
    return {k: v.clone() for k, v in rt.arena.items()}


def test_sharded_restore_writes_into_the_arena_and_replays(tmp_path):
    """Save, tick on, restore into the live runtime: the arena equals the
    clone taken at the save bit for bit, every lane is still a view, the
    counts are back, and the continuation equals the one that followed
    the save."""
    rt, eng = _fleet(True, n_shards=3)
    _drive(eng, 3, True)
    rt.save_checkpoint(tmp_path, 3)
    saved, counts = _clone_arena(rt), dict(rt.counts)
    _drive(eng, 2, True)
    want = _clone_arena(rt)
    assert not torch.equal(want["flat"], saved["flat"])
    rt.restore_checkpoint(tmp_path, 3)
    _views_ok(rt)
    for k in saved:
        assert torch.equal(rt.arena[k], saved[k]), k
    assert rt.counts == counts
    assert all(lane.snapshot is None for lane in eng._lanes.values())
    _drive(eng, 2, True)
    for k in want:
        assert torch.equal(rt.arena[k], want[k]), k
    aux = load_aux(tmp_path, 3)
    assert aux["shard_health"] == {sid: HEALTHY for sid in rt.shard_ids}
    assert "ef" in aux["shard_leaves"][rt.shard_ids[0]]


def test_sharded_checkpoint_roundtrip_across_replan(tmp_path):
    """A second runtime that diverged restores the checkpoint and replays
    a replan-crossing continuation to the identical trajectory."""
    def continuation(rt, eng):
        probe = _tree(9, (40,))
        rt.add_job("probe", tree_from_numpy(probe, "cpu"), _loss_torch,
                   lr=0.05, required_servers=1, agg_throughput=160 / 0.3)
        target = {"target": tree_from_numpy(
            {k: np.ones_like(v) for k, v in probe.items()}, "cpu")}
        for _ in range(3):
            for j in TREES:
                eng.step(j, _batch(j, True))
            eng.step("probe", target)
        eng.drain()

    rt1, eng1 = _fleet(True)
    _drive(eng1, 5, True)
    rt1.save_checkpoint(tmp_path, 5)
    continuation(rt1, eng1)
    rt2, eng2 = _fleet(True)
    _drive(eng2, 2, True)
    rt2.restore_checkpoint(tmp_path, 5)
    assert rt2.counts == {j: 5 for j in TREES}
    continuation(rt2, eng2)
    for k in rt1.arena:
        assert torch.equal(rt1.arena[k], rt2.arena[k]), k
    assert rt1.counts == rt2.counts


@pytest.mark.parametrize("grow", [True, False])
def test_elastic_restore_onto_another_fleet_size(tmp_path, grow):
    """A checkpoint of N shards restores into a runtime of M through
    ``migrate_sharded_state`` into its arena: every job's parameters and
    packed moments equal the saver's (the gather oracle), ef included,
    and the lanes stay views."""
    from repro_torch.ps.runtime import _gather_packed, _layout_rows

    rt1, eng1 = _fleet(True, n_shards=2 if grow else 3)
    _drive(eng1, 4, True)
    rt1.save_checkpoint(tmp_path, 4)

    def packed(rt, j, k):
        layout = rt.splan.job_layout(j)
        p = _gather_packed(layout, _layout_rows(layout, rt.device),
                           [rt.states[s][k] for s in layout.shard_ids])
        return torch.cat([p[st:st + n] for _, st, n, _, _
                          in sorted(layout.slots)])

    want = {(j, k): packed(rt1, j, k) for j in TREES
            for k in ("flat", "mu", "nu", "ef")}
    rt2, eng2 = _fleet(True, n_shards=3 if grow else 2)
    assert rt2.n_shards != rt1.n_shards
    rt2.restore_checkpoint(tmp_path, 4)
    _views_ok(rt2)
    for (j, k), v in want.items():
        assert torch.equal(packed(rt2, j, k), v), (j, k)
    assert rt2.counts == rt1.counts
    _drive(eng2, 1, True)  # and it trains on


def test_sharded_checkpoint_crosses_packages_both_ways(tmp_path):
    """A compressed fleet (ef on every shard): the reference saves and
    the port restores into its arena, the port saves and the reference
    restores, bit for bit, with the same manifest keys, shapes and
    dtypes; agg ids carry '/'."""
    jrt, jeng = _fleet(False, n_shards=3)
    _drive(jeng, 3, False)
    assert all("/" in sid for sid in jrt.shard_ids)
    jrt.save_checkpoint(tmp_path / "ref", 3)
    trt, _ = _fleet(True, n_shards=3)
    assert trt.shard_ids == jrt.shard_ids
    trt.restore_checkpoint(tmp_path / "ref", 3)
    _views_ok(trt)
    for sid in jrt.shard_ids:
        for k in ("flat", "mu", "nu", "ef"):
            np.testing.assert_array_equal(
                trt.states[sid][k].numpy().view(np.int32),
                np.asarray(jrt.states[sid][k]).view(np.int32))
    assert trt.counts == {j: int(c) for j, c in jrt.counts.items()} \
        == {j: 3 for j in TREES}
    trt.save_checkpoint(tmp_path / "port", 3)
    ours, theirs = (_manifest(tmp_path / d, 3) for d in ("port", "ref"))
    assert list(ours) == list(theirs)
    for k in ours:
        assert (ours[k]["shape"], ours[k]["dtype"]) == \
            (theirs[k]["shape"], theirs[k]["dtype"])
    assert load_aux(tmp_path / "port", 3)["shard_leaves"] == \
        load_aux(tmp_path / "ref", 3)["shard_leaves"]
    jrt2, _ = _fleet(False, n_shards=3)
    jrt2.restore_checkpoint(tmp_path / "port", 3)
    for sid in jrt.shard_ids:
        for k in ("flat", "mu", "nu", "ef"):
            np.testing.assert_array_equal(
                np.asarray(jrt2.states[sid][k]).view(np.int32),
                np.asarray(jrt.states[sid][k]).view(np.int32))
    assert {j: int(c) for j, c in jrt2.counts.items()} == trt.counts


def test_restore_without_ef_zeroes_it_and_with_ef_widens(tmp_path):
    """A checkpoint without ef into a compressed fleet leaves ef zero; a
    checkpoint with ef into a fleet without one widens the arena."""
    plain, peng = _fleet(True, compressed=())
    _drive(peng, 2, True)
    plain.save_checkpoint(tmp_path / "plain", 2)
    comp, ceng = _fleet(True)
    _drive(ceng, 2, True)
    assert float(comp.arena["ef"].abs().max()) > 0
    comp.save_checkpoint(tmp_path / "comp", 2)
    comp.restore_checkpoint(tmp_path / "plain", 2)
    _views_ok(comp)
    assert float(comp.arena["ef"].abs().max()) == 0
    for k in ("flat", "mu", "nu"):
        assert torch.equal(comp.arena[k], plain.arena[k])
    other, _ = _fleet(True, compressed=())
    assert "ef" not in other.arena
    other.restore_checkpoint(tmp_path / "comp", 2)
    _views_ok(other)
    assert "ef" in other.arena and float(other.arena["ef"].abs().max()) > 0


def test_sharded_checkpoint_aux_and_reserved_keys(tmp_path):
    rt, _ = _fleet(True, engine=False)
    with pytest.raises(ValueError, match="reserved"):
        save_sharded_checkpoint(tmp_path, 1, rt.splan, rt.states, rt.counts,
                                extra_aux={"jobs": []})
    save_sharded_checkpoint(tmp_path, 1, rt.splan, rt.states, rt.counts,
                            extra_aux={"note": "x"})
    aux = load_aux(tmp_path, 1)
    assert aux["note"] == "x" and aux["jobs"] == sorted(TREES)
    plan, states, counts = restore_sharded_checkpoint(tmp_path, 1,
                                                      device="cpu")
    assert plan == rt.splan and counts == {j: 0 for j in TREES}
    for sid in rt.shard_ids:
        for k, v in rt.states[sid].items():
            assert torch.equal(states[sid][k], v)
    with pytest.raises(IOError):
        restore_ps_checkpoint(tmp_path, 1, device="cpu")
    save_checkpoint(tmp_path / "plain", 1, {"x": torch.zeros(1)})
    with pytest.raises(IOError):
        restore_sharded_checkpoint(tmp_path / "plain", 1, device="cpu")


# ------------------------------------------------------------- launch.train
def test_launch_train_resumes_from_the_latest_checkpoint(tmp_path, capsys):
    """``--ckpt-dir`` saves every ``--ckpt-every`` steps; a relaunch
    restores the latest step and goes on from the next.  The saved state
    equals an uninterrupted run's after the same steps, bit for bit."""
    from repro_torch.launch import train

    args = ["--arch", "dlrm-rm2", "--smoke", "--device", "cpu",
            "--batch", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1", "--log-every", "1"]
    train.main(args + ["--steps", "3"])
    assert all_steps(tmp_path) == [0, 1, 2]
    capsys.readouterr()
    train.main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "restored checkpoint step 2" in out
    assert "step=3 " in out and "step=0 " not in out
    assert latest_step(tmp_path) == 4

    init_state, step, batch_fn, _ = train.build("dlrm-rm2", True, 16, 64,
                                                "cpu")
    state = init_state()
    for _ in range(3):
        state, _ = step(state, batch_fn())
    got = restore_checkpoint(tmp_path, 2, state, device="cpu")
    for a, b in zip(_leaves(got), _leaves(state)):
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
