"""The sharded engine's single-launch fleet tick, held against its
per-shard oracle (bit for bit, inside the port) and against the
reference's fused fleet tick (within the 1-ulp budget across packages).

The port keeps every shard's flat/mu/nu as views into one fleet arena per
leaf: ``tick_fleet`` hands K1 the arena with each entry's block table
rebased by its shard's offset, where the reference concatenates the
lanes' states and slices them back.  On the CPU K1's wrapper takes its
plain version, so the launch count is read from the wrapper's calls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ParameterService as JService
from repro.ps.service_runtime import ShardedServiceRuntime as JSharded
from repro_torch.core import ParameterService as TService
from repro_torch.kernels.agg_adam import ops as agg_ops
from repro_torch.ps.runtime import tree_from_numpy
from repro_torch.ps.service_runtime import ShardedServiceRuntime as TSharded

ULP_BUDGET = 1


def ulp_diff(a, b) -> int:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


def _tree(seed, sizes):
    rng = np.random.default_rng(seed)
    return {f"t{i}": rng.standard_normal(n).astype(np.float32)
            for i, n in enumerate(sizes)}


def _loss_torch(params, batch):
    return sum(torch.sum((params[k] - batch["target"][k]) ** 2)
               for k in params)


def _loss_jax(params, batch):
    return sum(jnp.sum((params[k] - batch["target"][k]) ** 2)
               for k in params)


# Uneven job sizes, as in the reference's test: shard spaces come out
# unevenly sized after a split, and "c" packs into a single 16-lane block.
TREES = {"a": _tree(0, (48, 16, 32)), "b": _tree(1, (32, 16)),
         "c": _tree(2, (16,))}
TARGETS = {j: {k: np.ones_like(v) for k, v in t.items()}
           for j, t in TREES.items()}


def _tb(j):
    return {"target": tree_from_numpy(TARGETS[j], "cpu")}


def _jb(j):
    return {"target": jax.tree_util.tree_map(jnp.asarray, TARGETS[j])}


def _add_jobs(rt, port):
    for jid, t in TREES.items():
        nbytes = sum(4 * v.size for v in t.values())
        params = (tree_from_numpy(t, "cpu") if port
                  else jax.tree_util.tree_map(jnp.asarray, t))
        rt.add_job(jid, params, _loss_torch if port else _loss_jax, lr=0.05,
                   required_servers=1, agg_throughput=nbytes / 0.2)


def _port(**engine):
    rt = TSharded(TService(total_budget=16, n_clusters=1, plan_pad_to=16),
                  device="cpu")
    eng = rt.attach_engine(**engine)
    _add_jobs(rt, port=True)
    return rt, eng


def _ref(**engine):
    rt = JSharded(JService(total_budget=16, n_clusters=1, plan_pad_to=16),
                  jit=False)
    eng = rt.attach_engine(jit=False, **engine)
    _add_jobs(rt, port=False)
    return rt, eng


def _spread(rt):
    """Split until at least two shard spaces exist."""
    for _ in range(3):
        if rt.n_shards >= 2:
            return
        rt.service.scale_out(1)
    assert rt.n_shards >= 2, "the control plane kept every job on one shard"


def _assert_bits(rt_a, rt_b):
    assert rt_a.shard_ids == rt_b.shard_ids
    for k in ("flat", "mu", "nu"):
        assert torch.equal(rt_a.arena[k], rt_b.arena[k]), k
    assert rt_a.counts == rt_b.counts


@pytest.fixture
def k1_calls(monkeypatch):
    """Counts calls of K1's wrapper (on the CPU it runs the plain
    version and its launch counter stays put)."""
    calls = []
    real = agg_ops.aggregate_adam_multijob_fused

    def counted(*args, **kw):
        calls.append(int(kw["block_idx"].numel() if "block_idx" in kw
                         else args[5].numel()))
        return real(*args, **kw)

    monkeypatch.setattr(agg_ops, "aggregate_adam_multijob_fused", counted)
    return calls


def test_fleet_tick_is_one_launch_and_bit_exact_vs_per_shard_oracle(
        k1_calls):
    """With pending pushes over S shards one fused fleet tick is ONE K1
    call (and one ``n_launches``), leaves every shard bit for bit with
    the per-shard oracle, and matches the reference's fused tick within
    the budget, through uneven shard sizes and a mid-trajectory split."""
    rt_f, eng_f = _port(max_staleness=0)
    rt_o, eng_o = _port(max_staleness=0, fleet_tick="per_shard")
    rt_j, eng_j = _ref(max_staleness=0)
    assert eng_f.fleet_tick == "fused"

    def all_(n):
        for _ in range(n):
            for j in TREES:
                eng_f.step(j, _tb(j))
                eng_o.step(j, _tb(j))
                eng_j.step(j, _jb(j))
        for e in (eng_f, eng_o, eng_j):
            e.drain()

    all_(3)
    for rt in (rt_f, rt_o, rt_j):
        _spread(rt)
    assert len({sp.total_len for sp in rt_f.splan.shards}) > 1
    all_(3)
    _assert_bits(rt_f, rt_o)

    futs = [eng_f.step(j, _tb(j))["future"] for j in TREES]
    eng_j_futs = [eng_j.step(j, _jb(j))["future"] for j in TREES]
    pending = [sid for sid, lane in eng_f._lanes.items()
               if any(lane.queues.get(j) for j in TREES)]
    assert len(pending) == rt_f.n_shards >= 2
    before, calls = eng_f.stats.n_launches, len(k1_calls)
    applied = eng_f.tick()
    assert applied == sum(len(rt_f.splan.job_layout(j).shard_ids)
                          for j in TREES) == eng_j.tick()
    assert eng_f.stats.n_launches == before + 1
    assert len(k1_calls) == calls + 1
    assert k1_calls[-1] == sum(int(l.blocks.size)
                               for j in TREES
                               for l in rt_f.splan.job_layout(j).layouts)
    assert all(f.done() for f in futs) and all(f.done() for f in eng_j_futs)
    assert [f.result() for f in futs] == [f.result() for f in eng_j_futs]
    for sid in rt_j.shard_ids:
        for k in ("flat", "mu", "nu"):
            assert ulp_diff(rt_f.states[sid][k].numpy(),
                            np.asarray(rt_j.states[sid][k])) <= ULP_BUDGET

    # The oracle path spends >= S launches on the same work.
    for j in TREES:
        eng_o.step(j, _tb(j))
    before, calls = eng_o.stats.n_launches, len(k1_calls)
    eng_o.tick()
    assert eng_o.stats.n_launches - before >= len(pending)
    assert len(k1_calls) - calls == eng_o.stats.n_launches - before
    _assert_bits(rt_f, rt_o)
    assert (dataclasses.asdict(eng_f.stats)["n_applied"]
            == eng_j.stats.n_applied)


def test_fleet_tick_moves_no_lane_storage():
    """The fleet tick writes the arena in place: every lane's flat/mu/nu
    stays a view of the arena at the same address across ticks, and the
    arena itself is not replaced."""
    rt, eng = _port(max_staleness=0)
    _spread(rt)
    ptrs = {sid: {k: st[k].data_ptr() for k in st}
            for sid, st in rt.states.items()}
    arena = {k: v.data_ptr() for k, v in rt.arena.items()}
    before = {k: v.clone() for k, v in rt.arena.items()}
    for _ in range(3):
        for j in TREES:
            eng.step(j, _tb(j))
        assert eng.tick_fleet() > 0
    assert {k: v.data_ptr() for k, v in rt.arena.items()} == arena
    assert {sid: {k: st[k].data_ptr() for k in st}
            for sid, st in rt.states.items()} == ptrs
    for sid, st in rt.states.items():
        for k, v in st.items():
            assert v._base is rt.arena[k]
    assert not torch.equal(before["flat"], rt.arena["flat"])
    # Snapshots and pulls are copies, never views of the arena.
    for lane in eng._lanes.values():
        for k, v in lane.snapshot.items():
            assert v.untyped_storage().data_ptr() != \
                rt.arena[k].untyped_storage().data_ptr()
    pulled = eng.pull("a")
    for v in pulled.values():
        assert v.untyped_storage().data_ptr() != \
            rt.arena["flat"].untyped_storage().data_ptr()


def test_fleet_tick_spanning_job_resolves_multipart_future_in_one_tick():
    rt, eng = _port(max_staleness=2)
    rt.service.scale_out(1)
    spanning = [j for j in TREES
                if len(rt.splan.job_layout(j).shard_ids) >= 2]
    if not spanning:
        pytest.skip("split left every job on one shard")
    j = spanning[0]
    fut = eng.step(j, _tb(j))["future"]
    assert not fut.done()
    before = eng.stats.n_launches
    assert eng.tick_fleet() == len(rt.splan.job_layout(j).shard_ids)
    assert eng.stats.n_launches == before + 1
    assert fut.done() and fut.result() >= 1
    assert rt.counts[j] == fut.result()


def test_fleet_tick_skips_empty_lanes_mid_table():
    """Lanes with nothing pending are not in the launch's table: only the
    pending lanes' stats move, the launch still counts one, and the idle
    lanes' state is untouched."""
    rt, eng = _port(max_staleness=2)
    _spread(rt)
    j = min(TREES, key=lambda j: len(rt.splan.job_layout(j).shard_ids))
    hosting = set(rt.splan.job_layout(j).shard_ids)
    if hosting == set(rt.splan.shard_ids):
        pytest.skip("every job spans every shard; no idle lane to skip")
    eng.step(j, _tb(j))
    ticks = {sid: lane.stats.n_ticks for sid, lane in eng._lanes.items()}
    idle = {sid: {k: v.clone() for k, v in st.items()}
            for sid, st in rt.states.items() if sid not in hosting}
    before = eng.stats.n_launches
    assert eng.tick_fleet() == len(hosting)
    assert eng.stats.n_launches == before + 1
    for sid, lane in eng._lanes.items():
        assert lane.stats.n_ticks - ticks.get(sid, 0) == (sid in hosting)
    for sid, st in idle.items():
        for k, v in st.items():
            assert torch.equal(rt.states[sid][k], v)
    assert eng.tick_fleet() == 0  # an empty fleet tick is free
    assert eng.stats.n_launches == before + 1


def test_fleet_tick_survives_replans_and_caches_invalidate():
    """The fused path rides through scale_out/scale_in: fleet appliers
    (which bake every shard's arena offset) are dropped with the plan, the
    arena is rebuilt, and the trajectory stays bit for bit the per-shard
    oracle's."""
    rt_f, eng_f = _port(max_staleness=0)
    rt_o, eng_o = _port(max_staleness=0, fleet_tick="per_shard")

    def both(n):
        for _ in range(n):
            for j in TREES:
                eng_f.step(j, _tb(j))
                eng_o.step(j, _tb(j))
        eng_f.drain()
        eng_o.drain()

    both(2)
    assert eng_f._fleet_appliers  # the fused path really built one
    arena = rt_f.arena
    rt_f.service.scale_out(1)
    rt_o.service.scale_out(1)
    assert not eng_f._fleet_appliers  # the replan cleared them
    assert rt_f.arena is not arena
    both(2)
    rt_f.service.scale_in(1)
    rt_o.service.scale_in(1)
    both(2)
    _assert_bits(rt_f, rt_o)


def test_fleet_tick_mode_validation_and_flip():
    rt = TSharded(TService(total_budget=16, n_clusters=1, plan_pad_to=16),
                  device="cpu")
    with pytest.raises(ValueError, match="fleet_tick"):
        rt.attach_engine(fleet_tick="bogus")
    rt_a, eng_a = _port(max_staleness=0)
    rt_b, eng_b = _port(max_staleness=0)
    for rt in (rt_a, rt_b):
        _spread(rt)
    for mode in ("fused", "per_shard", "fused"):
        eng_a.fleet_tick = mode  # one engine flipped between modes
        for j in TREES:
            eng_a.step(j, _tb(j))
            eng_b.step(j, _tb(j))
        eng_a.drain()
        eng_b.drain()
    _assert_bits(rt_a, rt_b)
    assert eng_a.stats.n_applied == eng_b.stats.n_applied
    assert eng_a.stats.n_launches > eng_b.stats.n_launches


def test_n_launches_surfaced_in_debug_stats():
    """debug_stats exposes n_launches: the fleet aggregate counts one per
    fleet tick, each lane's own counter only its per-shard launches."""
    rt, eng = _port(max_staleness=0)
    _spread(rt)
    for j in TREES:
        eng.step(j, _tb(j))
    eng.drain()
    stats = rt.debug_stats()
    assert stats["engine"]["n_launches"] == stats["engine"]["n_ticks"] == 1
    assert all("n_launches" in s for s in stats["shards"].values())
    lane_ticks = sum(s["n_ticks"] for s in stats["shards"].values())
    assert lane_ticks == rt.n_shards > stats["engine"]["n_launches"]
    assert stats["engine"]["n_fleet_fallbacks"] == 0


def test_pulls_are_copies_when_a_job_owns_its_whole_shard():
    """A job alone on its shard owns every block there (its gather is the
    identity): a pull and ``params_of`` still hand out copies, which the
    next tick's in-place apply leaves as they were."""
    rt = TSharded(TService(total_budget=16, n_clusters=1, plan_pad_to=16),
                  device="cpu")
    eng = rt.attach_engine(max_staleness=1)
    t = TREES["a"]
    rt.add_job("a", tree_from_numpy(t, "cpu"), _loss_torch, lr=0.05,
               required_servers=1,
               agg_throughput=sum(4 * v.size for v in t.values()) / 0.2)
    assert all(l.covers_all for l in rt.splan.job_layout("a").layouts)
    pulled, params = eng.pull("a"), rt.params_of("a")
    kept = {k: v.clone() for k, v in pulled.items()}
    eng.step("a", _tb("a"))
    assert eng.tick() == 1
    for got in (pulled, params):
        for k, v in got.items():
            assert torch.equal(v, kept[k])
    assert not torch.equal(rt.params_of("a")["t0"], kept["t0"])
