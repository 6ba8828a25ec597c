"""The port's operator cost walk (``repro_torch.launch.op_cost``) held
against the reference's HLO cost model (``repro.launch.hlo_cost``).

Counterparts of ``tests/test_hlo_cost.py``: a matmul's flops and bytes,
a loop's flops (the reference's scan multiplied by its trip count, here
a Python loop that runs every trip), a slice read at its slice size; and
the ring multipliers on a fake process group of 4 ranks.  Then Qwen's
smoke training cell on a one-device mesh: the port's dot flops within 1 %
of ``hlo_cost.analyze`` of the reference's compiled cell on its host
mesh.  They were equal when this test was written (forward, the remat
recompute and the backward: the same products on both sides), so the
bound leaves room for a compiler that fuses or drops a dot.  Children (this file run as a script) hold the process groups,
so the test process has none.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_cost import analyze as hlo_analyze
from repro_torch.launch import op_cost

ROOT = Path(__file__).resolve().parents[1]


def _child(mode, tmp_path):
    out = tmp_path / f"{mode}.json"
    subprocess.run([sys.executable, str(Path(__file__).resolve()), mode,
                    str(out)], check=True, timeout=300,
                   env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    return json.loads(out.read_text())


def _hlo(f, *args):
    return hlo_analyze(jax.jit(f).lower(*args).compile().as_text())


def test_plain_matmul_flops_and_bytes():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    _, oc = op_cost.analyze(lambda: a @ b)
    ref = _hlo(lambda x, y: x @ y, jax.ShapeDtypeStruct((64, 32), jnp.float32),
               jax.ShapeDtypeStruct((32, 16), jnp.float32))
    assert oc.cost.flops == ref.flops == 2 * 64 * 32 * 16
    assert oc.cost.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4 <= ref.bytes


@pytest.mark.parametrize("trips", [(10,), (4, 5)])
def test_loop_flops_counted_per_trip(trips):
    n = 1
    for t in trips:
        n *= t
    x, w = torch.randn(64, 128), torch.randn(128, 128)

    def run():
        c = x
        for _ in range(n):
            c = torch.tanh(c @ w)
        return c

    _, oc = op_cost.analyze(run)

    def f(c, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        for t in reversed(trips):
            inner = body

            def body(c, _, inner=inner, t=t):
                return jax.lax.scan(inner, c, None, length=t)[0], None
        return body(c, None)[0]

    ref = _hlo(f, jax.ShapeDtypeStruct((64, 128), jnp.float32),
               jax.ShapeDtypeStruct((128, 128), jnp.float32))
    assert oc.cost.flops == pytest.approx(ref.flops) == n * 2 * 64 * 128 * 128


def test_slice_counted_at_slice_size():
    stack = torch.randn(64, 1024, 32)

    def run():
        acc = torch.zeros(())
        for i in range(stack.shape[0]):
            acc = acc + torch.sum(stack[i])
        return acc

    _, oc = op_cost.analyze(run)
    full = 64 * 1024 * 32 * 4
    assert full <= oc.cost.bytes < 2 * full
    assert oc.cost.ops["aten.sum"] == 64


def test_views_are_free_and_gathers_count_rows():
    table = torch.randn(1000, 64)
    ids = torch.randint(0, 1000, (32,))
    _, oc = op_cost.analyze(lambda: table.t().reshape(64, 1000)[:, :8])
    assert oc.cost.bytes == 0 and oc.cost.flops == 0
    _, oc = op_cost.analyze(lambda: torch.nn.functional.embedding(ids, table))
    assert oc.cost.bytes == 2 * 32 * 64 * 4


def test_ring_multipliers_on_a_fake_group(tmp_path):
    got = _child("ring", tmp_path)
    n = 8 * 16 * 4  # the (8, 16) float32 local shards
    assert got["counts"] == {"all-gather": 1, "all-reduce": 2,
                             "reduce-scatter": 1, "all-to-all": 1}
    tr = got["traffic"]
    assert tr["all-gather"] == pytest.approx(0.5 * 2 * n)  # (G-1)/G x out
    assert tr["reduce-scatter"] == pytest.approx(1 * n / 2)  # (G-1) x out
    assert tr["all-to-all"] == pytest.approx(0.5 * n)  # (G-1)/G x bytes
    # 2 (G-1)/G x bytes: G = 2 on a mesh dim, G = 4 on the world group
    assert tr["all-reduce"] == pytest.approx(2 * 0.5 * n + 2 * 0.75 * n)
    assert got["raw"]["all-gather"] == 2 * n


def _qwen_smoke_cell(pkg, mesh):
    cells = pkg.launch.cells
    spec = cells.get_spec("qwen1.5-0.5b")
    cfgmod = __import__(f"{pkg.__name__}.configs.qwen1_5_0_5b",
                        fromlist=["smoke_config"])
    spec = dataclasses.replace(spec, model=cfgmod.smoke_config())
    cell = pkg.arch.ShapeCell(
        "train", "train", batch=4, seq=64,
        model_overrides={"attn_chunk_k": 16},
        run_overrides={"n_microbatches": 1})
    return cells._lm_cell(spec, cell, mesh)


def test_qwen_smoke_cell_dot_flops_within_1pct_of_hlo_cost(tmp_path):
    import repro
    import repro.arch
    import repro.launch.cells
    from repro.launch.mesh import make_host_mesh

    jmesh = make_host_mesh()
    jcell = _qwen_smoke_cell(repro, jmesh)
    with jmesh:
        text = jcell.lower().compile().as_text()
    ref = hlo_analyze(text).flops
    got = _child("qwen", tmp_path)
    assert got["model_flops"] == jcell.model_flops_per_step
    assert abs(got["flops"] - ref) <= 0.01 * ref, (got["flops"], ref)


# ------------------------------------------------------------- children
def _ring(out):
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch import mesh as tmesh

    m = tmesh.make_fake_mesh((2, 2), ("data", "model"))

    def dt(pl):
        return DTensor.from_local(torch.empty(8, 16, device="meta"), m, pl,
                                  run_check=False)

    with op_cost.OpCost() as oc:
        dt([Shard(0), Replicate()]).redistribute(m, [Replicate()] * 2)
        dt([Partial(), Replicate()]).redistribute(m, [Replicate()] * 2)
        dt([Partial(), Replicate()]).redistribute(m, [Shard(0), Replicate()])
        dt([Replicate(), Shard(0)]).redistribute(m, [Replicate(), Shard(1)])
        funcol.wait_tensor(funcol.all_reduce(torch.empty(8, 16,
                                                         device="meta"),
                                             "sum", dist.group.WORLD))
    c = oc.cost
    Path(out).write_text(json.dumps({"counts": c.coll_counts,
                                     "traffic": c.coll_traffic,
                                     "raw": c.coll_raw}))
    tmesh.close_mesh()


def _qwen(out):
    import repro_torch
    import repro_torch.arch
    import repro_torch.launch.cells
    from repro_torch.launch import mesh as tmesh

    m = tmesh.make_host_mesh("cpu")
    cell = _qwen_smoke_cell(repro_torch, m)
    with op_cost.OpCost() as oc:
        cell.lower()
    Path(out).write_text(json.dumps({"flops": oc.cost.flops,
                                     "model_flops": cell.model_flops_per_step}))
    tmesh.close_mesh()


if __name__ == "__main__":
    {"ring": _ring, "qwen": _qwen}[sys.argv[1]](sys.argv[2])
