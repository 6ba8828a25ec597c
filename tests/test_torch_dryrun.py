"""The port's dry-run (``repro_torch.launch.dryrun``) on a fake (2, 2)
mesh, on a fake (2, 2, 2) (``pod``, ``data``, ``model``) one and,
through its command line, on the production 16 x 16 one; each in a child
process, which holds the fake process group.

A cell that runs records the reference's fields (per-device bytes from
the local shards, flops, collectives, the roofline terms under the H100
SXM's constants); a cell DTensor cannot place is recorded ``ok: false``
naming the operator, and the run goes on.  Every cell of the registry
places; the unplaceable one here is made so, its step function swapped
for one that asks for ``nonzero``, whose output shape depends on values
that ``meta`` tensors do not have."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
CELLS = [("dlrm-rm2", "serve_p99"), ("qwen1.5-0.5b", "long_500k"),
         ("gin-tu", "molecule")]


UNPLACEABLE = ("dlrm-rm2", "serve_p99")  # its function swapped
CELLS8 = [("dien", "train_batch")]  # the batch over (pod, data)


@pytest.fixture(scope="module")
def fake4(tmp_path_factory):
    """The records of the (2, 2) mesh's cells (and, under
    ``"unplaceable"``, the swapped cell's) and of the (2, 2, 2) mesh's;
    the two meshes in two children side by side."""
    d = tmp_path_factory.mktemp("dryrun")
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               which, str(d)], env=ENV)
             for which in ("fake4", "fake8")]
    for p in procs:
        assert p.wait(timeout=300) == 0
    out = {(a, s): json.loads((d / "fake4" / f"{a}__{s}.json").read_text())
           for a, s in CELLS}
    out["unplaceable"] = json.loads(
        (d / "unplaceable" / "{}__{}.json".format(*UNPLACEABLE)).read_text())
    out.update({(a, s, 8): json.loads(
        (d / "fake8" / f"{a}__{s}.json").read_text()) for a, s in CELLS8})
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_records_the_reference_fields(fake4, arch, shape):
    rec = fake4[(arch, shape)]
    assert rec["ok"] and rec["chips"] == 4 and rec["mesh"] == "fake4"
    for key in ("lower_s", "memory", "per_device_flops", "per_device_bytes",
                "per_device_collective_bytes", "collectives", "roofline",
                "model_flops_per_step", "hlo_flops_global",
                "useful_flops_ratio", "roofline_fraction"):
        assert key in rec, key
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_estimate_bytes"]
    assert mem["output_bytes"] > 0
    assert rec["roofline"]["constants"] == "H100 SXM (analytic)"
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["per_device_flops"] > 0
    assert rec["hlo_flops_global"] == 4 * rec["per_device_flops"]
    assert rec["per_device_collective_bytes"] == pytest.approx(
        sum(rec["collectives"]["traffic_bytes"].values()))


def test_row_sharded_lookup_reduce_scatters(fake4):
    """The DLRM lookup's mesh branch: one reduce-scatter over the 4 ranks
    of its (B, 26, 64) float32 partial, a 512 / 4 row result."""
    coll = fake4[("dlrm-rm2", "serve_p99")]["collectives"]
    assert coll["counts"]["reduce-scatter"] >= 1
    assert coll["raw_bytes"]["reduce-scatter"] >= 128 * 26 * 64 * 4


def test_unplaceable_cell_is_recorded_not_raised(fake4):
    rec = fake4["unplaceable"]
    assert rec["ok"] is False
    assert "aten." in rec["error"] and rec["traceback"]


@pytest.mark.parametrize("arch,shape", CELLS8)
def test_three_axis_mesh_places_a_batch_over_two_axes(fake4, arch, shape):
    """DIEN's train_batch on (pod 2, data 2, model 2): its batch over two
    mesh axes, the target attention in its per-device region."""
    rec = fake4[(arch, shape, 8)]
    assert rec["ok"], rec.get("error")
    assert rec["chips"] == 8 and rec["mesh"] == "fake8"
    assert rec["per_device_flops"] > 0 and rec["hlo_flops_global"] == \
        8 * rec["per_device_flops"]


def test_command_line_on_the_production_mesh(tmp_path):
    args = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            "dlrm-rm2", "--shape", "serve_p99", "--out", str(tmp_path)]
    subprocess.run(args, check=True, timeout=300, env=ENV)
    path = tmp_path / "pod256" / "dlrm-rm2__serve_p99.json"
    rec = json.loads(path.read_text())
    assert rec["ok"] and rec["chips"] == 256
    stamp = path.stat().st_mtime_ns
    subprocess.run(args + ["--skip-existing"], check=True, timeout=300,
                   env=ENV)
    assert path.stat().st_mtime_ns == stamp


def _unplaceable(params, batch):
    import torch

    return torch.nonzero(batch["sparse"])


def _fake(which, out):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import close_mesh, make_fake_mesh

    if which == "fake8":
        mesh = make_fake_mesh((2, 2, 2), ("pod", "data", "model"))
        for arch, shape in CELLS8:
            dryrun.run_cell(arch, shape, "fake8", Path(out), mesh=mesh)
    else:
        mesh = make_fake_mesh((2, 2), ("data", "model"))
        for arch, shape in CELLS:
            dryrun.run_cell(arch, shape, "fake4", Path(out), mesh=mesh)
        dryrun.run_cell(*UNPLACEABLE, "unplaceable", Path(out), mesh=mesh,
                        overrides={"fn": _unplaceable})
    close_mesh()


if __name__ == "__main__":
    _fake(*sys.argv[1:3])
