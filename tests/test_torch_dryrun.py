"""The port's dry-run (``repro_torch.launch.dryrun``) on a fake (2, 2)
mesh and, through its command line, on the production 16 x 16 one; each
in a child process, which holds the fake process group.

A cell that runs records the reference's fields (per-device bytes from
the local shards, flops, collectives, the roofline terms under the H100
SXM's constants); a cell DTensor cannot place is recorded ``ok: false``
naming the operator, and the run goes on."""

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


@pytest.fixture(scope="module")
def fake4(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    subprocess.run([sys.executable, str(Path(__file__).resolve()), str(d)],
                   check=True, timeout=300, env=ENV)
    return {(a, s): json.loads((d / "fake4" / f"{a}__{s}.json").read_text())
            for a, s in CELLS}


@pytest.mark.parametrize("arch,shape", CELLS[:2])
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
    rec = fake4[("gin-tu", "molecule")]
    assert rec["ok"] is False
    assert "aten." in rec["error"] and rec["traceback"]


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


def _fake4(out):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import close_mesh, make_fake_mesh

    mesh = make_fake_mesh((2, 2), ("data", "model"))
    for arch, shape in CELLS:
        dryrun.run_cell(arch, shape, "fake4", Path(out), mesh=mesh)
    close_mesh()


if __name__ == "__main__":
    _fake4(sys.argv[1])
