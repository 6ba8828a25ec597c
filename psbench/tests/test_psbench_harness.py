"""The harness finds each cell's files by name, refuses what it does not
have, and its entry point never falls back to the CPU."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from psbench import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = harness.find_cell(name)
    w = {x["name"]: x for x in BENCH["workloads"]}[name]
    assert cell.config["name"] == w["config"]
    assert "loop" in cell.traffic
    assert cell.chips == w["chips"]
    reported = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]).read)
    for limit in cell.limits.values():
        assert limit >= 0


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        harness.find_cell("paper3.no_such_mix")
    with pytest.raises(KeyError):
        harness.reader("no_such_metric")


def test_benchmark_file_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["psbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("psbench/")
        assert (ROOT / c["file"]).is_file()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads", CELLS)
            assert cell in reports
        layers.setdefault(m["layer"], m["layer"])
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)


def test_traffic_and_config_files_are_data():
    for path in (ROOT / "psbench" / "traffic").iterdir():
        assert path.suffix in (".json", ".jsonl", ".toml", ".txt", ".csv")
        json.loads(path.read_text())
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "psbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_run_exits_without_a_card_and_prints_no_result():
    proc = _run(["--workload", CELLS[0], "--seed", "2147483649",
                 "--seconds", "1", "--trace", "0"], ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_refuses_an_unknown_cell():
    proc = _run(["--workload", "nope", "--seed", "1", "--seconds", "1"],
                ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "psbench", tmp_path / "psbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(["--workload", CELLS[0], "--seed", "3", "--seconds", "1"],
                tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
