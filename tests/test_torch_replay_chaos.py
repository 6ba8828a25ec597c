"""The chaos trace replay of the port (``repro_torch.sim.replay``) against
the reference's (``repro.sim.replay``) on the CPU.

``ReplayConfig()`` runs once per package: the reference eagerly, the port
on ``device="cpu"`` with the reference's own job trees (``_job_tree``,
carried across through numpy), so both drive the same tensors through
the same trace, chaos schedule and fleet.  Every counter of the report
and every per-window row must be equal, and the values the reference
recorded in ``BENCH_chaos.json`` must hold.

Parameters are compared within ULP_BUDGET, the per-apply budget of the
sharded tests, and within rtol 1e-5, not bit for bit: the reference's
Adam misses its own bit parity by 1 ulp on some lanes (ROADMAP
"Reference caveats"), so no cross-package bound is 0.  Every job is
compared when it leaves (an exit or a lease reclaim, read just before
``remove_job``), and the final live jobs at the end.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.ps.service_runtime as jsr
import repro.sim.replay as jreplay
import repro_torch.ps.service_runtime as tsr
import repro_torch.sim.replay as treplay

ROOT = Path(__file__).resolve().parents[1]
ULP_BUDGET = 1


def ulp_diff(a, b) -> int:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


def reference_tree(job_id, trace_job=None):
    """The reference's tree for trace job ``jN``, as CPU tensors."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in jreplay._job_tree(int(job_id[1:])).items()}


def capture(module, mp):
    """Swap ``module.ShardedServiceRuntime`` for a subclass that records
    its instance and each job's parameters just before it is removed."""
    seen = {"left": {}}
    base = module.ShardedServiceRuntime

    class Capturing(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["rt"] = self

        def remove_job(self, job_id):
            seen["left"][job_id] = {k: np.asarray(v) for k, v in
                                    self.params_of(job_id).items()}
            super().remove_job(job_id)

    mp.setattr(module, "ShardedServiceRuntime", Capturing)
    return seen


def run_pair(**cfg):
    """(reference report, its capture, port report, its capture, the
    port's on_window calls) for ``ReplayConfig(**cfg)``."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        jseen = capture(jsr, mp)
        jrep = jreplay.run_replay(jreplay.ReplayConfig(**cfg))
        tseen = capture(tsr, mp)
        trep = treplay.run_replay(
            treplay.ReplayConfig(**cfg), device="cpu",
            job_tree=reference_tree,
            on_window=lambda row, rt: calls.append((dict(row), rt)))
    return jrep, jseen, trep, tseen, calls


def assert_params_close(jseen, tseen, final_live):
    for side in (jseen, tseen):
        for j in final_live:
            side["left"][j] = {k: np.asarray(v) for k, v in
                               side["rt"].params_of(j).items()}
    assert sorted(tseen["left"]) == sorted(jseen["left"])
    for j, want in jseen["left"].items():
        got = tseen["left"][j]
        assert sorted(got) == sorted(want), j
        for k in want:
            assert ulp_diff(got[k], want[k]) <= ULP_BUDGET, (j, k)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def chaos():
    return run_pair()


def test_chaos_counters_equal_reference(chaos):
    jrep, _, trep, _, _ = chaos
    assert sorted(trep) == sorted(jrep)
    for k in jrep:
        if k != "windows":
            assert trep[k] == jrep[k], k


@pytest.mark.parametrize("window", range(12))
def test_chaos_window_rows_equal_reference(chaos, window):
    jrep, _, trep, _, _ = chaos
    assert len(trep["windows"]) == len(jrep["windows"]) == 12
    assert trep["windows"][window] == jrep["windows"][window]


def test_chaos_matches_bench_chaos_json(chaos):
    """The reference's recorded soak: 12 windows, 13 of 14 admitted, 13
    faults, 2 aborts and retries, 11 rollbacks, a recovery, j5's lease
    lapsing after 2 windows, no divergence."""
    _, _, trep, _, _ = chaos
    assert trep["n_windows"] == 12
    assert (trep["n_admitted"], trep["n_trace_jobs"]) == (13, 14)
    assert trep["n_faults_fired"] == 13
    assert trep["faults_by_kind"] == {"fail_migration": 2, "drop_push": 1,
                                      "fail_apply": 10}
    assert (trep["n_replan_aborts"], trep["n_replan_retries"]) == (2, 2)
    assert trep["n_rollbacks"] == 11
    assert trep["n_recoveries"] == 1
    assert trep["n_lease_expirations"] == 1
    assert (trep["dead_job"], trep["reclaim_latency_windows"]) == ("j5", 2)
    assert trep["registry_divergence_windows"] == 0
    bench = {r["name"]: r for r in json.loads(
        (ROOT / "BENCH_chaos.json").read_text())["rows"]}
    rows = treplay.report_rows(trep, trep)
    checked = 0
    for name, value, derived in rows:
        if name.startswith("chaos/") and name in bench:
            assert (value, derived) == (bench[name]["value"],
                                        bench[name]["derived"]), name
            checked += 1
    assert checked == 13


def test_chaos_params_within_budget_of_reference(chaos):
    """Every job that left (11 exits, j5's reclaim) and the final live
    job, against the reference's."""
    jrep, jseen, trep, tseen, _ = chaos
    assert len(jseen["left"]) == 12
    assert_params_close(jseen, tseen, trep["final_live"])


def test_chaos_report_rows_equal_reference(chaos):
    jrep, _, trep, _, _ = chaos
    assert treplay.report_rows(trep, trep) == jreplay.report_rows(jrep, jrep)


def test_on_window_sees_every_row_and_the_runtime(chaos):
    _, _, trep, tseen, calls = chaos
    assert [row for row, _ in calls] == trep["windows"]
    assert all(rt is tseen["rt"] for _, rt in calls)
    assert tseen["rt"].device == torch.device("cpu")


def test_default_job_tree_keeps_the_reference_sizes():
    for i in range(14):
        want = jreplay._job_tree(i)
        got = treplay.default_job_tree(f"j{i}")
        assert {k: v.shape for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
        assert all(v.dtype == torch.float32 for v in got.values())
    a, b = treplay.default_job_tree("j3"), treplay.default_job_tree("j3")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_run_replay_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        treplay.run_replay(treplay.ReplayConfig(max_windows=1))


def test_replay_cli_smoke_on_the_cpu(tmp_path, capsys):
    """``scripts/torch_replay_trace.py --smoke --device cpu``: both
    replays and the micro-benchmark pass their invariants, and rows are
    written only where ``--json`` says."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_replay_trace", ROOT / "scripts" / "torch_replay_trace.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    out = tmp_path / "rows.json"
    assert cli.main(["--smoke", "--device", "cpu", "--json", str(out)]) == 0
    assert "OK: " in capsys.readouterr().out
    rows = {r["name"]: r["value"] for r in json.loads(out.read_text())["rows"]}
    assert rows["chaos/zero_divergence"] == "1"
    assert rows["nofault/bit_exact"] == "1"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rows.json"]
