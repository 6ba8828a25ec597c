"""The no-fault trace replay (``chaos=False, parity_twin=True``) of the
port against the reference's on the CPU, and the recovered-replan
micro-benchmark's transactions.

Inside the port the sharded fleet (the fused multi-job Adam path and the
sharded relayout) must equal the flat ``ServiceRuntime`` twin (the block
step and the flat relayout) bit for bit at every window, across every
arrival, exit and scaler move of the trace.  Across packages the
counters and per-window rows must be equal, and parameters agree within
the per-apply budget of ``test_torch_replay_chaos.py`` (the reference
misses its own bit parity by 1 ulp; ROADMAP "Reference caveats").  Its
own file, so a worker of its own runs it beside the chaos replay.
"""

import json
from pathlib import Path

import pytest

import repro.sim.replay as jreplay
import repro_torch.sim.replay as treplay
from test_torch_replay_chaos import assert_params_close, run_pair

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def parity():
    return run_pair(chaos=False, parity_twin=True)


def test_port_fleet_equals_its_flat_twin_every_window(parity):
    _, _, trep, _, _ = parity
    assert trep["parity_violations"] == 0
    assert len(trep["windows"]) == 12
    assert all(w["parity"] and w["agree"] for w in trep["windows"])
    assert trep["n_faults_fired"] == 0 and trep["n_rollbacks"] == 0


def test_parity_counters_equal_reference(parity):
    jrep, _, trep, _, _ = parity
    assert jrep["parity_violations"] == 0
    assert trep == jrep


def test_parity_params_within_budget_of_reference(parity):
    jrep, jseen, trep, tseen, _ = parity
    assert len(jseen["left"]) == trep["n_exits"] == 12
    assert_params_close(jseen, tseen, trep["final_live"])


def test_parity_rows_match_bench_chaos_json(parity):
    _, _, trep, _, _ = parity
    bench = {r["name"]: r for r in json.loads(
        (ROOT / "BENCH_chaos.json").read_text())["rows"]}
    rows = {n: (v, d) for n, v, d in treplay.report_rows(trep, trep)}
    for name in ("nofault/windows", "nofault/parity_violations",
                 "nofault/bit_exact"):
        assert rows[name] == (bench[name]["value"], bench[name]["derived"])


def test_recovered_replan_micro_transactions_equal_reference():
    """One injected migration fault a cycle: every one aborts and is
    retried to success, in both packages (times are not compared)."""
    t = treplay.replan_overhead_micro(n_cycles=2, device="cpu")
    j = jreplay.replan_overhead_micro(n_cycles=2)
    assert (t["aborts"], t["retries"]) == (j["aborts"], j["retries"]) == (3, 3)
    assert t["clean_ms"] > 0 and t["recovered_ms"] > 0
    assert sorted(t) == sorted(j)
