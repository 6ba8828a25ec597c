"""The paper's §5.2 control-plane claims on the port's copies
(``repro_torch.core``, ``repro_torch.configs.paper_workloads``,
``repro_torch.sim``), each computed by both packages:
``tests/test_paper_claims.py``'s Fig. 2 utilizations, Fig. 7 balanced
placement, Fig. 8 Aggregator counts and savings band, Table 2 reduction
ratios and Fig. 9 loss bounds, and ``tests/test_sim.py``'s two Fig. 11
trace simulations (400 and 250 jobs, the reference's half in a child
process).  The two packages' numbers must be equal, and the claim must
hold on the port's.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import repro.configs.paper_workloads as jpw
import repro.core as jcore
import repro.core.assignment as jassign
import repro_torch.configs.paper_workloads as tpw
import repro_torch.core as tcore
import repro_torch.core.assignment as tassign
from test_torch_sim import run_both_in_parallel

PORT = SimpleNamespace(core=tcore, assign=tassign, pw=tpw)
REF = SimpleNamespace(core=jcore, assign=jassign, pw=jpw)
MODELS = ("alexnet", "vgg19", "awd-lm", "bert")


def both(fn):
    """``fn(ns)`` on both packages; equal results; returns the port's."""
    got, want = fn(PORT), fn(REF)
    assert got == want
    return got


def _run_multi_job(ns, model, n_jobs, servers, workers):
    svc = ns.core.ParameterService(total_budget=64, n_clusters=1)
    for i in range(n_jobs):
        svc.register_job(ns.pw.make_job(model, f"{model}-{i}", servers,
                                        workers))
    return svc


# --------------------------------------------------------------------- Fig 2
def test_fig2_cpu_underutilization():
    utils = both(lambda ns: {m: ns.pw.standalone_utilization(m, 1, 2)
                             for m in MODELS})
    assert utils["vgg19"] == pytest.approx(0.16, abs=0.02)
    assert all(u < 0.6 for u in utils.values())
    assert sum(utils.values()) / 4 < 0.5


# --------------------------------------------------------------------- Fig 7
def test_fig7_balanced_placement_beats_round_robin():
    def run(ns):
        out = {}
        for model, servers in (("vgg19", 2), ("alexnet", 2), ("bert", 4)):
            job = ns.pw.make_job(model, "j", servers, 2, chunk_bytes=1 << 62)
            out[model] = (
                ns.assign.shard_imbalance(
                    ns.assign.round_robin_shard_assignment(job, servers)),
                ns.assign.shard_imbalance(
                    ns.assign.balanced_shard_assignment(job, servers)))
        return out

    out = both(run)
    assert all(bal <= rr + 1e-9 for rr, bal in out.values())
    assert out["vgg19"][0] > 1.15


# --------------------------------------------------------------------- Fig 8
@pytest.mark.parametrize(
    "model,n_jobs,expected_aggs",
    [
        ("alexnet", 2, 3),
        ("vgg19", 2, 2),
        ("vgg19", 4, 2),
        ("awd-lm", 2, 2),
        ("awd-lm", 4, 2),
        ("bert", 2, 2),
    ],
)
def test_fig8_aggregator_counts_2s2w(model, n_jobs, expected_aggs):
    n = both(lambda ns: _run_multi_job(ns, model, n_jobs, 2, 2)
             .n_aggregators)
    assert n == expected_aggs


def test_fig8_reduction_band():
    ratios = both(lambda ns: [
        _run_multi_job(ns, model, n_jobs, 2, 2).cpu_reduction()
        for model in MODELS for n_jobs in (2, 3, 4)])
    assert min(ratios) == pytest.approx(0.25, abs=1e-6)
    assert max(ratios) == pytest.approx(0.75, abs=1e-6)


# -------------------------------------------------------------------- Table 2
@pytest.mark.parametrize(
    "model,expected_ratio",
    [("alexnet", 0.375), ("vgg19", 0.5), ("awd-lm", 0.5), ("bert", 0.5)],
)
def test_table2_reduction_ratio_4s4w(model, expected_ratio):
    ratio = both(lambda ns: _run_multi_job(ns, model, 2, 4, 4)
                 .cpu_reduction())
    assert ratio == pytest.approx(expected_ratio, abs=1e-6)


# --------------------------------------------------------------------- Fig 9
def test_fig9_loss_bounded_by_losslimit():
    losses = both(lambda ns: [
        _run_multi_job(ns, model, n_jobs, 2, 2).predicted_losses()
        for model in MODELS for n_jobs in (2, 4)])
    assert all(max(l.values()) <= 0.09 + 1e-9 for l in losses)


# ------------------------------------------------------- utilization benefit
def test_packing_improves_mean_utilization():
    def run(ns):
        solo = _run_multi_job(ns, "vgg19", 1, 2, 2)
        packed = _run_multi_job(ns, "vgg19", 4, 2, 2)
        return [sum(s.utilizations().values()) / s.n_aggregators
                for s in (solo, packed)]

    solo, packed = both(run)
    assert packed > 2.5 * solo


# -------------------------------------------------------------------- Fig 11
def test_saves_cpu_time_at_scale():
    """The headline Fig.-11 property: packing saves a large fraction of
    the CPU-time ps-lite would reserve (paper: 52.7%)."""
    res = run_both_in_parallel(n_jobs=400, seed=1, n_clusters=4)
    assert res.cpu_time_saving > 0.40, res.cpu_time_saving
    r = np.array(res.ratio_series())
    assert (r < 1).mean() > 0.95  # paper: >99% of samples under 1


def test_periodic_scaling_can_overshoot():
    """Idle Aggregators held until the scaling tick occasionally push the
    allocated/required ratio over 1 (the paper's >1 spikes)."""
    res = run_both_in_parallel(n_jobs=250, seed=3, n_clusters=2,
                               scaling_period=3600.0)
    assert max(res.ratio_series()) > 1.0
