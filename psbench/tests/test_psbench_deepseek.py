"""The DeepSeek-V2-Lite training cell on the CPU with a small model of the
same architecture (latent attention without q compression, YaRN, a
dense layer, then MoE layers holding a share of the routed experts):
``correct`` true for the program, false for the control and for each
fault a training step can have; the model's spans and MoE counters in a
profiled step, and nothing recorded off the profiler."""

import copy
import dataclasses
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from psbench import deepseek_job, harness  # noqa: E402
from psbench.reference import deepseek_v2 as ref  # noqa: E402
from psbench.reference import lm as ref_lm  # noqa: E402

CELL = "deepseek-v2-lite-l7.train4k"
SMALL = dict(num_hidden_layers=3, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, kv_lora_rank=16, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
             moe_intermediate_size=16, router_experts=16,
             n_routed_experts=4, experts_held_first=4,
             num_experts_per_tok=3, vocab_size=256,
             max_position_embeddings=32, torch_dtype="float32")
# float32 here: at 64 tokens a bfloat16 program routes a few % of the
# (token, layer) pairs to other experts than the float32 reference does,
# and each such token is a large share of its expert's few tokens, so the
# experts' gradients differ by more than any limit that still tells the
# program from the control.  The card's run is bfloat16 at 4,096 tokens.


@contextmanager
def _threads(n):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _small_cell():
    cell = harness.find_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg.update(SMALL)
    return dataclasses.replace(cell, config=cfg,
                               traffic=dict(cell.traffic, rows=2, seq=32))


def _run(seed, control=False, traced=False):
    with _threads(2):
        return harness.run_cell(_small_cell(), seed, 0.05, traced,
                                torch.device("cpu"),
                                t_start=time.perf_counter(), control=control)


def test_the_program_is_correct():
    res = _run(2 ** 31 + 41)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"count_gap", "grad_gap", "change_gap",
                                  "grad_diff"}
    assert math.isfinite(res["_readings"]["info.loss_gap"])
    assert 0.0 <= res["_readings"]["info.route_flips"] < 0.05


def test_the_control_is_not_correct():
    """The control and the faults planted in the reference, each judged
    by the harness's comparison in the program's place."""
    res = _run(2 ** 31 + 42, control=True)
    assert res["correct"], res["checks"]
    assert set(res["_variants"]) == {"control", "fault_half",
                                     "fault_altered"}
    for name, verdict in res["_variants"].items():
        assert not verdict["correct"], (name, verdict["checks"])


def _no_apply(monkeypatch):
    from repro_torch.ps import engine

    monkeypatch.setattr(engine.ShardedTickEngine, "_build_fleet_applier",
                        lambda self, key: (lambda arena, gs, counts: None))


def _half_batch(monkeypatch):
    from repro_torch.models import transformer

    real = transformer.chunked_softmax_xent

    def xent(hidden, unembed, labels, **kw):
        labels = labels.clone()
        labels[:, labels.shape[1] // 2:] = -1
        return real(hidden, unembed, labels, **kw)

    monkeypatch.setattr(transformer, "chunked_softmax_xent", xent)


def _altered(monkeypatch):
    from repro_torch.ps import engine

    real = engine._pack_slots

    def pack(layout, tree):
        g = real(layout, tree)
        g[: g.numel() // 2] *= 1.5
        return g

    monkeypatch.setattr(engine, "_pack_slots", pack)


def _no_held_experts(monkeypatch):
    """The held experts' part left out: each MoE layer adds the shared
    experts alone."""
    from repro_torch.models import transformer

    real = transformer.moe_ffn

    def shared_only(x, params, cfg, **kw):
        return real(x, dict(params, w_down=torch.zeros_like(
            params["w_down"])), cfg, **kw)

    monkeypatch.setattr(transformer, "moe_ffn", shared_only)


@pytest.mark.parametrize("fault", [_no_apply, _half_batch, _altered,
                                   _no_held_experts])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run(2 ** 31 + 43)
    assert not res["correct"], res["checks"]


def test_a_traced_run_reads_the_counters_and_the_model_spans():
    """On the CPU no device operation is attributed, so the two per-layer
    metrics read nothing; the counters still count a profiled step's
    held choices, every one kept or dropped."""
    res = _run(2 ** 31 + 44, traced=True)
    assert res["correct"], res["checks"]
    detail = res["_detail"]
    choices = detail["moe_choices"]
    assert set(choices) == {"kept", "dropped"}
    cell = _small_cell()
    m, tr = cell.config, cell.traffic
    n_moe = m["num_hidden_layers"] - m["first_k_dense_replace"]
    tokens = tr["rows"] * tr["seq"]
    assert choices["kept"] > 0
    assert choices["kept"] + choices["dropped"] <= (
        n_moe * tokens * m["num_experts_per_tok"])
    assert set(detail["fwd_ms"]) == {"mla", "moe"}
    assert "mla_fwd_ms.ds" not in res["metrics"]
    assert "tick_ms.lm" in res["metrics"]


def _model(seed):
    """The small config, the port's tree of the seed's weights (the
    reference's draws) and a batch of two rows."""
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_with_leaves

    m = _small_cell().config
    cfg = deepseek_job.lm_config(m)
    params = tree_with_leaves(tf.init_params(cfg, device="meta"), {
        n: ref.draw(n, s, std, dt, seed, "cpu")
        for n, s, std, dt in ref.leaf_specs(m)})
    toks = ref_lm.batch_tokens(m, 2, 32, seed, 0, "cpu")
    return m, cfg, params, toks, tf


SPANS = {"mla.proj", "attn.core", "attn.out", "moe.route", "moe.dispatch",
         "moe.experts", "moe.shared", "moe.combine", "ffn.dense"}


def test_spans_and_counters_appear_in_a_profiled_step_only():
    """A step under ``torch.func`` (as the engine takes it): every span
    of the model in the profile and both counters, which add up to the
    held experts' choices; off the profiler nothing is counted."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing

    m, cfg, params, toks, tf = _model(5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = torch.func.grad_and_value(lambda p, b: tf.loss_fn(cfg, p, b))
    with tracing.counting() as off:
        step(params, batch)
    assert off.read() == {}
    with tracing.counting() as on:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(params, batch)
    names = {e.name for e in prof.events()}
    assert {tracing.PREFIX + s for s in SPANS} <= names
    counts = on.read()
    assert set(counts) == {"moe.kept", "moe.dropped"}
    routes = deepseek_job.program_routes(m, 5, toks, "cpu")
    first, held = cfg.moe.experts_held
    chosen = sum(int(((r >= first) & (r < first + held)).sum())
                 for r in routes)
    assert counts["moe.kept"] + counts["moe.dropped"] == chosen


def test_the_configuration_lists_what_departs_from_its_source():
    cfg = harness.find_cell(CELL).config
    for key, value in cfg["published"].items():
        assert cfg[key] != value and key in cfg["reduced"]
    assert cfg["max_position_embeddings"] == harness.find_cell(
        CELL).traffic["seq"]
    assert cfg["n_routed_experts"] * 8 == cfg["router_experts"]
    assert cfg["vocab_size"] * 8 == cfg["published"]["vocab_size"]
    # the floors: a dense layer and at least 4 MoE layers, >= 8 experts,
    # >= 1/8 of the vocabulary
    assert cfg["num_hidden_layers"] - cfg["first_k_dense_replace"] >= 4
    assert cfg["n_routed_experts"] >= 8


def test_yarn_constants_at_the_published_sizes():
    c = ref.yarn_constants(harness.find_cell(CELL).config)
    assert (c["low"], c["high"]) == (10, 23)
    assert c["mscale_all_dim"] == pytest.approx(1.260804, abs=1e-6)
    assert c["scale"] == pytest.approx(0.114721, abs=1e-6)
    assert c["gain"] == 1.0


@pytest.mark.parametrize("key,value", [("q_lora_rank", 1536),
                                       ("attention_bias", True),
                                       ("topk_method", "group_limited_greedy"),
                                       ("seq_aux", False),
                                       ("routed_scaling_factor", 16)])
def test_a_model_the_port_cannot_run_is_refused(key, value):
    m = dict(harness.find_cell(CELL).config, **{key: value})
    with pytest.raises(ValueError):
        deepseek_job.lm_config(m)


def test_flops_per_token_by_hand():
    m = dict(_small_cell().config, num_hidden_layers=2)
    # MLA: q 64*4*24, latent 64*16, rope key 64*8, up 16*4*(16+16), o 4*16*64
    mla = 64 * 96 + 64 * 16 + 64 * 8 + 16 * 4 * 32 + 64 * 64
    # one dense layer (3*64*128) and one MoE layer: the router 64*16, the
    # shared experts 3*64*32 and 3*4/16 expected held choices of 3*64*16
    moe = 64 * 16 + 3 * 64 * 16 * (2 + 3 * 4 / 16)
    matmul = 2 * mla + 3 * 64 * 128 + moe + 64 * 256
    attention = 2 * 4 * (16 + 8 + 16) * 32 / 2
    assert deepseek_job.model_flops_per_token(m, 32) == pytest.approx(
        6 * (matmul + attention))


def test_the_kind_imports_with_jax_and_the_jax_package_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import psbench.deepseek_job, psbench.spans\n"
            "import psbench.reference.deepseek_v2\n"
            "from psbench import harness\n"
            "assert harness.forbidden_modules() == []\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
