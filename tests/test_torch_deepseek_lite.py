"""DeepSeek-V2-Lite's block in the port (MLA without q compression, YaRN
RoPE, DeepSeek's gate and sequence-wise balance loss, a share of the
routed experts held) against the benchmark's plain float32 reference
(``psbench/reference/deepseek_v2.py``), at a small size with seeded
weights on the CPU, the port in float32: the loss, the logits and every
leaf's gradient through a dense and two MoE layers; the YaRN constants
at the published sizes; the choices a full expert drops; the shares of
the experts adding up to the uncut layer; and the absorbed decode
through the cache against the prefill.

Tolerances: float32, rtol 1e-4 with atol 1e-5 x the largest magnitude
(the two sum products and the softmax in different orders, and build
their RoPE tables in float32 and float64).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from psbench import deepseek_job  # noqa: E402
from psbench.reference import deepseek_v2 as ref  # noqa: E402
from psbench.reference import lm as ref_lm  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import tree_leaves_by_key, tree_with_leaves  # noqa

PUBLISHED = {
    "hidden_size": 2048, "num_attention_heads": 16, "kv_lora_rank": 512,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"}}
SMALL = dict(
    PUBLISHED, hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
    kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    intermediate_size=96, moe_intermediate_size=16, router_experts=16,
    n_routed_experts=4, experts_held_first=4, num_experts_per_tok=3,
    n_shared_experts=2, first_k_dense_replace=1, num_hidden_layers=3,
    vocab_size=256, max_position_embeddings=64, rms_norm_eps=1e-6,
    attention_bias=False, hidden_act="silu", q_lora_rank=None,
    scoring_func="softmax", topk_method="greedy", n_group=1, topk_group=1,
    moe_layer_freq=1, tie_word_embeddings=False, seq_aux=True,
    norm_topk_prob=False, routed_scaling_factor=1, aux_loss_alpha=0.001,
    capacity_factor=1.25, torch_dtype="float32")


def _close(got, want, what=""):
    want = np.asarray(want.detach(), np.float64)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got.detach(), np.float64), want,
                               rtol=1e-4, atol=1e-5 * scale, err_msg=what)


def _weights(m, seed):
    """The reference's draws by name, and the port's tree of them."""
    w = {n: ref.draw(n, s, std, dt, seed, "cpu")
         for n, s, std, dt in ref.leaf_specs(m)}
    cfg = deepseek_job.lm_config(m)
    params = tree_with_leaves(ttf.init_params(cfg, device="meta"), w)
    return cfg, w, params


def test_loss_logits_and_every_gradient_match_the_reference():
    m = SMALL
    cfg, w, params = _weights(m, 11)
    toks = ref_lm.batch_tokens(m, 2, 32, 11, 0, "cpu")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grads, loss = torch.func.grad_and_value(
        lambda p: ttf.loss_fn(cfg, p, batch))(params)
    wr = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    want = ref.loss(wr, toks, m)
    want_g = dict(zip(wr, torch.autograd.grad(want, list(wr.values()))))
    _close(loss, want, "loss")
    got_g = tree_leaves_by_key(grads)
    assert set(got_g) == set(want_g)
    for name, g in want_g.items():
        _close(got_g[name], g, name)
    hidden, aux = ttf.forward_hidden(cfg, params, batch["tokens"])
    logits, want_aux = ref.forward(w, batch["tokens"], m)
    _close(hidden @ params["unembed"], logits, "logits")
    _close(aux, want_aux, "balance loss")
    assert float(want_aux) > 0


def test_yarn_constants_at_the_published_sizes():
    y = deepseek_job.lm_config(dict(SMALL, **PUBLISHED)).rope_scaling
    assert tlayers.yarn_range(64, 10000.0, y) == (10, 23)
    assert tlayers.yarn_mscale(y.factor, y.mscale_all_dim) == \
        pytest.approx(1.260804, abs=1e-6)
    cfg = dataclasses.replace(deepseek_job.lm_config(SMALL),
                              mla=ttf.MLAConfig(None, 512, 128, 64, 128))
    assert ttf._mla_scale(cfg) == pytest.approx(0.114721, abs=1e-6)
    c = ref.yarn_constants(dict(SMALL, **PUBLISHED))
    assert (c["low"], c["high"], c["gain"]) == (10, 23, 1.0)


@pytest.mark.parametrize("mscale", [0.707, 1.0])
def test_rope_tables_match_the_reference(mscale):
    """YaRN's cos and sin, also where mscale and mscale_all_dim differ
    (cos and sin then scaled), in the table and the decode's row."""
    m = dict(SMALL, **PUBLISHED)
    m["rope_scaling"] = dict(m["rope_scaling"], mscale=mscale)
    cfg = deepseek_job.lm_config(m)
    cos, sin = ttf.rope_tables(cfg, "cpu", 200)
    want_cos, want_sin = ref._yarn_tables(m, 200, "cpu")
    _close(cos, want_cos, "cos")
    _close(sin, want_sin, "sin")
    row_cos, row_sin = ttf.rope_tables(cfg, "cpu", position=137)
    _close(row_cos[0], want_cos[137], "row cos")
    _close(row_sin[0], want_sin[137], "row sin")


def _moe_inputs(m, seed, bias=None):
    cfg, w, params = _weights(m, seed)
    layer = {n[len("layers/"):]: t[0] for n, t in w.items()
             if n.startswith("layers/moe/")}
    if bias is not None:
        layer["moe/router"] = layer["moe/router"] + bias
    x = torch.randn((2, 24, m["hidden_size"]),
                    generator=torch.Generator().manual_seed(seed))
    return cfg, layer, x


def _port_moe(cfg_moe, layer, x):
    p = {n[len("moe/"):]: t for n, t in layer.items()}
    b, s, d = x.shape
    y, aux = tmoe.moe_ffn(x.reshape(b * s, d), p, cfg_moe, n_seqs=b)
    return y.reshape(b, s, d), aux


def test_a_full_expert_drops_the_same_choices_in_both():
    """A router biased to one held expert overflows it: the program keeps
    and drops what the reference's plain first-C rule does."""
    m = SMALL
    bias = torch.zeros(m["router_experts"])
    bias[m["experts_held_first"] + 1] = 4.0
    cfg, layer, x = _moe_inputs(m, 12, bias)
    with tracing.counting() as counts, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got, got_aux = _port_moe(cfg.moe, layer, x)
    routes = []
    want, want_aux = ref.moe(layer, x, m, lambda t: t, routes)
    _close(got, want, "moe output")
    _close(got_aux, want_aux, "balance loss")
    first, held = m["experts_held_first"], m["n_routed_experts"]
    cap = ref.capacity(m, x.shape[0] * x.shape[1])
    loads = torch.bincount(routes[0].reshape(-1),
                           minlength=m["router_experts"])[first:first + held]
    dropped = int((loads - cap).clamp(min=0).sum())
    assert dropped > 0
    assert counts.read() == {"moe.kept": int(loads.sum()) - dropped,
                             "moe.dropped": dropped}


def test_the_shares_of_the_experts_add_up_to_the_uncut_layer():
    """Eight shares of eight experts each: their outputs, with the shared
    experts (which every share computes) counted once, sum to the uncut
    reference layer's, and each share's balance loss is the layer's."""
    m = dict(SMALL, router_experts=64, n_routed_experts=64,
             experts_held_first=0, num_experts_per_tok=6)
    cfg, layer, x = _moe_inputs(m, 13)
    want, want_aux = ref.moe(layer, x, m, lambda t: t)
    p = {n[len("moe/"):]: t for n, t in layer.items()}
    shared = ref._swiglu(x, p["shared_gate"], p["shared_up"],
                         p["shared_down"], lambda t: t)
    total = torch.zeros_like(want)
    for i in range(8):
        part = dataclasses.replace(cfg.moe, experts_held=(8 * i, 8))
        held = {k: (v[8 * i:8 * i + 8] if k.startswith("moe/w_") else v)
                for k, v in layer.items()}
        y, aux = _port_moe(part, held, x)
        total = total + y - shared
        _close(aux, want_aux, f"share {i} balance loss")
    _close(total + shared, want, "sum of the shares")


def test_yarn_decode_through_the_cache_equals_the_prefill():
    """With a capacity factor of E / k no choice is dropped, so decoding
    the prompt one token at a time (MLA absorbed, the YaRN row) gives the
    prefill's last-token logits (MLA un-absorbed, the YaRN table)."""
    m = dict(SMALL, rope_scaling=dict(SMALL["rope_scaling"], factor=4,
                                      original_max_position_embeddings=8))
    cfg, _, params = _weights(m, 14)
    cfg = dataclasses.replace(
        cfg, moe_capacity_factor_override=cfg.moe.n_experts / cfg.moe.top_k)
    toks = ref_lm.batch_tokens(m, 3, 20, 14, 0, "cpu")[:, :20]
    pre = ttf.make_prefill(cfg)(params, toks)
    cache = ttf.init_kv_cache(cfg, 3, 20, device="cpu")
    step = ttf.make_serve_step(cfg)
    for i in range(20):
        logits, cache = step(params, cache, toks[:, i:i + 1])
    _close(logits, pre, "last-token logits")
