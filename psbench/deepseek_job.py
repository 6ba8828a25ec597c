"""Cells of DeepSeek-V2-Lite training as a job of the shared service
(configuration kind ``deepseek_job``).

As ``lm_job`` does for the Llama decoder: set-up builds a
``ShardedServiceRuntime`` with its fleet-tick engine and registers one
job, the port's decoder (``repro_torch.models.transformer``) at the
configuration's widths (latent attention without q compression,
YaRN-scaled RoPE, a leading dense layer, then MoE layers holding the
configuration's share of the routed experts), with weights drawn on the
device from the seed, its loss the port's ``loss_fn``.  Every step is
``engine.step(job, batch)`` then ``engine.tick()``.

The traffic's ``loop`` is ``train_steps``, as ``lm_job`` reads it.  A
traced run profiles ``profile_steps`` steps once: the benchmark's
summary of them is ``trace.summarize``'s, and the device time launched
inside the model's spans gives ``detail["fwd_ms"]``: ``mla`` (``mla.*``
and ``attn.*``) and ``moe`` (``moe.*``), device ms a step, forward only
(the backward launches from autograd threads after the spans close).
The MoE's ``moe.kept`` and ``moe.dropped`` counters over the same steps
are ``detail["moe_choices"]``, a step.

The three set-up steps are checked as ``lm_job`` checks them, against
the plain reference ``reference/deepseek_v2.py``; the share of (token,
MoE layer) whose top-k experts differ between the program's first step
and the reference's is ``info.route_flips`` (not compared).
"""

from __future__ import annotations

import gc
import time
from typing import Dict
from unittest import mock

import torch

from . import lm_job, spans, trace
from .reference import deepseek_v2 as ref

CHECKED_STEPS = lm_job.CHECKED_STEPS
# What the port's decoder does not run; the configuration must say so.
REQUIRED = {"attention_bias": False, "hidden_act": "silu",
            "rms_norm_eps": 1e-06, "q_lora_rank": None,
            "scoring_func": "softmax", "topk_method": "greedy",
            "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
            "tie_word_embeddings": False, "seq_aux": True,
            "routed_scaling_factor": 1}


def lm_config(m: Dict):
    """The port's ``LMConfig`` for the configuration's model keys (the
    catalog's ``config.json`` keys, the held experts, the router's width
    and the assumed balance coefficient and capacity factor).  What the
    port does not run is refused rather than run as something else."""
    from repro_torch.models.layers import YaRN
    from repro_torch.models.moe import DeepSeekMoEConfig
    from repro_torch.models.transformer import MLAConfig, YaRNLMConfig

    wrong = {k: m.get(k) for k, v in REQUIRED.items() if m.get(k) != v}
    if wrong or m["rope_scaling"]["type"] != "yarn":
        raise ValueError(f"the port's DeepSeek-V2 decoder runs {REQUIRED} "
                         f"with YaRN RoPE; the configuration has {wrong}")
    y = m["rope_scaling"]
    fe = m["moe_intermediate_size"]
    cfg = YaRNLMConfig(
        name="psbench", n_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], d_ff=m["intermediate_size"],
        vocab=m["vocab_size"], tie_embeddings=False, norm="rmsnorm",
        rope_theta=float(m["rope_theta"]),
        rope_scaling=YaRN(
            factor=float(y["factor"]),
            original_max_len=y["original_max_position_embeddings"],
            beta_fast=float(y["beta_fast"]), beta_slow=float(y["beta_slow"]),
            mscale=float(y["mscale"]),
            mscale_all_dim=float(y["mscale_all_dim"])),
        max_seq_len=m["max_position_embeddings"], dtype=m["torch_dtype"],
        # one chunk of logits a row: the vocabulary slice keeps them small
        loss_chunk=m["max_position_embeddings"],
        first_k_dense=m["first_k_dense_replace"],
        mla=MLAConfig(q_lora_rank=None, kv_lora_rank=m["kv_lora_rank"],
                      qk_nope_dim=m["qk_nope_head_dim"],
                      qk_rope_dim=m["qk_rope_head_dim"],
                      v_head_dim=m["v_head_dim"]),
        moe=DeepSeekMoEConfig(
            n_experts=m["router_experts"], top_k=m["num_experts_per_tok"],
            d_ff=fe, n_shared=m["n_shared_experts"],
            d_ff_shared=m["n_shared_experts"] * fe,
            capacity_factor=m["capacity_factor"],
            aux_loss_coef=m["aux_loss_alpha"], router_z_coef=0.0,
            normalize_gates=m["norm_topk_prob"], seq_aux=True,
            experts_held=(m["experts_held_first"], m["n_routed_experts"])))
    if cfg.padded_vocab != cfg.vocab:
        raise ValueError("the vocabulary must be a multiple of 256: the "
                         "port pads its embedding otherwise")
    return cfg


def model_flops_per_token(m: Dict, seq: int) -> float:
    """Forward and backward FLOPs a token needs (3 x the forward's), 2
    per multiply-add: MLA's six products, the dense layers' FFN, the
    router, the shared experts, the routed experts at k x held / E
    expected choices a token on the held experts (padding and drops not
    counted), the head over the vocabulary here, and causal attention's
    score and value products over the (on average) seq / 2 keys each
    query sees.  No recompute counted."""
    d, h = m["hidden_size"], m["num_attention_heads"]
    r, nope = m["kv_lora_rank"], m["qk_nope_head_dim"]
    rope, dv = m["qk_rope_head_dim"], m["v_head_dim"]
    fe, e = m["moe_intermediate_size"], m["router_experts"]
    n_dense = m["first_k_dense_replace"]
    n_moe = m["num_hidden_layers"] - n_dense
    mla = d * h * (nope + rope) + d * r + d * rope + r * h * (nope + dv) \
        + h * dv * d
    choices = m["num_experts_per_tok"] * m["n_routed_experts"] / e
    moe = d * e + 3 * d * fe * (m["n_shared_experts"] + choices)
    matmul = (m["num_hidden_layers"] * mla
              + n_dense * 3 * d * m["intermediate_size"] + n_moe * moe
              + d * m["vocab_size"])
    attention = m["num_hidden_layers"] * h * (nope + rope + dv) * seq / 2
    return 3 * 2 * (matmul + attention)


class Job(lm_job.Job):
    """``lm_job``'s job (step, tick, the state read back) with the
    DeepSeek-V2 decoder registered."""

    def __init__(self, cell, seed, device, bench_spans, sync):
        from repro_torch.core import ParameterService
        from repro_torch.models import transformer as tf
        from repro_torch.ps.service_runtime import ShardedServiceRuntime
        from repro_torch.tree import tree_leaves_by_key, tree_with_leaves

        cfg, tr = cell.config, cell.traffic
        svc = cfg["service"]
        self.m, self.tr, self.seed, self.device = cfg, tr, seed, device
        self.sync = sync
        self.id = cfg["job"]["id"]
        self.lm = lm_config(cfg)
        meta = tf.init_params(self.lm, device="meta")
        shapes = {k: (tuple(t.shape), t.dtype)
                  for k, t in tree_leaves_by_key(meta).items()}
        specs = ref.leaf_specs(cfg)
        want = {n: (tuple(s), getattr(torch, dt)) for n, s, _, dt in specs}
        if shapes != want:
            raise ValueError(f"the port's parameter tree {shapes} is not "
                             f"the reference's {want}")
        params = tree_with_leaves(meta, {
            n: ref.draw(n, s, std, dt, seed, device)
            for n, s, std, dt in specs})
        self.service = ParameterService(
            total_budget=svc["total_budget"], n_clusters=svc["n_clusters"],
            plan_pad_to=svc["plan_pad_to"])
        self.rt = ShardedServiceRuntime(self.service, device=device)
        self.eng = self.rt.attach_engine(
            fleet_tick=svc["fleet_tick"], max_staleness=svc["max_staleness"],
            snapshot_interval=svc["snapshot_interval"])
        lm = self.lm
        adam = cfg["adam"]
        with bench_spans.span("register", sync):
            self.rt.add_job(
                self.id, params, lambda p, b: tf.loss_fn(lm, p, b),
                iteration_duration=svc["iteration_duration"],
                n_workers=svc["n_workers"],
                required_servers=svc["required_servers"],
                agg_throughput=svc["agg_throughput"],
                lr=cfg["job"]["lr"], b1=adam["b1"], b2=adam["b2"],
                eps=adam["eps"])
        del params
        self.steps = 0


def program_routes(m: Dict, seed: int, tokens, device):
    """The port's top-k expert ids, one (tokens, k) tensor a MoE layer,
    in a forward pass of ``tokens`` (rows, seq + 1) from the seed's
    weights: the routing of the program's first step."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_with_leaves

    cfg = lm_config(m)
    params = tree_with_leaves(tf.init_params(cfg, device="meta"), {
        n: ref.draw(n, s, std, dt, seed, device)
        for n, s, std, dt in ref.leaf_specs(m)})
    routes = []
    real = moe.route

    def keep(*args, **kw):
        out = real(*args, **kw)
        routes.append(out[1])
        return out

    with mock.patch.object(moe, "route", keep), torch.no_grad():
        tf.forward_hidden(cfg, params, tokens[:, :-1])
    return routes


def run(cell, seed: int, seconds: float, traced: bool, device, rec, sync,
        control: bool = False) -> Dict[str, float]:
    """As ``lm_job.run``: set up (the three checked steps are its
    warm-up), measure for ``seconds``, then, when ``traced``, time the
    tick apart on a few more steps and profile a stretch, then check."""
    from repro_torch import tracing

    tr = cell.traffic
    if tr["loop"] != "train_steps":
        raise ValueError(f"unknown loop {tr['loop']!r} for an LM cell")
    job = Job(cell, seed, device, rec.spans, sync)
    m = job.m
    picks = ref.gradient_sample(m, seed, device)
    losses = []
    adam_b1 = cell.config["adam"]["b1"]
    for i in range(CHECKED_STEPS):
        loss, fut, _ = job.step()
        losses.append(float(loss))
        if i == 0:
            g = {k: v / (1.0 - adam_b1)
                 for k, v in job.leaves("mu").items()}
            grad_norm = {k: lm_job._norm(v) for k, v in g.items()}
            grad_sample = {k: g[k][idx] for k, idx in picks.items()}
            del g
    flat = job.leaves("flat")
    change = {n: lm_job._norm(flat[n] - ref.draw(n, s, std, dt, seed, device)
                              .reshape(-1).float())
              for n, s, std, dt in ref.leaf_specs(m)}
    del flat
    for _ in range(tr["warmup_steps"]):
        job.step()
    sync()
    tokens_per_step = tr["rows"] * tr["seq"]
    rec.model_flops_per_token = model_flops_per_token(m, tr["seq"])
    # The collector stays on in the window, as in ``lm_job``.  The
    # set-up's leftovers are collected here, in set-up, so that a full
    # collection they would trigger (~0.13 s over the ~300 k objects the
    # imports hold) does not fall in the window.
    gc.collect()
    t0 = time.perf_counter()
    rec.setup_s = t0 - rec.t_start
    while True:
        _, fut, _ = job.step()
        te = time.perf_counter()
        rec.attempted += 1
        if fut.done():
            rec.tokens += tokens_per_step
        else:
            rec.failed += 1
        if te - t0 >= seconds:
            break
    rec.window_s = te - t0
    if traced:
        for _ in range(tr["tick_steps"]):
            rec.tick_s.append(job.step(split=True)[2])

        def body(_):
            with trace.mark("round"):
                job.step(marks=True)

        n = tr["profile_steps"]
        with tracing.counting() as counts:
            rec.profile, inside = spans.profile(body, n, sync, device)
        rec.profile_ticks = n
        rec.detail["fwd_ms"] = {
            part: sum(s for name, s in inside.items()
                      if name.startswith(prefixes)) / n * 1e3
            for part, prefixes in (("mla", ("mla.", "attn.")),
                                   ("moe", ("moe.",)))}
        rec.detail["moe_choices"] = {
            name.split(".")[1]: total / n
            for name, total in counts.read().items()}
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)
    count = (int(job.rt.counts[job.id]), job.steps)
    lr = cell.config["job"]["lr"]
    del job, loss, fut
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    batches = [lm_job.ref.batch_tokens(m, tr["rows"], tr["seq"], seed, i,
                                       device)
               for i in range(CHECKED_STEPS)]
    readings = {"count_gap": float(abs(count[0] - count[1]))}
    kw = dict(seed=seed, batches=batches, lr=lr, adam=cell.config["adam"],
              device=device, picks=picks)
    got_routes = program_routes(m, seed, batches[0], device)
    with lm_job._fp32_matmul():
        want_routes = []
        want = ref.train3(m, **kw, routes=want_routes)
        readings["info.route_flips"] = ref.route_flips(got_routes,
                                                       want_routes)
        del got_routes, want_routes
        lm_job._compare(readings, "", (losses, grad_norm, change,
                                       grad_sample), want, rec)
        if control:
            for prefix, extra in (("control.", {"quant": "fp8"}),
                                  ("fault_half.", {"fault": "half"}),
                                  ("fault_altered.", {"fault": "altered"})):
                lm_job._compare(readings, prefix,
                                ref.train3(m, **kw, **extra), want, rec)
    rec.detail["seconds"] = {"check": time.perf_counter() - t_check,
                             "steps": rec.attempted}
    rec.detail["losses"] = {"program": losses, "reference": want[0]}
    return readings
