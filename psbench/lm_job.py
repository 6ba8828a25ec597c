"""Cells of a language model training as a job of the shared service
(configuration kind ``lm_job``).

Set-up builds a ``ShardedServiceRuntime`` with its fleet-tick engine and
registers one job: the port's decoder (``repro_torch.models.transformer``)
at the configuration's widths, with weights drawn on the device from the
seed (one draw a leaf), its loss the port's ``loss_fn``.  Every step is
``engine.step(job, batch)`` (pull, unpack, forward and backward, pack,
enqueue), then ``engine.tick()`` (the push applied by K1).

The traffic's ``loop`` names the window's loop:

- ``train_steps``: step, tick, synchronize, over batches of
  ``rows`` x ``seq`` tokens of a seeded uniform corpus, a new batch each
  step.

The first three steps, in set-up, are the ones checked: their losses,
the first gradient as the service's Adam holds it (its first moment
over 1 - b1) and the parameters' change after the three, each leaf's
norm against the plain reference's.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from . import trace
from .reference import lm as ref

CHECKED_STEPS = 3


def lm_config(m: Dict):
    """The port's ``LMConfig`` for the configuration's model keys.  The
    port's decoder has no output-projection or MLP bias and a fixed RMS
    norm constant of 1e-6; a configuration that asks otherwise is
    refused rather than run as something else."""
    from repro_torch.models.transformer import LMConfig

    if m["attention_bias"] or m["mlp_bias"] or m["rms_norm_eps"] != 1e-6:
        raise ValueError("the port's decoder runs attention_bias false, "
                         "mlp_bias false and rms_norm_eps 1e-6 only")

    cfg = LMConfig(
        name="psbench", n_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], d_ff=m["intermediate_size"],
        vocab=m["vocab_size"], d_head=m["head_dim"],
        tie_embeddings=m["tie_word_embeddings"],
        norm="rmsnorm", rope_theta=m["rope_theta"],
        max_seq_len=m["max_position_embeddings"], dtype=m["torch_dtype"])
    if cfg.padded_vocab != cfg.vocab:
        raise ValueError("the vocabulary must be a multiple of 256: the "
                         "port pads its embedding otherwise")
    return cfg


def model_flops_per_token(m: Dict, seq: int) -> float:
    """Forward and backward FLOPs a token needs (3 x the forward's):
    every matrix product, 2 FLOPs per multiply-add, the tied head
    included, and causal attention's score and value products over the
    (on average) seq / 2 keys each query sees.  No recompute counted."""
    d, L = m["hidden_size"], m["num_hidden_layers"]
    hq, hk, dh = (m["num_attention_heads"], m["num_key_value_heads"],
                  m["head_dim"])
    per_layer = d * (hq + 2 * hk) * dh + hq * dh * d + 3 * d * m[
        "intermediate_size"]
    matmul = L * per_layer + d * m["vocab_size"]
    attention = L * 2 * hq * dh * seq / 2  # QK^T and PV, causal half
    return 3 * 2 * (matmul + attention)


class Job:
    def __init__(self, cell, seed, device, spans: trace.Spans, sync):
        from repro_torch.core import ParameterService
        from repro_torch.models import transformer as tf
        from repro_torch.ps.service_runtime import ShardedServiceRuntime
        from repro_torch.tree import tree_leaves_by_key, tree_with_leaves

        cfg, tr = cell.config, cell.traffic
        svc = cfg["service"]
        self.m, self.tr, self.seed, self.device = cfg["model"], tr, seed, device
        self.sync = sync
        self.id = cfg["job"]["id"]
        self.lm = lm_config(self.m)
        meta = tf.init_params(self.lm, device="meta")
        shapes = {k: (tuple(t.shape), t.dtype)
                  for k, t in tree_leaves_by_key(meta).items()}
        specs = ref.leaf_specs(self.m)
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
        with spans.span("register", sync):
            self.rt.add_job(
                self.id, params, lambda p, b: tf.loss_fn(lm, p, b),
                iteration_duration=svc["iteration_duration"],
                n_workers=svc["n_workers"],
                required_servers=svc["required_servers"],
                agg_throughput=svc["agg_throughput"],
                lr=cfg["job"]["lr"], b1=adam["b1"], b2=adam["b2"],
                eps=adam["eps"])
        del params
        self.steps = 0  # steps submitted

    def batch(self, index: int):
        toks = ref.batch_tokens(self.m, self.tr["rows"], self.tr["seq"],
                                self.seed, index, self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def step(self, marks: bool = False, split: bool = False):
        """One step and its tick, ended by a synchronize.  Returns (loss
        tensor, future, seconds of the tick span or None).  With
        ``split`` the step's work is synchronized before the tick, so the
        tick's span holds the tick alone."""
        b = self.batch(self.steps)
        with trace.mark("step", marks):
            out = self.eng.step(self.id, b)
        self.steps += 1
        tick_s = None
        if split:
            self.sync()
            t0 = time.perf_counter()
        with trace.mark("tick", marks):
            self.eng.tick()
        with trace.mark("sync", marks):
            self.sync()
        if split:
            tick_s = time.perf_counter() - t0
        return out["loss"], out["future"], tick_s

    def leaves(self, leaf: str) -> Dict[str, torch.Tensor]:
        """The job's ``leaf`` state (flat, mu, nu) in the arena, read
        through the job's layout, as one flat float32 tensor a parameter
        leaf (views of one gathered copy)."""
        splan = self.rt.splan
        offs = dict(zip(splan.shard_ids, splan.concat_view()[0]))
        layout = splan.job_layout(self.id)
        arena = self.rt.arena[leaf]
        pieces = []
        for sid, l in zip(layout.shard_ids, layout.layouts):
            rows = torch.from_numpy(l.blocks.astype(np.int64)).to(
                self.device) + offs[sid] // l.block
            pieces.append(arena.view(-1, l.block)[rows].reshape(-1))
        packed = torch.cat(pieces)
        return {key: packed[start:start + size]
                for key, start, size, _, _ in layout.slots}


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def run(cell, seed: int, seconds: float, traced: bool, device, rec, sync,
        control: bool = False) -> Dict[str, float]:
    """Set up (the three checked steps are its warm-up), measure for
    ``seconds``, then, when ``traced``, time the tick apart on a few
    more steps and profile a stretch, then check.  The window's steps
    are the same whether traced or not."""
    tr = cell.traffic
    if tr["loop"] != "train_steps":
        raise ValueError(f"unknown loop {tr['loop']!r} for an LM cell")
    job = Job(cell, seed, device, rec.spans, sync)
    picks = ref.gradient_sample(job.m, seed, device)
    losses = []
    adam_b1 = cell.config["adam"]["b1"]
    for i in range(CHECKED_STEPS):
        loss, fut, _ = job.step()
        losses.append(float(loss))
        if i == 0:
            # The first moment after one step is (1 - b1) g.
            g = {k: v / (1.0 - adam_b1)
                 for k, v in job.leaves("mu").items()}
            grad_norm = {k: _norm(v) for k, v in g.items()}
            grad_sample = {k: g[k][idx] for k, idx in picks.items()}
            del g
    flat = job.leaves("flat")
    change = {n: _norm(flat[n] - ref.draw(n, s, std, dt, seed, device)
                       .reshape(-1).float())
              for n, s, std, dt in ref.leaf_specs(job.m)}
    del flat
    for _ in range(tr["warmup_steps"]):
        job.step()
    sync()
    tokens_per_step = tr["rows"] * tr["seq"]
    rec.model_flops_per_token = model_flops_per_token(job.m, tr["seq"])
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
        rec.profile = trace.profile(body, tr["profile_steps"], sync, device)
        rec.profile_ticks = tr["profile_steps"]
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)
    count = (int(job.rt.counts[job.id]), job.steps)
    m, lr = job.m, cell.config["job"]["lr"]
    # A future holds the engine, and the engine the arena.
    del job, loss, fut
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    batches = [ref.batch_tokens(m, tr["rows"], tr["seq"], seed, i, device)
               for i in range(CHECKED_STEPS)]
    readings = {"count_gap": float(abs(count[0] - count[1]))}
    kw = dict(seed=seed, batches=batches, lr=lr, adam=cell.config["adam"],
              device=device, picks=picks)
    with _fp32_matmul():
        want = ref.train3(m, **kw)
        _compare(readings, "", (losses, grad_norm, change, grad_sample),
                 want, rec)
        if control:
            for prefix, extra in (("control.", {"quant": "fp8"}),
                                  ("fault_half.", {"fault": "half"}),
                                  ("fault_altered.", {"fault": "altered"})):
                _compare(readings, prefix, ref.train3(m, **kw, **extra),
                         want, rec)
    rec.detail["seconds"] = {"check": time.perf_counter() - t_check,
                             "steps": rec.attempted}
    rec.detail["losses"] = {"program": losses, "reference": want[0]}
    return readings


def _compare(readings, prefix, got, want, rec):
    """grad_gap and change_gap (the worst leaf's norm gap), grad_diff
    (the worst leaf's relative distance on the sampled elements of the
    first gradient), and the loss's worst relative gap, which is not
    compared (``info.loss_gap``, ``info.control.loss_gap`` ...: no
    control or fault separates it from sound runs).  Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change."""
    g_loss, g_grad, g_change, g_sample = got
    w_loss, w_grad, w_change, w_sample = want
    med = sorted(w_grad.values())[len(w_grad) // 2]
    still = {k for k, v in w_grad.items() if v < 1e-3 * med}
    readings[prefix + "grad_gap"], at_g = ref.norm_gaps(g_grad, w_grad)
    readings[prefix + "change_gap"], at_c = ref.norm_gaps(
        g_change, w_change, skip=still)
    diffs = {k: _norm(g_sample[k].to(w.device) - w) / _norm(w)
             for k, w in w_sample.items()}
    at_d = max(diffs, key=diffs.get)
    readings[prefix + "grad_diff"] = diffs[at_d]
    readings["info." + prefix + "loss_gap"] = max(
        abs(a - b) / abs(b) for a, b in zip(g_loss, w_loss))
    rec.detail[prefix + "worst_leaf"] = {"grad": at_g, "change": at_c,
                                         "diff": at_d,
                                         "left_out": sorted(still)}


class _fp32_matmul:
    """Float32 products in float32 (no TF32) for the reference."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
