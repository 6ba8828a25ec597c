#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

The main path is the write path of the shared aggregation service, at
the paper workloads' full tensor inventories:

  a. AlexNet, VGG19 and BERT-base resident in one ServiceRuntime; 8 ticks
     of seeded packed-gradient pushes through the ServiceTickEngine (one
     launch of the multi-job Adam kernel per tick);
  b. AWD-LM arrives: a delta replan moves the touched blocks through the
     relayout kernels; 8 ticks with four jobs;
  c. AWD-LM leaves: another delta replan; 8 ticks; before the last, the
     unfused ``multi_job_adam_update`` (the packed multi-job Adam kernel,
     K4) on a clone of the state with that tick's pushes, p full and p
     packed, its outputs scattered onto their rows and held against the
     state the fused tick leaves, bit for bit;
  s. the sharded service at the same inventories: AlexNet, VGG19 and
     BERT-base resident in a ShardedServiceRuntime (one shard space per
     Aggregator, every shard's flat/mu/nu a view into one fleet arena per
     leaf) under a ShardedTickEngine with ``fleet_tick="fused"``; 4 fleet
     ticks, each exactly one launch of the multi-job Adam kernel over the
     arena, the last held bit for bit against the per-shard appliers on a
     clone of the arena; AWD-LM arrives through a sharded replan (its
     surviving shards' deltas through the relayout kernels, the
     cross-shard arrivals one index write per leaf); an ElasticScaler
     over an idle, a hot and an idle window grows the fleet by one shard
     and merges it back; 2 fleet ticks after each transition.  Every
     transition is held against the gather oracle (each resident job's
     packed flat/mu/nu read through its layout before and after, bit for
     bit) and the runtime's moved bytes and touched jobs against
     ``sharded_transition_summary``.  The phase must stay within 65 GB at
     peak; its times are printed, never checked;
  r. on phase s's runtime, its read side and fault tolerance (the engine
     carries a seeded FaultInjector with no rule armed before this
     phase): r1, a ReplicaSet of 2 pull-only replicas over the shard
     lanes and 3 fused fleet ticks, the second of one job's push only,
     after which a versioned diff pull of every job, from the engine and
     from a replica, must ship exactly that job's blocks and, patched
     onto the bootstrap pull, equal a full pull bit for bit, and the
     replica's tree pulls must equal the engine's after a refresh; r2, a
     ``fail_apply`` on the lane hosting the most jobs in the second of 3
     rounds: the fused tick falls back (one fall-back, the lanes roll
     back and replay, no replan), and the drained arena must equal bit
     for bit a clone of it taken before r2 driven through the same
     pieces by the per-shard appliers, every lane still a view of the
     arena; r3, a ``kill_shard`` on a lane hosting some jobs but not
     all: it quarantines after its retry, an ElasticScaler holds, the
     other jobs tick on at one launch a fused tick, direct pulls of its
     jobs raise while a replica serves them degraded and
     deterministically, and ``recover_shard`` (from the lane's snapshot,
     its rolled-back and cancelled pushes counted as the dead lane's
     queue says) re-hosts it, held against the gather oracle and the
     summary (the relayout kernels wherever a surviving shard's delta
     moves blocks); then 2 fused ticks of every job and the read tier
     re-subscribed across the epoch.  The phase must stay within 45 GB at
     peak; times are printed, never checked;
  q. a fresh sharded fleet with compressed pushes, a lease and a
     checkpoint: AlexNet plain, VGG19 ``push_compression="int8"`` and
     BERT-base ``"bf16"`` on 2 shards (the fleet arena gains a fourth
     leaf, ``ef``), the engine with a lease interval on a manual clock;
     q1, 4 fused fleet ticks, each one launch of the multi-job Adam
     kernel after the error-feedback rounds of the compressed pieces (one
     ``ef_round`` kernel launch a piece), the last held bit for bit
     against the per-shard appliers on a clone of the arena (ef
     included); each job's push alone must cost at most half of fp32 on
     the wire (int8), half (bf16) or all of it (plain); each compressed
     job's round timed through the kernel and the eager passes beside its
     bound (16 B a lane), and both held bit for bit against the CPU's
     ``ef_transform`` on its first piece;
     AWD-LM arrives with int8 through a sharded replan (the relayout
     kernels moving four leaves), held against the gather oracle on
     flat/mu/nu/ef; a ``fail_apply`` inside a fused tick, the drained arena
     held against the per-shard replay on a clone, every lane's ef still a
     view of the arena; q2, AWD-LM goes silent with a push queued while
     the others push, and after its lease ``expire_leases()`` must reclaim
     it alone through a replan held against the gather oracle, its queued
     future raising ``LeaseExpiredError``; q3, ``save_checkpoint`` of the
     fleet under ``build/`` (the free space checked first; the directory
     always removed), 2 more ticks, ``restore_checkpoint`` into the live
     runtime: the arena must equal the clone taken at the save bit for
     bit, every lane a view, and the next fused tick the per-shard
     appliers' tick on that clone.  The phase must stay within 50 GB at
     peak, and phases s, r and q together leave at most 256 MiB
     allocated; the EF round's own time is printed, never checked;
  t. the chaos trace replay of ``repro_torch.sim.replay.run_replay`` at
     the paper inventories' full widths: ``ReplayConfig()``'s trace (14
     jobs, 12 windows, seed 0, at most 6 live), each admitted job
     carrying its model's whole tensor inventory (VGG19 j0 and j13,
     AlexNet j1 and j4, BERT-base j3, j5, j8, j11 and j12, AWD-LM j2, j6,
     j7, j9 and j10; up to ~363 M fleet lanes), through the sharded
     fleet under its chaos schedule: apply faults, a boundary and a
     mid-migration ``fail_migration``, a dropped push piece, a killed
     shard re-hosted by ``recover_shard`` and a dead trainer reclaimed
     by its lease; it must show no registry divergence, the reclaim
     within one lease interval, ``fail_migration`` twice and
     ``drop_push`` once with 2 aborts and 2 retries, one recovery and
     one lease expiration, every lane a view of the fleet arena after
     every window; then the no-fault replay against a flat
     ServiceRuntime twin (K1 ticks and sharded K2 against K3 block steps
     and flat K2) over the trace's first 6 windows (T_PARITY_WINDOWS),
     every live job bit for bit at every window.
     Per-window lines give
     the live jobs, shards, the scaler's action, launches, tick and
     replan seconds; the phase must stay within 50 GB at peak and leave
     at most 256 MiB allocated;
  d. two small real models (the MLP jobs of examples/multi_job_service.py)
     train through ``engine.step`` and through ``ServiceRuntime.step``
     with the block kernel; a compressed (int8) MLP job in two twin
     runtimes, through ``engine.step`` and ``ServiceRuntime.step`` on the
     same batches, must end bit for bit equal (flat/mu/nu/ef);

and, after the service's state is freed, training of Qwen1.5-0.5B at its
published config (24 layers, d_model 1024, vocab 151,936, bf16; batch 8
x seq 512 from a repeating synthetic corpus; seeded random weights):

  e. 10 steps of ``make_train_step`` with ``adam(3e-4, fused=True)``: one
     launch of the dense Adam kernel per parameter leaf per step;
  f. 5 steps of the single-job parameter-server step
     (``build_flat_plan`` over 2 shards, ``make_ps_train_step`` with
     ``job_id=None`` and ``fused_kernel=True``): one launch per step over
     the whole float32 flat space;

and serving of the same model (seeded random bf16 weights):

  g. the weights hosted as job "lm" of a ServiceRuntime and read back
     through a ReplicaSet of 2 pull-only replicas
     (``launch/serve.py:_pull_params_via_replicas``: served weights bit
     for bit the hosted ones); a second, small job "side" (lr 1e-3)
     joins through a replan; versioned pulls of both jobs, then two
     ticks (one launch of the multi-job Adam kernel each), the first
     applying a seeded push of "lm" only (lr 0: its weights stay put,
     its block versions move), the second of "side" only; after each, a
     versioned diff pull of each job must ship exactly the pushed job's
     blocks and, patched with ``PullDiff.apply`` onto the client's
     vector, equal a full pull bit for bit; then KV-cache decode through
     ``make_serve_step`` at batch 16: a 128-token prompt by repeated
     decode and 128 greedy tokens, timed as one window; the last prompt
     step's logits held against ``make_prefill`` of the prompt (the
     flash attention kernel, one launch per layer);
  h. ``make_prefill`` at the prefill_32k cell's sequence length (32 768,
     ``attn_chunk_k`` 1024, bf16; batch cut from 32 to 1): 3 timed
     prefills, 24 launches of the flash attention kernel each; the
     last-token logits held against the same prefill through the plain
     ``chunked_attention``;

and the recsys family at its published widths (seeded random weights):

  i. DLRM-RM2 (26 tables, 54,072,832 padded rows x 64 float32, 13.84 GB)
     through ``launch/train.build`` at the train_batch cell's 65,536:
     10 steps of ``adagrad(0.01)``, one launch of the table-batched
     embedding-bag kernel (K6) a step over all 26 fields; the first
     step's loss, gradients
     and updated leaves held against the same step through K6's plain
     version, and two identical backward passes against each other, bit
     for bit;
  j. DLRM-RM2 scoring under ``torch.inference_mode()``: ``dlrm_forward``
     at serve_p99 (512) and serve_bulk (262,144), ``dlrm_retrieval`` of
     one user against retrieval_cand's 1,000,000 candidates; one K6
     launch a forward;
  k. SASRec and DIEN at the train_batch cell's 65,536 through
     ``launch/train.build``: 3 steps of adam(1e-3) each (plain PyTorch;
     no TPU kernel in either package), after two identical backward
     passes of the first batch held against each other bit for bit;

and the rest of the LM family (seeded random bf16 weights; each model
freed before the next):

  m. granite-moe-1b-a400m whole (24 layers, d_model 1024, 32 experts
     top-8 of width 512, vocab 49,155; 1.33 B parameters): 5 steps of
     ``make_train_step`` with ``adam(3e-4, fused=True)`` at 8 x 512, one
     K5 launch per leaf per step, the first step held bit for bit against
     the same step through K5's plain version; ``launch/serve.main`` on
     its normal path (the weights hosted and read through 2 read-tier
     replicas, served bit for bit the hosted ones; decode at batch 16, a
     128-token prompt, 128 tokens); ``make_prefill`` at the prefill_32k
     cell's overrides (32 768 tokens, ``moe_groups`` 256,
     ``attn_chunk_k`` 1024; batch cut from 32 to 1), K7 at head dim 64,
     24 launches a prefill, held against the plain chunked prefill;
     then, in float32 with a capacity factor of E / k (no token dropped),
     64 decode steps of a (4, 64) prompt against its prefill, the routing
     decisions that differ counted;
  n. granite-8b whole (36 layers, d_model 4096, 32/8 heads at head dim
     128; 16.1 GB) and command-r-plus-104b at its published widths with
     its depth cut from 64 to 6 layers (d_model 12,288, 96/8 heads, d_ff
     33,792, vocab 256,000 tied, the parallel block, LayerNorm; 25 GB):
     each through ``launch/serve.main --direct`` (decode at batch 16,
     its last prompt step held against the K7 prefill of the same
     prompt on the same weights, as in phase g), then a prefill through K7 at head dim 128 (granite-8b at 32 768
     tokens, command-r at its 8 192-token ``max_seq_len``), held against
     the plain chunked prefill; K7 at granite-8b's layer shape (1,
     32 768, 32, 128) with 8 kv heads against its plain version and
     timed beside ``scaled_dot_product_attention``;
  p. deepseek-v2-236b at its published widths with its depth cut from
     60 to 2 layers (the dense layer 0, then one MLA + MoE layer of 160
     experts top-6 and 2 shared; 10.7 GB): ``launch/serve.main --direct``
     with MLA's absorbed decode (batch 16, a 128-token prompt, 32
     tokens), a 4 096-token prefill through the plain chunked attention
     (MLA has no K7 route), and the absorbed decode against the
     un-absorbed prefill in float32 with no drops, as in phase m;

and the GNN family at gin-tu's four graph shapes (synthetic graphs from
``random_graph`` and ``molecule_batch``, seed 0, at the datasets'
published sizes; seeded random weights), then the port's examples:

  u. full_graph_sm (Cora's 2,708 nodes, 10,556 edges, 1,433 features)
     through ``launch/train.main --arch gin-tu``, 30 steps of adam(1e-3);
     ogb_products (2,449,029 nodes, 61,859,140 power-law edges, 100
     features) full-graph steps of ``make_train_step`` with ``adam(1e-3,
     fused=True)``, K5 a leaf a step: two identical forward+backward
     passes bit for bit (the segment sum is deterministic), the first
     step held bit for bit against K5's plain version, 5 timed steps,
     the aggregation timed apart (also with no chunks: the hot
     segment), within 40 GB at peak; minibatch_lg (Reddit's 232,965
     nodes, 114,615,892 edges, 602 features) through
     ``NeighborSampler(fanouts=(15, 10))`` at batch 1,024, a fresh block
     a step, host seconds of the graph, the CSR, each block, the batch
     and its copy printed; molecule, 128 graphs of 30 nodes and 64 edges,
     the graph task; every loss finite and falling;
  v. ``examples/torch_multi_job_service.py`` at its defaults (K1 every
     tick, K2 on the replans; losses falling across the arrival and the
     exit, the exit migrating bytes), ``examples/torch_train_lm_e2e.py``
     (the ~100 M LM, ``--fused-adam``) for 101 steps and then to 160 on
     one fresh checkpoint directory under ``build/``, the second call
     resuming from step 100, and ``examples/torch_serve_decode.py``
     (granite-8b's smoke config through two read-tier replicas);

and last the mesh layer (``repro_torch.launch``'s meshes, cells and
dry-run; ``ps.sharding`` and ``ps.act_sharding``) on a one-rank host
mesh, an NCCL group on the card:

  w. w1, DLRM-RM2's 26 tables (13.84 GB, seeded anew) at batch 65,536
     through the row-sharded lookup's mesh branch (K6 over the rank's
     row shards, the reduce-scatter, the constraint to the data axes),
     held bit for bit against the one-device lookup, both timed; w2,
     granite-moe-1b-a400m's MoE layer at its published widths (d_model
     1,024, 32 experts top-8, d_ff 512) in float32 on 8 x 512 tokens
     through ``moe_ffn_sharded``, held against the same function on a
     one-rank gloo mesh on the CPU in a child process on the same
     weights: the dropped (token, choice) sets equal, no routing flip,
     the output within W_MOE_RMS relative RMS; w3, qwen1.5-0.5b's
     train_4k cell from ``build_cell`` with its batch cut from 256 to 8:
     one step with DTensor params (``LoweredCell.lower`` under
     ``op_cost.OpCost``) against the same step on plain tensors, the
     loss and every updated leaf bit for bit, op_cost's flops printed
     beside the model flops; w5, one forward and backward of gin-tu's
     ogb_products step (61.9 M edges, published widths) through GIN's
     mesh branch (``index_add`` in a per-device region), its arguments
     placed by ``build_cell``, held against the one-device plan's pass
     (loss within W_GNN_LOSS_RTOL, each gradient leaf within
     W_GNN_GRAD_TOL of its largest magnitude), both timed, on phase u's
     host graph; w4, ``python -m
     repro_torch.launch.dryrun`` on the production meshes (fake process
     groups, meta tensors): qwen1.5-0.5b train_4k, dlrm-rm2
     train_batch, gin-tu ogb_products and sasrec train_batch on the
     16 x 16 mesh, dien train_batch on the 2 x 16 x 16 one
     (``--multi-pod``), five child processes started before w1 and run
     beside w1-w3 and w5: each cell's dominant roofline term and
     fraction, analytic under the H100 SXM's published rates, and wall
     seconds; a cell refused (``ok: false``) fails the phase.

Every kernel is built from the sources in the checkout, run at the main
path's shapes and held against its plain PyTorch version; every replan
against the full-gather oracle (phases s and r: the gather oracle above); the
last tick of each of phases a-c against the plain multi-job update; one
block step of phase d against the plain masked step; one fused step of
phase e against the unfused optimizer's step; the first step of phase f
against the same step with the plain ``_adam_math``; the decode's and
the K7 prefill's logits against their references within the bf16 logit
tolerance below, and phases m and p's float32 decodes against their
prefills within F32_LOGIT_REL_RMS and F32_LOGIT_MAX_FRAC.  The flash
attention kernel is also held against its plain version at the
prefill's layer shapes (D 64 and 128; bf16: every element within
rtol 1e-2 plus a small atol, and every query row of every head within
1e-2 relative L2 error; see K7_BF16_RTOL) and on small float32
(rtol/atol 2e-5) and bf16 cases (non-causal, ragged S, causal S_q < S_k,
GQA, head dim 128 ragged, strided views of one fused qkv tensor, an
unaligned view); a bf16 call at head dim 32 must raise; the built
library's SASS must hold wgmma (HGMMA) and TMA loads (UTMALDG) and no
mma.sync (HMMA).  K6 is held against its plain version bit for bit at
phase i's whole lookup (26 tables, the batch's ids; also against the 26
single-table calls), on small table-batched cases (strided ids,
bfloat16, 8-byte pieces, an unaligned view, 130 tables, L = 0, an
``out`` view), and as a single table at phase i's field, multi-hot (L =
20), D = 18 and 50 (8-byte pieces), bfloat16 and unaligned-view (one
element a lane) shapes; each timed back to back and on the device with a
cold L2, beside ``F.embedding_bag``.  Launch counters are set to 0 before
each phase and read after it.  Any failed check raises.

Output: per-phase lines, one JSON line of kernels (time, bound, plain
and library times, launches on the main path), the card's name and power
limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Run from the repository root: ``python3 chip_smoke.py``.  Without CUDA,
or outside a checkout of the repository, it exits non-zero and prints no
result.  ``--scale 0.001`` rehearses the phases on the card on smaller
tensors (phases e-h, i-k and m-p on the smoke configs, u's node-task
graphs cut by ``GNN_CUT``, v's examples at small settings), prints no
result and exits 2.  ``scripts/torch_lm_rehearsal.py`` rehearses phases
m, n and p on the CPU through ``lm_family_phases``, as ``main`` runs them;
``scripts/torch_gnn_rehearsal.py`` phases u and v through ``gnn_phase``
and ``examples_phase``; ``scripts/torch_mesh_rehearsal.py`` phase w
(but w4; w5 on the cut graph) through ``mesh_phase``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
ADAM_FLOPS_PER_LANE = 14  # mu 3, nu 4, bias corrections 2, update 5
ULP_BUDGET = 1  # plain vs kernel: same operation order, correctly rounded
QWEN_BATCH, QWEN_SEQ, QWEN_LR = 8, 512, 3e-4
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 16, 128, 128
PREFILL_SEQ = 32768  # the prefill_32k cell (repro/arch.py), batch cut to 1
CMDR_LAYERS = 6  # command-r-plus-104b's depth cut (64 layers: 208 GB bf16)
DS_LAYERS = 2  # deepseek-v2-236b's: the dense layer and one MLA + MoE layer
DLRM_STEPS = 10
# K7 against its plain version.  float32 (the SIMT kernel): rtol = atol =
# 2e-5, the reference kernel tests' own.  bfloat16 (the Hopper kernel,
# flash_fwd_wgmma): each output element within rtol 1e-2 (above one bf16
# ulp, 2^-7 relative at most) plus K7_BF16_ATOL, and the relative L2
# error of every (query row, head) over D at most K7_ROW_REL.  At the
# prefill shape (S = 32 768, N(0, 1) inputs) a late row's output is about
# 0.01 in size, so an atol of 2e-2 hid whole faults there; a key tile of
# 64 dropped from the last rows moves them by about sqrt(64 / 32768) =
# 4 %.  Set from scripts/torch_k7_fault_check.py at that shape (NVIDIA
# H100 80GB HBM3, 700 W) on the earlier mma.sync kernel: the sound kernel
# needed atol 1.52e-3 and had a largest row error of 5.30e-3; planted
# faults in the last query tile (a dropped or a stale key tile of 64, a
# normaliser 2 % high) showed row errors of 0.147, 0.154 and 0.0213.  The
# Hopper kernel reads the same sound values, and its faults (tiles of
# 128) 0.206, 0.250 and 0.0216.
K7_F32_TOL = 2e-5
K7_BF16_RTOL, K7_BF16_ATOL, K7_ROW_REL = 1e-2, 2.5e-3, 1e-2
# Two bf16 forwards of the same model that round in different places
# (decode vs prefill; K7 vs chunked attention) differ by about one bf16
# unit roundoff (2^-8) of the residual stream per layer, adding up like a
# random walk: sqrt(24) * 2^-8 = 0.019 relative RMS in the logits.  The
# checks allow 2.5x that, and a largest single difference of a tenth of
# the largest logit.
LOGIT_REL_RMS, LOGIT_MAX_FRAC = 0.05, 0.1


def _import_port():
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        raise SystemExit(f"chip_smoke: run from a checkout of the repository "
                         f"(repro_torch not importable: {exc})")


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest float32 ulp distance (on the tensors' device)."""
    a = a.contiguous().view(torch.int32).long()
    b = b.contiguous().view(torch.int32).long()
    a = torch.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = torch.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int((a - b).abs().max()) if a.numel() else 0


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (float32 or bfloat16)."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def sync(device):
    torch.cuda.synchronize(device)


def time_ms(fn, device, reps=10, warmup=3, inner=5) -> float:
    """Per-call time: the median over ``reps`` CUDA-event windows of
    ``inner`` back-to-back calls.  Back to back, the host's work for the
    next call overlaps the device's work for this one, so a wrapper's
    host time counts only where it exceeds its kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
FLUSH_KERNEL = "FillFunctor<unsigned char>"


def device_ms(fns, device, calls=8, cold=True, tries=4):
    """Device time of one call: ``calls`` calls that take ``fns`` in turn
    (one per id set), traced with ``torch.profiler``, each after a uint8
    fill (256 MB with ``cold``, evicting the L2; else 16 bytes) that marks
    where its kernels start; the durations of each call's kernels summed,
    the median over the calls (a call whose kernels the trace lost does
    not count).  A trace that holds fewer than half the calls (on the
    card the profiler now and then records no kernel at all) is taken
    again, up to ``tries`` times.  Returns (ms, {kernel name: ms}) of the
    median call."""
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.empty(FLUSH_BYTES if cold else 16, dtype=torch.uint8,
                          device=device)
    fns[0]()
    for attempt in range(tries):
        sync(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                scratch.fill_(i & 0x7F)
                fns[i % len(fns)]()
            sync(device)
        kernels = sorted(
            (e.time_range.start, e.name, e.time_range.elapsed_us())
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        per_call = []
        for _, name, us in kernels:
            if FLUSH_KERNEL in name:
                per_call.append({})
            elif per_call:
                per_call[-1][name] = per_call[-1].get(name, 0.0) + us / 1e3
        per_call = sorted((sum(c.values()), c) for c in per_call if c)
        if len(per_call) >= calls // 2:
            return per_call[len(per_call) // 2]
        print(f"device_ms: trace {attempt + 1} holds the kernels of "
              f"{len(per_call)} of {calls} calls; tracing again",
              file=sys.stderr, flush=True)
    raise AssertionError(f"device_ms: {tries} traces held the kernels of "
                         f"fewer than {calls // 2} of {calls} calls")


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_allocs(device) -> int:
    """``cudaMalloc`` calls the caching allocator has made so far."""
    return torch.cuda.memory_stats(device).get("num_device_alloc", 0)


def host_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def state_clone(state):
    return {k: state[k].clone() for k in ("flat", "mu", "nu")}


def check_equal(what, got, want):
    for k in ("flat", "mu", "nu"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} differs from the oracle "
                                 f"(max abs {max_abs(got[k], want[k])})")


# --------------------------------------------------------------- workloads
def chunked_inventory(model: str, scale: float):
    """The paper workload's tensors split at DEFAULT_CHUNK_BYTES as
    ``make_job`` splits them: [(leaf key, elements)]."""
    from repro_torch.configs import paper_workloads as pw

    out = []
    for name, params in pw.MODEL_TENSORS[model]:
        nbytes = params * pw.BYTES_PER_PARAM
        n = max(1, -(-nbytes // pw.DEFAULT_CHUNK_BYTES))
        per = nbytes // n
        for c in range(n):
            b = per if c < n - 1 else nbytes - per * (n - 1)
            key = f"{name}[{c}]" if n > 1 else name
            out.append((key, max(1, int(b // 4 * scale))))
    return out


def _no_model_loss(params, batch):
    raise NotImplementedError("the paper workloads carry tensor inventories "
                              "only; their pushes are seeded gradients")


class Service:
    """The full-size shared service and what the phases need of it; with
    ``sharded`` a ShardedServiceRuntime under a fused-fleet-tick engine
    (phase s), whose job sizes keep their full-size execution times at a
    rehearsal's scale, so the control plane places them as at full size."""

    LR = {"alexnet": 1e-3, "vgg19": 5e-4, "bert": 1e-4, "awd-lm": 3e-3}

    def __init__(self, device, scale, sharded=False, **engine):
        from repro_torch.core import ParameterService
        from repro_torch.ps.service_runtime import (
            ServiceRuntime,
            ShardedServiceRuntime,
        )

        self.device, self.scale, self.sharded = device, scale, sharded
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(0)
        self.svc = ParameterService(total_budget=16, n_clusters=1,
                                    plan_pad_to=128)
        if sharded:
            from repro_torch.ps.faults import FaultInjector

            # Phase r arms its faults on this injector; none is armed
            # before it, so phase s runs as it would without one.
            self.inj = FaultInjector(seed=0)
            self.rt = ShardedServiceRuntime(self.svc, device=device)
            self.eng = self.rt.attach_engine(max_staleness=1,
                                             fleet_tick="fused",
                                             fault_injector=self.inj,
                                             **engine)
        else:
            self.rt = ServiceRuntime(self.svc, device=device)
            self.eng = self.rt.attach_engine(max_staleness=1)
        self._masks, self._mask_key = {}, {}

    @property
    def plan(self):
        return self.rt.splan if self.sharded else self.rt.plan

    def params(self, model):
        return {k: torch.randn(n, generator=self.gen, device=self.device)
                * 0.02 for k, n in chunked_inventory(model, self.scale)}

    def add(self, model, compression=None):
        extra = {"agg_throughput": 7e9 * self.scale} if self.sharded else {}
        if compression:
            extra["push_compression"] = compression
        self.rt.add_job(model, self.params(model), _no_model_loss,
                        required_servers=2, lr=self.LR[model], **extra)

    def payload_mask(self, job):
        """The job's packed payload lanes (zero gradient on padding keeps
        every non-payload lane of the state zero, as packing does)."""
        layout = self.plan.job_layout(job)
        key = (id(self.plan), job)
        if self._mask_key.get(job) != key:
            mask = torch.zeros(layout.packed_len, dtype=torch.bool)
            for _, start, size, _, _ in layout.slots:
                mask[start:start + size] = True
            self._masks[job] = mask.to(self.device)
            self._mask_key[job] = key
        return self._masks[job]

    def grad(self, job):
        """A seeded packed gradient for ``job`` (zero on padding)."""
        mask = self.payload_mask(job)
        return torch.randn(mask.numel(), generator=self.gen,
                           device=self.device) * 1e-3 * mask

    def push_all(self, jobs=None):
        """One seeded packed gradient per resident job (or per job of
        ``jobs``); returns them."""
        gs = {j: self.grad(j) for j in (jobs or self.rt.job_ids)}
        for j, g in gs.items():
            self.eng.submit_packed(j, g)
        return gs

    def tick_tables(self, jobs, counts):
        """K1's hp table, block table and job-slot map for one tick over
        ``jobs`` at 1-based step ``counts``, as the engine builds them."""
        from repro_torch.kernels.agg_adam import ops as agg_ops
        from repro_torch.ps.engine import _flat_job_hp, _fused_tables

        plan = self.rt.plan
        block_idx, sizes, (lr, b1, b2, eps) = _fused_tables(
            [plan.job_layout(j) for j in jobs],
            [self.rt._jobs[j] for j in jobs], _flat_job_hp)
        hp = agg_ops.multi_job_hp(counts, lr=lr, b1=b1, b2=b2, eps=eps)
        slot = np.repeat(np.arange(len(jobs), dtype=np.int32), sizes)
        return (hp.to(self.device), torch.from_numpy(block_idx).to(self.device),
                torch.from_numpy(slot).to(self.device))


def reset_counters(wrappers):
    for w in wrappers.values():
        w.launches = 0


def read_counters(wrappers):
    return {name: w.launches for name, w in wrappers.items()}


def run_ticks(s: Service, n: int, check_tick: bool, k4: bool = False):
    """``n`` ticks, each timed on the host clock to a synchronize; with
    ``check_tick`` the last one is also held against the plain update.
    With ``k4``, before the last tick the unfused ``multi_job_adam_update``
    (K4) runs on a clone of the state with the tick's pushes, p full and p
    packed, each held against K4's plain version bit for bit; after the
    tick its outputs, scattered onto their rows, must equal the state the
    fused K1 tick left, bit for bit.  Returns (tick times, K4's largest
    difference from its plain version or None)."""
    from repro_torch.kernels.agg_adam import ops as agg_ops
    from repro_torch.kernels.agg_adam import ref as agg_ref

    times, k4_err = [], None
    for i in range(n):
        gs = s.push_all()
        before = k4_out = None
        if check_tick and i == n - 1:
            jobs = s.rt.job_ids
            before = state_clone(s.rt.state)
            tables = s.tick_tables(
                jobs, [s.rt.state["counts"][j] + 1 for j in jobs])
            if k4:
                k4_out, k4_err = k4_tick_check(s, before, gs, jobs, tables)
        sync(s.device)
        t0 = time.perf_counter()
        if s.eng.tick() != len(gs):
            raise AssertionError("a tick did not apply every pending job")
        sync(s.device)
        times.append((time.perf_counter() - t0) * 1e3)
        if before is not None:
            agg_ref.aggregate_adam_multijob_fused_plain(
                before["flat"], torch.cat([gs[j] for j in jobs]),
                before["mu"], before["nu"], *tables,
                block=s.rt.plan.block_align)
            for k in ("flat", "mu", "nu"):
                u = ulp_diff(s.rt.state[k], before[k])
                if u > ULP_BUDGET:
                    raise AssertionError(f"tick vs plain update: {k} {u} ulp")
            if k4_out is not None:
                # ``before`` differs from the state only on owned rows,
                # which the scatter overwrites.
                for k, packed in zip(("flat", "mu", "nu"), k4_out):
                    got = agg_ops.scatter_rows(before[k], packed, tables[1],
                                               s.rt.plan.block_align)
                    if not bits_equal(got, s.rt.state[k]):
                        raise AssertionError(
                            f"K4 + scatter_rows vs the K1 tick: {k} differs "
                            f"(max abs {max_abs(got, s.rt.state[k])})")
            del before, k4_out
    return times, k4_err


def k4_tick_check(s: Service, before, gs, jobs, tables):
    """K4 through its entry point, ``multi_job_adam_update``, on a clone of
    the state before a tick, with the tick's pushes: p full and p packed,
    each equal to K4's plain version bit for bit.  Returns (the full-p
    run's packed outputs, the largest difference from the plain version)."""
    from repro_torch.kernels.agg_adam import ops as agg_ops
    from repro_torch.kernels.agg_adam import ref as agg_ref
    from repro_torch.ps.engine import _flat_job_hp, _fused_tables

    plan = s.rt.plan
    block = plan.block_align
    block_idx, sizes, (lr, b1, b2, eps) = _fused_tables(
        [plan.job_layout(j) for j in jobs], [s.rt._jobs[j] for j in jobs],
        _flat_job_hp)
    counts = [s.rt.state["counts"][j] + 1 for j in jobs]
    hp, bi, slot = tables
    g_cat = torch.cat([gs[j] for j in jobs])
    packed_p = before["flat"].view(-1, block)[bi.long()].reshape(-1)
    err, out = 0.0, None
    for p_packed, p in ((False, before["flat"]), (True, packed_p)):
        kern = agg_ops.multi_job_adam_update(
            p, [gs[j] for j in jobs], before["mu"], before["nu"], counts,
            block_idx=block_idx, job_sizes=sizes, block=block,
            p_packed=p_packed, lr=lr, b1=b1, b2=b2, eps=eps)
        plain = agg_ref.aggregate_adam_multijob_plain(
            p, g_cat, before["mu"], before["nu"], hp, bi, slot, block=block,
            p_packed=p_packed)
        err = max(err, max(max_abs(a, b) for a, b in zip(kern, plain)))
        if not all(bits_equal(a, b) for a, b in zip(kern, plain)):
            raise AssertionError(f"K4 (p_packed={p_packed}) differs from its "
                                 f"plain version: max abs {err}")
        del plain
        if not p_packed:
            out = kern
        del kern
    del packed_p, g_cat
    return out, err


def replan(s: Service, what: str, fn):
    """Drain, keep the state, run the replan ``fn``, and hold the migrated
    state against the full-gather oracle on the kept input."""
    from repro_torch.kernels.relayout import ops as rl_ops
    from repro_torch.ps import elastic

    s.eng.drain()
    old = s.rt.plan
    before = {**state_clone(s.rt.state), "counts": dict(s.rt.state["counts"])}
    sync(s.device)
    t0 = time.perf_counter()
    fn()
    sync(s.device)
    replan_ms = (time.perf_counter() - t0) * 1e3
    new = s.rt.plan
    # The replan's host parts, timed again one by one on the same input.
    elastic.clear_plan_cache()
    t0 = time.perf_counter()
    delta = elastic.compile_migration_delta(old, new)
    t1 = time.perf_counter()
    fresh = dataclasses.replace(new)  # same plan, empty layout caches
    for j in fresh.job_ids:
        fresh.job_layout(j)
    t2 = time.perf_counter()
    rl_ops.stage_tables(delta, s.device)
    sync(s.device)
    t3 = time.perf_counter()
    del fresh
    timings = (f" replan_ms={replan_ms:.1f} delta_compile_s={t1 - t0:.3f} "
               f"job_layouts_s={t2 - t1:.3f} stage_tables_upload_s="
               f"{t3 - t2:.3f}")
    oracle = elastic.migrate_flat_state(before, old, new)
    got = state_clone(s.rt.state)
    for j in set(new.job_ids) - set(old.job_ids):  # arrival: seeded lanes
        rows = torch.from_numpy(new.job_layout(j).blocks.astype(np.int64)
                                ).to(s.device)
        for k in ("flat", "mu", "nu"):
            got[k].view(-1, new.block_align)[rows] = 0.0
    check_equal(f"{what} replan", got, oracle)
    del oracle, got
    return before, old, new, delta, timings


def phase_line(name, times, stats0, stats1, counts, extra=""):
    return (f"phase {name}: ticks={len(times)} tick_ms_median="
            f"{statistics.median(times):.3f} tick_ms_mean="
            f"{statistics.mean(times):.3f} n_launches="
            f"{stats1.n_launches - stats0.n_launches} counters={counts}"
            f"{extra} max_memory_allocated_gb="
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f}"
            f" host_maxrss_gb={host_rss_gb():.2f}")


# ----------------------------------------------------- kernels vs plain
def k1_entry(s: Service, device):
    """K1 at the 4-job tick's shapes, on clones of the live state."""
    from repro_torch.kernels.agg_adam import ops as agg_ops
    from repro_torch.kernels.agg_adam import ref as agg_ref

    jobs = s.rt.job_ids
    plan = s.rt.plan
    hp, bi, slot = s.tick_tables(
        jobs, [s.rt.state["counts"][j] + 1 for j in jobs])
    block = plan.block_align
    m = int(bi.numel()) * block
    g = torch.cat([s.grad(j) for j in jobs])
    kern = state_clone(s.rt.state)
    plain = state_clone(s.rt.state)
    agg_ops.aggregate_adam_multijob_fused(kern["flat"], g, kern["mu"],
                                          kern["nu"], hp, bi, slot,
                                          block=block)
    agg_ref.aggregate_adam_multijob_fused_plain(
        plain["flat"], g, plain["mu"], plain["nu"], hp, bi, slot, block=block)
    ulp = max(ulp_diff(kern[k], plain[k]) for k in kern)
    err = max(max_abs(kern[k], plain[k]) for k in kern)
    if ulp > ULP_BUDGET:
        raise AssertionError(f"K1 differs from its plain version: {ulp} ulp")
    ms = time_ms(lambda: agg_ops.aggregate_adam_multijob_fused(
        kern["flat"], g, kern["mu"], kern["nu"], hp, bi, slot, block=block),
        device)
    plain_ms = time_ms(lambda: agg_ref.aggregate_adam_multijob_fused_plain(
        plain["flat"], g, plain["mu"], plain["nu"], hp, bi, slot,
        block=block), device)
    del kern, plain
    nbytes = m * (12 + 4 + 12) + 8 * bi.numel() + hp.numel() * 4
    b, by = bound_ms(nbytes, m * ADAM_FLOPS_PER_LANE)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=None, max_abs_err=err, max_ulp=ulp,
                shape=f"N={plan.total_len} M={m} K={len(jobs)}")


def k4_entry(s: Service, device, err):
    """K4 at the 3-job tick's shapes (p full), on the live state (K4 only
    reads it), timed beside its plain version; ``err`` is the phase-c
    check's largest difference from the plain version."""
    from repro_torch.kernels.agg_adam import ops as agg_ops
    from repro_torch.kernels.agg_adam import ref as agg_ref

    jobs = s.rt.job_ids
    plan = s.rt.plan
    hp, bi, slot = s.tick_tables(
        jobs, [s.rt.state["counts"][j] + 1 for j in jobs])
    block = plan.block_align
    m = int(bi.numel()) * block
    g = torch.cat([s.grad(j) for j in jobs])
    st = s.rt.state
    args = (st["flat"], g, st["mu"], st["nu"], hp, bi, slot)
    ms = time_ms(lambda: agg_ops.aggregate_adam_multijob(
        *args, block=block, p_packed=False), device)
    plain_ms = time_ms(lambda: agg_ref.aggregate_adam_multijob_plain(
        *args, block=block, p_packed=False), device, reps=3, warmup=1)
    nbytes = m * (12 + 4 + 12) + 8 * bi.numel() + hp.numel() * 4
    b, by = bound_ms(nbytes, m * ADAM_FLOPS_PER_LANE)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=None, max_abs_err=err, max_ulp=0,
                shape=f"N={plan.total_len} M={m} K={len(jobs)} p full")


def k3_entry(s: Service, device, job="vgg19"):
    """K3 for one job's block step (packed p), at that job's shapes."""
    from repro_torch.kernels.agg_adam import ops as agg_ops
    from repro_torch.kernels.agg_adam import ref as agg_ref

    layout = s.rt.plan.job_layout(job)
    bi = torch.from_numpy(layout.blocks).to(device)
    hp = agg_ops.multi_job_hp([s.rt.state["counts"][job] + 1],
                              lr=s.LR[job]).to(device)
    rows = bi.long()
    st = s.rt.state
    p = st["flat"].view(-1, layout.block)[rows].reshape(-1)
    g = s.grad(job)
    args = (p, g, st["mu"], st["nu"], hp, bi)
    kern = agg_ops.aggregate_adam_blocks(*args, block=layout.block,
                                         p_packed=True)
    plain = agg_ref.aggregate_adam_blocks_plain(*args, block=layout.block,
                                                p_packed=True)
    ulp = max(ulp_diff(a, b) for a, b in zip(kern, plain))
    err = max(max_abs(a, b) for a, b in zip(kern, plain))
    if ulp > ULP_BUDGET:
        raise AssertionError(f"K3 differs from its plain version: {ulp} ulp")
    del kern, plain
    ms = time_ms(lambda: agg_ops.aggregate_adam_blocks(
        *args, block=layout.block, p_packed=True), device)
    plain_ms = time_ms(lambda: agg_ref.aggregate_adam_blocks_plain(
        *args, block=layout.block, p_packed=True), device)
    m = p.numel()
    b, by = bound_ms(m * (16 + 12) + 4 * bi.numel(), m * ADAM_FLOPS_PER_LANE)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=None, max_abs_err=err, max_ulp=ulp,
                shape=f"N={st['mu'].numel()} M={m} job={job}")


def k2_entries(before, delta, device):
    """K2 (staging + scatter) on the arrival delta, all three leaves.
    Also returns the two halves together against K2's own bound: every
    moved lane read once and every moved or vacated lane written once,
    per leaf."""
    from repro_torch.kernels.relayout import ops as rl_ops
    from repro_torch.kernels.relayout import ref as rl_ref

    leaves = [before[k] for k in ("flat", "mu", "nu")]
    src, dst = rl_ops.stage_tables(delta, device)
    staged = rl_ops.relayout_stage(leaves, src)
    staged_plain = rl_ref.stage_plain(leaves, src)
    err_stage = max(max_abs(a, b) for a, b in zip(staged, staged_plain))
    if not all(torch.equal(a, b) for a, b in zip(staged, staged_plain)):
        raise AssertionError("relayout_stage differs from its plain version")
    del staged_plain
    bases = [rl_ops._resize(x, delta.old_len, delta.new_len) for x in leaves]
    bases_plain = [b.clone() for b in bases]
    rl_ops.relayout_scatter(bases, staged, dst, block=delta.block)
    rl_ref.scatter_plain(bases_plain, staged, dst, delta.block)
    err_scatter = max(max_abs(a, b) for a, b in zip(bases, bases_plain))
    if not all(torch.equal(a, b) for a, b in zip(bases, bases_plain)):
        raise AssertionError("relayout_scatter differs from its plain version")
    del bases_plain
    n_lanes, n_leaves = int(src.numel()), len(leaves)
    n_kept = int((src >= 0).sum())
    # The library's gather, one index_select per leaf over the same lanes
    # (it leaves the lanes of -1, which the stage zeroes, gathered).
    src_rows = src.clamp(min=0).long()
    stage = dict(
        ms=time_ms(lambda: rl_ops.relayout_stage(leaves, src), device),
        plain_ms=time_ms(lambda: rl_ref.stage_plain(leaves, src), device),
        library_ms=time_ms(lambda: [torch.index_select(x, 0, src_rows)
                                    for x in leaves], device),
        max_abs_err=err_stage, max_ulp=0,
        shape=f"lanes={n_lanes} kept={n_kept} leaves={n_leaves}")
    # Reads the int32 map and each leaf's kept lanes; writes every lane.
    stage["bound_ms"], stage["bound_by"] = bound_ms(
        n_lanes * 4 + n_leaves * (4 * n_kept + 4 * n_lanes), 0)
    rows = dst.long()

    def library():
        for b, t in zip(bases, staged):
            b.view(-1, delta.block).index_copy_(0, rows,
                                                t.view(-1, delta.block))

    scatter = dict(
        ms=time_ms(lambda: rl_ops.relayout_scatter(bases, staged, dst,
                                                   block=delta.block), device),
        plain_ms=time_ms(lambda: rl_ref.scatter_plain(bases, staged, dst,
                                                      delta.block), device),
        library_ms=time_ms(library, device),
        max_abs_err=err_scatter, max_ulp=0,
        shape=f"tiles={int(dst.numel())} block={delta.block} "
              f"leaves={n_leaves}")
    scatter["bound_ms"], scatter["bound_by"] = bound_ms(
        n_leaves * 8 * n_lanes + 4 * int(dst.numel()), 0)
    whole = dict(ms=stage["ms"] + scatter["ms"],
                 bound_ms=bound_ms(n_leaves * 4 * (n_kept + n_lanes), 0)[0])
    return stage, scatter, whole


# ------------------------------------------- phase s: the sharded service
S_PEAK_GB = 65.0  # phase s's budget of device memory at peak
S_LEAK_BYTES = 256 << 20  # what phases s, r and q may leave allocated


def gather_jobs(s: Service, jobs):
    """The gather oracle of a sharded transition: each job's packed
    flat/mu/nu (and ef, on a fleet with compressed jobs) read through its
    ShardedJobLayout, its tensors' lanes ordered by leaf key (a
    transition may move a tensor to another shard and so reorder the
    packed vector), as new tensors."""
    from repro_torch.ps.runtime import _gather_packed, _layout_rows

    out = {}
    for j in jobs:
        layout = s.plan.job_layout(j)
        rows = _layout_rows(layout, s.device)
        slots = sorted(layout.slots)
        out[j] = {}
        for k in s.rt.arena:
            packed = _gather_packed(
                layout, rows, [s.rt.states[sid][k]
                               for sid in layout.shard_ids])
            out[j][k] = torch.cat([packed[start:start + size]
                                   for _, start, size, _, _ in slots])
            del packed
    return out


def fleet_heads(s: Service, at: int = 0):
    """The head piece (``at=-1``: the last queued) of every pending job on
    every lane, per lane: [(shard id, jobs, pieces, counts)], what the
    next fleet tick applies (the pieces the last push queued)."""
    heads = []
    for sid in s.plan.shard_ids:
        lane = s.eng._lanes.get(sid)
        jobs = tuple(j for j in s.rt.job_ids
                     if lane is not None and lane.queues.get(j))
        if jobs:
            hs = [lane.queues[j][at] for j in jobs]
            heads.append((sid, jobs, tuple(h[0] for h in hs),
                          tuple(h[1] for h in hs)))
    return heads


def per_shard_on_clone(s: Service, clone, heads):
    """The per-shard oracle: each lane's own applier (one K1 launch over
    the lane's views) applies its head pieces to ``clone`` (a copy of the
    fleet arena taken before the fused tick).  Returns the launches."""
    offsets = dict(zip(s.plan.shard_ids, s.plan.concat_view()[0]))
    for sid, jobs, gs, counts in heads:
        off, n = offsets[sid], s.plan.shard_of(sid).total_len
        views = {k: clone[k][off:off + n] for k in clone}
        s.eng._build_applier(sid, jobs)(views, gs, counts)
    return len(heads)


def fleet_ticks(s: Service, n: int, wrappers, oracle_last: bool = False,
                phase: str = "phase s"):
    """``n`` rounds: every resident job pushes one seeded packed gradient
    (one piece per hosting shard), then ONE fleet tick, timed on the host
    clock to a synchronize.  Each tick must apply every piece and add
    exactly one to ``TickStats.n_launches`` and to K1's counter, and one
    to the ``ef_round`` kernel's a compressed piece (:func:`ef_pieces`).
    With ``oracle_last`` the last tick is held against the per-shard
    oracle on a clone of the arena, bit for bit.  Returns (tick ms, the
    host's share of each: ms until ``tick()`` returns, before the
    synchronize; the caching allocator's new device allocations
    (``cudaMalloc``s) in each; the oracle's K1 launches)."""
    k1, k8 = wrappers["agg_adam_multijob_fused"], wrappers["ef_round"]
    times, enqueue, mallocs, oracle = [], [], [], 0
    for i in range(n):
        s.push_all()
        pieces = sum(len(s.plan.job_layout(j).shard_ids)
                     for j in s.rt.job_ids)
        compressed = ef_pieces(s)
        clone = heads = None
        if oracle_last and i == n - 1:
            clone = {k: v.clone() for k, v in s.rt.arena.items()}
            heads = fleet_heads(s)
        sync(s.device)
        launches0, k1_0, k8_0 = (s.eng.stats.n_launches, k1.launches,
                                 k8.launches)
        allocs0 = device_allocs(s.device)
        t0 = time.perf_counter()
        applied = s.eng.tick()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        sync(s.device)
        times.append((time.perf_counter() - t0) * 1e3)
        mallocs.append(device_allocs(s.device) - allocs0)
        if (s.eng.stats.n_launches - launches0, k1.launches - k1_0) != (1, 1):
            raise AssertionError(
                f"{phase}: a fleet tick made {k1.launches - k1_0} K1 "
                f"launches and {s.eng.stats.n_launches - launches0} "
                f"engine launches (want 1 and 1)")
        if k8.launches - k8_0 != compressed:
            raise AssertionError(
                f"{phase}: a fleet tick made {k8.launches - k8_0} ef_round "
                f"launches for {compressed} compressed pieces")
        if applied != pieces:
            raise AssertionError(f"{phase}: a fleet tick applied {applied} "
                                 f"of {pieces} pieces")
        if clone is not None:
            k1_0 = k1.launches
            per_shard_on_clone(s, clone, heads)
            oracle += k1.launches - k1_0
            for k, v in clone.items():
                if not bits_equal(v, s.rt.arena[k]):
                    raise AssertionError(
                        f"{phase}: the fused fleet tick and the per-shard "
                        f"oracle differ in {k} (max abs "
                        f"{max_abs(v, s.rt.arena[k])})")
            del clone, heads
    return times, enqueue, mallocs, oracle


def ef_pieces(s: Service) -> int:
    """The compressed pieces of a fleet tick with every job pushing: one
    error-feedback round, so one ``ef_round`` launch, each."""
    return sum(len(s.plan.job_layout(j).shard_ids) for j in s.rt.job_ids
               if s.rt._jobs[j]["step_opts"].get("push_compression"))


def sharded_transition(s: Service, what: str, fn, wrappers, drain=True,
                       jobs=None):
    """Drain (unless the caller has), read every resident job's packed
    state (or that of ``jobs``, those that stay) through its layout, run
    the replan ``fn``, then hold the migrated states against those reads
    bit for bit and the runtime's moved bytes and touched jobs against
    ``sharded_transition_summary``.  ``what`` names the phase and step
    in errors.  Returns (fn's result, replan s, K2 launches (stage,
    scatter), the summary)."""
    from repro_torch.ps.elastic import sharded_transition_summary

    if drain:
        s.eng.drain()
    jobs = s.rt.job_ids if jobs is None else tuple(jobs)
    before = gather_jobs(s, jobs)
    old = s.plan
    k2_0 = (wrappers["relayout_stage"].launches,
            wrappers["relayout_scatter"].launches)
    sync(s.device)
    t0 = time.perf_counter()
    out = fn()
    sync(s.device)
    replan_s = time.perf_counter() - t0
    k2 = (wrappers["relayout_stage"].launches - k2_0[0],
          wrappers["relayout_scatter"].launches - k2_0[1])
    new = s.plan
    if new is old:
        return out, replan_s, k2, None
    moved, touched = sharded_transition_summary(old, new)
    if (s.rt.last_relayout_bytes, s.rt.last_replan_touched) != (
            12 * moved, touched):
        raise AssertionError(
            f"{what}: moved {s.rt.last_relayout_bytes} B and "
            f"touched {s.rt.last_replan_touched}; the summary says "
            f"{12 * moved} B and {touched}")
    for j in jobs:
        after = gather_jobs(s, (j,))[j]
        for k, v in before.pop(j).items():
            if not bits_equal(after[k], v):
                raise AssertionError(
                    f"{what}: {j}'s packed {k} differs from the "
                    f"gather oracle (max abs {max_abs(after[k], v)})")
        del after
    return out, replan_s, k2, (moved, touched)


def s_line(step, times, stats0, stats1, replan_s, peak_gb, extra=""):
    ticks = stats1.n_ticks - stats0.n_ticks
    per_tick = (stats1.n_launches - stats0.n_launches) / max(1, ticks)
    ms = (f"tick_ms_median={statistics.median(times):.3f} tick_ms_mean="
          f"{statistics.mean(times):.3f} "
          f"tick_ms={[round(t, 3) for t in times]}"
          if times else "tick_ms=none")
    replan = "none" if replan_s is None else f"{replan_s:.2f}"
    return (f"phase s {step}: ticks={ticks} {ms} replan_s={replan} "
            f"peak_gb={peak_gb:.2f} launches_per_tick={per_tick:g}{extra} "
            f"host_maxrss_gb={host_rss_gb():.2f}")


def sharded_phase(device, wrappers, scale, flat_tick_ms):
    """Phase s: the sharded service at the paper inventories.  AlexNet,
    VGG19 and BERT-base resident in a ShardedServiceRuntime; 4 fused fleet
    ticks, the last held against the per-shard oracle; AWD-LM arrives
    through a sharded replan; then an ElasticScaler over idle, hot and
    idle windows grows the fleet by one shard and merges it back.  Every
    transition is held against the gather oracle and the summary's
    accounting.  Returns the phase's launch counts (the oracle's K1
    launches taken out) and the service, which phase r goes on with."""
    from repro_torch.ps import elastic
    from repro_torch.ps.autoscaler import AutoscalerConfig, ElasticScaler

    t_phase = time.perf_counter()
    elastic.clear_plan_cache()
    reset_counters(wrappers)
    peaks, oracle = [], 0

    def step_start():
        torch.cuda.reset_peak_memory_stats()
        return dataclasses.replace(s.eng.stats)

    def peak():
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        return peaks[-1]

    torch.cuda.reset_peak_memory_stats()
    s = Service(device, scale, sharded=True)
    t0 = time.perf_counter()
    for model in ("alexnet", "vgg19", "bert"):
        s.add(model)
    sync(device)
    print(f"phase s set-up: jobs={list(s.rt.job_ids)} shards="
          f"{s.rt.n_shards} lanes_per_shard="
          f"{[sp.total_len for sp in s.plan.shards]} payload="
          f"{s.plan.payload_elements} seconds={time.perf_counter() - t0:.2f}"
          f" peak_gb={peak():.2f} host_maxrss_gb={host_rss_gb():.2f}",
          flush=True)

    stats0 = step_start()
    times, enqueue, mallocs, n = fleet_ticks(s, 4, wrappers,
                                             oracle_last=True)
    oracle += n
    s.fleet_tick_ms = times  # the 3-job ticks phase q compares with
    print(s_line("1 (3 jobs)", times, stats0, s.eng.stats, None, peak(),
                 f" fused_vs_per_shard=bit_for_bit per_shard_k1_launches={n}"
                 f" host_enqueue_ms={[round(t, 3) for t in enqueue]}"
                 f" cuda_mallocs={mallocs}"
                 f" flat_tick_ms_median(phase a)="
                 f"{statistics.median(flat_tick_ms):.3f}"), flush=True)

    stats0 = step_start()
    _, replan_s, k2, (moved, touched) = sharded_transition(
        s, "phase s arrival", lambda: s.add("awd-lm"), wrappers)
    if min(k2) < 1:
        raise AssertionError(f"phase s arrival: K2 launches {k2}")
    times, _, _, _ = fleet_ticks(s, 2, wrappers)
    print(s_line("2 (AWD-LM arrives)", times, stats0, s.eng.stats, replan_s,
                 peak(), f" shards={s.rt.n_shards} moved_elements={moved} "
                 f"touched={list(touched)} k2_launches(stage+scatter)="
                 f"{k2[0]}+{k2[1]} gather_oracle=bit_for_bit"), flush=True)
    elastic.clear_plan_cache()

    # The scaler: min_shards holds the fleet at its size when idle and
    # max_shards lets it grow by one; shard_capacity puts two idle rounds
    # at or below the fleet's size however the pieces fall (each job has
    # at most one piece a shard), and the hot window's rounds above it.
    n0, n_jobs = s.rt.n_shards, len(s.rt.job_ids)
    cap = 2 * n_jobs * (n0 + 1) / n0
    hot = 2 * (n0 + 1) + 1
    scaler = ElasticScaler(s.rt, AutoscalerConfig(
        shard_capacity=cap, min_shards=n0, max_shards=n0 + 1, cooldown=1))
    for name, rounds, want in (("idle", 2, "hold"), ("hot", hot, "grow"),
                               ("idle", 2, "shrink")):
        stats0 = step_start()
        times, _, _, _ = fleet_ticks(s, rounds, wrappers)
        d, replan_s, k2, summary = sharded_transition(
            s, f"phase s {name} window", scaler.observe, wrappers)
        if d.action != want:
            raise AssertionError(f"phase s: the {name} window's decision is "
                                 f"{d.action}, not {want}: {d}")
        moved = "" if summary is None else (
            f" moved_elements={summary[0]} touched={list(summary[1])} "
            f"k2_launches(stage+scatter)={k2[0]}+{k2[1]} "
            f"gather_oracle=bit_for_bit")
        print(f"phase s ScaleDecision: window={d.window} load={d.load:g} "
              f"shards {d.n_shards_before}->{d.n_shards_after} action="
              f"{d.action} relayout_bytes={d.relayout_bytes}", flush=True)
        print(s_line(f"{len(peaks)} ({name} window, {rounds} rounds, "
                     f"{d.action})", times, stats0, s.eng.stats,
                     None if summary is None else replan_s, peak(), moved),
              flush=True)
        elastic.clear_plan_cache()
    stats0 = step_start()
    times, _, _, _ = fleet_ticks(s, 2, wrappers)
    print(s_line(f"{len(peaks)} (after the merge)", times, stats0,
                 s.eng.stats, None, peak(), f" shards={s.rt.n_shards}"),
          flush=True)
    counts = read_counters(wrappers)
    counts["agg_adam_multijob_fused"] -= oracle
    if max(peaks) > S_PEAK_GB:
        raise AssertionError(f"phase s: {max(peaks):.2f} GB at peak, over "
                             f"its {S_PEAK_GB} GB budget")
    print(f"phase s (sharded service): counters={counts} peak_gb="
          f"{max(peaks):.2f} engine={dataclasses.asdict(s.eng.stats)} "
          f"seconds={time.perf_counter() - t_phase:.1f}", flush=True)
    del scaler
    elastic.clear_plan_cache()
    return counts, s


# --------------------------------- phase r: read side and fault tolerance
R_PEAK_GB = 45.0  # phase r's budget of device memory at peak
R_FAULT_ROUNDS = 3  # r2's push rounds; the fault fires in the second


def r_tick(s: Service, wrappers, what: str):
    """One engine round (``tick()``), timed on the host clock to a
    synchronize.  A fused tick that does not fall back must be exactly one
    K1 launch and one ``n_launches``.  Returns (pieces applied, ms, the
    caching allocator's ``cudaMalloc``s in it)."""
    k1 = wrappers["agg_adam_multijob_fused"]
    fallbacks, launches, k1_0 = (s.eng.stats.n_fleet_fallbacks,
                                 s.eng.stats.n_launches, k1.launches)
    sync(s.device)
    allocs0 = device_allocs(s.device)
    t0 = time.perf_counter()
    applied = s.eng.tick()
    sync(s.device)
    ms = (time.perf_counter() - t0) * 1e3
    if applied and s.eng.stats.n_fleet_fallbacks == fallbacks and (
            s.eng.stats.n_launches - launches, k1.launches - k1_0) != (1, 1):
        raise AssertionError(
            f"{what}: a fused tick made {k1.launches - k1_0} K1 "
            f"launches and {s.eng.stats.n_launches - launches} engine "
            f"launches (want 1 and 1)")
    return applied, ms, device_allocs(s.device) - allocs0


def r_drain(s: Service, wrappers, what: str):
    """Tick until nothing is pending on a healthy lane; returns ticks."""
    n = 0
    while r_tick(s, wrappers, what)[0]:
        n += 1
    return n


def lane_views_ok(rt, what: str):
    """Every lane's state leaf is still a view of the fleet arena at its
    block-aligned offset."""
    offsets = dict(zip(rt.splan.shard_ids, rt.splan.concat_view()[0]))
    for sid, st in rt.states.items():
        for k, v in st.items():
            arena = rt.arena[k]
            if v._base is not arena or (v.data_ptr() - arena.data_ptr()
                                        != 4 * offsets[sid]):
                raise AssertionError(f"{what}: shard {sid}'s {k} is no "
                                     f"longer a view of the fleet arena")


def check_diffs(what, pulls, held, pushed, block_rows):
    """Each job's versioned diff against its held bootstrap: the pushed
    job ships every owned block and nothing else moves; patched onto the
    held payload, each equals a full pull bit for bit.  ``pulls(j, v)``
    is the engine's or a replica's versioned pull."""
    for j, h in held.items():
        d = pulls(j, h.version)
        want = np.arange(block_rows[j]) if j == pushed else np.empty(0)
        if d.full or not np.array_equal(d.block_ids, want):
            raise AssertionError(
                f"phase r {what}: the diff of {j} after a push of {pushed} "
                f"is full={d.full} with {d.block_ids.size} of "
                f"{block_rows[j]} blocks")
        full = pulls(j, 0)
        if not bits_equal(d.apply(h.data), full.data):
            raise AssertionError(f"phase r {what}: {j}'s patched diff "
                                 f"differs from a full pull")
        del d, full


def check_served(s: Service, rs, what: str):
    """After a refresh the read tier serves every job's tree as the
    engine pulls it, bit for bit."""
    rs.refresh()
    for j in s.rt.job_ids:
        got, want = rs.pull(j), s.eng.pull(j)
        if set(got) != set(want) or not all(bits_equal(got[k], want[k])
                                             for k in want):
            raise AssertionError(f"phase r {what}: the replica's tree pull "
                                 f"of {j} differs from the engine's")
        del got, want


def transient_fault(s: Service, wrappers, what: str, in_k1: bool = False):
    """A ``fail_apply`` on the lane that hosts the most jobs (with
    ``in_k1``, the K1 update raising once INSIDE the fused applier, after
    the tick's error-feedback rounds wrote the arena's ``ef`` in place), in
    the second of ``R_FAULT_ROUNDS`` push rounds: the fused tick must fall
    back once (the lane rolled back once, no quarantine, no replan), and
    the drained arena (every leaf, ef included) must equal a clone of it
    taken before, driven through the same pieces by the per-shard
    appliers, bit for bit, every lane still a view of the arena.  Returns
    (the target, the counters' moves, the oracle's K1 launches)."""
    from repro_torch.kernels.agg_adam import ops as agg_ops

    k1 = wrappers["agg_adam_multijob_fused"]
    # The applier's K1 call; the stand-in replaces it and not the wrapper,
    # whose launch counter is an attribute of its module-level name.
    update = agg_ops.multi_job_adam_update_fused
    eng, plan = s.eng, s.plan
    target = max(plan.shard_ids, key=lambda sid: len(
        plan.shard_of(sid).job_ids))
    stats0 = dataclasses.replace(eng.stats)
    lane_rollbacks = eng._lanes[target].stats.n_rollbacks
    replans = s.rt.n_replans
    clone = {k: v.clone() for k, v in s.rt.arena.items()}
    rounds = []
    ctl = {"ef0": None, "dirty": None, "fired": 0}

    def k1_fails_once(*args, **kw):
        if ctl["ef0"] is not None:
            # Armed: the EF rounds of this very tick have run by now.
            ctl["dirty"] = not torch.equal(s.rt.arena["ef"], ctl["ef0"])
            ctl["ef0"] = None
            ctl["fired"] += 1
            raise RuntimeError(f"{what}: K1 fails after the EF rounds")
        return update(*args, **kw)

    if in_k1:
        agg_ops.multi_job_adam_update_fused = k1_fails_once
    else:
        s.inj.fail_apply(target, at=2)
    fired0 = s.inj.fire_counts().get("fail_apply", 0)
    try:
        for r in range(R_FAULT_ROUNDS):
            s.push_all()
            rounds.append(fleet_heads(s, at=-1))
            if in_k1 and r == 1:
                ctl["ef0"] = s.rt.arena["ef"].clone()
            r_drain(s, wrappers, what)
    finally:
        agg_ops.multi_job_adam_update_fused = update
    ctl["ef0"] = None
    fired = (ctl["fired"] if in_k1 else
             s.inj.fire_counts().get("fail_apply", 0) - fired0)
    if in_k1 and ctl["dirty"] is not True:
        raise AssertionError(f"{what}: K1 raised with the arena's ef as "
                             f"before the tick: no EF round had written it")
    d_stats = {f: getattr(eng.stats, f) - getattr(stats0, f)
               for f in ("n_fleet_fallbacks", "n_rollbacks", "n_replayed",
                         "n_quarantines", "n_replans")}
    if (fired != 1 or d_stats["n_fleet_fallbacks"] != 1
            or eng._lanes[target].stats.n_rollbacks != lane_rollbacks + 1
            or d_stats["n_quarantines"] or d_stats["n_replans"]
            or s.rt.n_replans != replans or eng.quarantined_shards()):
        raise AssertionError(f"{what}: fired={fired} {d_stats}; want "
                             f"one fall-back, {target} rolled back once, "
                             f"no quarantine and no replan")
    k1_0 = k1.launches
    for heads in rounds:
        per_shard_on_clone(s, clone, heads)
    oracle = k1.launches - k1_0
    for k, v in clone.items():
        if not bits_equal(v, s.rt.arena[k]):
            raise AssertionError(
                f"{what}: after the fault the arena's {k} differs from "
                f"the fault-free per-shard replay (max abs "
                f"{max_abs(v, s.rt.arena[k])})")
    del clone, rounds
    lane_views_ok(s.rt, what)
    return target, d_stats, oracle


def read_phase(s: Service, wrappers):
    """Phase r, on phase s's runtime: the read tier over the shard lanes,
    a transient fault inside a fused fleet tick, and a lost shard.

    r1: a ReplicaSet of 2 attached; 3 fused fleet ticks, the second of
    one job's push only, after which versioned diff pulls of every job,
    from the engine and from a replica, ship exactly that job's blocks
    and patch onto the bootstrap to a full pull bit for bit; the replica's
    tree pulls equal the engine's.  r2: ``fail_apply`` on the lane that
    hosts the most jobs, in the second of 3 rounds: the fused tick falls
    back, the participants roll back and replay, and the drained arena
    equals a clone of it driven through the same pieces by the per-shard
    appliers, bit for bit, every lane still a view of the arena.  r3:
    ``kill_shard`` on a lane that hosts some jobs but not all: it
    quarantines after its retry, the scaler holds, the other jobs tick
    on, direct pulls of its jobs raise while a replica serves them
    degraded, and ``recover_shard`` re-hosts it, held against the gather
    oracle and the transition summary; then 2 fused ticks of every job
    and the read tier re-subscribed.  Returns the phase's launch counts
    (the oracle's K1 launches taken out)."""
    from repro_torch.ps import elastic
    from repro_torch.ps.autoscaler import AutoscalerConfig, ElasticScaler
    from repro_torch.ps.faults import EngineQuarantinedError
    from repro_torch.ps.replica import ReplicaSet

    t_phase = time.perf_counter()
    elastic.clear_plan_cache()
    s.eng.drain()
    reset_counters(wrappers)
    torch.cuda.reset_peak_memory_stats()
    rs = ReplicaSet(s.eng, n_replicas=2)
    rep = rs.replicas[0]
    eng, plan = s.eng, s.plan
    block_rows = {j: sum(int(l.blocks.size)
                         for l in plan.job_layout(j).layouts)
                  for j in s.rt.job_ids}

    # ---- r1: reads
    ticks = []
    s.push_all()
    ticks.append(r_tick(s, wrappers, "phase r r1")[1:])
    held = {j: eng.pull(j, since_version=0) for j in s.rt.job_ids}
    rs.refresh()
    held_rep = {j: rep.pull(j, since_version=0) for j in s.rt.job_ids}
    for j in held:
        if not (held_rep[j].full and bits_equal(held_rep[j].data,
                                                 held[j].data)):
            raise AssertionError(f"phase r r1: the replica's bootstrap of "
                                 f"{j} differs from the engine's")
    pushed = min(s.rt.job_ids, key=lambda j: block_rows[j])
    s.push_all([pushed])
    ticks.append(r_tick(s, wrappers, "phase r r1")[1:])
    check_diffs("r1 engine", lambda j, v: eng.pull(j, since_version=v),
                held, pushed, block_rows)
    rs.refresh()
    check_diffs("r1 replica", lambda j, v: rep.pull(j, since_version=v),
                held_rep, pushed, block_rows)
    del held, held_rep
    s.push_all()
    ticks.append(r_tick(s, wrappers, "phase r r1")[1:])
    check_served(s, rs, "r1")
    times = [t for t, _ in ticks]
    print(f"phase r r1 (reads, ReplicaSet x2): fleet ticks with the hub "
          f"attached ms={[round(t, 3) for t in times]} median="
          f"{statistics.median(times):.3f} cuda_mallocs="
          f"{[m for _, m in ticks]} (the second: {pushed} only); "
          f"versioned diffs after a push "
          f"of {pushed} only: {pushed} ships {block_rows[pushed]} of its "
          f"{block_rows[pushed]} blocks, the others 0, from the engine and "
          f"from a replica, patched = full pull bit_for_bit; replica tree "
          f"pulls = engine pulls bit_for_bit; publishes={rs.n_publishes} "
          f"peak_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}",
          flush=True)

    # ---- r2: a transient fault inside a fused fleet tick
    target, d_stats, oracle = transient_fault(s, wrappers, "phase r r2")
    print(f"phase r r2 (fail_apply on {target} in round 2 of "
          f"{R_FAULT_ROUNDS}): {d_stats} the drained arena = the "
          f"fault-free per-shard replay bit_for_bit (per_shard_k1_launches"
          f"={oracle}), every lane a view of the arena", flush=True)

    # ---- r3: a lost shard
    hosts = {sid: set(plan.shard_of(sid).job_ids) for sid in plan.shard_ids}
    jobs = set(s.rt.job_ids)
    victims = [sid for sid, js in hosts.items() if js != jobs]
    if not victims:
        raise AssertionError("phase r r3: every shard hosts every job")
    victim = min(victims, key=lambda sid: len(hosts[sid]))
    hosted = [j for j in s.rt.job_ids if j in hosts[victim]]
    spared = [j for j in s.rt.job_ids if j not in hosts[victim]]
    scaler = ElasticScaler(s.rt, AutoscalerConfig(
        shard_capacity=1.0, min_shards=s.rt.n_shards,
        max_shards=s.rt.n_shards + 1, cooldown=1))
    scaler.observe()  # opens the window
    s.inj.kill_shard(victim, at=1)
    s.push_all()
    for _ in range(2 * (eng.max_apply_retries + 1)):
        r_tick(s, wrappers, "phase r r3")
        if victim in eng.quarantined_shards():
            break
    else:
        raise AssertionError(f"phase r r3: {victim} never quarantined")
    t_quarantine = time.perf_counter()
    if eng.quarantined_shards() != (victim,):
        raise AssertionError(f"phase r r3: quarantined "
                             f"{eng.quarantined_shards()}, want {victim}")
    d = scaler.observe()
    if d.action != "hold" or d.quarantined != (victim,):
        raise AssertionError(f"phase r r3: the scaler did not hold on the "
                             f"quarantined fleet: {d}")
    spared_ms = []
    for _ in range(2):
        s.push_all(spared)
        while True:
            applied, ms, _ = r_tick(s, wrappers, "phase r r3 spared jobs")
            if not applied:
                break
            spared_ms.append(ms)
        if any(eng.outstanding(j) for j in spared):
            raise AssertionError("phase r r3: a job off the lost shard did "
                                 "not drain")
    for j in hosted:
        try:
            eng.pull(j)
        except EngineQuarantinedError as exc:
            if exc.shard_id != victim:
                raise
        else:
            raise AssertionError(f"phase r r3: pull of {j} did not raise "
                                 f"the quarantine of {victim}")
        first, again = rep.pull(j), rep.pull(j)
        if victim not in rep.degraded_lanes or not all(
                bits_equal(first[k], again[k]) for k in first):
            raise AssertionError(f"phase r r3: the replica's serve of {j} "
                                 f"is not a deterministic degraded serve")
        del first, again
    lane = eng._lanes[victim]
    futs = {id(f): f for q in lane.queues.values() for _, _, f, _ in q
            if f is not None}
    want = (sum(f.done() for f in futs.values()),
            sum(not f.done() for f in futs.values()))
    old = s.plan
    report, replan_s, k2, (moved, touched) = sharded_transition(
        s, "phase r r3 recovery", lambda: s.rt.recover_shard(victim), wrappers,
        drain=False)
    got = (report.rolled_back_pushes, report.cancelled_pushes)
    if report.seeded_from != "snapshot" or got != want:
        raise AssertionError(f"phase r r3: {report}; want seeded_from="
                             f"snapshot and (rolled back, cancelled) {want}")
    relaid = [sid for sid in s.plan.shard_ids if sid in old.shard_ids
              and elastic.compile_migration_delta(
                  old.shard_of(sid), s.plan.shard_of(sid)
              ).touched_blocks.size]
    if k2 != (len(relaid), len(relaid)):
        raise AssertionError(f"phase r r3: K2 launches {k2}; the summary's "
                             f"surviving shards with moved blocks: {relaid}")
    times, _, mallocs, _ = fleet_ticks(s, 2, wrappers)
    drained_s = time.perf_counter() - t_quarantine
    if set(eng.shard_health().values()) != {"healthy"} or any(
            rep._snaps[k].epoch != eng._epoch for k in s.plan.shard_ids):
        raise AssertionError("phase r r3: after recovery the fleet is not "
                             "healthy or the read tier did not re-subscribe")
    check_served(s, rs, "r3")
    counts = read_counters(wrappers)
    counts["agg_adam_multijob_fused"] -= oracle
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase r r3 (kill_shard {victim}, hosting {hosted}; spared "
          f"{spared}): quarantined after {eng.max_apply_retries} retry, "
          f"scaler hold, spared-job fleet ticks ms="
          f"{[round(t, 3) for t in spared_ms]} at 1 launch each, direct "
          f"pulls raise, degraded serves deterministic; {report}; "
          f"evacuation replan_s={replan_s:.2f} moved_elements={moved} "
          f"touched={list(touched)} k2_launches(stage+scatter)={k2[0]}+"
          f"{k2[1]} gather_oracle=bit_for_bit; then fleet ticks ms="
          f"{[round(t, 3) for t in times]} cuda_mallocs={mallocs}; "
          f"quarantine_to_drained_s="
          f"{drained_s:.2f} (the checks above included)", flush=True)
    if peak_gb > R_PEAK_GB:
        raise AssertionError(f"phase r: {peak_gb:.2f} GB at peak, over its "
                             f"{R_PEAK_GB} GB budget")
    print(f"phase r (read side and recovery): counters={counts} peak_gb="
          f"{peak_gb:.2f} engine={dataclasses.asdict(eng.stats)} seconds="
          f"{time.perf_counter() - t_phase:.1f} host_maxrss_gb="
          f"{host_rss_gb():.2f}", flush=True)
    del rs, rep, scaler, lane, futs
    elastic.clear_plan_cache()
    return counts


# ------------------------- phase q: compressed pushes, leases, checkpoint
Q_PEAK_GB = 50.0  # phase q's budget of device memory at peak
Q_COMPRESSION = {"vgg19": "int8", "bert": "bf16", "awd-lm": "int8"}
Q_LEASE_S = 2.0  # the engine's lease interval on phase q's manual clock
Q_EF_ENTRY_JOB = "vgg19"  # the ef_round kernel's entry in the report
Q_CKPT_DIR = ROOT / "build" / "phase_q_ckpt"  # git-ignored; removed after


class ManualClock:
    """The lease clock of phase q: time moves only when the phase sets
    ``now``."""

    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


EF_BYTES_PER_LANE = 16  # an EF round reads g and ef, writes q and ef


def ef_round_ms(s: Service, job: str):
    """Device ms of one job's error-feedback rounds, summed over its
    pieces: through the kernel (``_ef_round``, one ``ef_round`` launch a
    piece) and through the eager round it replaced (``ef_round_plain``:
    gather, ``ef_transform``, scatter, on the same CUDA tensors), each on a
    seeded gradient and a clone of each hosting shard's ``ef``, CUDA
    events around back-to-back calls.  Returns (kernel ms, eager ms, bound
    ms at 16 B a lane, lanes)."""
    from repro_torch.kernels.ef_round.ref import ef_round_plain
    from repro_torch.ps.runtime import _ef_round, _rows, _split_pieces

    layout = s.plan.job_layout(job)
    kind = s.rt._jobs[job]["step_opts"]["push_compression"]
    kernel = eager = 0.0
    lanes = 0
    for sid, l, g in zip(layout.shard_ids, layout.layouts,
                         _split_pieces(layout, s.grad(job))):
        ef = s.rt.states[sid]["ef"].clone()
        rows = None if l.covers_all else _rows(l, s.device)
        kernel += time_ms(lambda: _ef_round(l, ef, g, kind, rows), s.device,
                          reps=5, warmup=2, inner=3)
        eager += time_ms(lambda: ef_round_plain(g, ef, kind, rows, l.block),
                         s.device, reps=5, warmup=2, inner=3)
        lanes += g.numel()
        del ef
    return (kernel, eager, EF_BYTES_PER_LANE * lanes / HBM_BYTES_PER_S * 1e3,
            lanes)


def ef_card_vs_cpu(s: Service, job: str):
    """The job's error-feedback round on its first piece held against the
    CPU's ``ef_transform`` bit for bit, on a seeded gradient and the live
    owned rows of its hosting shard's ``ef`` (nonzero after the ticks):
    the card's eager ``ef_transform`` on the gathered rows, and the
    kernel's round (``_ef_round``) on a clone of the shard's ``ef``, whose
    owned rows must then hold the CPU's residual and whose other rows must
    be unchanged.  The tests hold ``ef_transform`` bit for bit against the
    reference's eager round.  Returns (lanes compared, the rows' max
    abs)."""
    from repro_torch.ps.compression import ef_transform
    from repro_torch.ps.runtime import _ef_round, _rows, _split_pieces

    layout = s.plan.job_layout(job)
    kind = s.rt._jobs[job]["step_opts"]["push_compression"]
    sid, l = layout.shard_ids[0], layout.layouts[0]
    g = _split_pieces(layout, s.grad(job))[0]
    ef = s.rt.states[sid]["ef"]
    r = None if l.covers_all else _rows(l, s.device)

    def owned(buf):
        return buf if r is None else buf.view(-1, l.block)[r].reshape(-1)

    rows = owned(ef)
    q, resid = ef_transform(g, rows, kind)
    q_cpu, resid_cpu = ef_transform(g.cpu(), rows.cpu(), kind)
    ef_k = ef.clone()
    q_k = _ef_round(l, ef_k, g, kind, r)
    for what, card, cpu in (("eager q", q, q_cpu),
                            ("eager residual", resid, resid_cpu),
                            ("kernel q", q_k, q_cpu),
                            ("kernel residual", owned(ef_k), resid_cpu)):
        if not bits_equal(card.cpu(), cpu):
            raise AssertionError(
                f"phase q q1: the card's {what} ({job}, {kind}) differs "
                f"from the CPU's ef_transform (max abs "
                f"{max_abs(card.cpu(), cpu)})")
    if r is not None:
        other = torch.ones(ef.numel() // l.block, dtype=torch.bool,
                           device=s.device)
        other[r] = False
        if not bits_equal(ef_k.view(-1, l.block)[other],
                          ef.view(-1, l.block)[other]):
            raise AssertionError(f"phase q q1: the kernel's round of {job} "
                                 f"wrote rows of {sid}'s ef it does not own")
    peak = float(rows.abs().max())
    if not peak > 0:
        raise AssertionError(f"phase q q1: {job}'s ef rows on {sid} are all "
                             f"zero after the ticks")
    return g.numel(), peak


def compressed_phase(device, wrappers, scale, s_tick_ms):
    """Phase q: compressed pushes, leases and a checkpoint on a fresh
    sharded fleet at the paper inventories (AlexNet plain, VGG19 int8,
    BERT-base bf16 on 2 shards; the engine with a lease interval on a
    manual clock).

    q1: 4 fused fleet ticks, each one K1 launch, the last bit for bit
    against the per-shard appliers on a clone of the arena, ef included;
    each job's push alone prices the wire (int8 at most half of fp32,
    bf16 half); AWD-LM arrives with int8 through a sharded replan (K2
    moving flat/mu/nu/ef) held against the gather oracle; a
    ``fail_apply`` inside a fused tick, the drained arena against the
    per-shard replay on a clone, every lane's ef a view of the arena.
    q2: AWD-LM goes silent with a push queued while the others push;
    past its lease ``expire_leases()`` reclaims exactly it through a
    replan held against the gather oracle, and its queued future raises
    ``LeaseExpiredError``.  q3: ``save_checkpoint`` to a directory under
    ``build/`` (always removed), 2 more ticks, ``restore_checkpoint``
    into the live runtime: the arena equals the clone taken at the save
    bit for bit, every lane a view; one more fused tick equals that tick
    run on the clone by the per-shard appliers.  Returns the phase's
    launch counts (the oracle's K1 launches taken out; ``ef_round``'s in
    the checked fused fleet ticks alone), the service and the report's
    entry for the ``ef_round`` kernel (VGG19's int8 piece)."""
    from repro_torch.ps import elastic
    from repro_torch.ps.faults import LeaseExpiredError

    t_phase = time.perf_counter()
    elastic.clear_plan_cache()
    reset_counters(wrappers)
    torch.cuda.reset_peak_memory_stats()
    k1 = wrappers["agg_adam_multijob_fused"]
    clock = ManualClock()
    s = Service(device, scale, sharded=True, lease_interval=Q_LEASE_S,
                clock=clock)
    t0 = time.perf_counter()
    for model in ("alexnet", "vgg19", "bert"):
        s.add(model, Q_COMPRESSION.get(model))
    sync(device)
    if sorted(s.rt.arena) != ["ef", "flat", "mu", "nu"]:
        raise AssertionError(f"phase q: the arena holds {sorted(s.rt.arena)}"
                             f", want flat/mu/nu/ef")
    lane_views_ok(s.rt, "phase q")
    print(f"phase q set-up: jobs={list(s.rt.job_ids)} compression="
          f"{ {j: Q_COMPRESSION.get(j) for j in s.rt.job_ids} } shards="
          f"{s.rt.n_shards} lanes_per_shard="
          f"{[sp.total_len for sp in s.plan.shards]} arena_leaves="
          f"{sorted(s.rt.arena)} seconds={time.perf_counter() - t0:.2f} "
          f"peak_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}",
          flush=True)

    # ---- q1: compressed pushes through fused fleet ticks
    main_k8 = 4 * ef_pieces(s)  # fleet_ticks checks each tick's launches
    times, enqueue, mallocs, oracle = fleet_ticks(
        s, 4, wrappers, oracle_last=True, phase="phase q q1")
    single = {}
    for j in s.rt.job_ids:
        st0 = dataclasses.replace(s.eng.stats)
        s.push_all([j])
        raw = s.eng.stats.push_bytes_raw - st0.push_bytes_raw
        wire = s.eng.stats.push_bytes_wire - st0.push_bytes_wire
        ms = [r_tick(s, wrappers, "phase q q1")[1]]
        for _ in range(2):  # the first tick of a pattern builds its applier
            s.push_all([j])
            ms.append(r_tick(s, wrappers, "phase q q1")[1])
        single[j] = (statistics.median(ms[1:]), wire / raw)
        kind = Q_COMPRESSION.get(j)
        if (kind == "int8" and not wire <= 0.5 * raw) or (
                kind == "bf16" and wire != 0.5 * raw) or (
                kind is None and wire != raw):
            raise AssertionError(f"phase q q1: {j} ({kind}) pushed {raw} B "
                                 f"of fp32 as {wire} B on the wire")
    ef_ms = {j: ef_round_ms(s, j) for j in s.rt.job_ids
             if Q_COMPRESSION.get(j)}
    ef_cpu = {j: ef_card_vs_cpu(s, j) for j in ef_ms}
    ef_line = {j: (round(k, 3), round(e, 3), round(b, 3),
                   f"{100 * b / k:.1f}%") for j, (k, e, b, _) in ef_ms.items()}
    k, e, b, lanes = ef_ms[Q_EF_ENTRY_JOB]
    ef_entry = dict(  # held bit for bit against the CPU by ef_card_vs_cpu
        shape=f"{Q_EF_ENTRY_JOB} {Q_COMPRESSION[Q_EF_ENTRY_JOB]}, {lanes} "
        f"lanes", ms=k, plain_ms=e, bound_ms=b, bound_by="bytes",
        library_ms=None, max_abs_err=0.0, max_ulp=0)
    print(f"phase q q1 (3 jobs, 2 compressed): fleet ticks ms="
          f"{[round(t, 3) for t in times]} median="
          f"{statistics.median(times):.3f} (phase s, the same jobs "
          f"uncompressed: {statistics.median(s_tick_ms):.3f}) host_enqueue_ms="
          f"{[round(t, 3) for t in enqueue]} cuda_mallocs={mallocs}; "
          f"fused_vs_per_shard=bit_for_bit (ef included) "
          f"per_shard_k1_launches={oracle}; one job a tick: "
          f"{ {j: (round(ms, 3), round(r, 4)) for j, (ms, r) in single.items()} }"
          f" (median ms of the 2nd and 3rd tick, wire/fp32 bytes); "
          f"ef_round (kernel ms, eager ms, bound ms at 16 B a lane, "
          f"kernel's share of the bound)={ef_line} "
          f"ef round card=cpu bit_for_bit (kernel and eager) on (lanes, "
          f"ef max abs) "
          f"{ {j: (n, f'{m:.3e}') for j, (n, m) in ef_cpu.items()} } peak_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)

    _, replan_s, k2, (moved, touched) = sharded_transition(
        s, "phase q arrival",
        lambda: s.add("awd-lm", Q_COMPRESSION["awd-lm"]), wrappers)
    if min(k2) < 1 or sorted(s.rt.arena) != ["ef", "flat", "mu", "nu"]:
        raise AssertionError(f"phase q arrival: K2 launches {k2}, arena "
                             f"{sorted(s.rt.arena)}")
    lane_views_ok(s.rt, "phase q")
    main_k8 += 2 * ef_pieces(s)
    times, _, _, _ = fleet_ticks(s, 2, wrappers, phase="phase q q1")
    print(f"phase q q1 (AWD-LM arrives, int8): replan_s={replan_s:.2f} "
          f"shards={s.rt.n_shards} moved_elements={moved} touched="
          f"{list(touched)} k2_launches(stage+scatter)={k2[0]}+{k2[1]} over "
          f"{len(s.rt.arena)} leaves, gather_oracle=bit_for_bit "
          f"(flat/mu/nu/ef); fleet ticks ms={[round(t, 3) for t in times]}",
          flush=True)
    for in_k1, how in ((False, "fail_apply on {}"),
                       (True, "K1 raising after the EF rounds, {} among")):
        target, d_stats, n = transient_fault(s, wrappers, "phase q q1 fault",
                                             in_k1=in_k1)
        oracle += n
        print(f"phase q q1 ({how.format(target)} in round 2 of "
              f"{R_FAULT_ROUNDS}): {d_stats} the drained arena = the "
              f"fault-free per-shard replay bit_for_bit (ef included, "
              f"per_shard_k1_launches={n}), every lane's ef a view of the "
              f"arena", flush=True)
    elastic.clear_plan_cache()

    # ---- q2: a silent trainer's lease expires
    silent = "awd-lm"
    others = [j for j in s.rt.job_ids if j != silent]
    s.eng.drain()
    clock.now = 100.0
    fut = s.eng.submit_packed(silent, s.grad(silent))
    clock.now += Q_LEASE_S / 2
    s.push_all(others)
    sync(device)
    s.eng.tick(only=others)
    if s.eng.outstanding(silent) != 1 or any(s.eng.outstanding(j)
                                             for j in others):
        raise AssertionError("phase q q2: the queues are not as set up")
    clock.now += Q_LEASE_S * 0.75  # past the silent job's lease only
    old = s.plan
    expired, replan_s, k2, (moved, touched) = sharded_transition(
        s, "phase q q2 reclaim", s.eng.expire_leases, wrappers, drain=False,
        jobs=others)
    if expired != (silent,) or s.eng.stats.n_lease_expirations != 1 or (
            silent in s.rt.job_ids):
        raise AssertionError(f"phase q q2: expired {expired}, "
                             f"{s.eng.stats.n_lease_expirations} "
                             f"expirations; want ({silent!r},) and 1")
    try:
        fut.result(timeout=1.0)
    except LeaseExpiredError as exc:
        if exc.job_id != silent:
            raise
    else:
        raise AssertionError("phase q q2: the silent job's queued push "
                             "did not raise LeaseExpiredError")
    relaid = [sid for sid in s.plan.shard_ids if sid in old.shard_ids
              and elastic.compile_migration_delta(
                  old.shard_of(sid), s.plan.shard_of(sid)
              ).touched_blocks.size]
    if k2 != (len(relaid), len(relaid)):
        raise AssertionError(f"phase q q2: K2 launches {k2}; surviving "
                             f"shards with moved blocks: {relaid}")
    lane_views_ok(s.rt, "phase q")
    main_k8 += 2 * ef_pieces(s)
    times, _, _, _ = fleet_ticks(s, 2, wrappers, phase="phase q q2")
    print(f"phase q q2 (lease {Q_LEASE_S} s on a manual clock; {silent} "
          f"silent with a push queued): expired={list(expired)} "
          f"n_lease_expirations=1, its future raised LeaseExpiredError; "
          f"reclaim replan_s={replan_s:.2f} shards={s.rt.n_shards} "
          f"moved_elements={moved} touched={list(touched)} "
          f"k2_launches(stage+scatter)={k2[0]}+{k2[1]} "
          f"gather_oracle=bit_for_bit; then fleet ticks ms="
          f"{[round(t, 3) for t in times]}", flush=True)
    elastic.clear_plan_cache()

    # ---- q3: checkpoint the fleet, tick on, restore into the arena
    s.eng.drain()
    need = sum(v.numel() * v.element_size() for v in s.rt.arena.values())
    Q_CKPT_DIR.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(Q_CKPT_DIR.parent).free
    if free < 2 * need:
        raise AssertionError(f"phase q q3: {free / 1e9:.1f} GB free under "
                             f"{Q_CKPT_DIR.parent}, the checkpoint needs "
                             f"{need / 1e9:.1f} GB (twice that required)")
    try:
        saved = {k: v.clone() for k, v in s.rt.arena.items()}
        counts_at_save = dict(s.rt.counts)
        sync(device)
        t0 = time.perf_counter()
        path = s.rt.save_checkpoint(Q_CKPT_DIR, 1)
        save_s = time.perf_counter() - t0
        written = sum(f.stat().st_size for f in path.iterdir())
        for _ in range(2):
            s.push_all()
            r_tick(s, wrappers, "phase q q3")
        t0 = time.perf_counter()
        s.rt.restore_checkpoint(Q_CKPT_DIR, 1)
        sync(device)
        restore_s = time.perf_counter() - t0
        for k, v in saved.items():
            if not bits_equal(s.rt.arena[k], v):
                raise AssertionError(
                    f"phase q q3: after the restore the arena's {k} differs "
                    f"from the clone taken at the save (max abs "
                    f"{max_abs(s.rt.arena[k], v)})")
        lane_views_ok(s.rt, "phase q")
        if s.rt.counts != counts_at_save:
            raise AssertionError(f"phase q q3: counts {s.rt.counts}, saved "
                                 f"{counts_at_save}")
        s.push_all()
        heads = fleet_heads(s)
        _, tick_ms, _ = r_tick(s, wrappers, "phase q q3")
        k1_0 = k1.launches
        per_shard_on_clone(s, saved, heads)
        oracle += k1.launches - k1_0
        for k, v in saved.items():
            if not bits_equal(s.rt.arena[k], v):
                raise AssertionError(
                    f"phase q q3: the tick after the restore and the "
                    f"per-shard appliers on the saved clone differ in {k}")
        del saved, heads
    finally:
        shutil.rmtree(Q_CKPT_DIR, ignore_errors=True)
    print(f"phase q q3 (checkpoint of {len(s.rt.arena)} leaves x "
          f"{s.plan.concat_view()[1]} lanes): bytes_written={written} "
          f"save_s={save_s:.2f} restore_s={restore_s:.2f} verify=on "
          f"(SHA-256 written and checked); restored arena = the clone at "
          f"the save bit_for_bit, every lane a view; the next fused tick "
          f"({tick_ms:.3f} ms) = the per-shard appliers on the clone "
          f"bit_for_bit; free_disk_gb={free / 1e9:.1f}", flush=True)

    counts = read_counters(wrappers)
    counts["agg_adam_multijob_fused"] -= oracle
    # the kernel's launches in the checked fused fleet ticks alone (the
    # timing, the parity checks and the oracles launch it too)
    counts["ef_round"] = main_k8
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if peak_gb > Q_PEAK_GB:
        raise AssertionError(f"phase q: {peak_gb:.2f} GB at peak, over its "
                             f"{Q_PEAK_GB} GB budget")
    print(f"phase q (compressed pushes, leases, checkpoint): counters="
          f"{counts} peak_gb={peak_gb:.2f} engine="
          f"{dataclasses.asdict(s.eng.stats)} seconds="
          f"{time.perf_counter() - t_phase:.1f} host_maxrss_gb="
          f"{host_rss_gb():.2f}", flush=True)
    elastic.clear_plan_cache()
    return counts, s, ef_entry


# ------------------------------ phase t: the chaos trace replay, full width
T_PEAK_GB = 50.0  # phase t's budget of device memory at peak
T_PARITY_WINDOWS = 6  # the parity replay's depth, cut from 12 for time
# The trace's model mix (philly_like_trace(seed=0, n_jobs=14)), checked
# against what the replay admits.
T_MIX = {"j0": "vgg19", "j13": "vgg19", "j1": "alexnet", "j4": "alexnet",
         **{f"j{i}": "bert" for i in (3, 5, 8, 11, 12)},
         **{f"j{i}": "awd-lm" for i in (2, 6, 7, 9, 10)}}


class MethodTimer:
    """Host seconds inside some methods, per label, each outermost call
    ended by a device sync (so a tick's time is its kernels' too), while
    armed as a context manager.  Calls nested in a call of the same label
    are not counted again; a call's seconds exclude those of the timed
    calls of other labels nested in it (a recovery's replan counts as a
    replan only), so the labels' seconds add up."""

    def __init__(self, device, targets):
        self.device, self.targets = device, targets  # {label: [(cls, name)]}
        self.calls = dict.fromkeys(targets, 0)
        self.seconds = dict.fromkeys(targets, 0.0)
        self._depth = dict.fromkeys(targets, 0)
        self._nested = []  # seconds of timed calls inside each open call
        self._saved = []

    def _wrap(self, label, fn):
        def timed(*args, **kwargs):
            if self._depth[label]:
                return fn(*args, **kwargs)
            self._depth[label] += 1
            self._nested.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sync(self.device)
                took = time.perf_counter() - t0
                self.seconds[label] += took - self._nested.pop()
                if self._nested:
                    self._nested[-1] += took
                self.calls[label] += 1
                self._depth[label] -= 1
        return timed

    def __enter__(self):
        for label, methods in self.targets.items():
            for cls, name in methods:
                fn = cls.__dict__[name]
                self._saved.append((cls, name, fn))
                setattr(cls, name, self._wrap(label, fn))
        return self

    def __exit__(self, *exc):
        for cls, name, fn in reversed(self._saved):
            setattr(cls, name, fn)
        self._saved = []

    def take(self):
        """{label: (calls, seconds)} since the last take."""
        out = {k: (self.calls[k], self.seconds[k]) for k in self.targets}
        self.calls = dict.fromkeys(self.targets, 0)
        self.seconds = dict.fromkeys(self.targets, 0.0)
        return out


def replay_job_tree(device, scale, models):
    """``run_replay``'s ``job_tree``: each trace job's model's whole
    tensor inventory (``chunked_inventory``), N(0, 1) * 0.02 from one
    seeded generator in admission order; records the model of each job in
    ``models``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def job_tree(job_id, trace_job):
        model = trace_job.profile.model
        models[job_id] = model
        return {k: torch.randn(n, generator=gen, device=device) * 0.02
                for k, n in chunked_inventory(model, scale)}

    return job_tree


def replay_run(name, cfg, device, wrappers, scale):
    """One ``run_replay`` of phase t at the inventories' widths, with a
    line per window (live jobs, shards, the scaler's action, lanes, K1/K2/
    K3 launches, tick and replan seconds, wall seconds, peak GB), every
    lane checked to be a view of the fleet arena after each window.
    Returns (report, {label: (calls, seconds)} over the run, the window
    rows' extras, wall seconds)."""
    from repro_torch.ps.engine import ShardedTickEngine
    from repro_torch.ps.service_runtime import (
        ServiceRuntime,
        ShardedServiceRuntime,
    )
    from repro_torch.sim.replay import run_replay

    models = {}
    timer = MethodTimer(device, {
        "tick": [(ShardedTickEngine, "tick"),
                 (ShardedTickEngine, "tick_shard")],
        "replan": [(ShardedServiceRuntime, "_on_replan")],
        "recover": [(ShardedServiceRuntime, "recover_shard")],
        "twin_step": [(ServiceRuntime, "step")],
        "twin_replan": [(ServiceRuntime, "_on_replan")],
    })
    totals = {}
    last = dict(read_counters(wrappers))
    t_run = time.perf_counter()
    t_win = [t_run]
    rows = []

    def on_window(row, rt):
        sync(device)
        now = time.perf_counter()
        if rt.splan is not None:
            lane_views_ok(rt, f"phase t {name}")
        counts = read_counters(wrappers)
        delta = {k: counts[k] - last[k] for k in counts}
        last.update(counts)
        took = timer.take()
        for k, (n, sec) in took.items():
            c, s0 = totals.get(k, (0, 0.0))
            totals[k] = (c + n, s0 + sec)
        lanes = rt.splan.concat_view()[1] if rt.splan is not None else 0
        extra = dict(
            lanes=lanes, k1=delta["agg_adam_multijob_fused"],
            k2=delta["relayout_scatter"], k3=delta["agg_adam_blocks"],
            ticks=took["tick"][0], tick_ms=took["tick"][1] * 1e3,
            replans=took["replan"][0], replan_s=took["replan"][1],
            recover_s=took["recover"][1],
            twin_replan_s=took["twin_replan"][1],
            twin_step_s=took["twin_step"][1], wall_s=now - t_win[-1],
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        rows.append(extra)
        t_win.append(now)
        print(f"phase t {name} window {row['window']}: live={row['live']} "
              f"shards={row['n_shards']} action={row['action']} lanes="
              f"{lanes} K1={extra['k1']} K2={extra['k2']} K3={extra['k3']} "
              f"ticks={extra['ticks']} tick_ms={extra['tick_ms']:.1f} "
              f"replans={extra['replans']} replan_s={extra['replan_s']:.2f}"
              f" recover_s={extra['recover_s']:.2f}"
              + (f" twin_step_s={extra['twin_step_s']:.2f} twin_replan_s="
                 f"{extra['twin_replan_s']:.2f} parity={row['parity']}"
                 if cfg.parity_twin else "")
              + f" faults_fired={row['faults_fired']} agree={row['agree']}"
              f" wall_s={extra['wall_s']:.2f} peak_gb={extra['peak_gb']:.2f}"
              f" host_maxrss_gb={host_rss_gb():.2f}", flush=True)

    with timer:
        report = run_replay(cfg, device=device,
                            job_tree=replay_job_tree(device, scale, models),
                            on_window=on_window)
    sync(device)
    wall = time.perf_counter() - t_run
    wrong = {j: m for j, m in models.items() if T_MIX.get(j) != m}
    if wrong:
        raise AssertionError(f"phase t {name}: admitted models {wrong} are "
                             f"not the trace's mix {T_MIX}")
    return report, totals, rows, wall


def replay_phase(device, wrappers, scale):
    """Phase t: ``ReplayConfig()``'s chaos replay and its no-fault parity
    replay (``chaos=False, parity_twin=True``, its first T_PARITY_WINDOWS
    windows: the script's time limit) through
    ``repro_torch.sim.replay.run_replay``, each admitted trace job at its
    paper model's full tensor inventory.  The chaos run must show the
    reference's invariants: no registry divergence, the dead trainer
    reclaimed within one lease interval, ``fail_migration`` twice and
    ``drop_push`` once with 2 aborts and 2 retries, one ``recover_shard``
    and one lease expiration; the parity run every window bit for bit
    against the flat twin.  Within 50 GB at peak.  Returns the phase's
    launch counts."""
    from repro_torch.ps import elastic
    from repro_torch.sim.replay import ReplayConfig

    t_phase = time.perf_counter()
    reset_counters(wrappers)
    torch.cuda.reset_peak_memory_stats()
    results = {}
    for name, kw in (("chaos", {}),
                     ("parity", dict(chaos=False, parity_twin=True,
                                     max_windows=T_PARITY_WINDOWS))):
        elastic.clear_plan_cache()
        cfg = ReplayConfig(**kw)
        report, totals, rows, wall = replay_run(name, cfg, device, wrappers,
                                                scale)
        results[name] = report
        print(f"phase t {name}: " + " ".join(
            f"{k}={v}" for k, v in report.items() if k != "windows")
            + " " + " ".join(f"{k}_calls={n} {k}_s={sec:.2f}"
                             for k, (n, sec) in totals.items())
            + f" lanes_peak={max(r['lanes'] for r in rows)} peak_gb="
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} wall_s="
            f"{wall:.1f}", flush=True)
    chaos, parity = results["chaos"], results["parity"]
    lease_ok = (chaos["reclaim_latency_windows"] is not None
                and chaos["reclaim_latency_windows"]
                <= int(chaos["lease_interval"]) + 1)
    want = {
        "registry_divergence_windows": (chaos[
            "registry_divergence_windows"], 0),
        "reclaimed within one lease interval": (lease_ok, True),
        "fail_migration fired": (
            chaos["faults_by_kind"].get("fail_migration", 0), 2),
        "drop_push fired": (chaos["faults_by_kind"].get("drop_push", 0), 1),
        "n_replan_aborts": (chaos["n_replan_aborts"], 2),
        "n_replan_retries": (chaos["n_replan_retries"], 2),
        "n_recoveries": (chaos["n_recoveries"], 1),
        "n_lease_expirations": (chaos["n_lease_expirations"], 1),
        "parity_violations": (parity["parity_violations"], 0),
        "parity registry_divergence_windows": (
            parity["registry_divergence_windows"], 0),
    }
    bad = {k: v for k, v in want.items() if v[0] != v[1]}
    if bad:
        raise AssertionError(f"phase t: {bad} (got, want)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if peak_gb > T_PEAK_GB:
        raise AssertionError(f"phase t: {peak_gb:.2f} GB at peak, over its "
                             f"{T_PEAK_GB} GB budget")
    counts = read_counters(wrappers)
    elastic.clear_plan_cache()
    print(f"phase t (chaos trace replay, full width): counters={counts} "
          f"checks={ {k: v[0] for k, v in want.items()} } peak_gb="
          f"{peak_gb:.2f} seconds={time.perf_counter() - t_phase:.1f} "
          f"host_maxrss_gb={host_rss_gb():.2f}", flush=True)
    return counts


# -------------------------------------------------------- the MLP phase
def block_step_vs_masked(rt, job, batch) -> int:
    """One ``ServiceRuntime.step`` of ``job`` (kernel K3) held against the
    masked full-space step (the plain ``_adam_math``) on a clone of the
    state and the same batch; returns the largest ulp difference."""
    from repro_torch.ps.runtime import make_ps_train_step

    info = rt._jobs[job]
    oracle = make_ps_train_step(info["loss_fn"], rt.plan, info["abstract"],
                                lr=info["lr"], job_id=job,
                                update_mode="masked")
    want, _ = oracle({**state_clone(rt.state),
                      "counts": dict(rt.state["counts"])}, batch)
    rt.step(job, batch)
    ulp = max(ulp_diff(rt.state[k], want[k]) for k in ("flat", "mu", "nu"))
    if ulp > ULP_BUDGET:
        raise AssertionError(f"block step (K3) vs plain masked step: {ulp} ulp")
    return ulp


def mlp_phase(device, wrappers):
    """Two MLP jobs train through engine.step and ServiceRuntime.step
    (block kernel) on the device; losses must be finite and fall.  Then a
    compressed MLP job (int8) in two twin runtimes, one stepped through
    ``engine.step`` (K1), one through ``ServiceRuntime.step`` (K3), on the
    same batches: their flat/mu/nu/ef must be equal bit for bit."""
    from repro_torch.core import ParameterService
    from repro_torch.ps.service_runtime import ServiceRuntime

    gen = torch.Generator(device=device)
    gen.manual_seed(1)

    def init(d_in, gen=gen):
        r = lambda *s: torch.randn(*s, generator=gen, device=device)
        z = lambda n: torch.zeros(n, device=device)
        return {"w1": r(d_in, 64) / 4.0, "b1": z(64), "w2": r(64, 64) / 8.0,
                "b2": z(64), "w3": r(64, 1) / 8.0, "b3": z(1)}

    def loss(params, batch):
        h = torch.tanh(batch["x"] @ params["w1"] + params["b1"])
        h = torch.tanh(h @ params["w2"] + params["b2"])
        pred = (h @ params["w3"] + params["b3"])[:, 0]
        return torch.mean((pred - batch["y"]) ** 2)

    pool_x = torch.randn(256, 16, generator=gen, device=device)
    pool_y = torch.sin(pool_x.sum(1))

    def batch():
        sel = torch.randint(0, 256, (64,), generator=gen, device=device)
        return {"x": pool_x[sel], "y": pool_y[sel]}

    rt = ServiceRuntime(ParameterService(total_budget=16, n_clusters=1,
                                         plan_pad_to=128), device=device)
    eng = rt.attach_engine(max_staleness=1)
    for jid in ("mlp", "mlp2"):
        params = init(16)
        rt.add_job(jid, params, loss, required_servers=2, lr=3e-3,
                   agg_throughput=sum(4 * v.numel() for v in params.values())
                   / 0.45)
    reset_counters(wrappers)
    losses = {j: [] for j in rt.job_ids}
    for _ in range(20):
        for j in rt.job_ids:
            losses[j].append(float(eng.step(j, batch())["loss"]))
    eng.drain()
    direct = [float(rt.step(j, batch())["loss"]) for _ in range(5)
              for j in rt.job_ids]
    sync(device)
    counts = read_counters(wrappers)
    ulp = block_step_vs_masked(rt, "mlp", batch())

    # The compressed job: engine.step (K1) == ServiceRuntime.step (K3).
    batches = [batch() for _ in range(6)]
    twins = []
    for engine in (True, False):
        g_q = torch.Generator(device=device)
        g_q.manual_seed(2)
        rt_q = ServiceRuntime(ParameterService(
            total_budget=16, n_clusters=1, plan_pad_to=128), device=device)
        eng_q = rt_q.attach_engine(max_staleness=0) if engine else None
        params = init(16, g_q)
        rt_q.add_job("mlp_q", params, loss, required_servers=2, lr=3e-3,
                     agg_throughput=sum(4 * v.numel()
                                        for v in params.values()) / 0.45,
                     push_compression="int8")
        for b in batches:
            (eng_q.step if engine else rt_q.step)("mlp_q", b)
        if engine:
            eng_q.drain()
        twins.append(rt_q)
    for k in ("flat", "mu", "nu", "ef"):
        if not bits_equal(twins[0].state[k], twins[1].state[k]):
            raise AssertionError(
                f"phase d: the compressed MLP job's {k} through engine.step "
                f"differs from ServiceRuntime.step's (max abs "
                f"{max_abs(twins[0].state[k], twins[1].state[k])})")
    if not float(twins[0].state["ef"].abs().max()) > 0:
        raise AssertionError("phase d: the compressed job left ef zero")
    del twins
    sync(device)
    counts = read_counters(wrappers)
    for j, ls in losses.items():
        if not all(np.isfinite(ls)) or not np.mean(ls[-5:]) < np.mean(ls[:5]):
            raise AssertionError(f"MLP job {j}: losses not finite and "
                                 f"falling: {ls}")
    if not all(np.isfinite(direct)):
        raise AssertionError(f"block-kernel steps gave non-finite losses")
    print(f"phase d (MLP, engine.step x20 + ServiceRuntime.step x5 per job): "
          f"first={ {j: round(l[0], 5) for j, l in losses.items()} } "
          f"last={ {j: round(l[-1], 5) for j, l in losses.items()} } "
          f"direct_last={direct[-1]:.5f} counters={counts} "
          f"block_step_vs_plain_max_ulp={ulp}; compressed job mlp_q "
          f"(int8) x{len(batches)}: engine.step = ServiceRuntime.step "
          f"bit_for_bit (flat/mu/nu/ef)", flush=True)
    return counts


# ------------------------------------------------------ the Qwen phases
def qwen_batches(cfg, n, seed, device):
    """``n`` batches of 8 x 512 rows of a repeating 64-row synthetic
    corpus, labels shifted by one with the last masked (as
    examples/train_lm_e2e.py draws them), on the device."""
    rng = np.random.default_rng(seed)
    corpus = rng.integers(0, cfg.vocab, size=(64, QWEN_SEQ), dtype=np.int32)
    out = []
    for _ in range(n):
        toks = corpus[rng.integers(0, corpus.shape[0], size=QWEN_BATCH)]
        labels = np.concatenate(
            [toks[:, 1:], -np.ones((QWEN_BATCH, 1), np.int32)], axis=1)
        out.append({"tokens": torch.from_numpy(toks).to(device),
                    "labels": torch.from_numpy(labels).to(device)})
    return out


def clone_train_state(state):
    """A copy of ``{"params", "opt": AdamState}`` sharing no buffer."""
    from repro_torch.tree import tree_map

    opt = state["opt"]
    return {"params": tree_map(torch.clone, state["params"]),
            "opt": opt._replace(mu=tree_map(torch.clone, opt.mu),
                                nu=tree_map(torch.clone, opt.nu))}


def timed_steps(step, state, batches, device):
    """Run ``step`` over ``batches``; host time of each to a synchronize
    and each loss (reading it synchronizes too)."""
    times, losses = [], []
    for b in batches:
        sync(device)
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return state, times, losses


def check_losses(phase, losses):
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"phase {phase}: losses not finite and falling: "
                             f"{losses}")


def qwen_line(phase, times, losses, counts, peak, extra=""):
    tok = QWEN_BATCH * QWEN_SEQ
    med = statistics.median(times)
    return (f"phase {phase}: steps={len(times)} step_ms_median={med:.2f} "
            f"step_ms_first={times[0]:.2f} tokens_per_s={tok / med * 1e3:.0f}"
            f" loss_first={losses[0]:.4f} loss_last={losses[-1]:.4f} "
            f"counters={counts} max_memory_allocated_gb={peak / 1e9:.2f}"
            f"{extra}")


def optimizer_phase(cfg, device, wrappers):
    """Phase e: ``make_train_step`` with the fused optimizer for 10 steps,
    then one fused and one unfused step from one state, compared.
    Returns (counters, the trained state, seconds)."""
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adam
    from repro_torch.tree import tree_leaves_by_key, tree_map

    t_start = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, device)
    opt = adam(QWEN_LR, fused=True)
    step = tf.make_train_step(cfg, opt)
    state = {"params": params, "opt": opt.init(params)}
    batches = qwen_batches(cfg, 11, 0, device)
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    reset_counters(wrappers)
    state, times, losses = timed_steps(step, state, batches[:10], device)
    counts = read_counters(wrappers)
    peak = torch.cuda.max_memory_allocated()
    n_leaves = len(tree_leaves_by_key(params))
    if counts["agg_adam_dense"] != 10 * n_leaves:
        raise AssertionError(f"phase e: {counts['agg_adam_dense']} launches "
                             f"of K5 for 10 steps of {n_leaves} leaves")
    check_losses("e", losses)
    # The optimizer alone on the trained state (14 K5 launches).
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                           device=device, dtype=t.dtype)
                     * 1e-3, state["params"])
    c = clone_train_state(state)
    opt_ms = time_ms(lambda: opt.step(c["params"], grads, c["opt"]), device)
    del c, grads
    # One fused and one unfused step (launch.train's default adam(3e-4))
    # from the same state and batch.
    unfused = adam(QWEN_LR)
    st_u, st_f = clone_train_state(state), clone_train_state(state)
    st_u, _ = tf.make_train_step(cfg, unfused)(st_u, batches[10])
    st_f, _ = step(st_f, batches[10])
    diff, lanes, worst = 0.0, 0, 0.0
    for k, pf in tree_leaves_by_key(st_f["params"]).items():
        pu = tree_leaves_by_key(st_u["params"])[k]
        d = (pf.float() - pu.float()).abs()
        # 2 x lr: a gradient lane whose sign the two runs see differently;
        # one bf16 ulp (2^-7 relative at most): the two groupings round
        # the float32 update to bf16 on either side of a boundary.
        tol = 2 * QWEN_LR + 2.0 ** -7 * pu.float().abs()
        worst = max(worst, float((d / tol).max()))
        diff = max(diff, float(d.max()))
        lanes += int((d > 0).sum())
    if worst > 1.0:
        raise AssertionError(f"phase e: fused vs unfused step differ by "
                             f"{diff} ({worst:.3f} x the tolerance)")
    del st_u, st_f
    seconds = time.perf_counter() - t_start
    print(qwen_line("e (Qwen1.5-0.5B, make_train_step, fused adam)", times,
                    losses, counts, peak,
                    f" k5_per_step={counts['agg_adam_dense'] // 10} "
                    f"optimizer_step_ms={opt_ms:.3f} fused_vs_unfused_step:"
                    f" max_abs={diff:.3e} lanes_differing={lanes} "
                    f"of_tolerance={worst:.4f} seconds={seconds:.1f}"),
          flush=True)
    return counts, state


def ps_phase(cfg, device, wrappers):
    """Phase f: the single-job PS step (K5 over the whole flat space) for
    5 steps; its first step held against the plain ``_adam_math`` step.
    Returns (counters, the trained state, the plan)."""
    from repro_torch.models import transformer as tf
    from repro_torch.ps.runtime import (build_flat_plan, init_ps_state,
                                        make_ps_train_step)

    t_start = time.perf_counter()
    abstract = tf.init_params(cfg, device="meta")
    plan = build_flat_plan(abstract, n_shards=2)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    state = init_ps_state(plan, tf.init_params(cfg, gen, device))
    loss = lambda p, b: tf.loss_fn(cfg, p, b)  # noqa: E731
    step_k = make_ps_train_step(loss, plan, abstract, lr=QWEN_LR,
                                fused_kernel=True)
    step_p = make_ps_train_step(loss, plan, abstract, lr=QWEN_LR,
                                fused_kernel=False)
    batches = qwen_batches(cfg, 5, 1, device)
    want, _ = step_p({**state_clone(state), "count": state["count"]},
                     batches[0])
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    reset_counters(wrappers)
    state, times, losses = timed_steps(step_k, state, batches[:1], device)
    ulp = max(ulp_diff(state[k], want[k]) for k in ("flat", "mu", "nu"))
    del want
    if ulp > ULP_BUDGET:
        raise AssertionError(f"phase f: K5 step vs plain step: {ulp} ulp")
    torch.cuda.reset_peak_memory_stats()  # the oracle's copy is gone
    state, t2, l2 = timed_steps(step_k, state, batches[1:], device)
    times, losses = times + t2, losses + l2
    counts = read_counters(wrappers)
    peak = torch.cuda.max_memory_allocated()
    if counts["agg_adam_dense"] != 5:
        raise AssertionError(f"phase f: {counts['agg_adam_dense']} launches "
                             f"of K5 for 5 steps")
    check_losses("f", losses)
    print(qwen_line(
        "f (Qwen1.5-0.5B, single-job PS step, fused_kernel=True)", times,
        losses, counts, peak,
        f" (peak over steps 2-5) flat_len={plan.total_len} shards="
        f"{plan.n_shards} "
        f"first_step_vs_plain_max_ulp={ulp} seconds="
        f"{time.perf_counter() - t_start:.1f}"), flush=True)
    return counts, state, plan


def k5_entry(p, g, mu, nu, device, what):
    """K5 on clones of one real buffer set: bit for bit against its plain
    version, then timed beside the plain version and
    ``torch.optim.Adam(fused=True)`` on the same tensors."""
    from repro_torch.kernels.agg_adam import ops as agg_ops
    from repro_torch.kernels.agg_adam import ref as agg_ref

    count, kw = 11, dict(lr=QWEN_LR, b1=0.9, b2=0.999, eps=1e-8, wd=0.0)
    hp = agg_ops.multi_job_hp([count], **kw).to(device)
    kern = [t.clone() for t in (p, mu, nu)]
    agg_ops.aggregate_adam(kern[0], g, kern[1], kern[2], count, **kw)
    plain = [t.clone() for t in (p, mu, nu)]
    agg_ref.aggregate_adam_plain(plain[0], g, plain[1], plain[2], hp)
    err = max(max_abs(a.float(), b.float()) for a, b in zip(kern, plain))
    if not all(bits_equal(a, b) for a, b in zip(kern, plain)):
        raise AssertionError(f"K5 ({what}) differs from its plain version: "
                             f"max abs {err}")
    del plain
    ms = time_ms(lambda: agg_ops.aggregate_adam(
        kern[0], g, kern[1], kern[2], count, **kw), device)
    plain_ms = time_ms(lambda: agg_ref.aggregate_adam_plain(
        kern[0], g, kern[1], kern[2], hp), device, reps=3, warmup=1)
    del kern
    param = torch.nn.Parameter(p.clone())
    param.grad = g.clone()
    lib = torch.optim.Adam([param], lr=QWEN_LR, fused=True)
    library_ms = time_ms(lib.step, device)
    del param, lib
    n = p.numel()
    nbytes = n * (2 * p.element_size() + g.element_size() + 16)
    b, by = bound_ms(nbytes, n * ADAM_FLOPS_PER_LANE)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=library_ms, max_abs_err=err, max_ulp=0,
                shape=f"{what}: N={n} p {str(p.dtype)[6:]} g "
                      f"{str(g.dtype)[6:]}")


def k5_small_checks(device):
    """K5 on (W=4, N) gradients, a ragged N, and an unaligned bf16 view
    (the kernel's scalar path), against its plain version bit for bit."""
    from repro_torch.kernels.agg_adam import ops as agg_ops
    from repro_torch.kernels.agg_adam import ref as agg_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    n = (1 << 20) + 3
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    hp = agg_ops.multi_job_hp([3], **kw).to(device)
    r = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa
    buf = r(n + 1).bfloat16()
    cases = {"W=4 f32 p, f32 g": (r(n), r(4, n)),
             "W=4 bf16 p, bf16 g": (r(n).bfloat16(), r(4, n).bfloat16()),
             "unaligned bf16 p": (buf[1:], r(n).bfloat16())}
    for name, (p, g) in cases.items():
        mu, nu = r(n) * 0.1, r(n).abs() * 0.01
        kern = [t.clone() for t in (p, mu, nu)]
        plain = [t.clone() for t in (p, mu, nu)]
        if name.startswith("unaligned"):  # keep the odd offset
            kern[0] = torch.cat([buf[:1], p])[1:]
        agg_ops.aggregate_adam(kern[0], g, kern[1], kern[2], 3, **kw)
        agg_ref.aggregate_adam_plain(plain[0], g, plain[1], plain[2], hp)
        if not all(bits_equal(a, b) for a, b in zip(kern, plain)):
            raise AssertionError(f"K5 {name}: differs from its plain version")
    print(f"K5 small checks (N={n}): {', '.join(cases)}: bit for bit",
          flush=True)


# ------------------------------------------------------ the serving phases
def logits_check(what, got, want, rel_rms=None, max_frac=None):
    """The bf16 logit tolerance (LOGIT_REL_RMS, LOGIT_MAX_FRAC, or the
    limits given); returns the numbers it compared."""
    rel_rms = LOGIT_REL_RMS if rel_rms is None else rel_rms
    max_frac = LOGIT_MAX_FRAC if max_frac is None else max_frac
    got, want = got.float(), want.float()
    d = got - want
    out = dict(max_abs=float(d.abs().max()),
               rel_rms=float(d.norm() / want.norm()),
               max_ref=float(want.abs().max()),
               argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean()))
    if not (all(np.isfinite([out["max_abs"], out["rel_rms"]]))
            and out["rel_rms"] <= rel_rms
            and out["max_abs"] <= max_frac * out["max_ref"]):
        raise AssertionError(f"{what}: logits outside the tolerance (rel "
                             f"RMS <= {rel_rms}, max abs <= {max_frac} x "
                             f"max |ref|): {out}")
    return out


def fmt_check(c):
    return (f"max_abs={c['max_abs']:.4f} rel_rms={c['rel_rms']:.5f} "
            f"max_ref={c['max_ref']:.3f} argmax_agree={c['argmax_agree']:.4f}")


def serve_phase(cfg, device, wrappers, batch, prompt_len, gen_len):
    """Phase g: host the weights, read them through the replicas, take
    versioned diff pulls of two jobs across two ticks, then decode and hold
    the last prompt step against the K7 prefill.  Returns (counters, the
    served bf16 weights)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    t_start = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    params = tf.init_params(cfg, gen, device)
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    reset_counters(wrappers)
    timings = {}
    t0 = time.perf_counter()
    served, rs = serve._pull_params_via_replicas(params, 2, timings)
    sync(device)
    host_s = time.perf_counter() - t0
    del params
    eng = rs.engine
    plan = eng.plan
    layout = plan.job_layout("lm")
    fresh = dataclasses.replace(plan)  # same plan, empty layout caches
    t0 = time.perf_counter()
    fresh.job_layout("lm")
    layout_s = time.perf_counter() - t0
    del fresh
    print(f"phase g set-up: hosted lm lanes={plan.total_len} payload="
          f"{plan.payload_elements} shards={plan.n_shards} add_job_s="
          f"{timings['add_job_s']:.2f} (job_layout_s={layout_s:.2f}) "
          f"publish_and_pull_s={timings['publish_and_pull_s']:.2f} "
          f"host_to_served_s={host_s:.2f} served_bit_exact=True "
          f"publishes={rs.n_publishes}", flush=True)
    # A second, small job on the same service (lr > 0, so its weights
    # move), then one tick per job, each applying one job's push: every
    # diff pull must select the pushed job's blocks and no block of the
    # other, and patch onto the client's vector to equal a full pull.
    n_side = 1 << 20
    t0 = time.perf_counter()
    eng.runtime.add_job("side", {"w": torch.randn(n_side, generator=gen,
                                                  device=device)},
                        _no_model_loss, lr=1e-3, required_servers=1,
                        agg_throughput=4 * n_side / 0.2)
    side_s = time.perf_counter() - t0
    rs.refresh()  # the replan bumped the epoch: publish the new layout
    layouts = {j: eng.plan.job_layout(j) for j in ("lm", "side")}
    have = {}
    for j, lay in layouts.items():
        d0 = rs.pull(j, since_version=0)
        if not d0.full or d0.data.numel() != lay.packed_len:
            raise AssertionError(f"phase g: the first versioned pull of {j} "
                                 f"is not full")
        have[j] = (d0.version, d0.data)
    wire = []
    for pushed in ("lm", "side"):
        lay = layouts[pushed]
        mask = torch.zeros(lay.packed_len, dtype=torch.bool)
        for _, start, size, _, _ in lay.slots:
            mask[start:start + size] = True
        g = (torch.randn(lay.packed_len, generator=gen, device=device) * 1e-3
             * mask.to(device))
        eng.submit_packed(pushed, g)
        if eng.tick() != 1:
            raise AssertionError(f"phase g: the tick did not apply the push "
                                 f"of {pushed}")
        del g, mask
        rs.refresh()
        for j, (version, data) in have.items():
            d1 = rs.pull(j, since_version=version)
            patched = d1.apply(data)
            full = eng.pull(j, since_version=0).data
            want = layouts[j].blocks.size if j == pushed else 0
            if d1.full or d1.block_ids.size != want:
                raise AssertionError(
                    f"phase g: after a tick of {pushed}, the diff pull of "
                    f"{j} shipped {d1.block_ids.size} blocks (full="
                    f"{d1.full}), expected {want}")
            if not bits_equal(patched, full):
                raise AssertionError(f"phase g: the patched diff pull of {j} "
                                     f"differs from a full pull")
            # lm has lr 0: its weights stay put; side's move when pushed.
            moves = j == pushed == "side"
            if bits_equal(full, data) == moves:
                raise AssertionError(
                    f"phase g: {j}'s weights {'stayed' if moves else 'moved'}"
                    f" across a tick of {pushed}")
            wire.append(f"{pushed}-tick/{j}: {d1.block_ids.size} of "
                        f"{layouts[j].blocks.size} blocks {d1.bytes_wire} of "
                        f"{d1.bytes_full} B")
            have[j] = (d1.version, patched)
            del d1, full
    print(f"phase g versioned pulls (side job {n_side} lanes, add_job_s="
          f"{side_s:.2f}): {'; '.join(wire)} patched_equals_full_pull=True "
          f"tick_launches={eng.stats.n_launches} publishes={rs.n_publishes}",
          flush=True)
    service_peak = torch.cuda.max_memory_allocated()
    # The service's objects refer to each other: collect them now.
    del have, patched, rs, eng, plan, layout, layouts
    gc.collect()
    torch.cuda.empty_cache()
    # KV-cache decode at batch 16.
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt_len), dtype=np.int32)).to(device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve.decode(cfg, served, prompt, gen_len)
    decode_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = out["gen_s"] * 1e3 / (gen_len - 1)
    tokens = out["tokens"]
    if tokens.shape != (batch, gen_len) or not (
            (tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"phase g: bad tokens {tuple(tokens.shape)}")
    # The last prompt step against the K7 prefill of the prompt.
    pre = tf.make_prefill(cfg)(served, prompt)
    check = logits_check("phase g decode vs K7 prefill", out["prompt_logits"],
                         pre)
    sync(device)
    counts = read_counters(wrappers)
    if counts["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"phase g: {counts['flash_attention']} K7 "
                             f"launches for one {cfg.n_layers}-layer prefill")
    print(f"phase g (Qwen serve: replicas x2, decode batch={batch} prompt="
          f"{prompt_len} gen={gen_len}): decode_ms_per_step={step_ms:.3f} "
          f"(window {out['gen_s']:.3f} s for {gen_len - 1} steps) "
          f"tokens_per_s={batch / step_ms * 1e3:.0f} "
          f"decode_with_prompt_s={decode_s:.2f} "
          f"decode_vs_prefill: {fmt_check(check)} counters={counts} "
          f"service_peak_gb={service_peak / 1e9:.2f} "
          f"decode_max_memory_allocated_gb={peak / 1e9:.2f} first_tokens="
          f"{tokens[0, :8].tolist()} seconds="
          f"{time.perf_counter() - t_start:.1f}", flush=True)
    return counts, served


def prefill_phase(what, cfg, params, device, wrappers, seq, runs=3):
    """Phases h, m, n and p: ``make_prefill`` of one seeded (1, ``seq``)
    prompt, ``runs`` times (its default route: K7 once a GQA layer a run,
    none for MLA), then, where that route is K7, the same prefill through
    the plain chunked attention, held within the bf16 logit tolerance.
    Returns the launch counts."""
    from repro_torch.models import transformer as tf

    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, seq),
                                         dtype=np.int32)).to(device)
    prefill = tf.make_prefill(cfg)
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    reset_counters(wrappers)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        logits = prefill(params, toks)
        sync(device)
        times.append(time.perf_counter() - t0)
    counts = read_counters(wrappers)
    peak = torch.cuda.max_memory_allocated()
    flash = cfg.mla is None
    want_k7 = runs * cfg.n_layers if flash else 0
    if counts["flash_attention"] != want_k7:
        raise AssertionError(f"{what}: {counts['flash_attention']} K7 "
                             f"launches for {runs} prefills, expected "
                             f"{want_k7}")
    if logits.shape != (1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"{what}: bad logits {tuple(logits.shape)}")
    extra = ""
    if flash:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plain = tf.make_prefill(cfg, attention="plain")(params, toks)
        sync(device)
        plain_s = time.perf_counter() - t0
        if read_counters(wrappers)["flash_attention"] != want_k7:
            raise AssertionError(f"{what}: the plain prefill launched K7")
        check = logits_check(f"{what} K7 vs chunked prefill", logits, plain)
        extra = (f" chunked_attention_prefill_s={plain_s:.3f} (peak "
                 f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB) "
                 f"k7_vs_chunked: {fmt_check(check)}")
        del plain
    med = statistics.median(times)
    print(f"{what} (make_prefill, seq={seq} batch=1, "
          f"{'K7' if flash else 'plain chunked attention'}, attn_chunk_k="
          f"{cfg.attn_chunk_k} moe_groups={cfg.moe_groups}): "
          f"prefill_s_median={med:.3f} prefill_s="
          f"{[round(t, 3) for t in times]} tokens_per_s={seq / med:.0f} "
          f"counters={counts} max_memory_allocated_gb={peak / 1e9:.2f}"
          f"{extra}", flush=True)
    del logits
    free_device()
    return counts


def k7_bound(b, s, h, d, elem, hk=None):
    """Least time for one causal K7 call: every (query, visible key) pair
    costs 4 D operations (q.k and p.v), S (S + 1) / 2 pairs per query
    head; the bytes are q, k, v (``hk`` kv heads, default ``h``) read once
    and o written once."""
    hk = h if hk is None else hk
    flops = 4 * d * b * h * s * (s + 1) / 2
    return bound_ms(2 * b * s * (h + hk) * d * elem, flops, BF16_FLOPS)


def k7_compare(kern: torch.Tensor, plain: torch.Tensor) -> dict:
    """How far a bf16 K7 output (B, S, H, D) lies from its plain version:
    the largest absolute difference, the least atol at which every element
    passes at rtol K7_BF16_RTOL, and the largest relative L2 difference of
    one (query row, head) over D; ``ok`` when both are within limits."""
    kern, plain = kern.float(), plain.float()
    diff = (kern - plain).abs()
    row = diff.norm(dim=-1) / plain.norm(dim=-1).clamp_min(1e-30)
    atol = float((diff - K7_BF16_RTOL * plain.abs()).max())
    rel = float(row.max())
    return dict(max_abs=float(diff.max()), atol_needed=atol, max_row_rel=rel,
                ok=atol <= K7_BF16_ATOL and rel <= K7_ROW_REL)


def k7_plain_bf16_p(q, k, v, *, causal=True, bk=128) -> torch.Tensor:
    """The plain version with the bf16 kernel's rounding: scores in
    float32, the online softmax over key tiles of ``bk`` in base 2 with the
    scale folded in (p = 2^(s c - m c), m the running maximum), each tile's
    P rounded to bf16 for P V while its sum stays in float32, O divided by
    max(l, 1e-30) at the end; every kv head read by its GQA group."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    c = d ** -0.5 * 1.4426950408889634
    qf = q.float().transpose(1, 2)  # (B, HQ, S_q, D)
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(hq // hk, dim=1)
              for t in (k, v))
    m = torch.full((b, hq, sq, 1), float("-inf"), device=q.device)
    l = torch.zeros(b, hq, sq, 1, device=q.device)
    o = torch.zeros(b, hq, sq, d, device=q.device)
    rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    for j0 in range(0, sk, bk):
        j1 = min(sk, j0 + bk)
        s = qf @ kf[:, :, j0:j1].transpose(-1, -2)
        if causal:
            keys = torch.arange(j0, j1, device=q.device)[None, :]
            s = s.masked_fill(keys > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        mc = torch.where(m_new == float("-inf"), 0.0, m_new * c)
        a = torch.exp2(m * c - mc)
        p = torch.exp2(s * c - mc)
        l = l * a + p.sum(-1, keepdim=True)
        o = o * a + p.to(torch.bfloat16).float() @ vf[:, :, j0:j1]
        m = m_new
    return (o / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


def fmt_k7(c: dict) -> str:
    return (f"max_abs={c['max_abs']:.4e} atol_needed={c['atol_needed']:.4e} "
            f"(limit {K7_BF16_ATOL:g} at rtol {K7_BF16_RTOL:g}) max_row_rel="
            f"{c['max_row_rel']:.4e} (limit {K7_ROW_REL:g})")


def k7_path_inputs(device, shape, hk=None):
    """q, k, v (bf16, N(0, 1), seeded) at one layer's prefill shape, k and
    v with ``hk`` heads (default q's)."""
    b, s, h, d = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    return tuple(torch.randn(sh, generator=gen, device=device
                             ).to(torch.bfloat16)
                 for sh in (shape, (b, s, hk or h, d), (b, s, hk or h, d)))


def k7_entry(device, shape, hk=None):
    """K7 at one layer's prefill shape (bf16, causal; ``hk`` kv heads for
    GQA) against its plain version, timed beside the plain version and
    ``scaled_dot_product_attention`` on the same tensors."""
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn import ref as fa_ref

    b, s, h, d = shape
    q, k, v = k7_path_inputs(device, shape, hk)
    kern = fa_ops.flash_attention(q, k, v, causal=True)
    plain = fa_ref.flash_attention_plain(q, k, v, causal=True)
    cmp = k7_compare(kern, plain)
    print(f"K7 at {shape} kv heads {hk or h} bf16 causal vs plain: "
          f"{fmt_k7(cmp)}", flush=True)
    if not cmp["ok"]:
        raise AssertionError(f"K7 differs from its plain version at {shape}: "
                             f"{fmt_k7(cmp)}")
    err = cmp["max_abs"]
    del kern, plain
    ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True),
                 device, reps=5, warmup=1, inner=2)
    plain_ms = time_ms(lambda: fa_ref.flash_attention_plain(q, k, v),
                       device, reps=3, warmup=1, inner=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = {"enable_gqa": True} if hk else {}
    library_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True, **gqa),
                         device)
    bnd, by = k7_bound(b, s, h, d, 2, hk)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=library_ms, max_abs_err=err, max_ulp=None,
                shape=f"(B,S,H,D)={shape}"
                      + (f" HK={hk}" if hk else "") + " bf16 causal")


def k7_small_checks(device):
    """K7 against its plain version on small cases, in float32 (the SIMT
    kernel, rtol/atol 2e-5) and in bfloat16 (the Hopper kernel, by
    ``k7_compare``'s limits): non-causal, ragged S (padded keys), causal
    with S_q < S_k (the bottom-right offset), GQA, head dim 128 (ragged,
    causal and not), q, k, v as strided views of one fused (B, S, 3, H, D)
    tensor, and one bf16 case on an unaligned view, which the wrapper
    copies first.  Then more head dim 128 cases, from a generator of their
    own (the cases above draw what they always drew): MHA, GQA groups of
    3, 4 and 12, a ragged S edge, causal with S_q < S_k, q, k, v as
    strided views of one fused (B, S, HQ + 2 HK, D) projection, and causal
    S_q = S_k (the prefill's own mask).  That last one is held, in bf16,
    against :func:`k7_plain_bf16_p`, the plain version with the kernel's P
    in bf16: with a few keys a row the P rounding alone moves outputs by
    up to 3.3e-3 against the float32-P plain version, over the limit's
    2.5e-3 of atol (set at the prefill shape); that reading is printed.
    A bf16 call at head dim 32 must raise ValueError."""
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn import ref as fa_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    gen_d128 = torch.Generator(device=device)
    gen_d128.manual_seed(9)
    cases = {  # name: (B, S_q, S_k, HQ, HK, D, causal)
        "non-causal S=256": (2, 256, 256, 4, 4, 64, False),
        "ragged S=200 causal": (1, 200, 200, 4, 4, 64, True),
        "ragged S=1000 non-causal": (1, 1000, 1000, 4, 4, 64, False),
        "causal S_q=300 S_k=1000": (1, 300, 1000, 4, 4, 64, True),
        "GQA HQ=8 HK=2 S=384": (1, 384, 384, 8, 2, 64, True),
        "D=128 S=300": (1, 300, 300, 4, 4, 128, True),
        "D=128 ragged S=1000 non-causal": (1, 1000, 1000, 2, 2, 128, False),
        "fused (B,S,3,H,D) views S=520": (2, 520, 520, 4, 4, 64, True),
    }
    d128 = {  # head dim 128
        "D=128 MHA causal S_q=300 S_k=1000": (1, 300, 1000, 4, 4, 128, True),
        "D=128 GQA group 3 causal S_q=384 S_k=1000": (
            1, 384, 1000, 6, 2, 128, True),
        "D=128 GQA group 4 causal S_q=300 S_k=1000": (
            1, 300, 1000, 8, 2, 128, True),
        "D=128 GQA group 12 causal S_q=256 S_k=640": (
            1, 256, 640, 24, 2, 128, True),
        "D=128 GQA group 4 ragged S=1000 non-causal": (
            2, 1000, 1000, 8, 2, 128, False),
        "D=128 GQA group 12 ragged S_q=200 S_k=520 causal": (
            1, 200, 520, 24, 2, 128, True),
        "fused (B,S,HQ+2HK,D) views D=128 group 4 S=520 non-causal": (
            2, 520, 520, 8, 2, 128, False),
        "D=128 GQA group 4 causal S=520, P in bf16": (
            1, 520, 520, 8, 2, 128, True),
    }
    worst = {"float32": 0.0, "atol_needed": -1.0, "max_row_rel": 0.0}
    p_bf16 = {}  # the bf16-P case against both plain versions

    def check(name, b, sq, sk, hq, hk, d, causal, dtype, gen):
        if name.startswith("fused (B,S,3"):
            x = torch.randn(b, sk, 3, hq, d, generator=gen,
                            device=device).to(dtype)
            q, k, v = x[:, :sq, 0], x[:, :, 1], x[:, :, 2]
        elif name.startswith("fused"):
            x = torch.randn(b, sk, hq + 2 * hk, d, generator=gen,
                            device=device).to(dtype)
            q, k, v = x[:, :sq, :hq], x[:, :, hq:hq + hk], x[:, :, hq + hk:]
        else:
            q = torch.randn(b, sq, hq, d, generator=gen, device=device)
            k, v = (torch.randn(b, sk, hk, d, generator=gen, device=device)
                    for _ in range(2))
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        if dtype == torch.bfloat16 and name.startswith("ragged S=200"):
            # an unaligned view (row stride 65 elements)
            q = torch.nn.functional.pad(q, (0, 1))[..., :d]
        kern = fa_ops.flash_attention(q, k, v, causal=causal)
        plain = fa_ref.flash_attention_plain(q, k, v, causal=causal)
        if dtype == torch.bfloat16 and name.endswith("P in bf16"):
            p_bf16[name] = {"P in float32 (not held)": k7_compare(kern, plain)}
            plain = k7_plain_bf16_p(q, k, v, causal=causal,
                                    bk=fa_ops.BF16_TILES[d][1])
            p_bf16[name]["P in bf16"] = k7_compare(kern, plain)
        if dtype == torch.float32:
            err = max_abs(kern, plain)
            worst["float32"] = max(worst["float32"], err)
            if not torch.allclose(kern, plain, rtol=K7_F32_TOL,
                                  atol=K7_F32_TOL):
                raise AssertionError(f"K7 {name} float32: differs from its "
                                     f"plain version by {err}")
            return
        cmp = k7_compare(kern, plain)
        for key in ("atol_needed", "max_row_rel"):
            worst[key] = max(worst[key], cmp[key])
        if not cmp["ok"]:
            raise AssertionError(f"K7 {name} bfloat16: {fmt_k7(cmp)}")

    for group, g in ((cases, gen), (d128, gen_d128)):
        for dtype in (torch.float32, torch.bfloat16):
            for name, case in group.items():
                check(name, *case, dtype, g)
    q32 = torch.zeros(1, 64, 2, 32, dtype=torch.bfloat16, device=device)
    try:
        fa_ops.flash_attention(q32, q32, q32)
    except ValueError as exc:
        refused = str(exc)
    else:
        raise AssertionError("K7: a bf16 call at head dim 32 did not raise")
    print(f"K7 small checks ({', '.join([*cases, *d128])}): float32 max "
          f"abs {worst['float32']:.3e} (rtol/atol {K7_F32_TOL:g}); bfloat16 "
          f"atol_needed {worst['atol_needed']:.3e} (limit {K7_BF16_ATOL:g} "
          f"at rtol {K7_BF16_RTOL:g}) max_row_rel {worst['max_row_rel']:.3e} "
          f"(limit {K7_ROW_REL:g}; the S=200 case on an unaligned view); "
          f"bf16 at D=32 refused: {refused}; "
          + "; ".join(f"{n} against the plain version with {ref}: "
                      f"{fmt_k7(c)}" for n, by in p_bf16.items()
                      for ref, c in by.items()), flush=True)


def k7_sass_counts(lib_path) -> dict:
    """Counts of wgmma (HGMMA), TMA load (UTMALDG) and mma.sync (HMMA)
    instructions in the built flash attention library's SASS; raises
    unless the bf16 kernel has wgmma and TMA and no mma.sync is left."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    # "/*0450*/  @!P0 HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], ... ;"
    ops = re.findall(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)",
                     sass)
    counts = {op: ops.count(op) for op in ("HGMMA", "UTMALDG", "HMMA")}
    print(f"K7 SASS ({Path(lib_path).name}): {counts}", flush=True)
    if counts["HGMMA"] == 0 or counts["UTMALDG"] == 0 or counts["HMMA"]:
        raise AssertionError(f"K7's library: expected wgmma and TMA and no "
                             f"mma.sync, got {counts}")
    return counts


# ------------------------------------------------------ the recsys phases
def grads_bits_equal(a, b) -> bool:
    from repro_torch.tree import tree_leaves_by_key

    la, lb = tree_leaves_by_key(a), tree_leaves_by_key(b)
    return la.keys() == lb.keys() and all(bits_equal(la[k], lb[k])
                                          for k in la)


def dlrm_train_phase(device, wrappers, full):
    """Phase i: DLRM-RM2 through ``launch/train.build`` (adagrad(0.01)),
    DLRM_STEPS steps at the train_batch cell's batch.  Before them, on the
    first step's inputs: the loss and every gradient twice through K6
    (equal bit for bit) and once through its plain version (the loss and
    the gradients bit for bit), then that step's Adagrad update from each
    route's gradients, leaf by leaf on clones, bit for bit.  Returns
    (counters, config, trained params, the first 4 batches' ids)."""
    from repro_torch.configs import dlrm_rm2
    from repro_torch.launch import train
    from repro_torch.models import recsys
    from repro_torch.optim import AdagradState
    from repro_torch.tree import tree_leaves_by_key, value_and_grad

    t_start = time.perf_counter()
    cfg = dlrm_rm2.config() if full else dlrm_rm2.smoke_config()
    batch = dlrm_rm2.TRAIN_BATCH if full else 256
    torch.cuda.reset_peak_memory_stats()
    init_state, step, batch_fn, _ = train.build("dlrm-rm2", not full, batch,
                                                0, device)
    state = init_state()
    batches = [batch_fn() for _ in range(DLRM_STEPS)]
    sync(device)
    init_s = time.perf_counter() - t_start
    params, opt_state = state["params"], state["opt"]
    table_gb = sum(t.numel() * t.element_size()
                   for t in params["tables"]) / 1e9
    grad = {lk: value_and_grad(lambda p, b, lk=lk: recsys.dlrm_loss(
        cfg, p, b, lookup=lk)) for lk in ("kernel", "plain")}
    loss_k, g_k = grad["kernel"](params, batches[0])
    loss_2, g_2 = grad["kernel"](params, batches[0])
    if not (bits_equal(loss_k, loss_2) and grads_bits_equal(g_k, g_2)):
        raise AssertionError("phase i: two identical backward passes differ")
    del g_2
    loss_p, g_p = grad["plain"](params, batches[0])
    if not (bits_equal(loss_k, loss_p) and grads_bits_equal(g_k, g_p)):
        raise AssertionError("phase i: the K6 step's loss or gradients "
                             "differ from the plain lookup's")
    # The update from each route's gradients, one leaf at a time: a
    # second copy of the tables and accumulators would not fit beside
    # them and the two gradient trees.
    opt = train._recsys(cfg, None, 0)[0]
    accum = tree_leaves_by_key(opt_state.accum)
    gk, gp = tree_leaves_by_key(g_k), tree_leaves_by_key(g_p)
    for k, p in tree_leaves_by_key(params).items():
        outs = []
        for g in (gk[k], gp[k]):
            pc, ac = p.clone(), accum[k].clone()
            opt.step({"x": pc}, {"x": g}, AdagradState({"x": ac}, 0))
            outs.append((pc, ac))
        if not all(bits_equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"phase i: the updated {k} differs between "
                                 f"the K6 and the plain lookup's step")
        del outs
    del g_k, g_p, gk, gp, accum
    check_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(wrappers)
    state, times, losses = timed_steps(step, state, batches, device)
    counts = read_counters(wrappers)
    peak = torch.cuda.max_memory_allocated()
    if counts["embed_bag"] != DLRM_STEPS:
        raise AssertionError(f"phase i: {counts['embed_bag']} K6 launches "
                             f"for {DLRM_STEPS} steps (one a forward)")
    if losses[0] != float(loss_k):
        raise AssertionError(f"phase i: the first step's loss {losses[0]} "
                             f"is not the checked {float(loss_k)}")
    check_losses("i", losses)
    med = statistics.median(times)
    print(f"phase i (DLRM-RM2 train, {cfg.name}: {cfg.n_sparse} tables, "
          f"{cfg.table_rows} padded rows x {cfg.embed_dim} {cfg.dtype}, "
          f"{table_gb:.2f} GB; batch={batch}, adagrad(0.01)): steps="
          f"{len(times)} step_ms_median={med:.2f} step_ms_first="
          f"{times[0]:.2f} items_per_s={batch / med * 1e3:.0f} loss_first="
          f"{losses[0]:.5f} loss_last={losses[-1]:.5f} counters={counts} "
          f"k6_per_step={counts['embed_bag'] / DLRM_STEPS:g} "
          f"max_memory_allocated_gb={peak / 1e9:.2f} (the checks: "
          f"{check_peak / 1e9:.2f}) first_step_vs_plain_lookup: loss, "
          f"gradients and updated leaves bit for bit; two backward passes "
          f"bit for bit; init_s={init_s:.2f} seconds="
          f"{time.perf_counter() - t_start:.1f}", flush=True)
    return counts, cfg, state["params"], [b["sparse"] for b in batches[:4]]


def dlrm_score_phase(cfg, params, device, wrappers, full):
    """Phase j: ``dlrm_forward`` at the serve_p99 and serve_bulk cells'
    batches and ``dlrm_retrieval`` at retrieval_cand's candidates, under
    ``torch.inference_mode()``; the serve_p99 logits held against the
    plain lookup's bit for bit.  Returns the counters."""
    from repro_torch.configs import dlrm_rm2
    from repro_torch.data import recsys_batch
    from repro_torch.models import recsys

    sizes = ((dlrm_rm2.SERVE_P99, dlrm_rm2.SERVE_BULK,
              dlrm_rm2.RETRIEVAL_CAND) if full else (64, 512, 1000))
    rng = np.random.default_rng(3)
    host = {n: recsys_batch(rng, n, cfg.n_dense, cfg.vocab_sizes)
            for n in sizes[:2]}
    cand = torch.from_numpy(rng.integers(0, cfg.vocab_sizes[-1], sizes[2],
                                         dtype=np.int32)).to(device)
    out = []
    with torch.inference_mode():
        dev = {n: {k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for n, b in host.items()}
        p99 = dev[sizes[0]]
        want = recsys.dlrm_forward(cfg, params, p99["dense"], p99["sparse"],
                                   lookup="plain")
        got = recsys.dlrm_forward(cfg, params, p99["dense"], p99["sparse"])
        if not bits_equal(got, want):
            raise AssertionError("phase j: serve_p99 logits differ from the "
                                 "plain lookup's")
        sync(device)
        reset_counters(wrappers)
        runs = {"serve_p99": (sizes[0], 10), "serve_bulk": (sizes[1], 3),
                "retrieval_cand": (sizes[2], 3)}
        for cell, (n, reps) in runs.items():
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(reps):
                sync(device)
                t0 = time.perf_counter()
                if cell == "retrieval_cand":
                    b = dev[sizes[0]]
                    logits = recsys.dlrm_retrieval(
                        cfg, params, b["dense"][:1], b["sparse"][:1, :-1],
                        cand)
                else:
                    b = dev[n]
                    logits = recsys.dlrm_forward(cfg, params, b["dense"],
                                                 b["sparse"])
                sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
            if logits.shape != (n,) or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"phase j {cell}: logits of shape "
                                     f"{tuple(logits.shape)}, finite="
                                     f"{bool(torch.isfinite(logits).all())}")
            med = statistics.median(times)
            out.append(f"{cell} batch={n} ms_median={med:.3f} (of {reps}) "
                       f"items_per_s={n / med * 1e3:.0f} peak_gb="
                       f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
            del logits
    counts = read_counters(wrappers)
    if counts["embed_bag"] != sum(r for _, r in runs.values()):
        raise AssertionError(f"phase j: {counts['embed_bag']} K6 launches "
                             f"(one a forward)")
    print(f"phase j (DLRM-RM2 scoring, inference_mode): {'; '.join(out)} "
          f"counters={counts} p99_vs_plain_lookup=bit_for_bit", flush=True)
    return counts


def recsys_train_phase(arch, batch, device, full, steps=3):
    """Phase k: ``steps`` steps of ``launch/train.build(arch)`` (adam(1e-3);
    plain PyTorch, no TPU kernel in either package); losses finite.
    Before them, the loss and every gradient of the first batch twice,
    bit for bit (the embeddings' gathers are ``F.embedding``, whose CUDA
    backward summed repeated ids in a run-dependent order for DLRM-RM2)."""
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves_by_key, value_and_grad

    t_start = time.perf_counter()
    init_state, step, batch_fn, _ = train.build(arch, not full, batch, 0,
                                                device)
    torch.cuda.reset_peak_memory_stats()
    state = init_state()
    batches = [batch_fn() for _ in range(steps)]
    cfg = registry.get_config(arch) if full else registry.get_smoke_config(arch)
    grad = value_and_grad(train._recsys(cfg, None, 0)[1])
    loss_1, g_1 = grad(state["params"], batches[0])
    loss_2, g_2 = grad(state["params"], batches[0])
    la, lb = tree_leaves_by_key(g_1), tree_leaves_by_key(g_2)
    differ = {k: (int((la[k] != lb[k]).sum()),
                  float((la[k] - lb[k]).abs().max()))
              for k in la if not bits_equal(la[k], lb[k])}
    if differ or not bits_equal(loss_1, loss_2):
        raise AssertionError(f"phase k {arch}: two identical backward passes "
                             f"differ: loss {float(loss_1)} vs "
                             f"{float(loss_2)}; leaves (lanes, max diff) "
                             f"{differ}")
    del g_1, g_2, la, lb
    state, times, losses = timed_steps(step, state, batches, device)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"phase k {arch}: losses not finite: {losses}")
    med = statistics.median(times)
    print(f"phase k ({arch} train, batch={batch}, adam(1e-3)): steps={steps} "
          f"step_ms_median={med:.2f} step_ms_first={times[0]:.2f} "
          f"items_per_s={batch / med * 1e3:.0f} losses="
          f"{[round(l, 5) for l in losses]} max_memory_allocated_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} two backward "
          f"passes bit for bit; seconds={time.perf_counter() - t_start:.1f}",
          flush=True)


def k6_bound(ids3, d, elem):
    """Least time for one K6 call on ids (B, T, L): each table's distinct
    looked-up rows read once (a row that several bags look up is one
    input), every id read once, the (B, T, D) float32 sums written once;
    B T L D adds.  Returns (ms, "bytes" or "operations", the bytes' ms
    were every looked-up row read anew)."""
    b, n, n_len = ids3.shape
    rows = sum(int(torch.unique(ids3[:, t]).numel()) for t in range(n))
    rest = ids3.numel() * 4 + b * n * d * 4
    ms, by = bound_ms(rows * d * elem + rest, b * n * n_len * d)
    return ms, by, bound_ms(ids3.numel() * d * elem + rest, 0)[0]


def k6_small_checks(device):
    """The table-batched K6 against its plain version, bit for bit, on
    small cases: multi-hot bags over mixed vocabularies read through a
    strided (B, T, L) id view, one-row bags through a strided (B, T)
    view, bfloat16 tables (16- and 8-byte pieces), D = 18 (8-byte
    pieces), an unaligned view among aligned tables (the launch one
    element a lane), 130 tables (3 launches), L = 0, and an ``out`` that
    is a view of a wider buffer (its other columns left as they were)."""
    from repro_torch.kernels.embed_bag import ops as eb_ops
    from repro_torch.kernels.embed_bag import ref as eb_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(16)

    def tables(vocabs, d, dtype=torch.float32):
        return [torch.randn(v, d, generator=gen, device=device).to(dtype)
                for v in vocabs]

    def ids(vocabs, b, n_len):
        return torch.stack([torch.randint(0, v, (b, n_len), generator=gen,
                                          device=device, dtype=torch.int32)
                            for v in vocabs], dim=1)

    vocabs, many = (40, 7, 1000), (300,) * 130
    wide = ids([v for v in vocabs for _ in "ab"], 300, 7)  # (300, 6, 7)
    buf = torch.empty(1000 * 64 + 1, device=device)
    unaligned = buf[1:].view(1000, 64)  # 4 bytes past 16-byte alignment
    unaligned.normal_(generator=gen)
    out_buf = torch.full((300, 5, 64), 7.0, device=device)
    cases = {
        "T=3 L=7 D=64, strided (B, T, L) ids": (
            tables(vocabs, 64), wide[:, ::2], None),
        "T=3 L=1 D=64, strided (B, T) ids": (
            tables(vocabs, 64), wide[:, 1::2, 3], None),
        "T=5 L=3 D=8 bfloat16": (
            tables((50,) * 5, 8, torch.bfloat16), ids((50,) * 5, 300, 3),
            None),
        "T=5 L=3 D=12 bfloat16 (8-byte pieces)": (
            tables((50,) * 5, 12, torch.bfloat16), ids((50,) * 5, 300, 3),
            None),
        "T=3 L=3 D=18 (8-byte pieces)": (
            tables(vocabs, 18), ids(vocabs, 300, 3), None),
        "T=3 L=2 D=64, an unaligned view": (
            tables(vocabs[:2], 64) + [unaligned], ids(vocabs, 300, 2), None),
        "T=130 L=1 D=8 (3 launches)": (
            tables(many, 8), ids(many, 64, 1)[:, :, 0], None),
        "T=3 L=0": (tables(vocabs, 64), ids(vocabs, 300, 0), None),
        "T=3 L=1 D=64 into out[:, 1:4] of (B, 5, D)": (
            tables(vocabs, 64), ids(vocabs, 300, 1)[:, :, 0],
            out_buf[:, 1:4]),
    }
    for name, (t, i, out) in cases.items():
        n0 = eb_ops.embedding_bags.launches
        got = eb_ops.embedding_bags(t, i, out)
        launches = eb_ops.embedding_bags.launches - n0
        want = eb_ref.embedding_bags_plain(t, i)
        if not bits_equal(got, want):
            raise AssertionError(f"K6 {name}: differs from its plain version "
                                 f"(max abs {max_abs(got, want)})")
        if launches != len(eb_ops.launch_groups(len(t))):
            raise AssertionError(f"K6 {name}: {launches} launches")
        if out is not None and (got.data_ptr() != out.data_ptr() or not bool(
                (out_buf[:, ::4] == 7.0).all())):
            raise AssertionError(f"K6 {name}: not written into out alone")
    print(f"K6 small cases ({len(cases)}, the table-batched call): bit for "
          f"bit with the plain version", flush=True)


def k6_single_cases(device, table, field_ids, full):
    """The single-table K6 cases, {name: (table, (B, L) ids)}: phase i's
    field (``table``, the largest, with the batch's strided column
    ``field_ids``), multi-hot bags (L = 20) on it, D = 18 and 50 (8-byte
    pieces) over 1 M rows, a bfloat16 copy and an unaligned view (4 bytes
    past 16-byte alignment: one element a lane)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    b, v = field_ids.shape[0], table.shape[0]
    small_v = 1_000_000 if full else 1000
    multi = torch.randint(0, v, (b, 20), generator=gen, device=device,
                          dtype=torch.int32)
    small = torch.randint(0, small_v, (b, 20), generator=gen, device=device,
                          dtype=torch.int32)
    buf = torch.empty(table.numel() + 1, device=device)
    unaligned = buf[1:].view(table.shape)
    unaligned.copy_(table)
    return {
        "phase i field (L=1)": (table, field_ids),
        "multi-hot L=20": (table, multi),
        "D=18 L=20": (torch.randn(small_v, 18, generator=gen, device=device),
                      small),
        "D=50 L=20": (torch.randn(small_v, 50, generator=gen, device=device),
                      small),
        "bf16 L=20": (table.bfloat16(), multi),
        "unaligned view L=20": (unaligned, multi),
    }


def k6_entries(device, tables, id_sets, full):
    """K6 against its plain version, bit for bit, at phase i's lookup:
    DLRM-RM2's trained tables (their values all differ, so a swapped
    descriptor shows) with a batch's (B, 26) ids as the model passes
    them, also against the 26 single-table calls.  Then the T = 1 call at
    six shapes: phase i's field (the largest table, the batch's strided
    column ``ids[:, i:i+1]``), multi-hot bags (L = 20) on that table,
    D = 18 and 50 (8-byte pieces), a bfloat16 copy and an unaligned view
    (one element a lane).  Each timed back to back through its wrapper
    (``time_ms``) and on the device with a cold L2 (``device_ms``; the
    lookup rotating over the 4 batches' ids), beside its plain version
    and, for one table,
    ``F.embedding_bag(mode="sum")``; the lookup beside 26 of those and a
    ``torch.stack`` (no single PyTorch call computes it).  Returns the
    lookup's entry."""
    from repro_torch.kernels.embed_bag import ops as eb_ops
    from repro_torch.kernels.embed_bag import ref as eb_ref

    bag = torch.nn.functional.embedding_bag
    ids = id_sets[0]
    b, n = ids.shape
    d = tables[0].shape[1]
    kern = eb_ops.embedding_bags(tables, ids)
    plain = eb_ref.embedding_bags_plain(tables, ids)
    singles = torch.stack([eb_ops.embedding_bag(t, ids[:, i:i + 1])
                           for i, t in enumerate(tables)], dim=1)
    err = max_abs(kern, plain)
    if not (bits_equal(kern, plain) and bits_equal(kern, singles)):
        raise AssertionError(f"K6 phase i lookup: differs from its plain "
                             f"version or the single-table calls (max abs "
                             f"{err}, {max_abs(kern, singles)})")
    del kern, plain, singles
    fns = [lambda i=i: eb_ops.embedding_bags(tables, i) for i in id_sets]
    dev_ms, _ = device_ms(fns, device)
    ms = time_ms(fns[0], device)
    plain_ms = time_ms(lambda: eb_ref.embedding_bags_plain(tables, ids),
                       device)
    stacked_ms = time_ms(lambda: torch.stack(
        [bag(ids[:, i:i + 1], t, mode="sum") for i, t in enumerate(tables)],
        dim=1), device)
    bnd, by, every_row = k6_bound(ids[:, :, None], d,
                                  tables[0].element_size())
    main = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=None, max_abs_err=err, max_ulp=0,
                shape=f"T={n} B={b} L=1 D={d} "
                      f"{str(tables[0].dtype)[6:]}, the batch's (B, T) ids")
    print(f"K6 phase i lookup: {main['shape']} bit_for_bit=True (and with "
          f"the {n} single-table calls) ms={ms:.4f} device_ms={dev_ms:.4f} "
          f"(cold L2) plain_ms={plain_ms:.4f} library_ms=none (no single "
          f"call; {n} F.embedding_bag and a stack: {stacked_ms:.4f}) "
          f"bound_ms={bnd:.4f} ({by}; {every_row:.4f} were every row read "
          f"anew) device_of_bound={bnd / dev_ms:.3f}", flush=True)

    largest = max(range(n), key=lambda i: tables[i].shape[0])
    cases = k6_single_cases(device, tables[largest],
                            ids[:, largest:largest + 1], full)
    for name, (t, idx) in cases.items():
        kern = eb_ops.embedding_bag(t, idx)
        plain = eb_ref.embedding_bag_plain(t, idx)
        err = max_abs(kern, plain)
        if not bits_equal(kern, plain):
            raise AssertionError(f"K6 {name}: differs from its plain version "
                                 f"(max abs {err})")
        del kern, plain
        ms = time_ms(lambda: eb_ops.embedding_bag(t, idx), device)
        dev_ms, _ = device_ms([lambda: eb_ops.embedding_bag(t, idx)], device)
        plain_ms = time_ms(lambda: eb_ref.embedding_bag_plain(t, idx), device)
        library_ms = time_ms(lambda: bag(idx, t, mode="sum"), device)
        bnd, by, every_row = k6_bound(idx[:, None], t.shape[1],
                                      t.element_size())
        print(f"K6 {name}: B={b} L={idx.shape[1]} D={t.shape[1]} "
              f"V={t.shape[0]} {str(t.dtype)[6:]} bit_for_bit=True "
              f"ms={ms:.4f} device_ms={dev_ms:.4f} (cold L2) plain_ms="
              f"{plain_ms:.4f} library_ms={library_ms:.4f} bound_ms="
              f"{bnd:.4f} ({by}; {every_row:.4f} every row) "
              f"device_of_bound={bnd / dev_ms:.3f}", flush=True)
    del cases
    return main


# --------------------------------------- phases m, n, p: the LM family
# Decode vs prefill in float32 with no capacity drops: the two forwards
# round in different places only, about float32's unit roundoff (6e-8)
# per product and layer; 1e-4 relative RMS allows a thousand times the
# residual stream's drift over these depths.  A routing decision that
# flips between them (a near tie in a router's top-k) moves a token's FFN
# output by a gate's share of an expert's output; the flips are counted.
F32_LOGIT_REL_RMS, F32_LOGIT_MAX_FRAC = 1e-4, 1e-3


class RouteRecorder:
    """While entered, records the expert ids (T, k) of every
    ``repro_torch.models.moe.route`` call, in call order."""

    def __enter__(self):
        from repro_torch.models import moe

        self.module, self.real, self.idx = moe, moe.route, []

        def recording(*args, **kwargs):
            out = self.real(*args, **kwargs)
            self.idx.append(out[1])
            return out

        moe.route = recording
        return self

    def __exit__(self, *exc):
        self.module.route = self.real


def routing_flips(prefill_idx, decode_idx, batch, seq) -> int:
    """(token, MoE layer) routing decisions whose top-k expert set differs
    between one prefill of (batch, seq) tokens and ``seq`` decode steps of
    ``batch``: the prefill's calls are one a layer over all tokens, the
    decode's one a layer a step."""
    n_moe = len(prefill_idx)
    if len(decode_idx) != seq * n_moe:
        raise AssertionError(f"{len(decode_idx)} decode routings for {seq} "
                             f"steps of {n_moe} MoE layers")
    flips = 0
    for layer, pre in enumerate(prefill_idx):
        pre = pre.reshape(batch, seq, -1).sort(-1).values
        for i in range(seq):
            dec = decode_idx[i * n_moe + layer].sort(-1).values
            flips += int((dec != pre[:, i]).any(-1).sum())
    return flips


def lm_config(arch, full, **overrides):
    from repro_torch.configs import registry

    cfg = registry.get_config(arch) if full else registry.get_smoke_config(
        arch)
    return dataclasses.replace(cfg, **overrides)


def seeded_params(cfg, device, seed=0):
    """``init_params`` from a ``torch.Generator`` on the device seeded
    with ``seed`` (``launch/serve.main``'s weights at seed 0)."""
    from repro_torch.models import transformer as tf

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tf.init_params(cfg, gen, device)


def free_device():
    gc.collect()
    torch.cuda.empty_cache()


def serve_main_phase(what, argv, device, wrappers, batch, gen_len, vocab):
    """``launch/serve.main`` on its normal path (``argv`` picks the arch,
    the shapes, ``--direct`` and ``--layers``): the tokens checked, its
    decode time and peak memory printed.  Returns the launch counts and
    the last prompt step's logits."""
    from repro_torch.launch import serve

    if device.type == "cpu":
        argv = argv + ["--device", "cpu"]
    free_device()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(wrappers)
    t0 = time.perf_counter()
    out = serve.main(argv)
    sync(device)
    seconds = time.perf_counter() - t0
    counts = read_counters(wrappers)
    tokens = out["tokens"]
    if tokens.shape != (batch, gen_len) or not (
            (tokens >= 0) & (tokens < vocab)).all():
        raise AssertionError(f"{what}: bad tokens {tuple(tokens.shape)}")
    if not torch.isfinite(out["prompt_logits"]).all():
        raise AssertionError(f"{what}: non-finite prompt logits")
    step_ms = out["gen_s"] * 1e3 / (gen_len - 1)
    print(f"{what} (launch/serve.main {' '.join(argv)}): decode_ms_per_step="
          f"{step_ms:.3f} tokens_per_s={batch / step_ms * 1e3:.0f} "
          f"counters={counts} max_memory_allocated_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} first_tokens="
          f"{tokens[0, :8].tolist()} seconds={seconds:.1f}", flush=True)
    prompt_logits = out["prompt_logits"]
    del out
    free_device()
    return counts, prompt_logits


def decode_vs_prefill_f32(what, cfg, device, batch, seq):
    """The model in float32 with a capacity factor of E / k (no token
    dropped by capacity): ``seq`` decode steps of a seeded (batch, seq)
    prompt against its prefill's last-token logits, within the float32
    limits above; the routing decisions that differ are counted and
    printed."""
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(
        cfg, dtype="float32",
        moe_capacity_factor_override=cfg.moe.n_experts / cfg.moe.top_k)
    params = seeded_params(cfg, device, seed=3)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq),
                                         dtype=np.int32)).to(device)
    t0 = time.perf_counter()
    with RouteRecorder() as pre_routes:
        pre = tf.make_prefill(cfg)(params, toks)
    cache = tf.init_kv_cache(cfg, batch, seq, device=device)
    step = tf.make_serve_step(cfg)
    with RouteRecorder() as dec_routes:
        for i in range(seq):
            logits, cache = step(params, cache, toks[:, i:i + 1])
    sync(device)
    flips = routing_flips(pre_routes.idx, dec_routes.idx, batch, seq)
    decisions = batch * seq * len(pre_routes.idx)
    check = logits_check(f"{what} float32 decode vs prefill, no drops",
                         logits, pre, F32_LOGIT_REL_RMS, F32_LOGIT_MAX_FRAC)
    print(f"{what} float32 decode vs prefill (batch={batch} seq={seq}, "
          f"capacity factor {cfg.moe_capacity_factor_override:g}: no drops"
          f"{', MLA absorbed vs un-absorbed' if cfg.mla else ''}): "
          f"max_abs={check['max_abs']:.3e} rel_rms={check['rel_rms']:.3e} "
          f"(limits {F32_LOGIT_REL_RMS:g} relative RMS, "
          f"{F32_LOGIT_MAX_FRAC:g} x max_ref) max_ref={check['max_ref']:.3f}"
          f" argmax_agree={check['argmax_agree']:.4f} routing_flips={flips}"
          f" of {decisions} decisions seconds="
          f"{time.perf_counter() - t0:.1f}", flush=True)
    del params, cache, pre, logits
    free_device()
    return flips


class FirstStepTwin:
    """An optimizer whose first ``step`` is held bit for bit against the
    same step through K5's plain version (``aggregate_adam_plain``) on
    clones of its inputs; every step is the wrapped optimizer's."""

    def __init__(self, opt, lr, what="phase m", **kw):
        self.opt, self.lr, self.kw, self.checked = opt, lr, kw, None
        self.what = what
        self.init = opt.init

    def step(self, params, grads, state):
        if self.checked is not None:
            return self.opt.step(params, grads, state)
        from repro_torch.kernels.agg_adam import ops as agg_ops
        from repro_torch.kernels.agg_adam import ref as agg_ref
        from repro_torch.tree import tree_leaves_by_key

        leaves = [tree_leaves_by_key(t) for t in
                  (params, grads, state.mu, state.nu)]
        twin = {k: [t[k].clone() for t in leaves] for k in leaves[0]}
        new_params, new_state = self.opt.step(params, grads, state)
        device = next(iter(twin.values()))[0].device
        hp = agg_ops.multi_job_hp([state.count + 1], lr=self.lr,
                                  **self.kw).to(device)
        got = [tree_leaves_by_key(t) for t in
               (new_params, new_state.mu, new_state.nu)]
        for k, (p, g, mu, nu) in twin.items():
            agg_ref.aggregate_adam_plain(p, g.contiguous(), mu, nu, hp)
            for name, want, have in zip(("p", "mu", "nu"), (p, mu, nu), got):
                if not bits_equal(have[k], want):
                    raise AssertionError(
                        f"{self.what}: the first step's {k} {name} differs "
                        f"from K5's plain version (max abs "
                        f"{max_abs(have[k].float(), want.float())})")
        self.checked = len(twin)
        del twin
        return new_params, new_state


def moe_train_phase(cfg, device, wrappers, steps=5):
    """Phase m's training: ``make_train_step`` with ``adam(3e-4,
    fused=True)`` for ``steps`` steps at 8 x 512, K5 once a leaf a step,
    the first step held bit for bit against its plain-kernel twin.
    Returns the launch counts."""
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adam
    from repro_torch.tree import tree_leaves_by_key

    t_start = time.perf_counter()
    params = seeded_params(cfg, device)
    opt = FirstStepTwin(adam(QWEN_LR, fused=True), QWEN_LR, b1=0.9,
                        b2=0.999, eps=1e-8, wd=0.0)
    step = tf.make_train_step(cfg, opt)
    state = {"params": params, "opt": opt.init(params)}
    batches = qwen_batches(cfg, steps, 0, device)
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    reset_counters(wrappers)
    state, times, losses = timed_steps(step, state, batches, device)
    counts = read_counters(wrappers)
    peak = torch.cuda.max_memory_allocated()
    n_leaves = len(tree_leaves_by_key(params))
    if counts["agg_adam_dense"] != steps * n_leaves:
        raise AssertionError(f"phase m: {counts['agg_adam_dense']} launches "
                             f"of K5 for {steps} steps of {n_leaves} leaves")
    if opt.checked != n_leaves:
        raise AssertionError("phase m: the first step was not checked")
    check_losses("m", losses)
    print(qwen_line(f"m ({cfg.name}, make_train_step, fused adam)", times,
                    losses, counts, peak,
                    f" (peak with the first step's twin) params="
                    f"{cfg.param_count} active={cfg.active_param_count} "
                    f"k5_per_step={counts['agg_adam_dense'] // steps} "
                    f"first_step_vs_plain_k5=bit-exact leaves={n_leaves} "
                    f"seconds={time.perf_counter() - t_start:.1f}"),
          flush=True)
    del state, params, batches
    free_device()
    return counts


def merge_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def moe_phase(device, wrappers, full):
    """Phase m: granite-moe-1b-a400m whole (bf16): training, serving
    through the read tier, the prefill_32k prefill through K7 against
    the chunked one, decode vs prefill in float32 with no drops.  Returns
    the launch counts of its main path (training, serving, K7 prefill)."""
    t_start = time.perf_counter()
    arch = "granite-moe-1b-a400m"
    cfg = lm_config(arch, full)
    print(f"phase m config: {cfg.name} layers={cfg.n_layers} d_model="
          f"{cfg.d_model} experts={cfg.moe.n_experts} top_k={cfg.moe.top_k} "
          f"expert_ff={cfg.moe.d_ff} vocab={cfg.vocab} dtype={cfg.dtype} "
          f"params={cfg.param_count} active={cfg.active_param_count}",
          flush=True)
    train = moe_train_phase(cfg, device, wrappers)
    b, p, g = ((SERVE_BATCH, SERVE_PROMPT, SERVE_GEN) if full
               else (4, 16, 16))
    serve_counts, _ = serve_main_phase(
        "phase m serve", ["--arch", arch, "--batch", str(b), "--prompt-len",
                          str(p), "--gen", str(g)]
        + ([] if full else ["--smoke"]),
        device, wrappers, b, g, cfg.vocab)
    seq = PREFILL_SEQ if full else 512
    params = seeded_params(cfg, device)
    pre = prefill_phase(
        "phase m prefill", dataclasses.replace(
            cfg, attn_chunk_k=1024, moe_groups=256, max_seq_len=seq),
        params, device, wrappers, seq, runs=2)
    del params
    free_device()
    flips = decode_vs_prefill_f32("phase m", cfg, device, 4, 64 if full
                                  else 16)
    counts = merge_counts(train, serve_counts, pre)
    print(f"phase m ({cfg.name}): counters={counts} "
          f"k5={counts['agg_adam_dense']} k7={counts['flash_attention']} "
          f"routing_flips={flips} seconds="
          f"{time.perf_counter() - t_start:.1f}", flush=True)
    return counts


def dense_phase(device, wrappers, full):
    """Phase n: granite-8b whole and command-r-plus-104b at full widths
    with its depth cut to 6 layers (bf16, ``--direct``): decode at batch
    16 through ``launch/serve.main``, its last prompt step held against
    the K7 prefill of the same prompt on the same weights, as phase g
    holds Qwen's; then a prefill through K7 at head dim 128 against the
    chunked one (granite-8b at prefill_32k's 32 768 tokens, command-r at
    its 8 192-token ``max_seq_len``).  Returns the launch counts."""
    from repro_torch.models import transformer as tf

    t_start = time.perf_counter()
    b, p, g = ((SERVE_BATCH, SERVE_PROMPT, SERVE_GEN) if full
               else (4, 16, 16))
    counts = []
    for arch, layers, seq in (("granite-8b", None, PREFILL_SEQ),
                              ("command-r-plus-104b", CMDR_LAYERS, 8192)):
        cfg = lm_config(arch, full)
        argv = ["--arch", arch, "--direct", "--batch", str(b),
                "--prompt-len", str(p), "--gen", str(g)]
        if layers is not None and full:
            cfg = dataclasses.replace(cfg, n_layers=layers)
            argv += ["--layers", str(layers)]
        if not full:
            argv.append("--smoke")
            seq = 512
        print(f"phase n config: {cfg.name} layers={cfg.n_layers} d_model="
              f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim="
              f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab} params="
              f"{cfg.param_count}", flush=True)
        serve_counts, served_logits = serve_main_phase(
            f"phase n serve {arch}", argv, device, wrappers, b, g, cfg.vocab)
        counts.append(serve_counts)
        params = seeded_params(cfg, device)  # serve.main's, seed 0
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (b, p), dtype=np.int32)).to(device)  # and its prompt
        check = logits_check(f"phase n {arch} decode vs K7 prefill",
                             served_logits, tf.make_prefill(cfg)(params,
                                                                 prompt))
        print(f"phase n {arch} decode vs K7 prefill (batch={b} prompt={p}): "
              f"{fmt_check(check)}", flush=True)
        del served_logits, prompt
        counts.append(prefill_phase(
            f"phase n prefill {arch}", dataclasses.replace(
                cfg, attn_chunk_k=1024, max_seq_len=seq), params, device,
            wrappers, seq, runs=2))
        del params
        free_device()
    counts = merge_counts(*counts)
    print(f"phase n (granite-8b, command-r-plus-104b x{CMDR_LAYERS} layers):"
          f" counters={counts} k7={counts['flash_attention']} seconds="
          f"{time.perf_counter() - t_start:.1f}", flush=True)
    return counts


def mla_phase(device, wrappers, full):
    """Phase p: deepseek-v2-236b at full widths, its depth cut to 2 layers
    (the dense layer 0 and one MLA + MoE layer of all 160 experts; bf16,
    ``--direct``): absorbed decode through ``launch/serve.main``, a 4 096-
    token prefill through the plain chunked attention (MLA has no K7
    route), and the absorbed decode against the un-absorbed prefill in
    float32 with no drops.  Returns the launch counts."""
    t_start = time.perf_counter()
    arch = "deepseek-v2-236b"
    cfg = lm_config(arch, full, **({"n_layers": DS_LAYERS} if full else {}))
    print(f"phase p config: {cfg.name} layers={cfg.n_layers} "
          f"(first_k_dense={cfg.first_k_dense}) d_model={cfg.d_model} "
          f"heads={cfg.n_heads} mla={cfg.mla} experts={cfg.moe.n_experts} "
          f"top_k={cfg.moe.top_k} shared_ff={cfg.moe.d_ff_shared} vocab="
          f"{cfg.vocab} params={cfg.param_count}", flush=True)
    b, p, g = (SERVE_BATCH, SERVE_PROMPT, 32) if full else (4, 16, 8)
    argv = ["--arch", arch, "--direct", "--batch", str(b), "--prompt-len",
            str(p), "--gen", str(g)]
    argv += ["--layers", str(DS_LAYERS)] if full else ["--smoke"]
    serve_counts, _ = serve_main_phase("phase p serve", argv, device, wrappers,
                                    b, g, cfg.vocab)
    seq = 4096 if full else 256
    params = seeded_params(cfg, device)
    pre = prefill_phase(
        "phase p prefill", dataclasses.replace(cfg, attn_chunk_k=1024,
                                               max_seq_len=seq),
        params, device, wrappers, seq, runs=1)
    del params
    free_device()
    flips = decode_vs_prefill_f32("phase p", cfg, device, 4, 32 if full
                                  else 16)
    counts = merge_counts(serve_counts, pre)
    if any(counts.values()):
        raise AssertionError(f"phase p launched a kernel: {counts} (MLA "
                             f"runs no K7; serving runs no tick)")
    print(f"phase p ({cfg.name} x{cfg.n_layers} layers): counters={counts} "
          f"routing_flips={flips} seconds="
          f"{time.perf_counter() - t_start:.1f}", flush=True)
    return counts


def lm_family_phases(device, wrappers, full, entries):
    """Phases m, n and p, each model freed before the next, and K7 at
    granite-8b's layer shape (head dim 128) between n and p, added to
    ``entries`` as ``flash_attention:d128``.  Returns the three phases'
    launch counts."""
    counts_m = moe_phase(device, wrappers, full)
    _require(counts_m, ("agg_adam_dense", "flash_attention"), "m")
    counts_n = dense_phase(device, wrappers, full)
    _require(counts_n, ("flash_attention",), "n")
    g8b = lm_config("granite-8b", True)  # its layer at the prefill length
    seq = PREFILL_SEQ if full else 512
    entries["flash_attention:d128"] = k7_entry(
        device, (1, seq, g8b.n_heads, g8b.head_dim), hk=g8b.n_kv_heads)
    free_device()
    counts_p = mla_phase(device, wrappers, full)
    return counts_m, counts_n, counts_p


# ------------------------------------------------------ the GNN (phase u)
GNN_LR = 1e-3  # launch/train's adam(1e-3) for gin-tu
GNN_STEPS = 6  # ogb_products: the twin's step, then 5 timed ones
MINIBATCH_STEPS = 8
MOLECULE_STEPS = 20
GNN_PEAK_GB = 40.0  # ogb_products: 24.7 GB of layer-1 messages plus state
GNN_CUT = 1000  # nodes and edges of a node-task graph divided by this
#                 in a rehearsal (widths and fanouts stay)


def captured(fn, *args):
    """``fn(*args)`` with its standard output captured, then printed;
    returns (its result, the text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    text = buf.getvalue()
    print(text, end="", flush=True)
    return out, text


def logged_losses(text, prefix="[train] step="):
    return [float(line.split("loss=")[1].split()[0])
            for line in text.splitlines() if line.startswith(prefix)]


def gnn_graph(shape, full):
    """A ``GRAPH_SHAPES`` node-task graph from ``random_graph`` (seed 0;
    cut by GNN_CUT unless ``full``), and the host seconds it took."""
    from repro_torch.configs import gin_tu
    from repro_torch.data import random_graph

    sh = gin_tu.GRAPH_SHAPES[shape]
    cut = 1 if full else GNN_CUT
    t0 = time.perf_counter()
    g = random_graph(np.random.default_rng(0), sh["n_nodes"] // cut,
                     sh["n_edges"] // cut, sh["d_feat"], sh["n_classes"])
    return g, time.perf_counter() - t0


def gnn_state(cfg, device, what):
    """Seeded GIN weights and ``adam(1e-3, fused=True)`` (K5 a leaf a
    step), its first step held against K5's plain version."""
    from repro_torch.models import gnn
    from repro_torch.optim import adam

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = gnn.init_params(cfg, gen, device)
    opt = FirstStepTwin(adam(GNN_LR, fused=True), GNN_LR, what, b1=0.9,
                        b2=0.999, eps=1e-8, wd=0.0)
    return {"params": params, "opt": opt.init(params)}, opt


def gnn_full_graph_phase(device, wrappers, full):
    """Phase u1: full_graph_sm (Cora's sizes) through
    ``launch/train.main --arch gin-tu``: 30 steps, losses finite and
    falling."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    argv = ["--arch", "gin-tu", "--steps", "30", "--log-every", "5"]
    argv += (["--device", "cpu"] if device.type == "cpu" else [])
    argv += [] if full else ["--smoke"]
    reset_counters(wrappers)
    _, text = captured(train.main, argv)
    counts = read_counters(wrappers)
    losses = logged_losses(text)
    check_losses("u full_graph_sm", losses)
    print(f"phase u full_graph_sm (launch/train.main {' '.join(argv)}): "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f} counters={counts} "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    return counts


def agg_times(batch, device):
    """The aggregation's device ms at the step's widths: forward at
    d_feat (layer 1) and at d_hidden, backward at d_hidden; at d_hidden
    also the same sums as ``index_select`` of the E message rows (timed
    alone too) and ``torch.segment_reduce`` over the same bags (held bit
    for bit against the aggregation), the forward with no chunks (the
    hot segment in one thread a column), and ``torch.sparse.mm`` of the
    CSR adjacency (cuSPARSE; a library call the port does not use, its
    summation order its own)."""
    from repro_torch.models import gnn

    agg, feats = batch["agg"], batch["feats"]
    n, fwd = feats.shape[0], agg.by_dst
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    h = torch.randn(n, 64, generator=gen, device=device)
    want = agg(h)

    def ms(fn):
        return time_ms(fn, device, reps=3, warmup=1, inner=1)

    def gathered():
        out = torch.segment_reduce(h.index_select(0, fwd.rows), "sum",
                                   offsets=fwd.offsets, axis=0, unsafe=True)
        if fwd.chunk_offsets is None:
            return out
        return torch.segment_reduce(out, "sum", offsets=fwd.chunk_offsets,
                                    axis=0, unsafe=True)

    if not bits_equal(gathered(), want):
        raise AssertionError("phase u: index_select + segment_reduce differ "
                             "from the aggregation's sums")
    t = {"fwd_d_feat": ms(lambda: agg(feats)), "fwd_d64": ms(lambda: agg(h)),
         "bwd_d64": ms(lambda: agg.by_src(h)),
         "index_select_d64": ms(lambda: h.index_select(0, fwd.rows)),
         "index_select_segment_reduce_d64": ms(gathered)}
    one = gnn.Aggregation(batch["edge_src"], batch["edge_dst"], n,
                          chunk=batch["edge_src"].numel())
    t["fwd_d64_unchunked"] = ms(lambda: one.by_dst(h))
    del one
    counts = torch.bincount(batch["edge_dst"].long(), minlength=n)
    adj = torch.sparse_csr_tensor(
        torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]), fwd.rows,
        torch.ones(fwd.rows.numel(), device=device), size=(n, n))
    err = float((torch.sparse.mm(adj, h) - want).abs().max()
                / want.abs().max())
    if not err < 1e-5:
        raise AssertionError(f"phase u: torch.sparse.mm differs from the "
                             f"aggregation by {err:.3e} of its largest sum")
    t["library_spmm_d64"] = ms(lambda: torch.sparse.mm(adj, h))
    del adj, h, want
    return t


def gnn_products_phase(device, wrappers, graph):
    """Phase u2: ogb_products (2,449,029 nodes, 61,859,140 power-law
    edges, 100 features; ``graph`` is ``gnn_graph``'s) full-graph steps
    through ``make_train_step`` with ``adam(1e-3, fused=True)``: two
    identical forward+backward passes bit for bit, the first step
    against K5's plain version bit for bit, then 5 timed steps; the
    aggregation timed apart; within GNN_PEAK_GB at peak."""
    from repro_torch.configs import gin_tu
    from repro_torch.models import gnn
    from repro_torch.tree import tree_leaves_by_key, value_and_grad

    t_start = time.perf_counter()
    g, gen_s = graph
    cfg = gin_tu.model_for_shape("ogb_products")
    free_device()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).to(device) for k, v in g.items()}
    sync(device)
    h2d_s = time.perf_counter() - t0
    n, e = g["feats"].shape[0], g["edge_src"].shape[0]
    hot = int(np.bincount(g["edge_dst"], minlength=n).max())
    del g
    t0 = time.perf_counter()
    batch = gnn.with_aggregation(cfg, batch)
    sync(device)
    plan_s = time.perf_counter() - t0
    state, opt = gnn_state(cfg, device, "phase u ogb_products")
    grad = value_and_grad(lambda p, b: gnn.loss_fn(cfg, p, b))
    (l1, g1), (l2, g2) = (grad(state["params"], batch) for _ in range(2))
    a, b = tree_leaves_by_key(g1), tree_leaves_by_key(g2)
    differ = [k for k in a if not bits_equal(a[k], b[k])]
    if differ or not bits_equal(l1, l2):
        raise AssertionError(f"phase u ogb_products: two identical passes "
                             f"differ: loss {float(l1)} vs {float(l2)}, "
                             f"leaves {differ}")
    del g1, g2, a, b
    step = gnn.make_train_step(cfg, opt)
    reset_counters(wrappers)
    state, times, losses = timed_steps(step, state, [batch] * GNN_STEPS,
                                       device)
    counts = read_counters(wrappers)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_leaves = len(tree_leaves_by_key(state["params"]))
    if opt.checked != n_leaves:
        raise AssertionError("phase u ogb_products: the first step was not "
                             "checked")
    if counts["agg_adam_dense"] != GNN_STEPS * n_leaves:
        raise AssertionError(f"phase u ogb_products: "
                             f"{counts['agg_adam_dense']} K5 launches for "
                             f"{GNN_STEPS} steps of {n_leaves} leaves")
    check_losses("u ogb_products", losses)
    if device.type == "cuda" and peak > GNN_PEAK_GB:
        raise AssertionError(f"phase u ogb_products: {peak:.2f} GB at peak "
                             f"(budget {GNN_PEAK_GB})")
    t = agg_times(batch, device)
    med = statistics.median(times[1:])
    per_step = t["fwd_d_feat"] + (cfg.n_layers - 1) * (t["fwd_d64"]
                                                        + t["bwd_d64"])
    print(f"phase u ogb_products ({cfg.name} x{cfg.n_layers} d_hidden="
          f"{cfg.d_hidden}, nodes={n} edges={e} d_feat={cfg.d_feat} "
          f"hot_segment={hot}): host graph_s={gen_s:.2f} h2d_s={h2d_s:.2f} "
          f"plan_s={plan_s:.2f}; steps={len(times)} step_ms_median="
          f"{med:.2f} (steps 2-{len(times)}) step_ms_first={times[0]:.2f} "
          f"edges_per_s={e / med * 1e3:.0f} losses="
          f"{[round(l, 4) for l in losses]} counters={counts} "
          f"k5_per_step={counts['agg_adam_dense'] // GNN_STEPS} "
          f"max_memory_allocated_gb={peak:.2f}; aggregation ms: "
          + " ".join(f"{k}={v:.3f}" for k, v in t.items())
          + f" per_step~{per_step:.2f} share~{per_step / med:.3f}; two "
          f"passes bit for bit, first step = K5's plain twin bit for bit; "
          f"seconds={time.perf_counter() - t_start:.1f}", flush=True)
    del batch, state
    free_device()
    return counts


def reddit_sampler(full):
    """minibatch_lg's graph (``gnn_graph``) and its
    ``NeighborSampler(fanouts=(15, 10))`` (the CSR build), on the host;
    returns (graph without its edge lists, sampler, graph s, CSR s)."""
    from repro_torch.configs import gin_tu
    from repro_torch.data import NeighborSampler

    g, gen_s = gnn_graph("minibatch_lg", full)
    t0 = time.perf_counter()
    sampler = NeighborSampler(g.pop("edge_src"), g.pop("edge_dst"),
                              g["feats"].shape[0],
                              gin_tu.GRAPH_SHAPES["minibatch_lg"]["fanouts"],
                              seed=0)
    return g, sampler, gen_s, time.perf_counter() - t0


def gnn_minibatch_phase(device, wrappers, built):
    """Phase u3: minibatch_lg (Reddit's 232,965 nodes and 114,615,892
    edges, 602 features) through ``NeighborSampler(fanouts=(15, 10))``
    at batch 1,024 (``built`` is ``reddit_sampler``'s): a fresh block a
    step, its batch copied to the card, its plans built there."""
    from repro_torch.configs import gin_tu
    from repro_torch.models import gnn

    t_start = time.perf_counter()
    sh = gin_tu.GRAPH_SHAPES["minibatch_lg"]
    cfg = gin_tu.model_for_shape("minibatch_lg")
    g, sampler, gen_s, csr_s = built
    n = g["feats"].shape[0]
    state, opt = gnn_state(cfg, device, "phase u minibatch_lg")
    step = gnn.make_train_step(cfg, opt)
    seeds = np.random.default_rng(1).permutation(n)
    bs = min(sh["batch_nodes"], n // MINIBATCH_STEPS)
    reset_counters(wrappers)
    torch.cuda.reset_peak_memory_stats()
    sample_s, batch_s, h2d_s, times, losses, sizes = [], [], [], [], [], []
    for i in range(MINIBATCH_STEPS):
        t0 = time.perf_counter()
        block = sampler.sample(seeds[i * bs:(i + 1) * bs])
        t1 = time.perf_counter()
        host = sampler.make_batch(block, g["feats"], g["labels"])
        t2 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        sync(device)
        t3 = time.perf_counter()
        batch = gnn.with_aggregation(cfg, batch)
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        sync(device)
        times.append((time.perf_counter() - t3) * 1e3)
        sample_s.append(t1 - t0)
        batch_s.append(t2 - t1)
        h2d_s.append(t3 - t2)
        sizes.append((block.n_active, int(host["edge_mask"].sum())))
    counts = read_counters(wrappers)
    check_losses("u minibatch_lg", losses)
    print(f"phase u minibatch_lg (fanouts={sh['fanouts']} batch={bs}, nodes="
          f"{n} edges={sampler.indices.shape[0]} d_feat="
          f"{cfg.d_feat}, padded block {sampler.max_sizes(bs)}): host "
          f"graph_s={gen_s:.2f} csr_s={csr_s:.2f} sample_s_per_block="
          f"{statistics.median(sample_s):.3f} make_batch_s="
          f"{statistics.median(batch_s):.3f} h2d_s="
          f"{statistics.median(h2d_s):.3f}; steps={len(times)} "
          f"step_ms_median={statistics.median(times):.2f} (plans and step) "
          f"step_ms_first={times[0]:.2f} active (nodes, edges) first="
          f"{sizes[0]} losses={[round(l, 4) for l in losses]} counters="
          f"{counts} max_memory_allocated_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} seconds="
          f"{time.perf_counter() - t_start:.1f}", flush=True)
    del sampler, g, state
    free_device()
    return counts


def gnn_molecule_phase(device, wrappers):
    """Phase u4: molecule, the graph task: 128 MUTAG-like graphs of 30
    nodes and 64 edges (``molecule_batch``), MOLECULE_STEPS steps on the
    batch with the sum readout."""
    from repro_torch.configs import gin_tu
    from repro_torch.data import molecule_batch
    from repro_torch.models import gnn

    t_start = time.perf_counter()
    sh = gin_tu.GRAPH_SHAPES["molecule"]
    cfg = gin_tu.model_for_shape("molecule")
    host = molecule_batch(np.random.default_rng(0), sh["batch"],
                          sh["n_nodes"], sh["n_edges"], sh["d_feat"],
                          sh["n_classes"])
    batch = gnn.with_aggregation(cfg, {k: torch.from_numpy(v).to(device)
                                       for k, v in host.items()})
    state, opt = gnn_state(cfg, device, "phase u molecule")
    reset_counters(wrappers)
    state, times, losses = timed_steps(gnn.make_train_step(cfg, opt), state,
                                       [batch] * MOLECULE_STEPS, device)
    counts = read_counters(wrappers)
    check_losses("u molecule", losses)
    print(f"phase u molecule (graphs={sh['batch']} x {sh['n_nodes']} nodes "
          f"x {sh['n_edges']} edges, d_feat={cfg.d_feat}, classes="
          f"{cfg.n_classes}): steps={len(times)} step_ms_median="
          f"{statistics.median(times):.2f} losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} counters={counts} seconds="
          f"{time.perf_counter() - t_start:.1f}", flush=True)
    return counts


def gnn_phase(device, wrappers, full, graphs=None):
    """Phase u: gin-tu at all four ``GRAPH_SHAPES`` (published node, edge
    and feature counts unless rehearsing).  The two large graphs are
    built on the host in two threads (numpy releases the GIL in its
    long calls) while the small shapes train; ogb_products' host graph
    is kept in ``graphs`` (a dict) where one is given, for phase w5.
    Returns the launch counts."""
    from concurrent.futures import ThreadPoolExecutor

    t_start = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        products = pool.submit(gnn_graph, "ogb_products", full)
        reddit = pool.submit(reddit_sampler, full)
        counts = merge_counts(
            gnn_full_graph_phase(device, wrappers, full),
            gnn_molecule_phase(device, wrappers),
            gnn_products_phase(device, wrappers, products.result()),
            gnn_minibatch_phase(device, wrappers, reddit.result()))
        if graphs is not None:
            graphs["ogb_products"] = products.result()
    _require(counts, ("agg_adam_dense",), "u")
    print(f"phase u (gin-tu, four graph shapes): counters={counts} seconds="
          f"{time.perf_counter() - t_start:.1f}", flush=True)
    return counts


# ------------------------------------------------- the examples (phase v)
E2E_STEPS = (101, 160)  # save_every 100: resume from step 100


def example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(device, wrappers, full):
    """Phase v: the port's examples on the card.  The multi-job service at
    its defaults (K1 every tick, K2 on the replans); the ~100 M LM with
    ``--fused-adam`` (K5) in two calls on one fresh checkpoint directory
    under ``build/``, the second resuming from step 100; the decode
    example through two read-tier replicas.  Returns the launch counts."""
    t_start = time.perf_counter()
    dev = [] if device.type == "cuda" else ["--device", "cpu"]
    reset_counters(wrappers)
    t0 = time.perf_counter()
    out, _ = captured(example("torch_multi_job_service").main,
                      dev + ([] if full else ["--steps", "30"]))
    for job in ("mlp", "lm"):
        ls = [l for _, l in out["losses"][job]]
        third = len(ls) // 3
        if not (all(np.isfinite(ls))
                and np.mean(ls[-third:]) < np.mean(ls[:third])):
            raise AssertionError(f"phase v multi-job service: {job} losses "
                                 f"not finite and falling: {ls}")
    if not out["migrated"]["exit"] > 0:
        raise AssertionError("phase v multi-job service: the exit migrated "
                             "nothing")
    mj_s = time.perf_counter() - t0
    counts = [read_counters(wrappers)]

    ckpt = ROOT / "build" / "phase_v_lm_e2e"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    free_gb = shutil.disk_usage(ckpt.parent).free / 1e9
    if free_gb < 8:
        raise AssertionError(f"phase v: {free_gb:.1f} GB free under build/,"
                             f" the LM's checkpoints need ~3")
    argv = dev + ["--fused-adam", "--ckpt-dir", str(ckpt)]
    steps = E2E_STEPS if full else (26, 40)
    argv += [] if full else ["--smoke", "--save-every", "25", "--batch", "2",
                             "--seq", "16"]
    reset_counters(wrappers)
    t0 = time.perf_counter()
    try:
        main = example("torch_train_lm_e2e").main
        first, _ = captured(main, argv + ["--steps", str(steps[0])])
        second, _ = captured(main, argv + ["--steps", str(steps[1])])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    e2e_s = time.perf_counter() - t0
    saved = steps[0] - 1
    if (first["resumed_from"] is not None or second["resumed_from"] != saved
            or second["steps"] != steps[1] - steps[0]):
        raise AssertionError(f"phase v LM: expected a fresh run, then a "
                             f"resume from step {saved}: {first}, {second}")
    if not (np.isfinite(second["last_loss"])
            and first["last_loss"] < first["first_loss"]
            and second["last_loss"] < first["first_loss"]):
        raise AssertionError(f"phase v LM: losses not finite and falling: "
                             f"{first}, {second}")
    counts.append(read_counters(wrappers))

    reset_counters(wrappers)
    t0 = time.perf_counter()
    out, _ = captured(example("torch_serve_decode").main, dev)
    if tuple(out["tokens"].shape) != (4, 24):
        raise AssertionError(f"phase v decode: tokens "
                             f"{tuple(out['tokens'].shape)}")
    serve_s = time.perf_counter() - t0
    counts.append(read_counters(wrappers))
    counts = merge_counts(*counts)
    print(f"phase v (examples): multi_job_service {mj_s:.1f} s; "
          f"train_lm_e2e steps {steps[0]} then {steps[1]} (resumed from "
          f"step {second['resumed_from']}, loss {first['first_loss']:.3f} "
          f"-> {second['last_loss']:.3f}) {e2e_s:.1f} s; serve_decode "
          f"{serve_s:.1f} s; counters={counts} seconds="
          f"{time.perf_counter() - t_start:.1f}", flush=True)
    return counts


# ----------------------------------------------------------------- main
# ------------------------------------------------------------- phase w
W_MOE_TOKENS = (8, 512)  # granite-moe's MoE layer: batch x sequence
W_MOE_RMS = 1e-5  # card vs CPU, relative RMS of the layer's output
W_TRAIN_BATCH = 8  # qwen1.5-0.5b train_4k: its batch of 256 cut to 8
W_DRYRUN = (("qwen1.5-0.5b", "train_4k", "pod256"),
            ("dlrm-rm2", "train_batch", "pod256"),
            ("gin-tu", "ogb_products", "pod256"),
            ("sasrec", "train_batch", "pod256"),
            ("dien", "train_batch", "pod512"))
W_GNN_LOSS_RTOL = 1e-4  # w5: the mesh branch's loss vs the one-device one
W_GNN_GRAD_TOL = 1e-3  # w5: each gradient leaf, x its largest magnitude
W_DIR = ROOT / "build" / "phase_w"  # git-ignored; removed after


class PositionRecorder:
    """While entered, records (eid, pos) of every
    ``repro_torch.models.moe.expert_positions`` call, in call order."""

    def __enter__(self):
        from repro_torch.models import moe

        self.module, self.real, self.calls = moe, moe.expert_positions, []

        def recording(eid, n_experts):
            pos = self.real(eid, n_experts)
            self.calls.append((eid.detach().cpu(), pos.detach().cpu()))
            return pos

        moe.expert_positions = recording
        return self

    def __exit__(self, *exc):
        self.module.expert_positions = self.real


def w_dryrun_start(out_dir: Path):
    """w4's children, one ``repro_torch.launch.dryrun`` process a cell on
    its production mesh (16 x 16, or 2 x 16 x 16 with ``--multi-pod``;
    fake process groups, meta tensors), all started at once; they run
    beside w1-w3 and w5."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = []
    for arch, shape, mesh in W_DRYRUN:
        log = open(out_dir / f"{mesh}_{arch}__{shape}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", str(out_dir)]
            + (["--multi-pod"] if mesh == "pod512" else []), cwd=ROOT,
            env=env, stdout=log, stderr=subprocess.STDOUT)
        procs.append([(arch, shape, mesh), proc, log, time.perf_counter(),
                      None])
    return procs


def w_dryrun_finish(procs, out_dir: Path, timeout_s: float = 600.0):
    """Wait for w4's children; print each cell's outcome (analytic, under
    the H100 SXM's published rates) and its wall seconds.  Raises if a
    cell wrote no record or was refused (``ok: false``)."""
    deadline = time.perf_counter() + timeout_s
    try:
        while any(p[4] is None for p in procs):
            for p in procs:
                if p[4] is None and p[1].poll() is not None:
                    p[4] = time.perf_counter() - p[3]
            if time.perf_counter() > deadline:
                raise AssertionError("phase w4: a dry-run child did not end "
                                     f"within {timeout_s:.0f} s")
            time.sleep(0.2)
    finally:
        for _, proc, log, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    refused = []
    for (arch, shape, mesh), proc, _, _, wall in procs:
        path = out_dir / mesh / f"{arch}__{shape}.json"
        if not path.exists():
            tail = (out_dir / f"{mesh}_{arch}__{shape}.log").read_text()[
                -1500:]
            raise AssertionError(f"phase w4: the dry-run of {arch} {shape} "
                                 f"on {mesh} wrote no record (exit "
                                 f"{proc.returncode}):\n{tail}")
        rec = json.loads(path.read_text())
        if rec["ok"]:
            r = rec["roofline"]
            print(f"phase w4 ({arch} {shape}, {mesh}, analytic under H100 "
                  f"SXM constants): ok=True dominant={r['dominant']} "
                  f"roofline_fraction={rec['roofline_fraction']:.6f} "
                  f"t_compute_s={r['t_compute_s']:.4f} t_memory_s="
                  f"{r['t_memory_s']:.4f} t_collective_s="
                  f"{r['t_collective_s']:.4f} per_device_flops="
                  f"{rec['per_device_flops']:.4e} peak_estimate_gb="
                  f"{rec['memory']['peak_estimate_bytes'] / 1e9:.2f} "
                  f"collectives={rec['collectives']['counts']} "
                  f"run_s={rec['lower_s']} wall_s={wall:.1f}", flush=True)
        else:
            print(f"phase w4 ({arch} {shape}, {mesh}): ok=False error="
                  f"{rec['error'][:300]!r} wall_s={wall:.1f}\n"
                  f"{rec['traceback']}", flush=True)
            refused.append(f"{arch} {shape} on {mesh}")
    if refused:
        raise AssertionError(f"phase w4: the dry-run refused {refused}")


def w1_lookup(device, wrappers, mesh, full):
    """w1: DLRM-RM2's 26 tables at the train_batch cell's batch through
    the row-sharded lookup's mesh branch (K6 over the rank's shards, then
    the reduce-scatter), held bit for bit against the one-device lookup.
    Returns the counters of the mesh branch's run."""
    from repro_torch.configs import dlrm_rm2
    from repro_torch.data import recsys_batch
    from repro_torch.models import recsys
    from repro_torch.ps import act_sharding as act

    cfg = dlrm_rm2.config() if full else dlrm_rm2.smoke_config()
    batch = dlrm_rm2.TRAIN_BATCH if full else 256
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    tables = recsys.dlrm_init(cfg, gen, device)["tables"]
    ids = torch.from_numpy(recsys_batch(
        np.random.default_rng(7), batch, cfg.n_dense,
        cfg.vocab_sizes)["sparse"]).to(device)
    sync(device)

    def on_mesh():
        with act.activate(mesh):
            return recsys.sharded_embedding_lookup(tables, ids)

    reset_counters(wrappers)
    got = on_mesh()
    sync(device)
    counts = read_counters(wrappers)
    if counts["embed_bag"] != 1:
        raise AssertionError(f"phase w1: {counts['embed_bag']} K6 launches "
                             f"for one mesh lookup (one expected)")
    want = recsys.sharded_embedding_lookup(tables, ids)
    if tuple(got.shape) != tuple(want.shape) or not bits_equal(
            got.to_local(), want):
        raise AssertionError("phase w1: the mesh branch's lookup differs "
                             "from the one-device lookup")
    ms_mesh = time_ms(on_mesh, device)
    ms_one = time_ms(lambda: recsys.sharded_embedding_lookup(tables, ids),
                     device)
    table_gb = sum(t.numel() * t.element_size() for t in tables) / 1e9
    print(f"phase w1 (DLRM-RM2 lookup on the host mesh, {len(tables)} "
          f"tables, {table_gb:.2f} GB, batch={batch}): mesh branch (K6 over "
          f"the rank's row shards + reduce-scatter + constrain) equal to the "
          f"one-device lookup bit for bit; mesh_ms={ms_mesh:.4f} "
          f"one_device_ms={ms_one:.4f} placements={tuple(got.placements)} "
          f"counters={counts}", flush=True)
    del tables, got, want
    free_device()
    return counts


def _w2_inputs(full):
    """granite-moe's MoE layer and its inputs, drawn on the CPU from seed
    0 (the card's run gets copies; the CPU child draws the same)."""
    from repro_torch.configs import granite_moe_1b_a400m as gm
    from repro_torch.models import moe

    lm = gm.config() if full else gm.smoke_config()
    b, s = W_MOE_TOKENS if full else (2, 64)
    gen = torch.Generator()
    gen.manual_seed(0)

    def normal(shape, scale, dtype):
        return (scale * torch.randn(shape, generator=gen)).to(dtype)

    params = moe.init_moe_params(normal, lm.d_model, lm.moe, torch.float32)
    x = torch.randn((b, s, lm.d_model), generator=gen)
    return lm, params, x


def _w2_run(mesh, lm, params, x):
    """moe_ffn_sharded on the mesh: (y, losses, eid, pos) as local
    tensors, the routing recorded from its one expert_positions call."""
    from repro_torch.models import moe
    from repro_torch.ps import act_sharding as act

    with PositionRecorder() as rec, act.activate(mesh):
        y, losses = moe.moe_ffn_sharded(x, params, lm.moe)
    (eid, pos), = rec.calls
    return y.to_local(), losses.to_local(), eid, pos


def w2_cpu(out_path, full):
    """w2's comparison run, in a child process: the same layer on the
    same inputs on a one-rank gloo mesh on the CPU."""
    _import_port()
    from repro_torch.launch.mesh import close_mesh, make_host_mesh

    lm, params, x = _w2_inputs(full == "full")
    mesh = make_host_mesh("cpu")
    y, losses, eid, pos = _w2_run(mesh, lm, params, x)
    torch.save({"y": y, "losses": losses, "eid": eid, "pos": pos}, out_path)
    close_mesh()


def w2_cpu_start(full):
    """Start w2's CPU child in a fresh W_DIR; it needs no card, so
    ``main`` starts it before phase v and it runs beside v and w1."""
    shutil.rmtree(W_DIR, ignore_errors=True)
    W_DIR.mkdir(parents=True)
    return subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke; chip_smoke.w2_cpu(*sys.argv[1:])",
         str(W_DIR / "w2_out.pt"), "full" if full else "smoke"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def w2_moe(device, mesh, full, child):
    """w2: granite-moe-1b-a400m's MoE layer at its published widths,
    float32, through ``moe_ffn_sharded`` on the host mesh, held against
    the same function on the CPU (a one-rank gloo mesh in a child
    process) on the same weights: the dropped (token, choice) sets equal,
    routing flips 0, the output within W_MOE_RMS relative RMS."""
    lm, params, x = _w2_inputs(full)
    params = {k: v.to(device) for k, v in params.items()}
    x = x.to(device)
    t0 = time.perf_counter()
    y, losses, eid, pos = _w2_run(mesh, lm, params, x)
    sync(device)
    first_s = time.perf_counter() - t0
    from repro_torch.models import moe
    from repro_torch.ps import act_sharding as act

    def on_mesh():
        with act.activate(mesh):
            return moe.moe_ffn_sharded(x, params, lm.moe)

    ms = time_ms(on_mesh, device, reps=5, warmup=1, inner=2)
    t0 = time.perf_counter()
    if child.wait(timeout=600) != 0:
        raise AssertionError(f"phase w2: the CPU child exited "
                             f"{child.returncode}")
    wait_s = time.perf_counter() - t0
    ref = torch.load(W_DIR / "w2_out.pt")
    t, k = x.shape[0] * x.shape[1], lm.moe.top_k
    cap = max(1, -(-int(lm.moe.capacity_factor * t * k) // lm.moe.n_experts))
    dropped = torch.nonzero(pos >= cap)[:, 0]
    dropped_ref = torch.nonzero(ref["pos"] >= cap)[:, 0]
    flips = int((eid.reshape(t, k).sort(-1).values
                 != ref["eid"].reshape(t, k).sort(-1).values).any(-1).sum())
    yc = y.cpu().double()
    rms = float(torch.sqrt(torch.mean((yc - ref["y"].double()) ** 2))
                / torch.sqrt(torch.mean(ref["y"].double() ** 2)))
    loss_rel = abs(float(losses) - float(ref["losses"])) / abs(
        float(ref["losses"]))
    print(f"phase w2 (granite-moe-1b-a400m MoE layer, d_model={lm.d_model} "
          f"E={lm.moe.n_experts} top_k={k} d_ff={lm.moe.d_ff} cf="
          f"{lm.moe.capacity_factor}, float32, {tuple(x.shape[:2])} tokens, "
          f"capacity {cap} a device): card vs CPU (gloo) dropped="
          f"{dropped.numel()} vs {dropped_ref.numel()} routing_flips={flips} "
          f"rel_rms={rms:.3e} (bound {W_MOE_RMS:g}) aux_rel={loss_rel:.3e} "
          f"ms={ms:.3f} first_s={first_s:.2f} cpu_child_wait_s={wait_s:.1f}",
          flush=True)
    if flips or not torch.equal(dropped, dropped_ref):
        raise AssertionError(f"phase w2: routing differs between the card "
                             f"and the CPU ({flips} flips, dropped sets "
                             f"{'equal' if torch.equal(dropped, dropped_ref) else 'differ'})")
    if not rms <= W_MOE_RMS or not loss_rel <= W_MOE_RMS:
        raise AssertionError(f"phase w2: output rel RMS {rms:.3e} or aux "
                             f"losses {loss_rel:.3e} over {W_MOE_RMS:g}")
    del params, x, y
    free_device()


def _whole(t):
    """A DTensor's global value as a plain tensor; a tensor as is."""
    from torch.distributed.tensor import DTensor

    while isinstance(t, DTensor):
        t = t.full_tensor()
    return t


def w3_train_cell(device, mesh, full):
    """w3: qwen1.5-0.5b's train_4k cell from ``build_cell`` on the host
    mesh, its batch cut to W_TRAIN_BATCH: one step with DTensor params
    (``LoweredCell.lower``, under ``op_cost.OpCost``) against the same
    step on plain tensors, loss and every updated leaf bit for bit."""
    from repro_torch.arch import ShapeCell
    from repro_torch.configs import registry
    from repro_torch.launch import cells, op_cost
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adam
    from repro_torch.tree import tree_leaves_by_key
    from torch.distributed.tensor import DTensor

    arch, shape = "qwen1.5-0.5b", "train_4k"
    spec = registry.spec(arch)
    if full:
        cell = cells.build_cell(arch, shape, mesh)
        batch_n, seq = W_TRAIN_BATCH, spec.cell(shape).seq
        cfg = dataclasses.replace(spec.model,
                                  **spec.cell(shape).model_overrides)
    else:  # the smoke config through the same cell constructor
        spec = dataclasses.replace(spec,
                                   model=registry.get_smoke_config(arch))
        sc = ShapeCell("train", "train", batch=2, seq=64,
                       model_overrides={"attn_chunk_k": 16})
        cell = cells._lm_cell(spec, sc, mesh)
        batch_n, seq = 2, 64
        cfg = dataclasses.replace(spec.model, attn_chunk_k=16)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, device)
    state = {"params": params, "opt": adam(3e-4).init(params)}
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (batch_n, seq + 1), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(device),
             "labels": torch.from_numpy(toks[:, 1:].copy()).to(device)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plain_state, plain_m = cell.fn(state, batch)
    sync(device)
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with op_cost.OpCost() as oc:
        mesh_state, mesh_m = cell.lower((state, batch))
    sync(device)
    mesh_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not bits_equal(_whole(mesh_m["loss"]), _whole(plain_m["loss"])):
        raise AssertionError(f"phase w3: loss {float(plain_m['loss'])} on "
                             f"plain tensors, "
                             f"{float(_whole(mesh_m['loss']))} with "
                             f"DTensor params")
    got = tree_leaves_by_key({"params": mesh_state["params"],
                              "mu": mesh_state["opt"].mu,
                              "nu": mesh_state["opt"].nu})
    want = tree_leaves_by_key({"params": plain_state["params"],
                               "mu": plain_state["opt"].mu,
                               "nu": plain_state["opt"].nu})
    kinds = {"dtensor leaves (DTensor step)": sum(
        isinstance(v, DTensor) for v in got.values()),
        "dtensor leaves (plain step)": sum(
            isinstance(v, DTensor) for v in want.values())}
    bad = [k for k in want if not bits_equal(_whole(got[k]),
                                             _whole(want[k]))]
    if bad:
        raise AssertionError(f"phase w3: {len(bad)} updated leaves differ "
                             f"between the DTensor step and the plain one, "
                             f"e.g. {bad[:4]}")
    model_flops = cell.model_flops_per_step * batch_n / spec.cell(
        shape).batch if full else cell.model_flops_per_step
    print(f"phase w3 ({arch} {shape} from build_cell on the host mesh, "
          f"batch cut {spec.cell(shape).batch}->{batch_n}, seq={seq}, "
          f"{cfg.dtype}, adam(3e-4)): loss={float(plain_m['loss']):.5f}; "
          f"the DTensor step's loss and {len(want)} updated leaves (params, "
          f"mu, nu) equal the plain step's bit for bit; op_cost_flops="
          f"{oc.cost.flops:.4e} model_flops_per_step={model_flops:.4e} "
          f"(ratio {oc.cost.flops / model_flops:.3f}) op_cost_bytes="
          f"{oc.cost.bytes:.4e} plain_step_s={plain_s:.2f} dtensor_step_s="
          f"{mesh_s:.2f} max_memory_allocated_gb={peak / 1e9:.2f} {kinds}",
          flush=True)
    del state, params, plain_state, mesh_state
    free_device()


def _leaf_errors(got, want):
    """Per leaf (by key): the largest difference of ``got`` from ``want``
    over ``want``'s largest magnitude."""
    out = {}
    for k, w in want.items():
        g = _whole(got[k]).float()
        out[k] = float((g - w.float()).abs().max()
                       / w.float().abs().max().clamp(min=1e-30))
    return out


def w5_gin_mesh(device, wrappers, mesh, graph):
    """w5: one forward and backward of gin-tu's ogb_products step (2.45 M
    nodes, 61.9 M edges, 100 features at its published widths; cut by
    GNN_CUT when rehearsing) through the mesh branch (``MeshAggregation``,
    ``index_add`` in a per-device region) on the host mesh, its arguments
    placed by ``build_cell``'s ``LoweredCell``, held against the same
    pass on plain tensors through the one-device plan: the loss within
    W_GNN_LOSS_RTOL, every gradient leaf within W_GNN_GRAD_TOL of its
    largest magnitude (``index_add`` sums in its own order); both timed.
    No kernel runs in either."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import gin_tu
    from repro_torch.launch import cells
    from repro_torch.models import gnn
    from repro_torch.optim import adam
    from repro_torch.ps import act_sharding as act
    from repro_torch.tree import tree_leaves_by_key, value_and_grad

    t_start = time.perf_counter()
    g, gen_s = graph
    cfg = gin_tu.model_for_shape("ogb_products")
    cell = cells.build_cell("gin-tu", "ogb_products", mesh)
    batch = {k: torch.from_numpy(v).to(device) for k, v in g.items()
             if k in ("feats", "edge_src", "edge_dst", "labels",
                      "label_mask")}
    n, e = g["feats"].shape[0], g["edge_src"].shape[0]
    batch["edge_mask"] = torch.ones(e, dtype=torch.bool, device=device)
    del g
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = gnn.init_params(cfg, gen, device)
    state = {"params": params, "opt": adam(GNN_LR).init(params)}
    grad = value_and_grad(lambda p, b: gnn.loss_fn(cfg, p, b))
    free_device()

    def timed(fn):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        return out, (time.perf_counter() - t0) * 1e3

    placed_state, placed_batch = cell.place((state, batch))

    def on_mesh():
        with act.activate(mesh), implicit_replication():
            return grad(placed_state["params"], placed_batch)

    base = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counters(wrappers)
    timed(on_mesh)
    free_device()
    (l_mesh, g_mesh), mesh_ms = timed(on_mesh)
    peak = torch.cuda.max_memory_allocated() / 1e9
    free_device()
    plan_batch = gnn.with_aggregation(cfg, batch)
    timed(lambda: grad(params, plan_batch))
    (l_one, g_one), one_ms = timed(lambda: grad(params, plan_batch))
    del plan_batch
    counts = read_counters(wrappers)
    if any(counts.values()):
        raise AssertionError(f"phase w5 launched a kernel: {counts}")
    loss_rel = abs(float(_whole(l_mesh)) - float(l_one)) / abs(float(l_one))
    errs = _leaf_errors(tree_leaves_by_key(g_mesh), tree_leaves_by_key(g_one))
    worst = max(errs, key=errs.get)
    print(f"phase w5 (gin-tu ogb_products, {cfg.name} x{cfg.n_layers} "
          f"d_hidden={cfg.d_hidden} d_feat={cfg.d_feat}, nodes={n} "
          f"edges={e}, one forward+backward through build_cell's placement "
          f"on the host mesh): mesh branch (index_add per device) vs the "
          f"one-device plan: loss {float(l_one):.6f} rel_diff={loss_rel:.3e} "
          f"(bound {W_GNN_LOSS_RTOL:g}) worst_grad_leaf={worst} "
          f"rel_err={errs[worst]:.3e} (bound {W_GNN_GRAD_TOL:g}) mesh_ms="
          f"{mesh_ms:.2f} one_device_ms={one_ms:.2f} memory_allocated_gb at "
          f"the start {base:.2f}, max in the mesh passes {peak:.2f}; host "
          f"graph_s={gen_s:.2f} (phase u's) counters={counts} seconds="
          f"{time.perf_counter() - t_start:.1f}", flush=True)
    if not loss_rel <= W_GNN_LOSS_RTOL or not errs[worst] <= W_GNN_GRAD_TOL:
        raise AssertionError(f"phase w5: the mesh branch differs from the "
                             f"one-device step: loss {loss_rel:.3e}, "
                             f"{worst} {errs[worst]:.3e}")
    del batch, placed_batch, placed_state, state, params, g_one, g_mesh
    free_device()


def mesh_phase(device, wrappers, full, graph, child):
    """Phase w: the mesh layer on a one-rank host mesh (NCCL on the card).
    w4's dry-run children start first and run beside w1-w3 and w5.  w2
    reads ``child`` (``w2_cpu_start``'s), w5 takes ``graph`` (phase u's
    ogb_products host graph, ``gnn_graph``'s result).  Returns the
    counters of w1's mesh lookup (the only kernel launches of the
    phase's main path)."""
    from repro_torch.launch.mesh import close_mesh, make_host_mesh

    t0 = time.perf_counter()
    procs = w_dryrun_start(W_DIR) if full else []
    try:
        mesh = make_host_mesh(device)
        counts = w1_lookup(device, wrappers, mesh, full)
        w2_moe(device, mesh, full, child)
        w3_train_cell(device, mesh, full)
        w5_gin_mesh(device, wrappers, mesh, graph)
        close_mesh()
        if full:
            w_dryrun_finish(procs, W_DIR)
    finally:
        for p in procs:
            if p[1].poll() is None:
                p[1].kill()
                p[1].wait()
            p[2].close()
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(W_DIR, ignore_errors=True)
    print(f"phase w: {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of every workload tensor (a rehearsal "
                         "below 1 prints no result and exits 2)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a card",
              file=sys.stderr)
        return 1
    _import_port()
    from repro_torch.kernels import _build
    from repro_torch.kernels.agg_adam import ops as agg_ops
    from repro_torch.kernels.ef_round import ops as ef_ops
    from repro_torch.kernels.embed_bag import ops as eb_ops
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.relayout import ops as rl_ops

    device = torch.device("cuda:0")
    t_script = time.perf_counter()
    scale = args.scale
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(logs)})", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    k7_sass_counts(_build.library_path("flash_attn"))

    wrappers = {
        "agg_adam_multijob_fused": agg_ops.aggregate_adam_multijob_fused,
        "agg_adam_blocks": agg_ops.aggregate_adam_blocks,
        "agg_adam_multijob": agg_ops.aggregate_adam_multijob,
        "relayout_stage": rl_ops.relayout_stage,
        "relayout_scatter": rl_ops.relayout_scatter,
        "agg_adam_dense": agg_ops.aggregate_adam,
        "flash_attention": fa_ops.flash_attention,
        "embed_bag": eb_ops.embedding_bags,
        "ef_round": ef_ops.ef_round,
    }
    totals = dict.fromkeys(wrappers, 0)

    def add_totals(counts):
        for k, v in counts.items():
            totals[k] += v

    # ---- set-up: three paper workloads resident
    s = Service(device, scale)
    t0 = time.perf_counter()
    for model in ("alexnet", "vgg19", "bert"):
        s.add(model)
    sync(device)
    plan = s.rt.plan
    print(f"setup: jobs={list(s.rt.job_ids)} shards={plan.n_shards} "
          f"total_len={plan.total_len} payload={plan.payload_elements} "
          f"seconds={time.perf_counter() - t0:.2f} host_maxrss_gb="
          f"{host_rss_gb():.2f}", flush=True)

    # ---- phase a: 8 ticks, three jobs
    torch.cuda.reset_peak_memory_stats()
    stats0 = dataclasses.replace(s.eng.stats)
    reset_counters(wrappers)
    times, _ = run_ticks(s, 8, check_tick=True)
    flat_tick_ms = times
    counts = read_counters(wrappers)
    _require(counts, ("agg_adam_multijob_fused",), "a")
    add_totals(counts)
    print(phase_line("a (3 jobs)", times, stats0, s.eng.stats, counts),
          flush=True)

    # ---- phase b: AWD-LM arrives, 8 ticks, four jobs
    torch.cuda.reset_peak_memory_stats()
    stats0 = dataclasses.replace(s.eng.stats)
    reset_counters(wrappers)
    before, old, new, delta, timings = replan(
        s, "arrival", lambda: s.add("awd-lm"))
    times, _ = run_ticks(s, 8, check_tick=True)
    counts = read_counters(wrappers)
    _require(counts, ("agg_adam_multijob_fused", "relayout_stage",
                      "relayout_scatter"), "b")
    add_totals(counts)
    print(phase_line(
        "b (AWD-LM arrives)", times, stats0, s.eng.stats, counts,
        f" total_len {old.total_len}->{new.total_len} moved_elements="
        f"{delta.moved_elements} touched_jobs={list(delta.touched_jobs)} "
        f"touched_blocks={delta.touched_blocks.size}{timings}"), flush=True)
    entries = {"agg_adam_multijob_fused": k1_entry(s, device)}
    entries["relayout_stage"], entries["relayout_scatter"], k2 = k2_entries(
        before, delta, device)
    print(f"K2 as a whole (stage + scatter) on the arrival delta: "
          f"ms={k2['ms']:.4f} bound_ms={k2['bound_ms']:.4f} (moved lanes "
          f"read once, moved and vacated lanes written once, per leaf) "
          f"ratio={k2['ms'] / k2['bound_ms']:.3f}", flush=True)
    del before

    # ---- phase c: AWD-LM leaves, 8 ticks, three jobs
    torch.cuda.reset_peak_memory_stats()
    stats0 = dataclasses.replace(s.eng.stats)
    reset_counters(wrappers)
    before, old, new, delta, timings = replan(
        s, "exit", lambda: s.rt.remove_job("awd-lm"))
    del before
    times, k4_err = run_ticks(s, 8, check_tick=True, k4=True)
    counts = read_counters(wrappers)
    _require(counts, ("agg_adam_multijob_fused", "relayout_stage",
                      "relayout_scatter", "agg_adam_multijob"), "c")
    add_totals(counts)
    print(phase_line(
        "c (AWD-LM leaves)", times, stats0, s.eng.stats, counts,
        f" total_len {old.total_len}->{new.total_len} moved_elements="
        f"{delta.moved_elements} zeroed_elements={delta.zeroed_elements} "
        f"touched_jobs={list(delta.touched_jobs)} touched_blocks="
        f"{delta.touched_blocks.size}{timings}"), flush=True)
    entries["agg_adam_blocks"] = k3_entry(s, device)
    entries["agg_adam_multijob"] = k4_entry(s, device, k4_err)
    print(f"K4 in phase c's last tick (multi_job_adam_update, p full and p "
          f"packed): equal to its plain version bit for bit; scattered onto "
          f"its rows, equal to the K1 tick's state bit for bit", flush=True)
    print(f"engine stats: {s.rt.debug_stats()['engine']}", flush=True)
    del s

    # ---- phase s: the sharded service, AWD-LM's arrival and a scaler's
    # scale-out and scale-in; then phase r on its runtime: the read tier
    # over the shard lanes, a transient fault and a lost shard; within
    # their memory budgets and leaving nothing behind
    gc.collect()
    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    counts, s = sharded_phase(device, wrappers, scale, flat_tick_ms)
    _require(counts, ("agg_adam_multijob_fused", "relayout_stage",
                      "relayout_scatter"), "s")
    add_totals(counts)
    counts = read_phase(s, wrappers)
    _require(counts, ("agg_adam_multijob_fused",), "r")
    add_totals(counts)
    s_tick_ms = s.fleet_tick_ms
    del s
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase q: compressed pushes, a lease reclaim and a checkpoint on
    # a fresh sharded fleet; then the leak check of phases s, r and q
    counts, s, entries["ef_round"] = compressed_phase(device, wrappers, scale,
                                                      s_tick_ms)
    _require(counts, ("agg_adam_multijob_fused", "relayout_stage",
                      "relayout_scatter", "ef_round"), "q")
    add_totals(counts)
    del s
    gc.collect()
    torch.cuda.empty_cache()
    leaked = torch.cuda.memory_allocated() - baseline
    if leaked > S_LEAK_BYTES:
        raise AssertionError(f"phases s, r and q left {leaked / 2**20:.1f} "
                             f"MiB allocated (budget {S_LEAK_BYTES >> 20} "
                             f"MiB)")
    print(f"phases s, r and q leak check: {leaked} bytes left allocated "
          f"(budget {S_LEAK_BYTES})", flush=True)

    # ---- phase t: the chaos trace replay and its no-fault parity replay
    # at the paper inventories' full widths; then its own leak check
    add_totals(run_phase_t(device, wrappers, scale))

    # ---- phase d: real models on the device
    counts = mlp_phase(device, wrappers)
    _require(counts, ("agg_adam_multijob_fused", "agg_adam_blocks",
                      "ef_round"), "d")
    add_totals(counts)

    # ---- phases e and f: Qwen1.5-0.5B training, full width and depth
    from repro_torch.configs import qwen1_5_0_5b

    torch.cuda.empty_cache()
    cfg = qwen1_5_0_5b.config()
    if scale != 1.0:
        cfg = qwen1_5_0_5b.smoke_config()
    print(f"Qwen config: {cfg.name} layers={cfg.n_layers} d_model="
          f"{cfg.d_model} vocab={cfg.vocab} dtype={cfg.dtype} params="
          f"{cfg.param_count} batch={QWEN_BATCH}x{QWEN_SEQ}", flush=True)
    counts_e, state = optimizer_phase(cfg, device, wrappers)
    _require(counts_e, ("agg_adam_dense",), "e")
    add_totals(counts_e)
    embed = state["params"]["embed"]
    entries["agg_adam_dense:embed"] = k5_entry(
        embed, torch.randn(embed.shape, device=device,
                           dtype=embed.dtype) * 1e-3,
        state["opt"].mu["embed"], state["opt"].nu["embed"], device,
        "optimizer path, embedding leaf")
    del state, embed
    torch.cuda.empty_cache()
    counts_f, state, plan = ps_phase(cfg, device, wrappers)
    _require(counts_f, ("agg_adam_dense",), "f")
    add_totals(counts_f)
    entries["agg_adam_dense:ps_flat"] = k5_entry(
        state["flat"], torch.randn(state["flat"].shape, device=device) * 1e-3,
        state["mu"], state["nu"], device, "single-job PS flat space")
    del state
    torch.cuda.empty_cache()
    k5_small_checks(device)

    # ---- phases g and h: serving Qwen1.5-0.5B, full width and depth
    serve_shape = ((SERVE_BATCH, SERVE_PROMPT, SERVE_GEN) if scale == 1.0
                   else (4, 16, 16))
    seq = PREFILL_SEQ if scale == 1.0 else 512
    counts_g, served = serve_phase(cfg, device, wrappers, *serve_shape)
    _require(counts_g, ("agg_adam_multijob_fused", "flash_attention"), "g")
    add_totals(counts_g)
    counts_h = prefill_phase(
        "phase h (Qwen prefill)", dataclasses.replace(cfg, attn_chunk_k=1024),
        served, device, wrappers, seq)  # the prefill_32k cell
    _require(counts_h, ("flash_attention",), "h")
    add_totals(counts_h)
    del served
    torch.cuda.empty_cache()
    entries["flash_attention"] = k7_entry(  # the smoke config's D is 16
        device, (1, seq, cfg.n_heads, cfg.head_dim if scale == 1.0 else 64))
    k7_small_checks(device)

    # ---- phases i-k: the recsys family, DLRM-RM2 at its published widths
    full = scale == 1.0
    counts_i, rm2, params, id_sets = dlrm_train_phase(device, wrappers,
                                                      full)
    _require(counts_i, ("embed_bag",), "i")
    add_totals(counts_i)
    counts_j = dlrm_score_phase(rm2, params, device, wrappers, full)
    _require(counts_j, ("embed_bag",), "j")
    add_totals(counts_j)
    entries["embed_bag"] = k6_entries(device, params["tables"], id_sets,
                                      full)
    k6_small_checks(device)
    del params, id_sets
    torch.cuda.empty_cache()
    from repro_torch.configs import dlrm_rm2

    reset_counters(wrappers)
    for arch in ("sasrec", "dien"):
        recsys_train_phase(arch, dlrm_rm2.TRAIN_BATCH if full else 64,
                           device, full)
    if any(read_counters(wrappers).values()):
        raise AssertionError("phase k launched a kernel: SASRec and DIEN "
                             "run none in either package")
    free_device()

    # ---- phases m, n and p: the rest of the LM family
    counts_m, counts_n, counts_p = lm_family_phases(device, wrappers, full,
                                                    entries)
    for counts in (counts_m, counts_n, counts_p):
        add_totals(counts)

    # ---- phase u: the GNN at its four graph shapes; phase v: the examples
    graphs = {}
    counts_u = gnn_phase(device, wrappers, full, graphs)
    add_totals(counts_u)
    w2_child = w2_cpu_start(full)  # phase w2's CPU run, beside v
    try:
        counts_v = examples_phase(device, wrappers, full)
    except BaseException:
        w2_child.kill()
        raise
    _require(counts_v, ("agg_adam_multijob_fused", "agg_adam_dense"), "v")
    add_totals(counts_v)

    # ---- phase w: the mesh layer on a one-rank host mesh; the dry-run
    counts_w = mesh_phase(device, wrappers, full, graphs.pop("ogb_products"),
                          w2_child)
    _require(counts_w, ("embed_bag",), "w")
    add_totals(counts_w)

    # ---- report
    k1_src = "src/repro_torch/kernels/agg_adam/csrc/agg_adam.cu"
    rl_src = "src/repro_torch/kernels/relayout/csrc/relayout.cu"
    # entry -> (source, TPU kernel it replaces, launches on the main path)
    meta = {
        "agg_adam_multijob_fused": (
            k1_src, "src/repro/kernels/agg_adam/kernel.py:214",
            totals["agg_adam_multijob_fused"]),
        "agg_adam_blocks": (
            k1_src, "src/repro/kernels/agg_adam/kernel.py:124",
            totals["agg_adam_blocks"]),
        "relayout_stage": (
            rl_src, "src/repro/kernels/relayout/kernel.py:48",
            totals["relayout_stage"]),
        "relayout_scatter": (
            rl_src, "src/repro/kernels/relayout/kernel.py:48",
            totals["relayout_scatter"]),
        "agg_adam_dense:embed": (  # bf16 leaves: phases e and m
            k1_src, "src/repro/kernels/agg_adam/kernel.py:76",
            counts_e["agg_adam_dense"] + counts_m["agg_adam_dense"]),
        "agg_adam_dense:ps_flat": (  # float32 leaves: phases f, u and v
            k1_src, "src/repro/kernels/agg_adam/kernel.py:76",
            counts_f["agg_adam_dense"] + counts_u["agg_adam_dense"]
            + counts_v["agg_adam_dense"]),
        "agg_adam_multijob": (
            k1_src, "src/repro/kernels/agg_adam/kernel.py:276",
            totals["agg_adam_multijob"]),
        "flash_attention": (
            "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
            "src/repro/kernels/flash_attn/kernel.py:65",
            counts_g["flash_attention"] + counts_h["flash_attention"]
            + counts_m["flash_attention"]),  # head dim 64: g, h and m
        "flash_attention:d128": (
            "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
            "src/repro/kernels/flash_attn/kernel.py:65",
            counts_n["flash_attention"]),  # phase n: head dim 128
        "embed_bag": (
            "src/repro_torch/kernels/embed_bag/csrc/embed_bag.cu",
            "src/repro/kernels/embed_bag/kernel.py:34",
            totals["embed_bag"]),  # phases i, j and w
        "ef_round": (  # no TPU kernel: the reference's round is plain jnp
            "src/repro_torch/kernels/ef_round/csrc/ef_round.cu",
            "src/repro/ps/compression.py:74",
            totals["ef_round"]),  # phase q's fused ticks and phase d
    }
    kernels = []
    for name, (source, replaces, launches) in meta.items():
        e = entries[name]
        if launches <= 0:
            raise AssertionError(f"{name} never launched on the main path")
        print(f"kernel {name}: {e['shape']} ms={e['ms']:.4f} plain_ms="
              f"{e['plain_ms']:.4f} bound_ms={e['bound_ms']:.4f} "
              f"({e['bound_by']}) library_ms={e['library_ms']} max_ulp="
              f"{e['max_ulp']} launches={launches}", flush=True)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"],
            **({"device_ms": e["device_ms"]} if "device_ms" in e else {})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s from the "
          f"card check to the report, the build included", flush=True)
    if scale != 1.0:
        print(f"rehearsal at scale {scale} finished: no result",
              file=sys.stderr)
        return 2
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phase_t(device, wrappers, scale):
    """Phase t with its launch check and its leak check; returns its
    launch counts."""
    gc.collect()
    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    counts = replay_phase(device, wrappers, scale)
    _require(counts, ("agg_adam_multijob_fused", "relayout_stage",
                      "relayout_scatter", "agg_adam_blocks"), "t")
    gc.collect()
    torch.cuda.empty_cache()
    leaked = torch.cuda.memory_allocated() - baseline
    if leaked > S_LEAK_BYTES:
        raise AssertionError(f"phase t left {leaked / 2**20:.1f} MiB "
                             f"allocated (budget {S_LEAK_BYTES >> 20} MiB)")
    print(f"phase t leak check: {leaked} bytes left allocated (budget "
          f"{S_LEAK_BYTES})", flush=True)
    return counts


def _require(counts, names, phase):
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"phase {phase}: no launch of {missing}")


if __name__ == "__main__":
    sys.exit(main())
