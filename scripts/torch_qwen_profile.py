#!/usr/bin/env python3
"""Where a Qwen1.5-0.5B training step's time goes on the card.

Runs the two training paths of ``chip_smoke.py`` (phase e: the fused
optimizer; phase f: the single-job parameter-server step) at the same
full-size configuration, traces two steps of each with
``torch.profiler`` after three warm-up steps, and prints per step: the
wall time (host clock to a synchronize), the device's busy time (the sum
of its kernels' durations) and idle share, and the kernel time by class
and by name, and the host's busiest operators.  It times the parts of
each step one by one (each ended by a synchronize): the gradient and
the optimizer for phase e; the pull, the gradient, the push and the K5
update for phase f.  It then times the dense Adam kernel K5 at the
embedding leaf's shape on fresh random moments and on the moments that
training left, to show how much its time depends on the data.

Run from the repository root on a machine with one NVIDIA card:
``python3 scripts/torch_qwen_profile.py``.  Without CUDA it exits 1.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CLASSES = (  # (class, pattern on the kernel name), first match wins
    ("K5 dense Adam", r"dense_kernel"),
    ("matmul", r"gemm|cutlass|xmma|nvjet|cublas|sm90_"),
    ("softmax / logsumexp", r"softmax|logsumexp"),
    ("reduction", r"reduce"),
    ("embedding / index / gather", r"embedding|index|gather|scatter|sort"),
    ("copy / cast / cat", r"copy|cast|cat|fill"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def kernel_class(name: str) -> str:
    for cls, pat in CLASSES:
        if re.search(pat, name, re.I):
            return cls
    return "other"


def profile_steps(step, state, batches, device, label):
    """Trace ``len(batches)`` steps; print the breakdown; return state."""
    from torch.profiler import ProfilerActivity, profile

    cs.sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, m = step(state, b)
            float(m["loss"])
        cs.sync(device)
        wall = (time.perf_counter() - t0) * 1e3 / len(batches)
    by_name = collections.Counter()
    count = collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
            count[evt.name] += 1
    n = len(batches)
    busy = sum(by_name.values()) / n
    print(f"{label}: wall_ms_per_step={wall:.2f} device_busy_ms={busy:.2f} "
          f"idle_share={1 - busy / wall:.3f} kernels_per_step="
          f"{sum(count.values()) / n:.0f}", flush=True)
    if not by_name:
        print(f"{label}: the profiler saw no device time", flush=True)
        return state
    by_class = collections.Counter()
    for name, ms in by_name.items():
        by_class[kernel_class(name)] += ms / n
    for cls, ms in by_class.most_common():
        print(f"  class {cls}: {ms:.2f} ms ({ms / busy:.1%} of busy)")
    for name, ms in by_name.most_common(12):
        print(f"  kernel {ms / n:8.3f} ms x{count[name] / n:.0f} "
              f"{name[:110]}")
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in ops[:10]:
        print(f"  host {e.self_cpu_time_total / 1e3 / n:8.3f} ms "
              f"x{e.count / n:.0f} {e.key[:80]}")
    return state


def parts_ms(parts, device, reps=3):
    """Median host time of each named part, each ended by a synchronize;
    ``parts`` is a list of (name, fn), run in order, each fn taking the
    previous one's result."""
    out = {name: [] for name, _ in parts}
    for _ in range(reps):
        x = None
        for name, fn in parts:
            cs.sync(device)
            t0 = time.perf_counter()
            x = fn(x)
            cs.sync(device)
            out[name].append((time.perf_counter() - t0) * 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in out.items()}


def k5_by_data(state, device):
    """K5 at the embedding leaf on fresh moments and on trained ones."""
    from repro_torch.kernels.agg_adam import ops as agg_ops

    embed = state["params"]["embed"]
    mu_t, nu_t = state["opt"].mu["embed"], state["opt"].nu["embed"]
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    g = (torch.randn(embed.shape, generator=gen, device=device)
         * 1e-3).bfloat16()
    fresh = ((torch.randn(embed.shape, generator=gen, device=device) * 1e-4),
             torch.randn(embed.shape, generator=gen, device=device).abs()
             * 1e-7)
    for what, (mu, nu) in (("fresh random moments", fresh),
                           ("trained moments", (mu_t, nu_t))):
        p, mu, nu = embed.clone(), mu.clone(), nu.clone()
        tiny = float(((nu > 0) & (nu < 1e-30)).float().mean())
        print(f"K5 embed, {what}: mu==0 {float((mu == 0).float().mean()):.4f}"
              f" nu==0 {float((nu == 0).float().mean()):.4f} "
              f"0<nu<1e-30 {tiny:.4f}", flush=True)
        ms = cs.time_ms(lambda: agg_ops.aggregate_adam(
            p, g, mu, nu, 11, lr=3e-4), device)
        print(f"K5 embed, {what}: ms={ms:.4f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_qwen_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import qwen1_5_0_5b
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adam
    from repro_torch.kernels.agg_adam.ops import adam_update
    from repro_torch.ps.runtime import (build_flat_plan, flatten_tree,
                                        init_ps_state, make_ps_train_step,
                                        unflatten_tree)
    from repro_torch.tree import value_and_grad

    device = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    cfg = qwen1_5_0_5b.config()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, device)
    opt = adam(cs.QWEN_LR, fused=True)
    step = tf.make_train_step(cfg, opt)
    state = {"params": params, "opt": opt.init(params)}
    batches = cs.qwen_batches(cfg, 5, 0, device)
    state, times, _ = cs.timed_steps(step, state, batches[:3], device)
    print(f"phase e warm-up step ms: {[round(t, 2) for t in times]}")
    state = profile_steps(step, state, batches[3:], device,
                          "phase e (make_train_step, fused adam)")
    grad_fn = value_and_grad(lambda p, b: tf.loss_fn(cfg, p, b))
    parts = parts_ms([
        ("grad", lambda _: grad_fn(state["params"], batches[0])[1]),
        ("optimizer (14 K5)", lambda g: opt.step(state["params"], g,
                                                 state["opt"]))], device)
    print(f"phase e parts ms: {parts}", flush=True)
    k5_by_data(state, device)
    del state, params
    torch.cuda.empty_cache()

    abstract = tf.init_params(cfg, device="meta")
    plan = build_flat_plan(abstract, n_shards=2)
    gen.manual_seed(1)
    state = init_ps_state(plan, tf.init_params(cfg, gen, device))
    step = make_ps_train_step(lambda p, b: tf.loss_fn(cfg, p, b), plan,
                              abstract, lr=cs.QWEN_LR, fused_kernel=True)
    batches = cs.qwen_batches(cfg, 5, 1, device)
    torch.cuda.reset_peak_memory_stats()
    state, times, _ = cs.timed_steps(step, state, batches[:3], device)
    print(f"phase f warm-up step ms: {[round(t, 2) for t in times]} "
          f"max_memory_allocated_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    state = profile_steps(step, state, batches[3:], device,
                          "phase f (single-job PS step, fused_kernel=True)")
    grad_fn = value_and_grad(lambda p, b: tf.loss_fn(cfg, p, b))
    parts = parts_ms([
        ("pull", lambda _: unflatten_tree(plan, state["flat"], abstract)),
        ("grad", lambda p: grad_fn(p, batches[0])[1]),
        ("push", lambda g: flatten_tree(plan, g, device=device)),
        ("K5 update", lambda gflat: adam_update(
            state["flat"], gflat, state["mu"], state["nu"], 9,
            lr=cs.QWEN_LR))], device)
    print(f"phase f parts ms: {parts}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
