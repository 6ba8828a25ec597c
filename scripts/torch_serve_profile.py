#!/usr/bin/env python3
"""Where Qwen1.5-0.5B serving time goes on the card.

Runs the two serving shapes of ``chip_smoke.py`` at the full model
(seeded random bf16 weights): phase g's decode step (batch 16, a
128-token prompt by repeated decode, a KV cache of 256 positions) and
phase h's prefill (32 768 tokens, batch 1, attention through the flash
attention kernel K7).  After a warm-up it traces 8 decode steps and one
prefill with ``torch.profiler``.  It prints a decode step's time with a
synchronize after every step and in windows of 10 steps; then,
per decode step and per prefill: the wall time (host clock to a
synchronize), the device's busy time (the sum of its kernels'
durations) and idle share, the kernels launched, the kernel time by
class and by name, and the host's busiest operators.

Run from the repository root on a machine with one NVIDIA card:
``python3 scripts/torch_serve_profile.py``.  Without CUDA it exits 1.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CLASSES = (  # (class, pattern on the kernel name), first match wins
    ("K7 flash attention", r"flash_fwd"),
    ("matmul", r"gemm|cutlass|xmma|nvjet|cublas|sm90_|gemv"),
    ("softmax", r"softmax"),
    ("reduction", r"reduce"),
    ("embedding / index / gather", r"embedding|index|gather|scatter"),
    ("copy / cast / cat", r"copy|cast|cat|fill"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def kernel_class(name: str, classes=CLASSES) -> str:
    for cls, pat in classes:
        if re.search(pat, name, re.I):
            return cls
    return "other"


def trace(fn, n, device, label, classes=CLASSES):
    """Trace ``n`` calls of ``fn``; print the breakdown per call, the
    kernels grouped by the first matching (class, name pattern)."""
    from torch.profiler import ProfilerActivity, profile

    cs.sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        cs.sync(device)
        wall = (time.perf_counter() - t0) * 1e3 / n
    by_name = collections.Counter()
    count = collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
            count[evt.name] += 1
    busy = sum(by_name.values()) / n
    print(f"{label}: wall_ms={wall:.2f} device_busy_ms={busy:.2f} "
          f"idle_share={1 - busy / wall:.3f} kernels="
          f"{sum(count.values()) / n:.0f}", flush=True)
    if not by_name:
        print(f"{label}: the profiler saw no device time", flush=True)
        return
    by_class = collections.Counter()
    for name, ms in by_name.items():
        by_class[kernel_class(name, classes)] += ms / n
    for cls, ms in by_class.most_common():
        print(f"  class {cls}: {ms:.3f} ms ({ms / busy:.1%} of busy)")
    for name, ms in by_name.most_common(10):
        print(f"  kernel {ms / n:9.3f} ms x{count[name] / n:.0f} "
              f"{name[:110]}")
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in ops[:10]:
        print(f"  host {e.self_cpu_time_total / 1e3 / n:8.3f} ms "
              f"x{e.count / n:.0f} {e.key[:80]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import qwen1_5_0_5b
    from repro_torch.models import transformer as tf

    device = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    cfg = qwen1_5_0_5b.config()
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    params = tf.init_params(cfg, gen, device)
    rng = np.random.default_rng(0)
    batch, prompt_len = cs.SERVE_BATCH, cs.SERVE_PROMPT
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt_len), dtype=np.int32)).to(device)
    serve = tf.make_serve_step(cfg)
    cache = tf.init_kv_cache(cfg, batch, prompt_len + cs.SERVE_GEN,
                             device=device)
    for i in range(prompt_len):  # the prompt, as phase g runs it
        logits, cache = serve(params, cache, prompt[:, i:i + 1])
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for _ in range(4):  # warm-up decode steps
        serve(params, cache, tok)
    # A decode step (and its greedy pick) timed two ways on this host, in
    # alternating rounds of 10 steps: each step ended by a synchronize,
    # and 10 steps as one window with a single synchronize at its end, as
    # launch/serve.py times its generation.
    synced, windows = [], []
    for _ in range(4):
        for _ in range(10):
            t0 = time.perf_counter()
            logits, cache = serve(params, cache, tok)
            torch.argmax(logits, -1)
            torch.cuda.synchronize(device)
            synced.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for _ in range(10):
            logits, cache = serve(params, cache, tok)
            torch.argmax(logits, -1)
        torch.cuda.synchronize(device)
        windows.append((time.perf_counter() - t0) * 1e3 / 10)
    print(f"decode step ms: synchronised after each step median "
          f"{float(np.median(synced)):.3f} mean {float(np.mean(synced)):.3f}"
          f" (40 steps); in windows of 10 steps {float(np.mean(windows)):.3f}"
          f" a step (rounds: {[round(w, 3) for w in windows]})", flush=True)
    trace(lambda: serve(params, cache, tok), 8, device,
          f"decode step (batch {batch}, cache {cache['length']} of "
          f"{prompt_len + cs.SERVE_GEN})")
    del cache
    torch.cuda.empty_cache()

    pcfg = dataclasses.replace(cfg, attn_chunk_k=1024)  # prefill_32k
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, cs.PREFILL_SEQ), dtype=np.int32)).to(device)
    prefill = tf.make_prefill(pcfg)
    prefill(params, toks)  # warm-up
    trace(lambda: prefill(params, toks), 1, device,
          f"prefill (seq {cs.PREFILL_SEQ}, batch 1, K7)")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
