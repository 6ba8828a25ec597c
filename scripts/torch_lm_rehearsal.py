#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s LM family phases on the CPU: m
(granite-moe-1b-a400m: training, serving through the read tier, the
prefill through K7, decode vs prefill in float32 with no drops), n
(granite-8b and command-r-plus-104b: decode held against the K7 prefill
of its prompt, a K7 prefill against the chunked one; then K7 at
granite-8b's head dim 128) and p (deepseek-v2-236b: MLA's absorbed
decode, a chunked prefill, decode vs prefill in float32), through
``chip_smoke.lm_family_phases`` as ``chip_smoke.py`` runs them after
phase k.

The phases run on the smoke configs with the kernels' plain versions,
each kernel wrapper wrapped in a stand-in that counts its calls as the
wrapper counts its launches on the card; the card-only memory calls read
0 and CUDA-event timings are host timings, so the times printed are CPU
times, not the card's.

    PYTHONPATH=src python3 scripts/torch_lm_rehearsal.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
from repro_torch.kernels.agg_adam import ops as agg_ops  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fa_ops  # noqa: E402
from torch_sharded_rehearsal import counting, host_ms  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    device = torch.device("cpu")
    wrappers = {
        "agg_adam_dense": counting(agg_ops, "aggregate_adam"),
        "flash_attention": counting(fa_ops, "flash_attention"),
    }
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.empty_cache = lambda *a, **k: None
    chip_smoke.sync = lambda device: None
    chip_smoke.time_ms = host_ms
    entries = {}
    counts = chip_smoke.lm_family_phases(device, wrappers, False, entries)
    e = entries["flash_attention:d128"]
    print(f"kernel flash_attention:d128: {e['shape']} max_abs_err="
          f"{e['max_abs_err']:.4e}", flush=True)
    print(f"phases m, n and p on the CPU: counters m, n, p = {list(counts)} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
