#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s phase w on the CPU: the mesh layer on a
one-rank host mesh (gloo here, NCCL on the card) through
``chip_smoke.mesh_phase`` at small settings: w1, DLRM-RM2's smoke tables
through the row-sharded lookup's mesh branch against the one-device
lookup; w2, granite-moe's smoke MoE layer through ``moe_ffn_sharded``
against the same run in a child process; w3, Qwen's smoke training cell
with DTensor params against plain tensors; w5, gin-tu's ogb_products
pass through GIN's mesh branch against the one-device plan, on the graph
cut by ``chip_smoke.GNN_CUT`` (widths kept).  w4 (the dry-run children
on the production meshes) runs on the card only; run it here with
``PYTHONPATH=src python -m repro_torch.launch.dryrun``.

K6 runs its plain version, wrapped in a stand-in that counts its calls
as the wrapper counts its launches on the card; the card-only memory
calls read 0 and CUDA-event timings are host timings, so the times
printed are CPU times, not the card's.

    PYTHONPATH=src python3 scripts/torch_mesh_rehearsal.py
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
from repro_torch.kernels.embed_bag import ops as eb_ops  # noqa: E402
from torch_sharded_rehearsal import counting, host_ms  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    device = torch.device("cpu")
    wrappers = {"embed_bag": counting(eb_ops, "embedding_bags")}
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.empty_cache = lambda *a, **k: None
    chip_smoke.sync = lambda device: None
    chip_smoke.time_ms = host_ms
    counts = chip_smoke.mesh_phase(
        device, wrappers, False, chip_smoke.gnn_graph("ogb_products", False),
        chip_smoke.w2_cpu_start(False))
    print(f"phase w on the CPU: counters={counts} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
