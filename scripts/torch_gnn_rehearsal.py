#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s phases u and v on the CPU: u, gin-tu at
its four graph shapes (full_graph_sm through ``launch/train.main`` on the
smoke config; ogb_products and minibatch_lg at their published widths
and fanouts with nodes and edges cut by ``chip_smoke.GNN_CUT``; molecule
whole), and v, the port's examples at small settings, through
``chip_smoke.gnn_phase`` and ``chip_smoke.examples_phase`` as
``chip_smoke.py`` runs them after phase p.

The kernels run their plain versions, each wrapper wrapped in a stand-in
that counts its calls as the wrapper counts its launches on the card;
the card-only memory calls read 0 and CUDA-event timings are host
timings, so the times printed are CPU times, not the card's.

    PYTHONPATH=src python3 scripts/torch_gnn_rehearsal.py
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
from repro_torch.kernels.relayout import ops as rl_ops  # noqa: E402
from torch_sharded_rehearsal import counting, host_ms  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    device = torch.device("cpu")
    wrappers = {
        "agg_adam_multijob_fused": counting(
            agg_ops, "aggregate_adam_multijob_fused"),
        "relayout_stage": counting(rl_ops, "relayout_stage"),
        "relayout_scatter": counting(rl_ops, "relayout_scatter"),
        "agg_adam_dense": counting(agg_ops, "aggregate_adam"),
    }
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.empty_cache = lambda *a, **k: None
    chip_smoke.sync = lambda device: None
    chip_smoke.time_ms = host_ms
    counts_u = chip_smoke.gnn_phase(device, wrappers, False)
    counts_v = chip_smoke.examples_phase(device, wrappers, False)
    print(f"phases u and v on the CPU: counters u={counts_u} v={counts_v} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
