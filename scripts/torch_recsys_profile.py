#!/usr/bin/env python3
"""Where DLRM-RM2's training and scoring time goes on the card.

Builds DLRM-RM2 at its published widths (26 tables, 54,072,832 padded
rows x 64 float32; seeded random weights) through ``launch/train.build``
as ``chip_smoke.py`` phase i does, takes 2 warm-up steps of
``adagrad(0.01)`` at the train_batch cell's 65,536, then traces 3 steps
with ``torch.profiler``; then, under ``torch.inference_mode()``, traces
``dlrm_forward`` at serve_bulk (262,144; 3 calls) and serve_p99 (512; 10
calls).  For each it prints the wall time (host clock to a
synchronize), the device's busy time and idle share, the kernels
launched, the kernel time by class and by name, and the host's busiest
operators.

Run from the repository root on a machine with one NVIDIA card:
``python3 scripts/torch_recsys_profile.py``.  Without CUDA it exits 1.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

import torch_serve_profile as sp  # noqa: E402

CLASSES = (  # (class, pattern on the kernel name), first match wins
    ("K6 embedding bag", r"bags?_kernel"),
    ("embedding gradient (sort, segment sums)",
     r"embedding_backward|radix|sort|segment|partials|compute_grad|"
     r"sum_and_scatter|krn_"),
) + sp.CLASSES


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_recsys_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import dlrm_rm2
    from repro_torch.data import recsys_batch
    from repro_torch.launch import train
    from repro_torch.models import recsys

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    init_state, step, batch_fn, _ = train.build(
        "dlrm-rm2", False, dlrm_rm2.TRAIN_BATCH, 0, device)
    state = init_state()
    batches = [batch_fn() for _ in range(5)]
    for b in batches[:2]:  # warm-up
        state, _ = step(state, b)
    box = {"state": state, "i": 2}

    def one_step():
        box["state"], _ = step(box["state"], batches[box["i"]])
        box["i"] += 1

    sp.trace(one_step, 3, device,
             f"DLRM-RM2 train step (batch {dlrm_rm2.TRAIN_BATCH})", CLASSES)
    params = box.pop("state")["params"]
    cfg = dlrm_rm2.config()
    rng = np.random.default_rng(3)
    with torch.inference_mode():
        for n, reps in ((dlrm_rm2.SERVE_BULK, 3), (dlrm_rm2.SERVE_P99, 10)):
            b = {k: torch.from_numpy(v).to(device) for k, v in
                 recsys_batch(rng, n, cfg.n_dense, cfg.vocab_sizes).items()}
            recsys.dlrm_forward(cfg, params, b["dense"], b["sparse"])
            sp.trace(lambda: recsys.dlrm_forward(cfg, params, b["dense"],
                                                 b["sparse"]),
                     reps, device, f"DLRM-RM2 scoring (batch {n})", CLASSES)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
