#!/usr/bin/env python3
"""Qwen1.5-0.5B's decode step time on the card, for comparing two
checkouts of the port in one call.

Runs ``launch/serve.decode`` at ``chip_smoke.py`` phase g's shape (batch
16, a 128-token prompt by repeated decode, 128 generated tokens; seeded
random bf16 weights, no read tier) once to warm up and ``--runs`` times
after, and prints each run's decode milliseconds a step (the host clock
over the generated steps, ending in a synchronize), their median, and
the card's name and power limit.  ``--src DIR`` imports ``repro_torch``
from DIR (e.g. a ``git archive`` of another commit unpacked under
``build/``), so parent and change run in one call, in turns:

    python3 scripts/torch_decode_ab.py --src build/parent/src
    python3 scripts/torch_decode_ab.py

Without CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_ab: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import qwen1_5_0_5b
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    device = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    cfg = qwen1_5_0_5b.config()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, device)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (16, 128), dtype=np.int32)).to(device)
    gen_len = 128
    serve.decode(cfg, params, prompt, gen_len)  # warm-up
    ms = []
    for _ in range(args.runs):
        out = serve.decode(cfg, params, prompt, gen_len)
        ms.append(out["gen_s"] * 1e3 / (gen_len - 1))
    print(json.dumps({"src": args.src, "card": card,
                      "decode_ms_per_step": ms,
                      "median": statistics.median(ms)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
