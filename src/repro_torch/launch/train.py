"""Training driver (``repro.launch.train``): --arch <id> end-to-end
training on the card.

Synthetic LM batches -> ``make_train_step`` with the reference's
``adam(3e-4)`` -> loss and throughput lines.  Runs on ``cuda:0`` unless
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 20 --batch 8 --seq 512

The lm family runs; gnn and recsys archs are not ported yet (ROADMAP.md,
Queue 1 item 15), nor is checkpointing (``--ckpt-dir``, item 11).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import registry
from ..data import lm_batch
from ..device import resolve_device
from ..models import transformer as tf
from ..optim import adam


def build(arch: str, smoke: bool, batch: int, seq: int, device=None):
    """Returns (init_state, train_step, batch_fn, tokens_per_batch)."""
    if registry.family(arch) != "lm":
        raise NotImplementedError(
            f"arch {arch!r} ({registry.family(arch)}) is not ported yet "
            f"(ROADMAP.md, Queue 1 item 15)")
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    cfg = registry.get_smoke_config(arch) if smoke else registry.get_config(arch)
    opt = adam(3e-4)
    step = tf.make_train_step(cfg, opt)

    def init_state():
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = tf.init_params(cfg, gen, device)
        return {"params": params, "opt": opt.init(params)}

    def batch_fn():
        return {k: torch.from_numpy(v).to(device)
                for k, v in lm_batch(rng, batch, seq, cfg.vocab).items()}

    return init_state, step, batch_fn, batch * seq


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(registry.ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        raise NotImplementedError("checkpointing is not ported yet "
                                  "(ROADMAP.md, Queue 1 item 11)")

    init_state, step, batch_fn, tokens = build(
        args.arch, args.smoke, args.batch, args.seq, args.device)
    state = init_state()
    t0 = time.time()
    for i in range(args.steps):
        state, metrics = step(state, batch_fn())
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            rate = tokens * (i + 1) / max(dt, 1e-9)
            print(f"[train] step={i} loss={loss:.4f} items/s={rate:,.0f}",
                  flush=True)
    print("[train] done", flush=True)


if __name__ == "__main__":
    main()
