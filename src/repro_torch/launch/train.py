"""Training driver (``repro.launch.train``): --arch <id> end-to-end
training on the card.

Synthetic batches -> the family's train step with the reference's
optimizer (lm: ``adam(3e-4)``; dlrm: ``adagrad(0.01)``; sasrec and dien:
``adam(1e-3)``) -> CheckpointManager (background saves every
``--ckpt-every`` steps; a relaunch resumes from the latest step) -> loss
and throughput lines.  Weights come from a ``torch.Generator`` on the
device seeded with 0.  Runs on ``cuda:0`` unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 20 --batch 8 --seq 512 [--ckpt-dir DIR]
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 \\
      --steps 10 --batch 65536

Every lm arch (dense, MoE and MLA) and the recsys family run; the gnn
arch is not ported yet (ROADMAP.md, Queue 1 item 15, part 4).  No full
LM but Qwen1.5-0.5B and granite-moe-1b-a400m has a training state that
fits one 80 GB card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import registry
from ..data import dien_batch, lm_batch, recsys_batch, sasrec_batch
from ..device import resolve_device
from ..models import recsys
from ..models import transformer as tf
from ..optim import adagrad, adam


def _seeded(device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return gen


def _recsys(cfg, rng, batch: int):
    """(optimizer, loss, init, host batch) of one recsys config."""
    if isinstance(cfg, recsys.DLRMConfig):
        return (adagrad(0.01), lambda p, b: recsys.dlrm_loss(cfg, p, b),
                recsys.dlrm_init,
                lambda: recsys_batch(rng, batch, cfg.n_dense, cfg.vocab_sizes))
    if isinstance(cfg, recsys.SASRecConfig):
        return (adam(1e-3), lambda p, b: recsys.sasrec_loss(cfg, p, b),
                recsys.sasrec_init,
                lambda: sasrec_batch(rng, batch, cfg.seq_len, cfg.n_items))
    return (adam(1e-3), lambda p, b: recsys.dien_loss(cfg, p, b),
            recsys.dien_init,
            lambda: dien_batch(rng, batch, cfg.seq_len, cfg.n_items,
                               cfg.n_cats))


def build(arch: str, smoke: bool, batch: int, seq: int, device=None):
    """Returns (init_state, train_step, batch_fn, items_per_batch): tokens
    for an LM, examples for a recsys model."""
    fam = registry.family(arch)
    if fam not in ("lm", "recsys"):
        raise NotImplementedError(
            f"arch {arch!r} ({fam}) is not ported yet "
            f"(ROADMAP.md, Queue 1 item 15, part 4)")
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    cfg = registry.get_smoke_config(arch) if smoke else registry.get_config(arch)
    if fam == "recsys":
        opt, loss, init, host_batch = _recsys(cfg, rng, batch)

        def init_state():
            params = init(cfg, _seeded(device), device)
            return {"params": params, "opt": opt.init(params)}

        def batch_fn():
            return {k: torch.from_numpy(v).to(device)
                    for k, v in host_batch().items()}

        return init_state, recsys.make_train_step(loss, opt), batch_fn, batch

    opt = adam(3e-4)
    step = tf.make_train_step(cfg, opt)

    def init_state():
        params = tf.init_params(cfg, _seeded(device), device)
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

    init_state, step, batch_fn, tokens = build(
        args.arch, args.smoke, args.batch, args.seq, args.device)
    start = 0
    state = init_state()
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every)
        # The fresh state gives the restore its structure and shapes.
        found, restored = mgr.restore_latest(
            state, device=resolve_device(args.device))
        if found is not None:
            start, state = found + 1, restored
            print(f"[train] restored checkpoint step {found}", flush=True)
    t0 = time.time()
    for i in range(start, args.steps):
        state, metrics = step(state, batch_fn())
        if mgr is not None:
            mgr.maybe_save(i, state)
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            rate = tokens * (i - start + 1) / max(dt, 1e-9)
            print(f"[train] step={i} loss={loss:.4f} items/s={rate:,.0f}",
                  flush=True)
    if mgr is not None:
        mgr.wait()
    print("[train] done", flush=True)


if __name__ == "__main__":
    main()
