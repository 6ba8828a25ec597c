"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM for
a few hundred steps.

The synthetic token pipeline, the transformer (remat per layer), Adam
(``--fused-adam``: the dense Adam kernel K5, one launch a leaf a step),
and checkpoint/restart through ``CheckpointManager`` (kill it mid-run and
relaunch: it resumes from the latest saved step).  The loss should drop
markedly from random init (~ln(vocab)) within a few hundred steps.  The
torch counterpart of ``examples/train_lm_e2e.py``; ``--smoke`` swaps in
a 2-layer model and ``--save-every`` sets the checkpoint interval, for a
short run on the CPU.

Run: PYTHONPATH=src python examples/torch_train_lm_e2e.py [--steps 300]
     [--fused-adam] [--ckpt-dir build/torch_lm_e2e] [--device cpu --smoke]
"""

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.optim import adam

# ~100M params: 12L x d=640 x heads 10 (GQA kv=5), vocab 32k, tied.
CFG = tf.LMConfig(
    name="lm-100m", n_layers=12, d_model=640, n_heads=10, n_kv_heads=5,
    d_ff=1708, vocab=32000, tie_embeddings=True, loss_chunk=64,
)
SMOKE_CFG = tf.LMConfig(
    name="lm-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, tie_embeddings=True, loss_chunk=16,
)


def main(argv=None) -> dict:
    """Returns the resumed-from step (or None), the first and last logged
    losses and the steps run."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="build/torch_lm_e2e")
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--fused-adam", action="store_true",
                    help="route updates through the dense Adam kernel (K5)")
    ap.add_argument("--smoke", action="store_true",
                    help="a 2-layer d 64 model (CPU-friendly)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = SMOKE_CFG if args.smoke else CFG
    opt = adam(3e-4, fused=args.fused_adam)
    step = tf.make_train_step(cfg, opt)
    print(f"model: {cfg.param_count / 1e6:.1f}M params")

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, device)
    state = {"params": params, "opt": opt.init(params)}
    mgr = CheckpointManager(args.ckpt_dir, save_every=args.save_every,
                            keep_last=2)
    start = 0
    # The fresh state gives the restore its structure and shapes.
    found, restored = mgr.restore_latest(state, device=device)
    if found is not None:
        start, state = found + 1, restored
        print(f"resumed from checkpoint step {found}")

    rng = np.random.default_rng(0)
    # A repeating synthetic corpus so the model can fit it (loss drops).
    corpus = rng.integers(0, cfg.vocab, size=(64, args.seq), dtype=np.int32)

    t0, first_loss, loss = time.time(), None, None
    for i in range(start, args.steps):
        toks = corpus[rng.integers(0, corpus.shape[0], size=args.batch)]
        labels = np.concatenate(
            [toks[:, 1:], -np.ones((args.batch, 1), np.int32)], axis=1)
        state, m = step(state, {"tokens": torch.from_numpy(toks).to(device),
                                "labels": torch.from_numpy(labels).to(device)})
        mgr.maybe_save(i, state)
        if i % 25 == 0 or i == args.steps - 1:
            loss = float(m["loss"])
            first_loss = loss if first_loss is None else first_loss
            tput = args.batch * args.seq * (i - start + 1) / (time.time() - t0)
            print(f"step={i:4d} loss={loss:.4f} tok/s={tput:,.0f}")
    mgr.wait()
    if loss is not None:
        print(f"loss: {first_loss:.3f} -> {loss:.3f} "
              f"(random-init ~= ln(vocab) = {math.log(cfg.vocab):.2f})")
    return {"resumed_from": found, "first_loss": first_loss,
            "last_loss": loss, "steps": max(args.steps - start, 0)}


if __name__ == "__main__":
    main()
