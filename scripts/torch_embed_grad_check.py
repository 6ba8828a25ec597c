#!/usr/bin/env python3
"""Is the embedding gradient the same from run to run on the card?

For each of DLRM-RM2's 26 tables (padded rows as in ``dlrm_init``), the
ids of one seeded train batch of 65,536 (``data.recsys_batch``, as
``launch/train.py`` draws them) and a seeded float32 cotangent, it
computes the dense (V, 64) table gradient twice with
``embedding_dense_backward`` (``F.embedding``'s backward) and twice with
``models.recsys._dense_grad`` (the port's, under the embedding bag), and
prints, per way, the tables whose two results differ, with the lanes
that differ and the largest difference, and whether the two ways agree
within float32 rounding.

Run from the repository root on a machine with one NVIDIA card:
``python3 scripts/torch_embed_grad_check.py``.  Without CUDA it exits 1.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def model_gathers(device, gen):
    """SASRec's and DIEN's gathers: for each, whether two identical
    backward passes agree, through ``F.embedding``'s backward and through
    ``recsys._dense_grad``."""
    from repro_torch.configs import dien, sasrec
    from repro_torch.data import dien_batch, sasrec_batch
    from repro_torch.models import recsys

    batch = 65536
    rng = np.random.default_rng(0)
    s_cfg, d_cfg = sasrec.config(), dien.config()
    sb = sasrec_batch(rng, batch, s_cfg.seq_len, s_cfg.n_items)
    rng = np.random.default_rng(0)
    db = dien_batch(rng, batch, d_cfg.seq_len, d_cfg.n_items, d_cfg.n_cats)
    cases = [(f"sasrec item_emb[{k}]", s_cfg.n_items, s_cfg.embed_dim, sb[k])
             for k in ("seq", "pos", "neg")]
    cases += [(f"dien item_emb[{k}]", d_cfg.n_items, d_cfg.embed_dim, db[k])
              for k in ("hist_items", "target_item")]
    cases += [(f"dien cat_emb[{k}]", d_cfg.n_cats, d_cfg.embed_dim, db[k])
              for k in ("hist_cats", "target_cat")]
    lines = []
    for name, rows, dim, ids in cases:
        ids = torch.from_numpy(ids).to(device).long()
        cot = torch.randn(*ids.shape, dim, generator=gen, device=device)
        out = {}
        for way, fn in (("F.embedding", lambda g, i, v: torch.ops.aten
                         .embedding_dense_backward(g, i, v, -1, False)),
                        ("_dense_grad", recsys._dense_grad)):
            a, b = (fn(cot, ids, rows) for _ in range(2))
            out[way] = ("bit for bit" if torch.equal(a, b) else
                        f"differ in {int((a != b).sum())} lanes, max "
                        f"{float((a - b).abs().max()):.3e}")
        lines.append(f"{name} (V {rows}, {ids.numel()} ids): two passes "
                     + "; ".join(f"{w} {r}" for w, r in out.items()))
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_embed_grad_check: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import dlrm_rm2
    from repro_torch.data import recsys_batch
    from repro_torch.models import recsys

    device = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card} torch {torch.__version__}", flush=True)
    cfg = dlrm_rm2.config()
    batch = dlrm_rm2.TRAIN_BATCH
    ids = torch.from_numpy(recsys_batch(np.random.default_rng(0), batch,
                                        cfg.n_dense, cfg.vocab_sizes)
                           ["sparse"]).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ways = {
        "embedding_dense_backward": lambda g, i, v: (
            torch.ops.aten.embedding_dense_backward(g, i, v, -1, False)),
        "recsys._dense_grad": recsys._dense_grad,
    }
    differ = {w: [] for w in ways}
    worst_between = 0.0
    for f, vocab in enumerate(cfg.vocab_sizes):
        rows = recsys.pad_vocab(vocab)
        idx = ids[:, f:f + 1].contiguous()
        cot = torch.randn(batch, 1, cfg.embed_dim, generator=gen,
                          device=device)
        first = {}
        for way, fn in ways.items():
            a, b = fn(cot, idx, rows), fn(cot, idx, rows)
            if not torch.equal(a, b):
                differ[way].append(
                    f"table {f} (V {rows}): {int((a != b).sum())} lanes, "
                    f"max {float((a - b).abs().max()):.3e}")
            first[way] = a
            del b
        x, y = first.values()
        worst_between = max(worst_between, float(
            (x - y).abs().max() / x.abs().max().clamp_min(1e-30)))
        del first, x, y
    for way, lines in differ.items():
        print(f"{way}: {len(lines)} of {cfg.n_sparse} tables differ between "
              f"two identical passes" + ("" if not lines else ": "
                                         + "; ".join(lines)), flush=True)
    print(f"largest difference between the two ways, over the table's "
          f"largest gradient: {worst_between:.3e}", flush=True)
    for line in model_gathers(device, gen):
        print(line, flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
