"""Synthetic batch generators (``repro.data.synthetic``), numpy on the
host, shaped and typed like the real input specs: the same arrays as the
reference's from the same ``numpy.random.Generator``.  The graph
generator comes with the GNN family (ROADMAP.md, Queue 1 item 15)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def lm_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int) -> Dict:
    toks = rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1  # masked
    return {"tokens": toks, "labels": labels}


def recsys_batch(
    rng: np.random.Generator, batch: int, n_dense: int, vocab_sizes: Sequence[int]
) -> Dict:
    dense = np.log1p(rng.exponential(1.0, size=(batch, n_dense))).astype(np.float32)
    sparse = np.stack(
        [rng.integers(0, v, size=batch, dtype=np.int32) for v in vocab_sizes], axis=1
    )
    labels = (rng.random(batch) < 0.25).astype(np.float32)
    return {"dense": dense, "sparse": sparse, "labels": labels}


def sasrec_batch(rng, batch: int, seq: int, n_items: int) -> Dict:
    seqs = rng.integers(1, n_items, size=(batch, seq), dtype=np.int32)
    pos = np.roll(seqs, -1, axis=1)
    pos[:, -1] = rng.integers(1, n_items, size=batch)
    neg = rng.integers(1, n_items, size=(batch, seq), dtype=np.int32)
    return {"seq": seqs, "pos": pos, "neg": neg}


def dien_batch(rng, batch: int, seq: int, n_items: int, n_cats: int) -> Dict:
    return {
        "hist_items": rng.integers(0, n_items, size=(batch, seq), dtype=np.int32),
        "hist_cats": rng.integers(0, n_cats, size=(batch, seq), dtype=np.int32),
        "target_item": rng.integers(0, n_items, size=batch, dtype=np.int32),
        "target_cat": rng.integers(0, n_cats, size=batch, dtype=np.int32),
        "labels": (rng.random(batch) < 0.5).astype(np.float32),
    }
