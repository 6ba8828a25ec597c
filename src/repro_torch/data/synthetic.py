"""Synthetic batch generators (``repro.data.synthetic``), numpy on the
host, shaped and typed like the real input specs.  The LM batch so far;
the recsys and graph generators come with their models (ROADMAP.md,
Queue 1 item 15)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def lm_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int) -> Dict:
    toks = rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1  # masked
    return {"tokens": toks, "labels": labels}
