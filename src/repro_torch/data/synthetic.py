"""Synthetic batch generators (``repro.data.synthetic``), numpy on the
host, shaped and typed like the real input specs: the same arrays as the
reference's from the same ``numpy.random.Generator``."""

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


def random_graph(
    rng, n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
    power_law: bool = True,
) -> Dict:
    """Directed edge list with a skewed (power-law-ish) degree distribution,
    node features, labels, and a train mask."""
    if power_law:
        w = 1.0 / (np.arange(1, n_nodes + 1) ** 0.8)
        p = w / w.sum()
        dst = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    else:
        dst = rng.integers(0, n_nodes, size=n_edges, dtype=np.int32)
    src = rng.integers(0, n_nodes, size=n_edges, dtype=np.int32)
    return {
        "feats": rng.standard_normal((n_nodes, d_feat)).astype(np.float32),
        "edge_src": src,
        "edge_dst": dst,
        "labels": rng.integers(0, n_classes, size=n_nodes, dtype=np.int32),
        "label_mask": (rng.random(n_nodes) < 0.3),
    }


def molecule_batch(
    rng, n_graphs: int, nodes_per_graph: int, edges_per_graph: int,
    d_feat: int, n_classes: int,
) -> Dict:
    """Batched small graphs (disjoint union) for graph classification."""
    n = n_graphs * nodes_per_graph
    e = n_graphs * edges_per_graph
    offs = np.repeat(np.arange(n_graphs) * nodes_per_graph, edges_per_graph)
    src = rng.integers(0, nodes_per_graph, size=e).astype(np.int32) + offs
    dst = rng.integers(0, nodes_per_graph, size=e).astype(np.int32) + offs
    return {
        "feats": rng.standard_normal((n, d_feat)).astype(np.float32),
        "edge_src": src.astype(np.int32),
        "edge_dst": dst.astype(np.int32),
        "graph_ids": np.repeat(np.arange(n_graphs), nodes_per_graph).astype(np.int32),
        "labels": rng.integers(0, n_classes, size=n_graphs, dtype=np.int32),
    }
