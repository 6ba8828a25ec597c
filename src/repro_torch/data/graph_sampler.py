"""Fanout neighbour sampler (``repro.data.graph_sampler``), numpy on the
host: GraphSAGE-style minibatches for the GNN's minibatch training.

`build_csr` converts an edge list to CSR once; `NeighborSampler.sample`
draws a k-hop sampled subgraph around a seed batch with per-hop fanouts
(the minibatch_lg shape uses fanout 15-10), returning fixed-size padded
arrays (edge_mask marks real edges).  A copy of the reference: the same
seed gives the same blocks, array for array, because its sequence of
``rng.choice`` calls is the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


def build_csr(edge_src: np.ndarray, edge_dst: np.ndarray, n_nodes: int):
    """CSR of incoming edges: for each node, the list of its neighbors
    (message sources). Returns (indptr, indices)."""
    order = np.argsort(edge_dst, kind="stable")
    indices = edge_src[order]
    counts = np.bincount(edge_dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, indices


@dataclass
class SampledBlock:
    """Padded sampled subgraph: local ids 0..n_active-1, seeds first."""

    node_ids: np.ndarray  # (max_nodes,) global ids (padded w/ 0)
    n_active: int
    edge_src: np.ndarray  # (max_edges,) local ids
    edge_dst: np.ndarray
    edge_mask: np.ndarray  # (max_edges,) bool
    seed_count: int


class NeighborSampler:
    def __init__(self, edge_src, edge_dst, n_nodes: int, fanouts: Sequence[int],
                 seed: int = 0):
        self.indptr, self.indices = build_csr(
            np.asarray(edge_src), np.asarray(edge_dst), n_nodes
        )
        self.n_nodes = n_nodes
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    def max_sizes(self, batch_nodes: int) -> Tuple[int, int]:
        """Padded (max_nodes, max_edges) for a given seed-batch size."""
        nodes, edges, frontier = batch_nodes, 0, batch_nodes
        for f in self.fanouts:
            edges += frontier * f
            frontier *= f
            nodes += frontier
        return nodes, edges

    def sample(self, seeds: np.ndarray) -> SampledBlock:
        seeds = np.asarray(seeds, dtype=np.int64)
        max_nodes, max_edges = self.max_sizes(len(seeds))

        local: Dict[int, int] = {int(g): i for i, g in enumerate(seeds)}
        node_ids: List[int] = list(map(int, seeds))
        es: List[int] = []
        ed: List[int] = []

        frontier = seeds
        for fanout in self.fanouts:
            next_frontier: List[int] = []
            for g in frontier:
                lo, hi = self.indptr[g], self.indptr[g + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(fanout, deg)
                picks = self.indices[
                    lo + self.rng.choice(deg, size=take, replace=False)
                ]
                for nb in picks:
                    nb = int(nb)
                    if nb not in local:
                        local[nb] = len(node_ids)
                        node_ids.append(nb)
                        next_frontier.append(nb)
                    # message edge: neighbor -> node
                    es.append(local[nb])
                    ed.append(local[int(g)])
            frontier = np.asarray(next_frontier, dtype=np.int64)
            if len(frontier) == 0:
                break

        n_active, n_e = len(node_ids), len(es)
        pad_nodes = np.zeros(max_nodes, np.int32)
        pad_nodes[:n_active] = np.asarray(node_ids, np.int32)
        pe_src = np.zeros(max_edges, np.int32)
        pe_dst = np.zeros(max_edges, np.int32)
        mask = np.zeros(max_edges, bool)
        pe_src[:n_e] = np.asarray(es, np.int32)
        pe_dst[:n_e] = np.asarray(ed, np.int32)
        mask[:n_e] = True
        return SampledBlock(pad_nodes, n_active, pe_src, pe_dst, mask, len(seeds))

    def make_batch(self, block: SampledBlock, feats, labels) -> Dict:
        """The padded minibatch dict (numpy) of a sampled block."""
        label_mask = np.zeros(block.node_ids.shape[0], bool)
        label_mask[: block.seed_count] = True
        return {
            "feats": feats[block.node_ids],
            "edge_src": block.edge_src,
            "edge_dst": block.edge_dst,
            "edge_mask": block.edge_mask,
            "labels": labels[block.node_ids].astype(np.int32),
            "label_mask": label_mask,
        }
