"""gin-tu: GIN, n_layers=5 d_hidden=64 aggregator=sum eps=learnable.
[arXiv:1810.00826; paper]

d_feat / n_classes are per-shape (the four assigned graph workloads pin the
datasets): full_graph_sm = Cora (2708 nodes, 1433 feats, 7 classes);
minibatch_lg = Reddit (232,965 nodes, 114.6M edges, 602 feats, 41 classes,
fanout 15-10 sampled); ogb_products (2.45M nodes, 61.86M edges, 100 feats,
47 classes); molecule = MUTAG-like batched small graphs (7 feats, 2 classes).
"""

from __future__ import annotations

import dataclasses

from ..arch import ArchSpec, ShapeCell
from ..models.gnn import GINConfig


def config() -> GINConfig:
    return GINConfig(name="gin-tu", n_layers=5, d_hidden=64,
                     d_feat=1433, n_classes=7, learnable_eps=True)


def smoke_config() -> GINConfig:
    return dataclasses.replace(config(), n_layers=2, d_hidden=16, d_feat=8,
                               n_classes=4)


# per-shape dataset shapes
GRAPH_SHAPES = {
    "full_graph_sm": dict(n_nodes=2_708, n_edges=10_556, d_feat=1_433,
                          n_classes=7, task="node"),
    "minibatch_lg": dict(n_nodes=232_965, n_edges=114_615_892, d_feat=602,
                         n_classes=41, task="node", batch_nodes=1_024,
                         fanouts=(15, 10)),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                         n_classes=47, task="node"),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=7,
                     n_classes=2, task="graph"),
}


def model_for_shape(shape: str) -> GINConfig:
    s = GRAPH_SHAPES[shape]
    return dataclasses.replace(
        config(), d_feat=s["d_feat"], n_classes=s["n_classes"], task=s["task"]
    )


def spec() -> ArchSpec:
    cells = {
        name: ShapeCell(name=name, kind="train", extras=dict(sh))
        for name, sh in GRAPH_SHAPES.items()
    }
    return ArchSpec(
        arch_id="gin-tu",
        family="gnn",
        model=config(),
        cells=cells,
        notes="Message passing = take + segment_sum; minibatch_lg uses the "
              "real fanout-(15,10) NeighborSampler. Aggregation placement "
              "applies (5 weight tensors) but is a small term vs graph "
              "scatter cost -- recorded, not skipped.",
    )
