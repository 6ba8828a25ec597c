"""Synthetic batch generators (numpy, host side) and the fanout neighbour
sampler of the GNN's minibatch training."""

from .graph_sampler import NeighborSampler, build_csr  # noqa: F401
from .synthetic import (dien_batch, lm_batch, molecule_batch,  # noqa: F401
                        random_graph, recsys_batch, sasrec_batch)
