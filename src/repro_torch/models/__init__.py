"""Models of the port (``repro.models``): the decoder-only LM
(``transformer``: GQA and MLA attention, dense and MoE FFNs) with its
layers, attention and MoE FFN (``moe``), the recsys family (``recsys``:
DLRM, SASRec, DIEN and the system EmbeddingBag) and the GNN (``gnn``:
GIN over a deterministic segment sum)."""
