"""Models of the port (``repro.models``): the decoder-only LM
(``transformer``: GQA and MLA attention, dense and MoE FFNs) with its
layers, attention and MoE FFN (``moe``), and the recsys family
(``recsys``: DLRM, SASRec, DIEN and the system EmbeddingBag).  The GNN
is not ported yet (ROADMAP.md, Queue 1 item 15, part 4)."""
