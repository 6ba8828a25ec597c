"""Models of the port (``repro.models``): the dense decoder-only LM
(``transformer``) with its layers and attention, and the recsys family
(``recsys``: DLRM, SASRec, DIEN and the system EmbeddingBag).  MoE, MLA
and GNN models are not ported yet (ROADMAP.md, Queue 1 item 15)."""
