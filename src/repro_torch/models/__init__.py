"""Models of the port (``repro.models``): so far the dense decoder-only
LM (``transformer``) with its layers and attention.  MoE, MLA, recsys and
GNN models are not ported yet (ROADMAP.md, Queue 1 item 15)."""
