"""Workload configurations.

- ``paper_workloads``: the paper's testbed models as tensor inventories
  for the control plane.
- one module per ported architecture (``qwen1_5_0_5b``) exposing
  ``config()`` (published dims) and ``smoke_config()`` (reduced).
- ``registry``: arch id -> config constructors, for --arch flags.
"""
