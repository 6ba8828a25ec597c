"""Workload configurations.

- ``paper_workloads``: the paper's testbed models as tensor inventories
  for the control plane.
- one module per architecture (the LMs, ``dlrm_rm2``, ``dlrm_mlperf``,
  ``sasrec``, ``dien``, ``gin_tu``) exposing ``config()`` (published
  dims), ``smoke_config()`` (reduced) and ``spec()`` (its cells).
- ``registry``: arch id -> config constructors, for --arch flags.
"""
