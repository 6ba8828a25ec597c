"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python psbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and prints
one JSON result line.  Nothing here imports ``jax`` or the JAX package;
``psbench/reference`` imports nothing of ``repro_torch`` either.
"""
