"""PyTorch/CUDA port of the elastic parameter service.

The JAX package ``repro`` is the reference; this package grows beside it
slice by slice and imports nothing of it.  Entry points run on the first
CUDA card unless given ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
