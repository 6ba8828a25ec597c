"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version; built from ``<family>/csrc`` on first use (see ``_build``)."""
