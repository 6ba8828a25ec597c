"""Synthetic batch generators (numpy, host side)."""

from .synthetic import lm_batch  # noqa: F401
