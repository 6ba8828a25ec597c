"""Synthetic batch generators (numpy, host side)."""

from .synthetic import dien_batch, lm_batch, recsys_batch, sasrec_batch  # noqa: F401
