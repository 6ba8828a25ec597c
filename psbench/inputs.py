"""Inputs made from ``--seed``: every draw has a generator of its own,
seeded from the run's seed and the draw's name, so a draw's values do not
depend on what was drawn before it, and the reference can make the same
draw again after the program's state is gone."""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one named draw of the run ``seed``."""
    text = repr((int(seed),) + tuple(str(p) for p in parts)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def normal(n: int, scale: float, seed: int, *parts,
           device: torch.device) -> torch.Tensor:
    """``n`` float32 draws of N(0, scale^2), made on ``device`` in one
    call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *parts))
    out = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    return out.mul_(scale)


def rng(seed: int, *parts) -> np.random.Generator:
    """A host generator for choices (samples, orders) of the run."""
    return np.random.default_rng(sub_seed(seed, *parts))
