"""Optimizer interface (``repro.optim.base``)."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..tree import tree_map

PyTree = Any
OptState = Any


class Optimizer(NamedTuple):
    """A tree optimizer.

    init(params) -> state
    step(params, grads, state) -> (new_params, new_state)
    """

    init: Callable[[PyTree], OptState]
    step: Callable[[PyTree, PyTree, OptState], Tuple[PyTree, OptState]]
    name: str = "optimizer"


def tree_zeros_like(params: PyTree, dtype=None) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype or p.dtype,
                                          device=p.device), params)
