"""Functional optimizers over parameter trees (``repro.optim``'s Adam).

Each factory returns an ``Optimizer(init, step)`` pair with
``step(params, grads, state) -> (new_params, new_state)``.  With
``fused=True`` the Adam update is the dense kernel K5, written in place.
``sgd`` and ``adagrad`` are not ported yet (ROADMAP.md, Queue 1 item 14).
"""

from .adam import AdamState, adam, adamw
from .base import Optimizer, OptState

__all__ = ["Optimizer", "OptState", "AdamState", "adam", "adamw"]
