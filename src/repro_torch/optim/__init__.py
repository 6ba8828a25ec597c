"""Functional optimizers over parameter trees (``repro.optim``'s SGD,
Adam and Adagrad).

Each factory returns an ``Optimizer(init, step)`` pair with
``step(params, grads, state) -> (new_params, new_state)``.  With
``fused=True`` the Adam update is the dense kernel K5, written in place;
Adagrad always updates in place; SGD returns new tensors.
"""

from .adagrad import AdagradState, adagrad
from .adam import AdamState, adam, adamw
from .base import Optimizer, OptState
from .sgd import SgdState, sgd

__all__ = ["Optimizer", "OptState", "AdamState", "AdagradState", "SgdState",
           "sgd", "adam", "adamw", "adagrad"]
