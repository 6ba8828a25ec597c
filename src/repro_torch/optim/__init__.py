"""Functional optimizers over parameter trees (``repro.optim``'s Adam and
Adagrad).

Each factory returns an ``Optimizer(init, step)`` pair with
``step(params, grads, state) -> (new_params, new_state)``.  With
``fused=True`` the Adam update is the dense kernel K5, written in place;
Adagrad always updates in place.  ``sgd`` is not ported yet (it comes with
the GNN family, ROADMAP.md, Queue 1 item 14).
"""

from .adagrad import AdagradState, adagrad
from .adam import AdamState, adam, adamw
from .base import Optimizer, OptState

__all__ = ["Optimizer", "OptState", "AdamState", "AdagradState", "adam",
           "adamw", "adagrad"]
