"""train_mfu: the whole training step's share of the card's bf16 peak:
the model FLOPs of the window's applied steps (forward and backward, 3
x 2 per multiply-add of every product, causal attention's half, no
recompute) over the window's seconds (host clock; the same untraced
steps as ``train_tokens_per_s``: the model, the service's pull, pack and
tick, and the host) times the data-sheet peak, in %.  The card's power
limit is written beside it."""

import importlib


def read(rec):
    if not rec.window_s or not rec.tokens or not rec.model_flops_per_token:
        return None
    if not rec.profile or not rec.profile["busy_s"]:
        return None  # no device ran: not a card's utilisation
    yardstick = importlib.import_module("psbench.yardstick")
    return (rec.model_flops_per_token * rec.tokens / rec.window_s
            / yardstick.BF16_FLOPS * 100.0)
