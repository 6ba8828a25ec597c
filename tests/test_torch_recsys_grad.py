"""SASRec's and DIEN's embedding gradients against the fixed-order sum.

Both models gather their embeddings with ``F.embedding`` (the reference's
``jnp.take``).  On the card its backward summed repeated ids in a
run-dependent order for DLRM-RM2's small tables, so DLRM's lookup takes
its gradient from ``models.recsys._dense_grad`` (a stable sort of the ids
and one sequential segment sum per row).  For SASRec's and DIEN's ids
the card's backward gave the same result twice (phase k of
``chip_smoke.py`` holds two whole backward passes bit for bit), so they
keep ``F.embedding``.  These tests hold the models' whole gradient with
``F.embedding`` against the same gradient with every gather's backward
replaced by ``_dense_grad``, bit for bit on the CPU: the fixed-order route
is a drop-in that changes no number, should the card's backward ever
need it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import dien, sasrec
from repro_torch.data import dien_batch, sasrec_batch
from repro_torch.models import recsys
from repro_torch.tree import tree_leaves_by_key, value_and_grad


class _FixedOrderGather(torch.autograd.Function):
    backward_calls = 0

    @staticmethod
    def forward(ctx, ids, table):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        _FixedOrderGather.backward_calls += 1
        return None, recsys._dense_grad(grad, ids, ctx.n_rows)


class _FunctionalWithFixedGather:
    """``torch.nn.functional`` with ``embedding`` taking the fixed-order
    backward."""

    embedding = staticmethod(_FixedOrderGather.apply)

    def __getattr__(self, name):
        return getattr(F, name)


def _case(arch):
    rng = np.random.default_rng(0)
    if arch == "sasrec":
        cfg = sasrec.smoke_config()
        params = recsys.sasrec_init(cfg, device="cpu")
        host = sasrec_batch(rng, 64, cfg.seq_len, cfg.n_items)
        loss = lambda p, b: recsys.sasrec_loss(cfg, p, b)  # noqa: E731
    else:
        cfg = dien.smoke_config()
        params = recsys.dien_init(cfg, device="cpu")
        host = dien_batch(rng, 64, cfg.seq_len, cfg.n_items, cfg.n_cats)
        loss = lambda p, b: recsys.dien_loss(cfg, p, b)  # noqa: E731
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    return params, batch, value_and_grad(loss)


@pytest.mark.parametrize("arch", ["sasrec", "dien"])
def test_embedding_gradient_equals_the_fixed_order_sum(arch, monkeypatch):
    params, batch, grad = _case(arch)
    loss_e, g_e = grad(params, batch)
    monkeypatch.setattr(recsys, "F", _FunctionalWithFixedGather())
    calls = _FixedOrderGather.backward_calls
    loss_f, g_f = grad(params, batch)
    assert _FixedOrderGather.backward_calls - calls == (3 if arch == "sasrec"
                                                        else 4)
    assert torch.equal(loss_e, loss_f)
    le, lf = tree_leaves_by_key(g_e), tree_leaves_by_key(g_f)
    assert le.keys() == lf.keys()
    for key in le:
        assert torch.equal(le[key], lf[key]), key
    # the ids repeat, so the sum's order matters at all
    ids = batch["seq"] if arch == "sasrec" else batch["hist_cats"]
    assert ids.unique().numel() < ids.numel()
