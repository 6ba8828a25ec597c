"""The port's recsys family (``repro_torch.models.recsys``: the system
EmbeddingBag, DLRM, SASRec, DIEN), Adagrad, the recsys configs, batch
generators and the recsys branch of ``launch/train.py``, held against the
reference on the same weights (the reference's, carried across bit for
bit with ``tree_from_numpy``) and the same numpy inputs.

Tolerances.  Everything runs in float32 on the CPU in both packages, but
XLA and PyTorch order the sums of matrix products, softmaxes and norms
differently.  The EmbeddingBag in all its forms: the reference kernel
test's rtol 1e-4 with atol 1e-6 (``tests/test_kernels.py``: K6 against
take + segment_sum).  Logits: rtol 1e-5 with atol 1e-6 x the largest
logit; losses: rtol 1e-5.  Gradients: rtol 1e-4 with atol 1e-6 x the
largest gradient magnitude of the whole model, not of the leaf: a leaf
whose true gradient is zero or cancels (DIEN's attention-logit bias,
which a softmax over the sequence ignores, so both packages return
rounding noise near 1e-11) has only absolute error to show.  Three
optimizer steps: Adagrad's and Adam's first steps move every weight by
about ``lr`` whatever the gradient's size, so a gradient sign that
differs on a near-zero lane moves that weight by up to 2 x lr; the
parameters are held at atol 3 x 2 x lr everywhere and at atol lr / 10 on
all but 0.1 % of the lanes, the losses at rtol 1e-5.  The EmbeddingBag's
gradient against ``F.embedding``'s, configs, vocab tuples and batches are
compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dien as jdien
from repro.configs import dlrm_mlperf as jmlperf
from repro.configs import dlrm_rm2 as jrm2
from repro.configs import sasrec as jsasrec
from repro.data import dien_batch, recsys_batch, sasrec_batch
from repro.models import recsys as jrec
from repro.optim import adagrad as jadagrad
from repro.optim import adam as jadam
from repro.ps.runtime import _leaf_key
from repro_torch import data as tdata
from repro_torch.configs import dien as tdien
from repro_torch.configs import dlrm_mlperf as tmlperf
from repro_torch.configs import dlrm_rm2 as trm2
from repro_torch.configs import registry
from repro_torch.configs import sasrec as tsasrec
from repro_torch.launch import train
from repro_torch.models import recsys as trec
from repro_torch.optim import adagrad as tadagrad
from repro_torch.optim import adam as tadam
from repro_torch.ps.runtime import tree_from_numpy
from repro_torch.tree import tree_leaves_by_key, value_and_grad

CONFIGS = {"dlrm-rm2": (jrm2, trm2), "dlrm-mlperf": (jmlperf, tmlperf),
           "sasrec": (jsasrec, tsasrec), "dien": (jdien, tdien)}


def _dlrm_batch(rng, cfg, n=64):
    return recsys_batch(rng, n, cfg.n_dense, cfg.vocab_sizes)


# model -> (config modules, reference init/loss, port init/loss, batch,
#           reference optimizer, port optimizer, lr)
MODELS = {
    "dlrm": (jrm2, trm2, jrec.dlrm_init, jrec.dlrm_loss, trec.dlrm_loss,
             _dlrm_batch, jadagrad(0.01), tadagrad(0.01), 0.01),
    "sasrec": (jsasrec, tsasrec, jrec.sasrec_init, jrec.sasrec_loss,
               trec.sasrec_loss,
               lambda rng, c: sasrec_batch(rng, 16, c.seq_len, c.n_items),
               jadam(1e-3), tadam(1e-3), 1e-3),
    "dien": (jdien, tdien, jrec.dien_init, jrec.dien_loss, trec.dien_loss,
             lambda rng, c: dien_batch(rng, 16, c.seq_len, c.n_items,
                                       c.n_cats),
             jadam(1e-3), tadam(1e-3), 1e-3),
}


def _weights(init, jcfg, seed=0):
    """The reference's weights, its all-zero leaves (biases) given values
    to compare, and the same tree as CPU tensors."""
    rng = np.random.default_rng(seed)
    jparams = jax.tree_util.tree_map(
        lambda x: x if np.any(np.asarray(x)) else
        jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype),
        init(jcfg, jax.random.PRNGKey(seed)))
    return jparams, tree_from_numpy(jparams, "cpu")


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _jleaves(tree):
    return {_leaf_key(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tleaves(tree):
    return {k: v.detach().float().numpy()
            for k, v in tree_leaves_by_key(tree).items()}


# ------------------------------------------------------------ EmbeddingBag
def _bag_inputs(seed=0, vocab=64, dim=8):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((vocab, dim)).astype(np.float32)
    idx = rng.integers(0, vocab, (6, 4), dtype=np.int32)
    flat = rng.integers(0, vocab, 13, dtype=np.int32)
    offsets = np.array([0, 3, 3, 7, 12], np.int32)  # an empty bag
    w2 = rng.random((6, 4)).astype(np.float32)
    w1 = rng.random(13).astype(np.float32)
    return table, idx, flat, offsets, w2, w1


FORMS = {  # name -> (uses offsets, weighted, mode)
    "fixed-sum": (False, False, "sum"), "fixed-mean": (False, False, "mean"),
    "weighted": (False, True, "sum"), "offsets-sum": (True, False, "sum"),
    "offsets-mean": (True, False, "mean"),
    "offsets-weighted-mean": (True, True, "mean"),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_embedding_bag_matches_reference(form):
    use_offsets, weighted, mode = FORMS[form]
    table, idx, flat, offsets, w2, w1 = _bag_inputs()
    ind = flat if use_offsets else idx
    w = (w1 if use_offsets else w2) if weighted else None
    off = offsets if use_offsets else None
    want = jrec.embedding_bag(
        jnp.asarray(table), jnp.asarray(ind),
        None if off is None else jnp.asarray(off),
        None if w is None else jnp.asarray(w), mode)
    got = trec.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ind),
        None if off is None else torch.from_numpy(off),
        None if w is None else torch.from_numpy(w), mode)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


def test_embedding_bag_rejects_unknown_mode_and_route():
    table, idx, *_ = _bag_inputs()
    with pytest.raises(ValueError, match="mode"):
        trec.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                           mode="max")
    with pytest.raises(ValueError, match="lookup"):
        trec.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                           lookup="sparse")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_gradient_equals_f_embedding_bit_for_bit(dtype):
    """K6's autograd Function: the dense table gradient that
    ``F.embedding`` + sum gives, bit for bit, with repeated ids (in one
    bag and across bags)."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((20, 12)).astype(
        np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 5, (30, 6), dtype=np.int32))
    cot = torch.from_numpy(rng.standard_normal((30, 12)).astype(np.float32)
                           ).to(dtype)
    t1 = table.clone().requires_grad_(True)
    trec.embedding_bag(t1, idx).backward(cot)
    t2 = table.clone().requires_grad_(True)
    torch.nn.functional.embedding(idx, t2).sum(1).backward(cot)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert t1.grad.dtype == dtype
    assert torch.equal(t1.grad.view(view), t2.grad.view(view))
    assert torch.count_nonzero(t1.grad[5:]) == 0


def test_one_row_bags_equal_takes_bit_for_bit():
    """DLRM's lookup: one bag of one row per field equals the reference's
    ``jnp.take`` per field bit for bit, through K6's route and its plain
    route."""
    rng = np.random.default_rng(4)
    tables = [rng.standard_normal((v, 8)).astype(np.float32)
              for v in (40, 7, 100)]
    ids = np.stack([rng.integers(0, v, 50, dtype=np.int32)
                    for v in (40, 7, 100)], axis=1)
    want = np.asarray(jrec.sharded_embedding_lookup(
        [jnp.asarray(t) for t in tables], jnp.asarray(ids)))
    for lookup in trec.LOOKUPS:
        got = trec.sharded_embedding_lookup(
            [torch.from_numpy(t) for t in tables], torch.from_numpy(ids),
            lookup=lookup)
        assert got.numpy().tobytes() == want.tobytes()


def test_mesh_lookup_raises_naming_its_item(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    with pytest.raises(NotImplementedError, match="item 16"):
        trec.sharded_embedding_lookup([torch.zeros(4, 2)],
                                      torch.zeros((3, 1), dtype=torch.int32))


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("model", sorted(MODELS))
def test_loss_and_gradients_match_reference(model):
    jmod, tmod, init, jloss, tloss, mk, *_ = MODELS[model]
    jcfg, tcfg = jmod.smoke_config(), tmod.smoke_config()
    jparams, tparams = _weights(init, jcfg)
    jb, tb = _both(mk(np.random.default_rng(0), jcfg))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jcfg, p, b)))(jparams, jb)
    tl, tg = value_and_grad(lambda p, b: tloss(tcfg, p, b))(tparams, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    j, t = _jleaves(jg), _tleaves(tg)
    assert t.keys() == j.keys()
    scale = max(float(np.abs(v).max()) for v in j.values())
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=k)


def _logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


def test_dlrm_forward_and_retrieval_match_reference():
    jcfg, tcfg = jrm2.smoke_config(), trm2.smoke_config()
    jparams, tparams = _weights(jrec.dlrm_init, jcfg, seed=1)
    jb, tb = _both(_dlrm_batch(np.random.default_rng(1), jcfg))
    _logits_close(trec.dlrm_forward(tcfg, tparams, tb["dense"], tb["sparse"]),
                  jrec.dlrm_forward(jcfg, jparams, jb["dense"], jb["sparse"]))
    cand = np.arange(0, jcfg.vocab_sizes[-1], 7, dtype=np.int32)
    args = (jb["dense"][:1], jb["sparse"][:1, :-1])
    want = jrec.dlrm_retrieval(jcfg, jparams, *args, jnp.asarray(cand))
    got = trec.dlrm_retrieval(tcfg, tparams, tb["dense"][:1],
                              tb["sparse"][:1, :-1], torch.from_numpy(cand))
    assert got.shape == (cand.size,)
    _logits_close(got, want)


def test_sasrec_and_dien_retrieval_match_reference():
    jcfg, tcfg = jsasrec.smoke_config(), tsasrec.smoke_config()
    jparams, tparams = _weights(jrec.sasrec_init, jcfg, seed=2)
    rng = np.random.default_rng(2)
    seq = rng.integers(0, jcfg.n_items, (3, jcfg.seq_len), dtype=np.int32)
    cand = rng.integers(0, jcfg.n_items, 40, dtype=np.int32)
    _logits_close(
        trec.sasrec_retrieval(tcfg, tparams, torch.from_numpy(seq),
                              torch.from_numpy(cand)),
        jrec.sasrec_retrieval(jcfg, jparams, jnp.asarray(seq),
                              jnp.asarray(cand)))
    jcfg, tcfg = jdien.smoke_config(), tdien.smoke_config()
    jparams, tparams = _weights(jrec.dien_init, jcfg, seed=3)
    hist = [rng.integers(0, n, (1, jcfg.seq_len), dtype=np.int32)
            for n in (jcfg.n_items, jcfg.n_cats)]
    cands = [rng.integers(0, n, 9, dtype=np.int32)
             for n in (jcfg.n_items, jcfg.n_cats)]
    _logits_close(
        trec.dien_retrieval(tcfg, tparams,
                            *(torch.from_numpy(x) for x in hist + cands)),
        jrec.dien_retrieval(jcfg, jparams,
                            *(jnp.asarray(x) for x in hist + cands)))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_three_optimizer_steps_match_reference(model):
    """Adagrad (DLRM) or Adam (SASRec, DIEN), three steps through each
    package's ``make_train_step`` on the same batches."""
    jmod, tmod, init, jloss, tloss, mk, jopt, topt, lr = MODELS[model]
    jcfg, tcfg = jmod.smoke_config(), tmod.smoke_config()
    jparams, tparams = _weights(init, jcfg, seed=5)
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    tstate = {"params": tparams, "opt": topt.init(tparams)}
    jstep = jax.jit(jrec.make_train_step(lambda p, b: jloss(jcfg, p, b),
                                         jopt))
    tstep = trec.make_train_step(lambda p, b: tloss(tcfg, p, b), topt)
    rng = np.random.default_rng(6)
    for _ in range(3):
        jb, tb = _both(mk(rng, jcfg))
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    j, t = _jleaves(jstate["params"]), _tleaves(tstate["params"])
    assert t.keys() == j.keys()
    diff = np.concatenate([np.abs(t[k] - j[k]).ravel() for k in j])
    assert diff.max() <= 3 * 2 * lr
    assert np.mean(diff > lr / 10) <= 1e-3
    assert tstate["opt"].count == 3


def test_adagrad_updates_in_place_in_the_reference_grouping():
    """One step on hand-made values, a bf16 leaf in a list included: p and
    the accumulator are written in place, equal bit for bit to numpy's
    float32 ``a + g*g`` and ``p - (lr*g)/(sqrt(a)+eps)`` (each operation
    correctly rounded), p rounded once to its dtype."""
    rng = np.random.default_rng(7)
    vals = {k: rng.standard_normal(n).astype(np.float32)
            for k, n in (("pa", 500), ("ga", 500), ("pb", 64), ("gb", 64))}
    p = {"a": torch.from_numpy(vals["pa"].copy()),
         "b": [torch.from_numpy(vals["pb"]).bfloat16()]}
    g = {"a": torch.from_numpy(vals["ga"]), "b": [torch.from_numpy(vals["gb"])]}
    opt = tadagrad(0.05, initial_accum=0.1)
    state = opt.init(p)
    want_p = {}
    for key, p0, g0 in (("a", vals["pa"], vals["ga"]),
                        ("b/0", p["b"][0].float().numpy(), vals["gb"])):
        f32 = np.float32
        a = f32(0.1) + g0 * g0
        want_p[key] = p0 - (f32(0.05) * g0) / (np.sqrt(a) + f32(1e-10))
    new_p, new_state = opt.step(p, g, state)
    assert new_p["a"] is p["a"] and new_state.accum is state.accum
    assert new_state.count == 1
    got = tree_leaves_by_key(new_p)
    assert got["a"].numpy().tobytes() == want_p["a"].tobytes()
    want_b = torch.from_numpy(want_p["b/0"]).bfloat16()
    assert torch.equal(got["b/0"].view(torch.int16), want_b.view(torch.int16))
    accum = tree_leaves_by_key(state.accum)["a"].numpy()
    assert accum.tobytes() == (np.float32(0.1) + vals["ga"] * vals["ga"]
                               ).tobytes()


# ------------------------------------------ configs, data, launch, trees
def test_configs_and_vocab_equal_the_reference():
    for arch, (jmod, tmod) in CONFIGS.items():
        for fn in ("config", "smoke_config"):
            assert (dataclasses.asdict(getattr(tmod, fn)())
                    == dataclasses.asdict(getattr(jmod, fn)())), (arch, fn)
        assert registry.get_config(arch) == tmod.config()
        assert registry.family(arch) == "recsys"
    assert trm2.VOCAB == jrm2.VOCAB
    assert tmlperf.CRITEO_TB_VOCAB == jmlperf.CRITEO_TB_VOCAB
    cells = jrm2.recsys_cells()
    assert trm2.TRAIN_BATCH == cells["train_batch"].batch
    assert trm2.SERVE_P99 == cells["serve_p99"].batch
    assert trm2.SERVE_BULK == cells["serve_bulk"].batch
    assert trm2.RETRIEVAL_CAND == cells["retrieval_cand"].extras[
        "n_candidates"]
    assert trm2.config().table_rows == 54_072_832
    assert trec.pad_vocab(1) == jrec.pad_vocab(1) == 512


def test_batch_generators_equal_the_reference():
    cfg = jrm2.config()
    for name, args in (("recsys_batch", (300, 13, cfg.vocab_sizes)),
                       ("sasrec_batch", (20, 50, 1000)),
                       ("dien_batch", (20, 30, 1000, 40))):
        import repro.data as jdata

        want = getattr(jdata, name)(np.random.default_rng(9), *args)
        got = getattr(tdata, name)(np.random.default_rng(9), *args)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=name)


def test_recsys_trees_cross_by_leaf_key():
    """``tree_from_numpy`` carries the lists of tables and MLP layers with
    the reference's leaf keys, shapes and dtypes, bit for bit."""
    for init, mod in ((jrec.dlrm_init, jrm2), (jrec.sasrec_init, jsasrec),
                      (jrec.dien_init, jdien)):
        jparams = init(mod.smoke_config(), jax.random.PRNGKey(1))
        j, t = _jleaves(jparams), tree_leaves_by_key(
            tree_from_numpy(jparams, "cpu"))
        assert t.keys() == j.keys()
        for k in j:
            assert t[k].numpy().tobytes() == j[k].tobytes(), k
    # The port's own init gives the same tree structure.
    for tinit, jinit, tmod, jmod in (
            (trec.dlrm_init, jrec.dlrm_init, trm2, jrm2),
            (trec.sasrec_init, jrec.sasrec_init, tsasrec, jsasrec),
            (trec.dien_init, jrec.dien_init, tdien, jdien)):
        t = tree_leaves_by_key(tinit(tmod.smoke_config(), device="cpu"))
        j = _jleaves(jinit(jmod.smoke_config(), jax.random.PRNGKey(0)))
        assert {k: tuple(v.shape) for k, v in t.items()} == {
            k: v.shape for k, v in j.items()}


def test_launch_train_dlrm_smoke_loss_falls(capsys):
    train.main(["--arch", "dlrm-rm2", "--smoke", "--device", "cpu",
                "--steps", "5"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[train] step=")]
    losses = [float(l.split("loss=")[1].split()[0]) for l in lines]
    assert len(losses) >= 2 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_launch_train_recsys_branch_and_unported_families():
    for arch in ("sasrec", "dien", "dlrm-mlperf"):
        init_state, step, batch_fn, items = train.build(arch, True, 4, 0,
                                                        "cpu")
        state, m = step(init_state(), batch_fn())
        assert items == 4 and np.isfinite(float(m["loss"]))
    with pytest.raises(NotImplementedError, match="item 15"):
        train.build("gin-tu", True, 4, 0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.build("dlrm-rm2", True, 4, 0)
