"""The port's GIN (``repro_torch.models.gnn``), its deterministic segment
sum, the gin-tu config and the GNN branch of ``launch/train.py``, held
against the reference (``repro.models.gnn``) on the same weights (the
reference's, carried across with ``gnn.params_from_numpy``) and the same
numpy graphs.

Tolerances.  Both packages run float32 on the CPU, but XLA and PyTorch
order the sums of matrix products and softmaxes differently, and the
port sums a long segment as partial sums.  A layer's output and the
logits: rtol 1e-5 with atol 1e-6 x the largest value; losses: rtol
1e-5.  Gradients: the dense LM's bound, rtol 1e-4 with atol 1e-6 x the
leaf's largest gradient magnitude.  Three Adam steps: Adam's first steps
move every weight by about ``lr`` whatever the gradient's size, so a
gradient sign that differs on a near-zero lane moves that weight by up
to 2 x lr; the parameters are held at atol 3 x 2 x lr everywhere and at
atol lr / 10 on all but 0.1 % of the lanes, the losses at rtol 1e-5.
The segment sum against ``index_add_`` (the same additions in the same
order) and two backward passes against each other: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gin_tu as jgin_tu
from repro.data import NeighborSampler as JSampler
from repro.data import molecule_batch, random_graph
from repro.models import gnn as jgnn
from repro.optim import adam as jadam
from repro.ps.runtime import _leaf_key
from repro_torch.configs import gin_tu as tgin_tu
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.models import gnn as tgnn
from repro_torch.optim import adam as tadam
from repro_torch.tree import tree_leaves_by_key, value_and_grad


def _cfgs(task="node", **kw):
    jcfg = dataclasses.replace(jgin_tu.smoke_config(), task=task, **kw)
    return jcfg, dataclasses.replace(tgin_tu.smoke_config(), task=task, **kw)


def _weights(jcfg, seed=0):
    """The reference's weights, its zero leaves (biases, eps) given values
    so that each is exercised, and the same tree in the port."""
    rng = np.random.default_rng(seed)
    jparams = jax.tree_util.tree_map(
        lambda x: x if np.any(np.asarray(x)) else
        jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype),
        jgnn.init_params(jcfg, jax.random.PRNGKey(seed)))
    tcfg = tgnn.GINConfig(**dataclasses.asdict(jcfg))
    return jparams, tgnn.params_from_numpy(tcfg, jparams, "cpu")


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def _node_graph(cfg, masked: bool, seed=0):
    """A power-law graph as a full-graph batch, or (masked) a sampled
    block of it: padded edges, ``edge_mask`` False on the padding."""
    rng = np.random.default_rng(seed)
    g = random_graph(rng, 300, 2400, cfg.d_feat, cfg.n_classes)
    if not masked:
        return g
    s = JSampler(g["edge_src"], g["edge_dst"], 300, (5, 3), seed=seed)
    b = s.make_batch(s.sample(np.arange(16)), g["feats"], g["labels"])
    assert not b["edge_mask"].all()
    return b


def _molecules(cfg, seed=0):
    return molecule_batch(np.random.default_rng(seed), 12, 30, 64,
                          cfg.d_feat, cfg.n_classes)


def _jleaves(tree):
    return {_leaf_key(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tleaves(tree):
    return {k: v.detach().float().numpy()
            for k, v in tree_leaves_by_key(tree).items()}


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


# ------------------------------------------------------------ segment sum
def _index_add(h, src, dst, n, mask=None):
    """The messages added into their nodes in edge order."""
    msgs = h[src.long()]
    if mask is not None:
        msgs, dst = msgs[mask], dst[mask]
    return torch.zeros((n, h.shape[1]), dtype=h.dtype).index_add_(
        0, dst.long(), msgs)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_sum_equals_index_add_bit_for_bit(masked):
    """No segment longer than the chunk: one segment sum, the additions
    of ``index_add_`` in the same order; its backward, the sum over
    out-edges, against ``index_add_`` by src."""
    rng = np.random.default_rng(1)
    n, e = 97, 1500
    src = torch.from_numpy(rng.integers(0, n, e, dtype=np.int32))
    dst = torch.from_numpy(rng.integers(0, n - 3, e, dtype=np.int32))
    mask = torch.from_numpy(rng.random(e) < 0.7) if masked else None
    h = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
    agg = tgnn.Aggregation(src, dst, n, mask=mask)
    assert agg.by_dst.chunk_offsets is None
    hh = h.clone().requires_grad_(True)
    out = agg(hh)
    assert torch.equal(out, _index_add(h, src, dst, n, mask))
    g = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
    (grad,) = torch.autograd.grad(out, hh, g)
    assert torch.equal(grad, _index_add(g, dst, src, n, mask))
    assert torch.equal(out[-3:], torch.zeros(3, 6))  # nodes with no in-edge


@pytest.mark.parametrize("chunk", [64, tgnn.AGG_CHUNK])
def test_hot_segment_sums_in_chunks_deterministically(chunk):
    """A power-law graph (``random_graph``: node 0 takes ~6 % of the
    edges here) whose hot segments exceed the chunk: partial sums of
    ``chunk`` messages in edge order, then each node's partials in
    order, equal to that two-level ``index_add_`` bit for bit; within
    float32 tolerance of the reference's ``segment_sum``; two passes
    equal bit for bit."""
    rng = np.random.default_rng(2)
    n, e = 400, 20000
    g = random_graph(rng, n, e, 8, 2)
    src, dst = (torch.from_numpy(g[k]) for k in ("edge_src", "edge_dst"))
    counts = np.bincount(g["edge_dst"], minlength=n)
    assert counts.max() > 4 * chunk  # the hot segment
    h = torch.from_numpy(g["feats"])
    agg = tgnn.Aggregation(src, dst, n, chunk=chunk)
    assert agg.by_dst.chunk_offsets is not None
    out = agg(h)
    # The reference order: each edge's chunk is its rank among its
    # node's in-edges // chunk; partials first, then per node.
    order = np.argsort(g["edge_dst"], kind="stable")
    rank = np.empty(e, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank[order] = np.arange(e) - np.repeat(starts, counts)
    n_chunks = np.maximum((counts + chunk - 1) // chunk, 1)
    first = np.concatenate([[0], np.cumsum(n_chunks)[:-1]])
    chunk_id = torch.from_numpy(first[g["edge_dst"]] + rank // chunk)
    partial = _index_add(h, src, chunk_id, int(n_chunks.sum()))
    owner = torch.from_numpy(np.repeat(np.arange(n), n_chunks))
    assert torch.equal(out, _index_add(partial, torch.arange(len(owner)),
                                       owner, n))
    want = jax.ops.segment_sum(jnp.asarray(g["feats"])[g["edge_src"]],
                               g["edge_dst"], num_segments=n)
    _close(out, want)
    grads = []
    for _ in range(2):
        hh = h.clone().requires_grad_(True)
        (gr,) = torch.autograd.grad((agg(hh) ** 2).sum(), hh)
        grads.append(gr)
    assert torch.equal(grads[0], grads[1])


def test_aggregation_rejects_bad_ids_and_row_counts():
    src = torch.tensor([0, 1, 5])
    with pytest.raises(ValueError, match="src"):
        tgnn.Aggregation(src, torch.tensor([0, 0, 1]), 4)
    agg = tgnn.Aggregation(src[:2], torch.tensor([0, 1]), 4)
    with pytest.raises(ValueError, match="rows"):
        agg(torch.zeros(3, 2))


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("masked", [False, True])
def test_gin_layer_matches_reference(masked):
    jcfg, _ = _cfgs()
    jparams, tparams = _weights(jcfg)
    g = _node_graph(jcfg, masked)
    jb, tb = _both(g)
    n = g["feats"].shape[0]
    want = jgnn.gin_layer(jparams["layers"][0], jb["feats"], jb["edge_src"],
                          jb["edge_dst"], n, jb.get("edge_mask"))
    got = tgnn.gin_layer(tparams["layers"][0], tb["feats"], tb["edge_src"],
                         tb["edge_dst"], n, tb.get("edge_mask"))
    _close(got, want)


def _loss_and_grads(jcfg, tcfg, jparams, tparams, batch):
    jb, tb = _both(batch)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jgnn.loss_fn(jcfg, p, b)))(jparams, jb)
    tl, tg = value_and_grad(lambda p, b: tgnn.loss_fn(tcfg, p, b))(
        tparams, tgnn.with_aggregation(tcfg, tb))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    j, t = _jleaves(jg), _tleaves(tg)
    assert t.keys() == j.keys()
    for k in j:
        np.testing.assert_allclose(
            t[k], j[k], rtol=1e-4, atol=1e-6 * float(np.abs(j[k]).max()),
            err_msg=k)
    return t


@pytest.mark.parametrize("masked", [False, True])
def test_node_loss_and_gradients_match_reference(masked):
    jcfg, tcfg = _cfgs()
    jparams, tparams = _weights(jcfg, seed=1)
    t = _loss_and_grads(jcfg, tcfg, jparams, tparams,
                        _node_graph(jcfg, masked, seed=1))
    for i in range(jcfg.n_layers):  # eps gets its gradient
        assert t[f"layers/{i}/eps"].shape == () and t[f"layers/{i}/eps"] != 0


@pytest.mark.parametrize("masked", [False, True])
def test_graph_loss_and_gradients_match_reference(masked):
    jcfg, tcfg = _cfgs("graph", d_feat=7, n_classes=2)
    jparams, tparams = _weights(jcfg, seed=2)
    batch = _molecules(jcfg, seed=2)
    if masked:
        batch["edge_mask"] = np.random.default_rng(3).random(
            batch["edge_src"].shape[0]) < 0.8
    t = _loss_and_grads(jcfg, tcfg, jparams, tparams, batch)
    assert t["layers/0/eps"] != 0
    jb, tb = _both(batch)
    _close(tgnn.graph_logits(tcfg, tparams, tb["feats"], tb["edge_src"],
                             tb["edge_dst"], tb["graph_ids"], 12,
                             tb.get("edge_mask")),
           jgnn.graph_logits(jcfg, jparams, jb["feats"], jb["edge_src"],
                             jb["edge_dst"], jb["graph_ids"], 12,
                             jb.get("edge_mask")))


@pytest.mark.parametrize("task", ["node", "graph"])
def test_three_adam_steps_match_reference(task):
    kw = {"d_feat": 7, "n_classes": 2} if task == "graph" else {}
    jcfg, tcfg = _cfgs(task, **kw)
    jparams, tparams = _weights(jcfg, seed=4)
    lr = 1e-3
    jopt, topt = jadam(lr), tadam(lr)
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    tstate = {"params": tparams, "opt": topt.init(tparams)}
    jstep = jax.jit(jgnn.make_train_step(jcfg, jopt))
    tstep = tgnn.make_train_step(tcfg, topt)
    for i in range(3):
        batch = (_molecules(jcfg, seed=i) if task == "graph"
                 else _node_graph(jcfg, i == 1, seed=i))
        jb, tb = _both(batch)
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


def test_two_backward_passes_equal_bit_for_bit():
    jcfg, tcfg = _cfgs()
    _, tparams = _weights(jcfg, seed=5)
    _, tb = _both(_node_graph(jcfg, True, seed=5))
    tb = tgnn.with_aggregation(tcfg, tb)
    fn = value_and_grad(lambda p, b: tgnn.loss_fn(tcfg, p, b))
    (l1, g1), (l2, g2) = fn(tparams, tb), fn(tparams, tb)
    assert torch.equal(l1, l2)
    a, b = tree_leaves_by_key(g1), tree_leaves_by_key(g2)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_init_params_tree_and_conversion():
    _, tcfg = _cfgs()
    jcfg = jgin_tu.config()
    p = tgnn.init_params(tcfg, device="cpu")
    want = {_leaf_key(k): np.shape(v) for k, v in
            jax.tree_util.tree_flatten_with_path(
                jgnn.init_params(jgin_tu.smoke_config(),
                                 jax.random.PRNGKey(0)))[0]}
    assert {k: tuple(v.shape) for k, v in tree_leaves_by_key(p).items()} \
        == want
    assert isinstance(p["layers"], list) and p["layers"][0]["eps"].dtype \
        == torch.float32
    jfull = jgnn.init_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(ValueError):
        tgnn.params_from_numpy(tcfg, jfull, "cpu")  # the full config's


# -------------------------------------------------- config, registry, train
def test_gin_tu_config_equals_reference():
    assert tgin_tu.GRAPH_SHAPES == jgin_tu.GRAPH_SHAPES
    for f in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(tgin_tu, f)()) == \
            dataclasses.asdict(getattr(jgin_tu, f)())
    for shape in jgin_tu.GRAPH_SHAPES:
        assert dataclasses.asdict(tgin_tu.model_for_shape(shape)) == \
            dataclasses.asdict(jgin_tu.model_for_shape(shape))
    assert registry.get_smoke_config("gin-tu") == tgin_tu.smoke_config()


def test_launch_train_gin_trains_and_resumes(tmp_path, capsys):
    argv = ["--arch", "gin-tu", "--smoke", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
            "--log-every", "1"]
    train.main(argv + ["--steps", "9"])
    first = capsys.readouterr().out
    losses = [float(l.split("loss=")[1].split()[0])
              for l in first.splitlines() if l.startswith("[train] step=")]
    assert len(losses) == 9 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    train.main(argv + ["--steps", "12"])
    out = capsys.readouterr().out
    assert "[train] restored checkpoint step 8" in out
    steps = [int(l.split("step=")[1].split()[0]) for l in out.splitlines()
             if l.startswith("[train] step=")]
    assert steps == [9, 10, 11]
