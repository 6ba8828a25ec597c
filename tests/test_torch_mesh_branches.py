"""The port's mesh branches for the dry-run's cells on 1, 2 and 4 gloo
ranks against the reference on as many XLA host devices, with the same
weights and inputs through numpy.

* GIN (``models.gnn``: ``MeshAggregation``, ``mesh_readout``) with masked
  edges, the node task and the graph task: the loss and every gradient
  against the reference's ``loss_fn``; the edges sharded over every
  mesh axis, the node rows (node task) or the graphs (graph task) as the
  dry-run's cells shard them.
* SASRec's gathers from its row-sharded item table
  (``recsys.gather_rows``): each of the four gathers (``seq``, ``pos``,
  ``neg``, retrieval's candidates) bit for bit with the one-device
  ``F.embedding``; the loss and every gradient, ``item_emb``'s among
  them, against the reference's ``sasrec_loss``.
* DIEN on a (2, 2, 1) (``pod``, ``data``, ``model``) mesh, its batch
  over two mesh axes (the target attention's per-device region): the
  loss and every gradient against the reference's ``dien_loss``.
* ``moe_ffn_grouped_sharded`` with a batch of 3 rows, which does not
  divide the 2 data ranks of the (2, 2) mesh, in 3 groups: the routing
  (every (token, choice)'s expert) and the dropped set exactly, the
  output, the aux losses and the gradients of x, the router and the
  experts at tolerance against the reference's grouped ``moe_ffn`` on
  the whole batch; on the (2, 2) mesh ``_ffn_block`` takes this branch.

Float32 on both sides, sums in different orders: values at rtol 1e-5 and
gradients at rtol 1e-4, each with atol 1e-6 x the largest magnitude of
what is compared (``tests/test_torch_mesh_paths.py``'s bounds; a model's
gradient leaves share the largest magnitude of the whole gradient);
losses at rtol 1e-5.  The ranks are child processes (this file run as a script),
and so is the reference, with ``--xla_force_host_platform_device_count=4``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ME = str(Path(__file__).resolve())
MESHES = {1: (1, 1), 2: (1, 2), 4: (2, 2)}  # (data, model)
DIEN_MESH = (2, 2, 1)  # (pod, data, model), 4 ranks
N_ITEMS = 512  # SASRec's table: rows divide every mesh
REC_B = 16
MOE = dict(E=4, K=2, D=8, F=12, B=3, S=8, G=3, CF=1.0)


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu", **extra)


# --------------------------------------------------------------- inputs
def _configs(side):
    """Each model's config at test size: the reference's (``side`` "ref")
    or the port's ("port")."""
    import dataclasses
    import importlib

    pkg = "repro" if side == "ref" else "repro_torch"
    gin, sas, dien = (importlib.import_module(f"{pkg}.configs.{m}")
                      for m in ("gin_tu", "sasrec", "dien"))
    return {"gin_node": dataclasses.replace(gin.smoke_config(), task="node"),
            "gin_graph": dataclasses.replace(gin.smoke_config(),
                                             task="graph"),
            "sasrec": dataclasses.replace(sas.smoke_config(),
                                          n_items=N_ITEMS),
            "dien": dien.smoke_config()}


def _port_init(model, cfg):
    from repro_torch.models import gnn, recsys

    if model.startswith("gin"):
        return gnn.init_params(cfg, device="meta")
    init = recsys.sasrec_init if model == "sasrec" else recsys.dien_init
    return init(cfg, device="meta")


def _inputs(path):
    """Every weight leaf (by leaf key) and batch of each model, drawn from
    numpy seed 0."""
    from repro_torch.configs import gin_tu as tgin
    from repro_torch.data import (dien_batch, molecule_batch, random_graph,
                                  sasrec_batch)
    from repro_torch.tree import tree_leaves_by_key

    rng = np.random.default_rng(0)
    f32 = np.float32
    arrays = {}
    cfgs = _configs("port")
    for model, cfg in cfgs.items():
        for key, leaf in tree_leaves_by_key(_port_init(model, cfg)).items():
            scale = (leaf.shape[0] ** -0.5 if leaf.ndim == 2 else 0.1)
            arrays[f"{model}|w|{key}"] = (
                scale * rng.standard_normal(tuple(leaf.shape))).astype(f32)
    cfg = tgin.smoke_config()
    g = random_graph(rng, 96, 400, cfg.d_feat, cfg.n_classes)
    mols = molecule_batch(rng, 8, 12, 20, cfg.d_feat, cfg.n_classes)
    for name, batch in (("gin_node", g), ("gin_graph", mols)):
        batch["edge_mask"] = rng.random(batch["edge_src"].shape[0]) < 0.75
        for k, v in batch.items():
            arrays[f"{name}|b|{k}"] = v
    for k, v in sasrec_batch(rng, REC_B, cfgs["sasrec"].seq_len,
                             N_ITEMS).items():
        arrays[f"sasrec|b|{k}"] = v
    arrays["sasrec|cand"] = rng.integers(0, N_ITEMS, 24).astype(np.int32)
    di = cfgs["dien"]
    for k, v in dien_batch(rng, REC_B, di.seq_len, di.n_items,
                           di.n_cats).items():
        arrays[f"dien|b|{k}"] = v
    m = MOE
    arrays.update({
        "moe|x": rng.standard_normal((m["B"], m["S"], m["D"])).astype(f32),
        "moe|cot": rng.standard_normal((m["B"], m["S"], m["D"])).astype(f32),
        "moe|router": (m["D"] ** -0.5 * rng.standard_normal(
            (m["D"], m["E"]))).astype(f32),
        "moe|w_gate": (m["D"] ** -0.5 * rng.standard_normal(
            (m["E"], m["D"], m["F"]))).astype(f32),
        "moe|w_up": (m["D"] ** -0.5 * rng.standard_normal(
            (m["E"], m["D"], m["F"]))).astype(f32),
        "moe|w_down": (m["F"] ** -0.5 * rng.standard_normal(
            (m["E"], m["F"], m["D"]))).astype(f32),
    })
    np.savez(path, **arrays)


def _split(a, model):
    """The weights (by leaf key) and the batch of ``model``."""
    w = {k.split("|", 2)[2]: v for k, v in a.items()
         if k.startswith(f"{model}|w|")}
    b = {k.split("|", 2)[2]: v for k, v in a.items()
         if k.startswith(f"{model}|b|")}
    return w, b


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_branches")
    _inputs(d / "in.npz")
    ref = subprocess.Popen(
        [sys.executable, ME, "reference", str(d)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    procs = []
    for n in (1, 2, 4):
        port = _free_port()
        procs += [subprocess.Popen([sys.executable, ME, "rank", str(d),
                                    str(n), str(r), str(port)], env=_env())
                  for r in range(n)]
    for p in procs:
        assert p.wait(timeout=300) == 0
    assert ref.wait(timeout=300) == 0
    return d


def _close(got, want, rtol, what):
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale,
                               err_msg=what)


def _loss_and_grads(got, want):
    """The loss, and every gradient leaf at atol 1e-6 x the largest
    magnitude of the whole gradient (as ``tests/test_torch_recsys.py``
    holds these models' gradients: a leaf of tiny gradients, DIEN's
    attention bias, sums cancelling terms in another order)."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    keys = sorted(k for k in want.files if k.startswith("g|"))
    assert keys and keys == sorted(k for k in got.files
                                   if k.startswith("g|"))
    scale = max(float(np.abs(want[k]).max()) for k in keys)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=k)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("task", ["node", "graph"])
def test_gin_mesh_branch_matches_reference(runs, task, n):
    _loss_and_grads(np.load(runs / f"port_gin_{task}_{n}.npz"),
                    np.load(runs / f"ref_gin_{task}_{n}.npz"))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sasrec_gathers_bit_for_bit_and_gradients(runs, n):
    got = np.load(runs / f"port_sasrec_{n}.npz")
    for use in ("seq", "pos", "neg", "cand"):
        assert got[f"mesh|{use}"].tobytes() == got[f"plain|{use}"].tobytes()
    _loss_and_grads(got, np.load(runs / f"ref_sasrec_{n}.npz"))
    assert "g|item_emb" in got.files


def test_dien_batch_over_two_mesh_axes(runs):
    _loss_and_grads(np.load(runs / "port_dien_4.npz"),
                    np.load(runs / "ref_dien_4.npz"))
    info = json.loads((runs / "dien_placements.json").read_text())
    assert info == {"mesh": [2, 2, 1],
                    "target_item": "(Shard(dim=0), Shard(dim=0), "
                                   "Replicate())"}


@pytest.mark.parametrize("n", [1, 2, 4])
def test_grouped_moe_matches_reference(runs, n):
    got = np.load(runs / f"port_moe_{n}.npz")
    want = np.load(runs / "ref_moe.npz")
    assert got["idx"].tolist() == want["idx"].tolist()
    assert got["dropped"].tolist() == want["dropped"].tolist()
    assert len(want["dropped"]) > 0  # the capacity bites
    _close(got["y"], want["y"], 1e-5, "y")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for name in ("x", "router", "w_gate", "w_up", "w_down"):
        _close(got[f"g_{name}"], want[f"g_{name}"], 1e-4, name)


def test_ffn_block_takes_the_grouped_branch(runs):
    """On the (2, 2) mesh the batch of 3 does not divide the data axis
    and the sequence divides ``model``: ``_ffn_block`` gives the grouped
    branch's output bit for bit."""
    got = np.load(runs / "port_moe_4.npz")
    assert got["ffn_block_y"].tobytes() == got["y"].tobytes()


# ------------------------------------------------------------ reference
def _jtree(tree, w):
    """The reference's tree ``tree`` with the leaves of ``w`` (by key)."""
    import jax
    import jax.numpy as jnp

    from repro.ps.runtime import _leaf_key

    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(w[_leaf_key(p)]), tree)


def _jgrads(loss, grads):
    import jax

    from repro.ps.runtime import _leaf_key

    out = {"loss": np.asarray(loss)}
    for p, v in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"g|{_leaf_key(p)}"] = np.asarray(v)
    return out


def _reference(d):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.models import gnn as jgnn
    from repro.models import moe as jmoe
    from repro.models import recsys as jrec

    a = dict(np.load(Path(d) / "in.npz"))
    cfgs = _configs("ref")

    def run(mesh, loss, params, batch, specs):
        put = {k: jax.device_put(jnp.asarray(v), NamedSharding(
            mesh, specs.get(k, P()))) for k, v in batch.items()}
        return _jgrads(*jax.jit(jax.value_and_grad(loss))(params, put))

    for n, shape in MESHES.items():
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        every = P(("data", "model"))
        for task in ("node", "graph"):
            jcfg = cfgs[f"gin_{task}"]
            w, b = _split(a, f"gin_{task}")
            params = _jtree(jgnn.init_params(jcfg, jax.random.PRNGKey(0)), w)
            rows = every if task == "node" else P("data")
            specs = {"edge_src": every, "edge_dst": every,
                     "edge_mask": every, "feats": rows, "labels": rows,
                     "label_mask": rows, "graph_ids": rows}
            np.savez(Path(d) / f"ref_gin_{task}_{n}.npz", **run(
                mesh, lambda p, bb: jgnn.loss_fn(jcfg, p, bb), params, b,
                specs))
        jcfg = cfgs["sasrec"]
        w, b = _split(a, "sasrec")
        params = _jtree(jrec.sasrec_init(jcfg, jax.random.PRNGKey(0)), w)
        params["item_emb"] = jax.device_put(params["item_emb"],
                                            NamedSharding(mesh, every))
        np.savez(Path(d) / f"ref_sasrec_{n}.npz", **run(
            mesh, lambda p, bb: jrec.sasrec_loss(jcfg, p, bb), params, b,
            {k: P("data") for k in b}))

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(DIEN_MESH),
                ("pod", "data", "model"))
    jcfg = cfgs["dien"]
    w, b = _split(a, "dien")
    params = _jtree(jrec.dien_init(jcfg, jax.random.PRNGKey(0)), w)
    np.savez(Path(d) / "ref_dien_4.npz", **run(
        mesh, lambda p, bb: jrec.dien_loss(jcfg, p, bb), params, b,
        {k: P(("pod", "data")) for k in b}))

    m = MOE
    cfg = jmoe.MoEConfig(n_experts=m["E"], top_k=m["K"], d_ff=m["F"],
                         capacity_factor=m["CF"])
    names = ("router", "w_gate", "w_up", "w_down")
    t = m["B"] * m["S"]

    def f(x, p):
        y, losses = jmoe.moe_ffn(x.reshape(t, m["D"]), p, cfg,
                                 n_groups=m["G"])
        y = y.reshape(x.shape)
        return jnp.sum(y * a["moe|cot"]) + losses, (y, losses)

    p = {k: jnp.asarray(a[f"moe|{k}"]) for k in names}
    x = jnp.asarray(a["moe|x"])
    (_, (y, losses)), (gx, gp) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(x, p)
    _, idx, _, _ = jmoe.route(x.reshape(t, m["D"]), p["router"], cfg)
    tg = t // m["G"]
    cap = max(1, int(m["CF"] * tg * m["K"] / m["E"]))
    idx_g = np.asarray(idx).reshape(m["G"], tg * m["K"])
    dropped = []
    for gi in range(m["G"]):
        pos = np.asarray(jmoe.expert_positions(jnp.asarray(idx_g[gi]),
                                               m["E"]))
        dropped += [(gi, int(i)) for i in np.nonzero(pos >= cap)[0]]
    np.savez(Path(d) / "ref_moe.npz", y=np.asarray(y),
             losses=np.asarray(losses), idx=np.asarray(idx), g_x=np.asarray(gx),
             dropped=np.array(dropped, np.int64).reshape(-1, 2),
             **{f"g_{k}": np.asarray(gp[k]) for k in names})


# ----------------------------------------------------------------- ranks
def _ttree(model, cfg, w):
    import torch

    from repro_torch.tree import tree_with_leaves

    return tree_with_leaves(_port_init(model, cfg),
                            {k: torch.from_numpy(v) for k, v in w.items()})


def _place(mesh, t, spec):
    from repro_torch.launch import cells

    return cells._place(mesh, t, spec)


def _step(mesh, loss, params, batch, param_specs, batch_specs):
    """``value_and_grad(loss)`` on DTensors placed at the specs (leaf key
    -> spec, default replicated), under the context as
    ``LoweredCell.lower`` runs it; the loss and the gradients whole."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.ps import act_sharding as act
    from repro_torch.tree import (tree_leaves_by_key, tree_with_leaves,
                                  value_and_grad)

    placed = tree_with_leaves(params, {
        k: _place(mesh, v, param_specs.get(k, ()))
        for k, v in tree_leaves_by_key(params).items()})
    pb = {k: _place(mesh, v, batch_specs.get(k, ())) for k, v in batch.items()}
    with act.activate(mesh), implicit_replication():
        loss, grads = value_and_grad(loss)(placed, pb)
    out = {"loss": loss.full_tensor().detach().numpy()}
    for k, g in tree_leaves_by_key(grads).items():
        out[f"g|{k}"] = g.full_tensor().detach().numpy()
    return out, pb


def _rank(d, n, rank, port):
    import types

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import gnn, moe, recsys
    from repro_torch.models import transformer as tf
    from repro_torch.ps import act_sharding as act

    n, rank = int(n), int(rank)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n)
    a = dict(np.load(Path(d) / "in.npz"))
    cfgs = _configs("port")
    mesh = init_device_mesh("cpu", MESHES[n], mesh_dim_names=("data",
                                                              "model"))
    every = (("data", "model"),)
    saves = {}

    for task in ("node", "graph"):
        cfg = cfgs[f"gin_{task}"]
        w, b = _split(a, f"gin_{task}")
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        rows = every if task == "node" else (("data",),)
        out, _ = _step(
            mesh, lambda p, bb, cfg=cfg: gnn.loss_fn(cfg, p, bb),
            _ttree(f"gin_{task}", cfg, w), b, {},
            {"edge_src": every, "edge_dst": every, "edge_mask": every,
             "feats": rows, "labels": rows, "label_mask": rows,
             "graph_ids": rows})
        saves[f"gin_{task}_{n}"] = out

    cfg = cfgs["sasrec"]
    w, b = _split(a, "sasrec")
    b = {k: torch.from_numpy(v) for k, v in b.items()}
    params = _ttree("sasrec", cfg, w)
    out, pb = _step(mesh, lambda p, bb: recsys.sasrec_loss(cfg, p, bb),
                    params, b, {"item_emb": every},
                    {k: (("data",),) for k in b})
    table = _place(mesh, params["item_emb"], every)
    cand = torch.from_numpy(a["sasrec|cand"])
    with act.activate(mesh), implicit_replication():
        for use, ids, plain in [*((k, pb[k], b[k]) for k in b),
                                ("cand", _place(mesh, cand, (("data",),)),
                                 cand)]:
            got = recsys.gather_rows(table, ids).full_tensor()
            out[f"mesh|{use}"] = got.numpy()
            out[f"plain|{use}"] = F.embedding(plain,
                                              params["item_emb"]).numpy()
    saves[f"sasrec_{n}"] = out

    if n == 4:
        mesh3 = init_device_mesh("cpu", DIEN_MESH,
                                 mesh_dim_names=("pod", "data", "model"))
        cfg = cfgs["dien"]
        w, b = _split(a, "dien")
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        out, pb = _step(mesh3, lambda p, bb: recsys.dien_loss(cfg, p, bb),
                        _ttree("dien", cfg, w), b, {},
                        {k: (("pod", "data"),) for k in b})
        saves["dien_4"] = out
        if rank == 0:
            (Path(d) / "dien_placements.json").write_text(json.dumps({
                "mesh": list(mesh3.shape),
                "target_item": str(tuple(pb["target_item"].placements))}))

    m = MOE
    cfg = moe.MoEConfig(n_experts=m["E"], top_k=m["K"], d_ff=m["F"],
                        capacity_factor=m["CF"])
    names = ("router", "w_gate", "w_up", "w_down")
    x = torch.from_numpy(a["moe|x"]).requires_grad_(True)
    p = {k: torch.from_numpy(a[f"moe|{k}"]).requires_grad_(True)
         for k in names}
    seen = []
    real = moe.expert_positions

    def recording(eid, e):
        pos = real(eid, e)
        seen.append((eid.clone(), pos.clone()))
        return pos

    moe.expert_positions = recording
    with act.activate(mesh), implicit_replication():
        xd = act.constrain(act.as_dtensor(x, mesh), "dp", "tp", None)
        y, losses = moe.moe_ffn_grouped_sharded(xd, p, cfg, n_groups=m["G"])
        loss = (y * act.as_dtensor(torch.from_numpy(a["moe|cot"]),
                                   mesh)).sum() + losses
    moe.expert_positions = real
    loss.full_tensor().backward()
    (eid, pos), = seen
    tg = m["B"] * m["S"] // m["G"]
    cap = max(1, int(m["CF"] * tg * m["K"] / m["E"]))
    res = {"y": y.full_tensor().detach().numpy(),
           "losses": losses.full_tensor().detach().numpy(),
           "idx": eid.reshape(-1, m["K"]).numpy(), "g_x": x.grad.numpy(),
           "dropped": torch.nonzero(pos >= cap).numpy(),
           **{f"g_{k}": p[k].grad.numpy() for k in names}}
    if n == 4:
        lm = types.SimpleNamespace(moe=cfg, moe_capacity_factor_override=None,
                                   moe_groups=m["G"])
        with torch.no_grad(), act.activate(mesh), implicit_replication():
            xd = act.constrain(act.as_dtensor(x.detach(), mesh), "dp", "tp",
                               None)
            yb, _ = tf._ffn_block(lm, {"moe": {k: v.detach()
                                                for k, v in p.items()}}, xd)
        res["ffn_block_y"] = yb.full_tensor().numpy()
    saves[f"moe_{n}"] = res

    if rank == 0:
        for name, arrays in saves.items():
            np.savez(Path(d) / f"port_{name}.npz", **arrays)
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _rank(*sys.argv[2:6])
