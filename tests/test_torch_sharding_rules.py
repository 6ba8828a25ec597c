"""The port's sharding rules (``repro_torch.ps.sharding``) and activation
roles (``repro_torch.ps.act_sharding``) against the reference's.

Counterparts of the six tests of ``tests/test_sharding_rules.py``, on
shape-only meshes (no process group in the test process: the DTensor
side runs in ``tests/test_torch_mesh_paths.py``'s spawned ranks), and
every arch's full config on abstract (16, 16) and (2, 16, 16) meshes:
param, optimizer-state, batch and KV-cache specs equal the reference's
``PartitionSpec``s leaf by leaf, exactly."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as jreg
from repro.launch.mesh import make_abstract_mesh as j_abstract_mesh
from repro.models import gnn as jgnn
from repro.models import recsys as jrec
from repro.models import transformer as jtf
from repro.optim import adagrad as jadagrad
from repro.optim import adam as jadam
from repro.ps import sharding as jshd
from repro_torch.configs import registry as treg
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import gnn as tgnn
from repro_torch.models import recsys as trec
from repro_torch.models import transformer as ttf
from repro_torch.optim import adagrad as tadagrad
from repro_torch.optim import adam as tadam
from repro_torch.ps import act_sharding as act
from repro_torch.ps import sharding as shd

MESHES = {"pod256": ((16, 16), ("data", "model")),
          "pod512": ((2, 16, 16), ("pod", "data", "model"))}


def _tspecs(specs):
    return {k: tuple(v) for k, v in shd.spec_by_key(specs).items()}


def test_lm_rules_cover_all_params():
    """Every leaf of the three smoke LMs gets a spec of at most its rank,
    the same spec as the reference's on a host-sized mesh."""
    tm = make_abstract_mesh((1, 1), ("data", "model"))
    jm = j_abstract_mesh((1, 1), ("data", "model"))
    for arch in ("qwen1.5-0.5b", "deepseek-v2-236b", "granite-moe-1b-a400m"):
        params = ttf.init_params(treg.get_smoke_config(arch), device="meta")
        specs = _tspecs(shd.param_shardings(tm, params, "lm"))
        leaves = shd.spec_by_key(params)
        assert set(specs) == set(leaves)
        assert all(len(specs[k]) <= leaves[k].ndim for k in leaves)
        jp = jax.eval_shape(lambda: jtf.init_params(
            jreg.get_smoke_config(arch), jax.random.PRNGKey(0)))
        assert specs == _jtree(jshd.param_shardings(jm, jp, "lm"))


def test_divisibility_guard_degrades_to_replicated():
    mesh4 = make_abstract_mesh((1, 4), ("data", "model"))
    spec = shd._lm_rule(mesh4, "layers/attn/w_q", (2, 64, 7, 128))
    assert spec[2] is None and spec[3] == "model"
    spec = shd._lm_rule(mesh4, "layers/attn/w_q", (2, 64, 8, 128))
    assert spec[2] == "model"
    assert shd._lm_rule(mesh4, "layers/attn/w_q", (2, 8, 4, 8)) == ()
    jm = j_abstract_mesh((1, 4), ("data", "model"))
    for shape in ((2, 64, 7, 128), (2, 64, 8, 128), (2, 8, 4, 8),
                  (2, 7, 64, 128), (2, 4, 64, 9)):
        for name in ("layers/attn/w_q", "layers/attn/w_o", "odd"):
            assert shd._lm_rule(mesh4, name, shape) == tuple(
                jshd._lm_rule(jm, name, shape)), (name, shape)


def test_batch_shardings_leading_dim():
    batch = {"tokens": torch.empty((8, 16), dtype=torch.int32,
                                   device="meta"),
             "odd": torch.empty((7,), device="meta")}
    host = make_abstract_mesh((1, 1), ("data", "model"))
    assert shd.batch_shardings(host, batch)["tokens"] == ("data",)
    mesh4 = make_abstract_mesh((4, 1), ("data", "model"))
    tree4 = shd.batch_shardings(mesh4, batch)
    assert tree4["odd"] == () and tree4["tokens"] == ("data",)


def test_act_constrain_noop_without_context():
    x = torch.ones((4, 4))
    assert act.constrain(x, "dp", "tp") is x
    assert not act.enabled()


def test_act_roles_resolve_in_context():
    """Role resolution and the divisibility fallback, as the reference's
    ``constrain`` builds its spec; a plain tensor passes through."""
    for shape, axes in MESHES.values():
        mesh = make_abstract_mesh(shape, axes)
        with act.activate(mesh):
            assert act.enabled()
            ctx = act._current()
            dp = ctx["dp"]
            assert dp == (("pod", "data") if "pod" in axes else ("data",))
            got = act.resolve(ctx, (64, 48, 7), ("dp", "tp", "tp"))
            want = [Replicate()] * len(axes)
            for a in dp:
                want[axes.index(a)] = Shard(0)
            want[axes.index("model")] = Shard(1)
            assert got == tuple(want)
            # 7 does not divide: dim 2 stays whole; 8 does not divide dp
            got = act.resolve(ctx, (8, 7), ("dp", "tp"))
            assert got == (Replicate(),) * len(axes)
            x = torch.ones((4, 4))
            assert act.constrain(x, "dp", "tp") is x
        assert not act.enabled()
    with act.activate(make_abstract_mesh((1, 1), ("data", "model"))):
        assert act.resolve(act._current(), (4, 4), ("dp", "tp")) == (
            Replicate(), Replicate())
    with act.activate(make_abstract_mesh((2, 2), ("data", "model")),
                      enabled=False):
        assert not act.enabled()


def test_kv_cache_sharding_batch_vs_seq():
    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    cache = {"scan": {"k": torch.empty((2, 4, 8, 2, 4), device="meta")},
             "length": 0}
    tree = shd.kv_cache_shardings(mesh, cache, batch=4)
    assert tree["length"] == ()
    assert tree["scan"]["k"][1] == "data"


def test_placements_of_a_spec():
    m = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.placements(m, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(m, ()) == (Replicate(),) * 3
    assert shd.placements(m, (None, ("pod", "data", "model"))) == (
        Shard(1),) * 3
    host = make_abstract_mesh((1, 1), ("data", "model"))  # one device
    assert shd.placements(host, ("data", "model")) == (Replicate(),) * 2


# ----------------------------------------------- every arch, full config
def _jtree(tree):
    """{leaf key: spec tuple} of a reference NamedSharding tree."""
    return {jshd._leaf_name(p): tuple(x.spec) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


_RECSYS = {"dlrm-rm2": ("dlrm", jadagrad, tadagrad, 0.01),
           "dlrm-mlperf": ("dlrm", jadagrad, tadagrad, 0.01),
           "sasrec": ("sasrec", jadam, tadam, 1e-3),
           "dien": ("dien", jadam, tadam, 1e-3)}


def _models(arch):
    """(reference init, port init, reference opt, port opt, family)."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    family = treg.family(arch)
    if family == "lm":
        return (lambda k: jtf.init_params(jcfg, k),
                lambda: ttf.init_params(tcfg, device="meta"),
                jadam(3e-4), tadam(3e-4), family)
    if family == "gnn":
        return (lambda k: jgnn.init_params(jcfg, k),
                lambda: tgnn.init_params(tcfg, device="meta"),
                jadam(1e-3), tadam(1e-3), family)
    kind, jopt, topt, lr = _RECSYS[arch]
    return (lambda k: getattr(jrec, f"{kind}_init")(jcfg, k),
            lambda: getattr(trec, f"{kind}_init")(tcfg, device="meta"),
            jopt(lr), topt(lr), family)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """Both packages' shape trees of one arch (traced once for both
    meshes)."""
    jinit, tinit, jopt, topt, family = _models(arch)
    jp = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0)))
    jo = jax.eval_shape(lambda: jopt.init(jinit(jax.random.PRNGKey(0))))
    tp = tinit()
    return jp, tp, jo, topt.init(tp), family


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_full_config_specs_equal_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    jm, tm = j_abstract_mesh(shape, axes), make_abstract_mesh(shape, axes)
    jp, tp, jo, to, family = _trees(arch)
    j_ps = jshd.param_shardings(jm, jp, family)
    assert _tspecs(shd.param_shardings(tm, tp, family)) == _jtree(j_ps)

    j_os = jshd.opt_state_shardings(jm, jo, j_ps, family)
    t_os = shd.opt_state_shardings(tm, to, family)
    assert to._fields == jo._fields
    for field in to._fields:
        want = _jtree(getattr(j_os, field))
        got = getattr(t_os, field)
        if field == "count":  # a host int here, an int32 scalar there
            assert got == () and want == {"": ()}
        else:
            assert _tspecs(got) == want, field

    if family == "lm":
        jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
        for batch, seq in ((128, 32768), (1, 524288)):
            jc = jax.eval_shape(lambda: jtf.init_kv_cache(jcfg, batch, seq))
            tc = ttf.init_kv_cache(tcfg, batch, seq, device="meta")
            want = _jtree(jshd.kv_cache_shardings(jm, jc, batch))
            got = _tspecs(shd.kv_cache_shardings(tm, tc, batch))
            assert got == want, batch
        jb = {"tokens": _sds((256, 4096), jnp.int32),
              "odd": _sds((7,), jnp.float32)}
    elif family == "recsys":
        jb = {"sparse": _sds((65536, 26), jnp.int32),
              "labels": _sds((65536,), jnp.float32),
              "odd": _sds((100,), jnp.float32)}
    else:
        jb = {"feats": _sds((2449152, 100), jnp.float32),
              "labels": _sds((2708,), jnp.int32)}
    tb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
    assert _tspecs(shd.batch_shardings(tm, tb)) == \
        _jtree(jshd.batch_shardings(jm, jb))
    assert _tspecs(shd.replicated(tm, tb)) == \
        _jtree(jshd.replicated(jm, jb))
