"""The port's LM family beyond Qwen: granite-8b and command-r-plus-104b
(dense; GQA, tied embeddings, command-r's parallel block with LayerNorm),
granite-moe-1b-a400m (the MoE FFN) and deepseek-v2-236b (a leading dense
layer, then MLA attention with the MoE FFN and shared experts), held
against the reference on the reference's weights, carried across with
``tree_from_numpy``, and the same numpy inputs, in float32 on the CPU.

Tolerances are those of ``tests/test_torch_transformer.py`` (the loss at
rtol 1e-5, every gradient leaf at rtol 1e-4, parameters after three Adam
steps within 3 x 2 x lr and within a tenth of a step on all but 0.1 % of
the lanes) and of
``tests/test_torch_serve.py`` (logits and cache entries at rtol 1e-4
with atol 1e-5 x the largest magnitude; greedy tokens exactly).  MoE
routing must come out the same in both packages for these to hold: a
token sent to another expert moves its FFN output by a gate's share of
an expert's output, far outside them.  One bound differs: a gradient
leaf's atol is 2e-6 x its largest magnitude, not 1e-6.  At 1e-6 the
worst element of most leaves lands at 0.5-1.06 x the bound on these
configs (granite-8b's smoke config is twice Qwen's smoke width; deepseek
sums MLA's low-rank products), one near-zero element a leaf.  In float64
both packages give the same gradients to within 1e-12 of a leaf's
magnitude, and the port's float32 gradients lie no farther from that
value than twice the reference's float32 gradients do
(``tests/test_torch_lm_grad_f64.py``): the difference is rounding on
both sides, not a fault of either.  The parameter trees of the four
full configs are compared key for key, shape for shape and dtype for
dtype, the port's on ``meta``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import lm_batch
from repro.models import transformer as jtf
from repro.optim import adam as jadam
from repro.ps import plan as jplan
from repro.ps import runtime as jruntime
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import transformer as ttf
from repro_torch.optim import adam as tadam
from repro_torch.ps import plan as tplan
from repro_torch.ps import runtime as truntime
from repro_torch.tree import cache_from_numpy, tree_leaves_by_key
from repro_torch.tree import value_and_grad

LR = 1e-3
ARCHS = ["granite-8b", "command-r-plus-104b", "granite-moe-1b-a400m",
         "deepseek-v2-236b"]


def _configs(arch):
    return jregistry.get_smoke_config(arch), registry.get_smoke_config(arch)


def _weights(jcfg, seed=0):
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, truntime.tree_from_numpy(jparams, "cpu")


def _batches(cfg, n, seed=0, batch=2, seq=32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = lm_batch(rng, batch, seq, cfg.vocab)
        out.append(({k: jnp.asarray(v) for k, v in b.items()},
                    {k: torch.from_numpy(v) for k, v in b.items()}))
    return out


def _np_leaves(tree):
    return {k: v.float().numpy() for k, v in tree_leaves_by_key(tree).items()}


def _jleaves(tree):
    return {jruntime._leaf_key(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-4,
                               atol=1e-5 * scale, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    jcfg, tcfg = _configs(arch)
    jparams, tparams = _weights(jcfg)
    (jb, tb), = _batches(jcfg, 1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(jcfg, p, b)))(jparams, jb)
    tloss, tgrads = value_and_grad(
        lambda p, b: ttf.loss_fn(tcfg, p, b))(tparams, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    t, j = _np_leaves(tgrads), _jleaves(jgrads)
    assert t.keys() == j.keys()
    for k in j:
        scale = float(np.abs(j[k]).max()) or 1.0
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=2e-6 * scale,
                                   err_msg=k)
    if tcfg.moe is not None:  # the aux losses reach the loss
        _, aux = ttf.forward_hidden(tcfg, tparams, tb["tokens"])
        assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    jcfg, tcfg = _configs(arch)
    jparams, tparams = _weights(jcfg, seed=1)
    jopt, topt = jadam(LR, fused=True), tadam(LR, fused=True)
    jstep = jax.jit(jtf.make_train_step(jcfg, jopt))
    tstep = ttf.make_train_step(tcfg, topt)
    js = {"params": jparams, "opt": jopt.init(jparams)}
    ts = {"params": tparams, "opt": topt.init(tparams)}
    jl, tl = [], []
    for jb, tb in _batches(jcfg, 3, seed=2, batch=4):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    t, j = _np_leaves(ts["params"]), _jleaves(js["params"])
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=3 * 2 * LR,
                                   err_msg=k)
        off = np.abs(t[k] - j[k]) > 0.1 * LR
        assert off.mean() <= 1e-3, (k, int(off.sum()), off.size)


def _prompt(cfg, batch, length, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (batch, length), dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    jcfg, tcfg = _configs(arch)
    jparams, tparams = _weights(jcfg, seed=3)
    toks = _prompt(jcfg, 2, 8, seed=1)
    jstep = jax.jit(jtf.make_serve_step(jcfg))
    tstep = ttf.make_serve_step(tcfg)
    jc = jtf.init_kv_cache(jcfg, 2, 10)
    tc = cache_from_numpy(jax.device_get(jc), "cpu")
    fresh = ttf.init_kv_cache(tcfg, 2, 10, device="cpu")
    assert fresh.keys() == tc.keys()
    for group in ("scan", "dense"):
        if group in tc:
            assert {n: (t.shape, t.dtype) for n, t in tc[group].items()} == \
                {n: (t.shape, t.dtype) for n, t in fresh[group].items()}
    for i in range(8):
        jl, jc = jstep(jparams, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc2 = tstep(tparams, tc, torch.from_numpy(toks[:, i:i + 1]))
        assert tc2 is tc and tl.shape == (2, tcfg.vocab)
        _close(tl.numpy(), jl, f"logits step {i}")
    assert tc["length"] == int(jc["length"]) == 8
    for group in ("scan", "dense"):
        for name, t in tc.get(group, {}).items():
            _close(t.numpy(), jc[group][name], f"{group}/{name}")
            assert not t[:, :, 8:].any()  # untouched positions


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    jcfg, tcfg = _configs(arch)
    jparams, tparams = _weights(jcfg, seed=4)
    toks = _prompt(jcfg, 2, 24, seed=5)
    jl = jax.jit(jtf.make_prefill(jcfg))(jparams, jnp.asarray(toks))
    tl = ttf.make_prefill(tcfg)(tparams, torch.from_numpy(toks))
    assert tl.shape == (2, tcfg.vocab) and tl.dtype == torch.float32
    _close(tl.numpy(), jl)
    # the chunked attention route, as the prefill_32k cell sets it
    jc = dataclasses.replace(jcfg, attn_chunk_k=8)
    tc = dataclasses.replace(tcfg, attn_chunk_k=8)
    jl = jax.jit(jtf.make_prefill(jc))(jparams, jnp.asarray(toks))
    tl = ttf.make_prefill(tc, attention="plain")(tparams,
                                                 torch.from_numpy(toks))
    _close(tl.numpy(), jl, "chunked")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_tree_matches_reference(arch):
    jcfg, tcfg = jregistry.get_config(arch), registry.get_config(arch)
    jabs = jax.eval_shape(lambda: jtf.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    tabs = ttf.init_params(tcfg, device="meta")
    j = {jruntime._leaf_key(p): (tuple(v.shape), np.dtype(v.dtype).name)
         for p, v in jax.tree_util.tree_flatten_with_path(jabs)[0]}
    t = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tree_leaves_by_key(tabs).items()}
    assert t == j
    assert all(v.device.type == "meta" for v in tree_leaves_by_key(
        tabs).values())
    assert tcfg.param_count == jcfg.param_count
    assert tcfg.active_param_count == jcfg.active_param_count
    if tcfg.moe is not None:  # the router stays float32 under bf16
        assert t["layers/moe/router"][1] == "float32"


def _reference_decode(jcfg, jparams, batch, prompt_len, gen):
    """The reference's serving loop (``repro.launch.serve.main``), greedy."""
    step = jax.jit(jtf.make_serve_step(jcfg))
    cache = jtf.init_kv_cache(jcfg, batch, prompt_len + gen)
    prompt = jnp.asarray(_prompt(jcfg, batch, prompt_len))
    for i in range(prompt_len):
        logits, cache = step(jparams, cache, prompt[:, i:i + 1])
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [tok]
    for _ in range(gen - 1):
        logits, cache = step(jparams, cache, tok)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch,direct", [("granite-moe-1b-a400m", False),
                                         ("deepseek-v2-236b", True)])
def test_launch_serve_greedy_tokens_match_reference(arch, direct, capsys):
    jcfg, _ = _configs(arch)
    jparams, tparams = _weights(jcfg, seed=6)
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--gen", "8"]
    out = serve.main(argv + (["--direct"] if direct else []),
                     params=tparams)
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[serve]")]
    assert any("generated 14 tokens" in l for l in lines)
    assert any("bit-exact vs hosted" in l for l in lines) != direct
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  _reference_decode(jcfg, jparams, 2, 6, 8))


def test_launch_serve_cuts_depth_to_whole_layers():
    """``--layers`` keeps the leading dense layers and the first scanned
    ones; deepseek's smoke config has 1 dense and 2 MLA + MoE layers."""
    jcfg, _ = _configs("deepseek-v2-236b")
    jcut = dataclasses.replace(jcfg, n_layers=2)
    jparams, tparams = _weights(jcut, seed=7)
    argv = ["--arch", "deepseek-v2-236b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "4", "--gen", "4", "--direct"]
    out = serve.main(argv + ["--layers", "2"], params=tparams)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  _reference_decode(jcut, jparams, 2, 4, 4))
    assert out["cache"]["scan"]["ckv"].shape[0] == 1
    for bad in ("1", "4"):
        with pytest.raises(ValueError, match="--layers"):
            serve.main(argv + ["--layers", bad], params=tparams)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v2-236b"])
def test_flat_plans_equal_on_the_moe_configs(arch):
    """One plan lays out both packages' MoE and MLA trees (the float32
    router among bf16 leaves included), full config and smoke."""
    for jcfg, tcfg in ((jregistry.get_config(arch), registry.get_config(arch)),
                       _configs(arch)):
        jabs = jax.eval_shape(lambda c=jcfg: jtf.init_params(
            c, jax.random.PRNGKey(0)))
        tabs = ttf.init_params(tcfg, device="meta")
        j = jruntime.build_flat_plan(jabs, 2)
        t = truntime.build_flat_plan(tabs, 2)
        assert tplan.plan_to_json(t) == jplan.plan_to_json(j)
        assert (t.total_len, t.shard_len) == (j.total_len, j.shard_len)


def test_hosting_refuses_what_cannot_fit_the_card(monkeypatch):
    """granite-8b hosted as a float32 service job needs 12 bytes a
    parameter, about 97 GB: more than an 80 GB card, so ``serve`` asks
    for ``--direct``; Qwen1.5-0.5B (5.6 GB) is hosted."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (80 * 10**9, 80 * 10**9))
    card = torch.device("cuda", 0)
    big = ttf.init_params(registry.get_config("granite-8b"), device="meta")
    with pytest.raises(ValueError, match="pass --direct"):
        serve._check_hosting_fits(big, card)
    small = ttf.init_params(registry.get_config("qwen1.5-0.5b"),
                            device="meta")
    serve._check_hosting_fits(small, card)
    serve._check_hosting_fits(big, torch.device("cpu"))  # no card: no check
