"""The port's dense LM (``repro_torch.models.transformer``), its layers
and attention, its training step and the single-job parameter-server
step, held against the reference on the same weights (the reference's,
carried across bit for bit with ``tree_from_numpy``) and the same numpy
inputs.

Tolerances.  Everything runs in float32 on the CPU in both packages, but
XLA and PyTorch sum the matrix products, the softmax and the norms in
different orders.  Single layers and attention: rtol 1e-5 with atol
1e-6, and atol 1e-5 where a result is a sum of products (``swiglu``) or
depends on a float32 ``theta ** x`` (RoPE tables; the two libraries'
``pow`` differ in the last bit, which the angle multiplies by the
position).  The model's loss: rtol 1e-5; every gradient leaf: rtol 1e-4
with atol 1e-6 x its largest magnitude (near-zero gradients carry
absolute, not relative, error).  Three training steps compound those
differences through Adam, whose first steps move every weight by about
``lr`` whatever the gradient's size, so a gradient sign that differs on
a near-zero lane moves that weight by up to 2 x lr: the parameters after
three steps are held at atol 3 x 2 x lr (lr = 1e-3) everywhere and at
atol 1e-4 (a tenth of one step) on all but 0.1 % of the lanes, and the
losses at rtol 1e-4.  Plans, shapes, dtypes, ``_expand_kv`` and the bf16
carry-across are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen1_5_0_5b as jqwen
from repro.data import lm_batch
from repro.models import transformer as jtf
from repro.optim import adam as jadam
from repro.ps import plan as jplan
from repro.ps import runtime as jruntime
from repro_torch.configs import qwen1_5_0_5b as tqwen
from repro_torch.configs import registry
from repro_torch.models import transformer as ttf
from repro_torch.optim import adam as tadam
from repro_torch.ps import plan as tplan
from repro_torch.ps import runtime as truntime
from repro_torch.tree import tree_leaves_by_key, value_and_grad

LR = 1e-3

# name -> overrides applied to both packages' qwen smoke config
VARIANTS = {
    "qwen-smoke": {},
    # the other dense-path branches: LayerNorm, the parallel block, GQA,
    # no QKV bias, untied unembedding, chunked attention, no remat
    "parallel-ln-gqa-chunked": dict(norm="layernorm", parallel_block=True,
                                    n_kv_heads=2, qkv_bias=False,
                                    tie_embeddings=False, attn_chunk_k=8,
                                    remat=False),
}


def _configs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(jqwen.smoke_config(), **kw),
            dataclasses.replace(tqwen.smoke_config(), **kw))


def _weights(jcfg, seed=0):
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    # the reference zero-inits the biases; give them values to compare
    rng = np.random.default_rng(seed)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(rng.standard_normal(x.shape) * 0.1,
                                    x.dtype)
        if str(getattr(path[-1], "key", "")).startswith("b_") else x,
        jparams)
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
    return {k: np.asarray(v.float().numpy() if isinstance(v, torch.Tensor)
                          else v, np.float32)
            for k, v in tree_leaves_by_key(tree).items()}


def _jleaves(tree):
    return {jruntime._leaf_key(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_grads_close(tg, jg):
    t, j = _np_leaves(tg), _jleaves(jg)
    assert t.keys() == j.keys()
    for k in j:
        scale = float(np.abs(j[k]).max()) or 1.0
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_gradients_match_reference(variant):
    jcfg, tcfg = _configs(variant)
    jparams, tparams = _weights(jcfg)
    (jb, tb), = _batches(jcfg, 1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(jcfg, p, b)))(jparams, jb)
    tloss, tgrads = value_and_grad(
        lambda p, b: ttf.loss_fn(tcfg, p, b))(tparams, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _assert_grads_close(tgrads, jgrads)
    # the caller's weights stay free of autograd state
    assert not any(t.requires_grad for t in tree_leaves_by_key(
        tparams).values())


def _assert_steps_close(t, j, steps, what):
    """Parameters after ``steps`` Adam steps (see the module docstring)."""
    np.testing.assert_allclose(t, j, rtol=0, atol=steps * 2 * LR,
                               err_msg=what)
    off = np.abs(t - j) > 0.1 * LR
    assert off.mean() <= 1e-3, (what, int(off.sum()), off.size)


def _close_after_steps(tparams, jparams, tlosses, jlosses, steps):
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    t, j = _np_leaves(tparams), _jleaves(jparams)
    for k in j:
        _assert_steps_close(t[k], j[k], steps, k)


@pytest.mark.parametrize("fused,micro", [(True, 1), (False, 2)])
def test_train_step_three_steps_match_reference(fused, micro):
    jcfg, tcfg = _configs("qwen-smoke")
    jparams, tparams = _weights(jcfg, seed=1)
    jopt, topt = jadam(LR, fused=fused), tadam(LR, fused=fused)
    jstep = jax.jit(jtf.make_train_step(jcfg, jopt, n_microbatches=micro))
    tstep = ttf.make_train_step(tcfg, topt, n_microbatches=micro)
    js = {"params": jparams, "opt": jopt.init(jparams)}
    ts = {"params": tparams, "opt": topt.init(tparams)}
    jl, tl = [], []
    for jb, tb in _batches(jcfg, 3, seed=2, batch=4):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert ts["opt"].count == 3
    _close_after_steps(ts["params"], js["params"], tl, jl, 3)


def test_flat_plans_equal_on_the_full_config_and_smoke():
    for jcfg, tcfg in ((jqwen.config(), tqwen.config()),
                       (jqwen.smoke_config(), tqwen.smoke_config())):
        jabs = jax.eval_shape(lambda c=jcfg: jtf.init_params(
            c, jax.random.PRNGKey(0)))
        tabs = ttf.init_params(tcfg, device="meta")
        for n_shards, mode in ((2, "balanced"), (3, "round_robin")):
            j = jruntime.build_flat_plan(jabs, n_shards, mode=mode)
            t = truntime.build_flat_plan(tabs, n_shards, mode=mode)
            assert tplan.plan_to_json(t) == jplan.plan_to_json(j)
            assert (t.total_len, t.shard_len, t.block_align) == \
                (j.total_len, j.shard_len, j.block_align)
            assert [t.start(s) for s in t.segments] == \
                [j.start(s) for s in j.segments]
        # the JSON round trip keeps bfloat16 segments
        again = tplan.plan_from_json(tplan.plan_to_json(t))
        assert [s.dtype for s in again.segments] == \
            [s.dtype for s in t.segments]


@pytest.mark.parametrize("fused_kernel", [True, False])
def test_single_job_ps_step_matches_reference(fused_kernel):
    jcfg, tcfg = _configs("qwen-smoke")
    jparams, tparams = _weights(jcfg, seed=3)
    jplan_ = jruntime.build_flat_plan(jparams, n_shards=2)
    tplan_ = truntime.build_flat_plan(tparams, n_shards=2)
    jstep = jax.jit(jruntime.make_ps_train_step(
        lambda p, b: jtf.loss_fn(jcfg, p, b), jplan_, jparams, lr=LR,
        fused_kernel=fused_kernel))
    tstep = truntime.make_ps_train_step(
        lambda p, b: ttf.loss_fn(tcfg, p, b), tplan_,
        truntime.abstract_tree(tparams), lr=LR, fused_kernel=fused_kernel)
    js = jruntime.init_ps_state(jplan_, jparams)
    ts = truntime.init_ps_state(tplan_, tparams)
    np.testing.assert_array_equal(ts["flat"].numpy(), np.asarray(js["flat"]))
    flat0 = ts["flat"]
    jl, tl = [], []
    for jb, tb in _batches(jcfg, 3, seed=4):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert ts["count"] == 3 and ts["flat"] is flat0  # updated in place
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_steps_close(ts["flat"].numpy(), np.asarray(js["flat"]), 3,
                        "flat")
    for k in ("mu", "nu"):
        scale = float(np.abs(np.asarray(js[k])).max())
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-3, atol=1e-4 * scale, err_msg=k)


def test_single_job_fused_and_plain_steps_agree_bit_for_bit():
    """In the port, K5 (plain version here) and ``_adam_math`` share one
    grouping and one hp table: the first step's flat/mu/nu are equal."""
    jcfg, tcfg = _configs("qwen-smoke")
    _, tparams = _weights(jcfg, seed=5)
    plan = truntime.build_flat_plan(tparams, n_shards=2)
    abstract = truntime.abstract_tree(tparams)
    (_, tb), = _batches(jcfg, 1, seed=6)
    out = []
    for fused in (True, False):
        step = truntime.make_ps_train_step(
            lambda p, b: ttf.loss_fn(tcfg, p, b), plan, abstract, lr=LR,
            fused_kernel=fused)
        out.append(step(truntime.init_ps_state(plan, tparams), tb)[0])
    for k in ("flat", "mu", "nu"):
        assert torch.equal(out[0][k], out[1][k]), k


def test_full_config_abstract_tree_matches_reference():
    jabs = jax.eval_shape(lambda: jtf.init_params(jqwen.config(),
                                                  jax.random.PRNGKey(0)))
    tabs = ttf.init_params(tqwen.config(), device="meta")
    j = {jruntime._leaf_key(p): (tuple(v.shape), np.dtype(v.dtype).name)
         for p, v in jax.tree_util.tree_flatten_with_path(jabs)[0]}
    t = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tree_leaves_by_key(tabs).items()}
    assert t == j
    assert len(t) == 14
    assert all(v.device.type == "meta"
               for v in tree_leaves_by_key(tabs).values())
    assert tqwen.config().param_count == 464_118_784 == \
        jqwen.config().param_count


def test_bf16_weights_cross_bit_for_bit():
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((64, 33)) * 3.0).astype(jnp.bfloat16)
    tree = {"a": {"w": x}, "b": [x[:5], jnp.float32(2.5) * x[0]]}
    got = truntime.tree_from_numpy(tree, "cpu")
    assert got["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["a"]["w"].view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))
    np.testing.assert_array_equal(got["b"][0].view(torch.int16).numpy(),
                                  np.asarray(x[:5]).view(np.int16))
    assert got["b"][1].dtype == torch.float32
    st = truntime.state_from_numpy({"flat": x, "count": jnp.int32(4)}, "cpu")
    assert st["count"] == 4 and st["flat"].dtype == torch.bfloat16


def test_registry_and_unported_paths_raise():
    assert registry.list_archs() == sorted(registry.ARCHS)
    assert registry.get_config("qwen1.5-0.5b") == tqwen.config()
    for arch in registry.list_archs():
        registry.get_config(arch)
    # every arch is ported, the GNN included
    assert registry.PORTED == set(registry.list_archs())
    assert registry.get_smoke_config("gin-tu").name == "gin-tu"
    # Compressed pushes (item 4) are ported: the step builds.
    assert callable(truntime.make_ps_train_step(lambda p, b: 0, None, {},
                                                push_compression="int8"))


def _rand(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hk", [(4, 4), (4, 2), (4, 1)])
def test_attention_matches_reference(hq, hk, causal):
    from repro.models import attention as jatt
    from repro_torch.models import attention as tatt

    rng = np.random.default_rng(hq * 10 + hk + causal)
    (jq, tq), (jk, tk), (jv, tv) = (_rand(rng, 2, 32, h, 16)
                                    for h in (hq, hk, hk))
    np.testing.assert_allclose(
        tatt.full_attention(tq, tk, tv, causal=causal).numpy(),
        np.asarray(jatt.full_attention(jq, jk, jv, causal=causal)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tatt.chunked_attention(tq, tk, tv, causal=causal, chunk_k=8).numpy(),
        np.asarray(jatt.chunked_attention(jq, jk, jv, causal=causal,
                                          chunk_k=8)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tatt._expand_kv(tk, hq // hk).numpy(),
        np.asarray(jatt._expand_kv(jk, hq // hk)))


def test_layers_match_reference():
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(11)
    (jx, tx), (jg, tg), (jb, tb) = (_rand(rng, 2, 8, 16), _rand(rng, 16),
                                    _rand(rng, 16))
    close = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.rms_norm(tx, tg).numpy(),
                               np.asarray(jl.rms_norm(jx, jg)), **close)
    np.testing.assert_allclose(tl.layer_norm(tx, tg, tb).numpy(),
                               np.asarray(jl.layer_norm(jx, jg, jb)), **close)
    np.testing.assert_allclose(tl.silu(tx).numpy(), np.asarray(jl.silu(jx)),
                               **close)
    (jwg, twg), (jwu, twu), (jwd, twd) = (_rand(rng, 16, 24),
                                          _rand(rng, 16, 24),
                                          _rand(rng, 24, 16))
    np.testing.assert_allclose(
        tl.swiglu(tx, twg, twu, twd).numpy(),
        np.asarray(jl.swiglu(jx, jwg, jwu, jwd)), rtol=1e-5, atol=1e-5)
    jc, js = jl.rope_frequencies(16, 40, 1e6)
    tc, ts = tl.rope_frequencies(16, 40, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    jh, th = _rand(rng, 2, 40, 4, 16)
    np.testing.assert_allclose(tl.apply_rope(th, tc, ts).numpy(),
                               np.asarray(jl.apply_rope(jh, jc, js)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_chunked_xent_masks_padding_and_labels_as_reference(smoothing):
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(12)
    (jh, th), (jw, tw) = _rand(rng, 2, 32, 16), _rand(rng, 16, 256)
    labels = rng.integers(0, 200, size=(2, 32)).astype(np.int32)
    labels[:, -3:] = -1
    want = jl.chunked_softmax_xent(jh, jw, jnp.asarray(labels), chunk=8,
                                   label_smoothing=smoothing, real_vocab=200)
    got = tl.chunked_softmax_xent(th, tw, torch.from_numpy(labels), chunk=8,
                                  label_smoothing=smoothing, real_vocab=200)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
