"""The port's serving path (``init_kv_cache``, ``make_serve_step``,
``make_prefill``, ``launch/serve.py``) held against the reference's on
identical weights (the reference's, carried across with
``tree_from_numpy``) and identical numpy prompts, in float32 on the CPU.

Tolerances follow ``tests/test_torch_transformer.py``: XLA and PyTorch sum
the matrix products, softmax and norms in different orders, and their
float32 RoPE tables differ in the last bit.  Logits and cache entries are
held at rtol 1e-4 with atol 1e-5 x the largest magnitude (the gradient
leaves' bound there, for results that went through every layer); greedy
tokens and shapes exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen1_5_0_5b as jqwen
from repro.models import transformer as jtf
from repro_torch.configs import qwen1_5_0_5b as tqwen
from repro_torch.launch import serve
from repro_torch.models import transformer as ttf
from repro_torch.ps import runtime as truntime
from repro_torch.tree import cache_from_numpy, tree_leaves_by_key

VARIANTS = {
    "qwen-smoke": {},
    "parallel-ln-gqa": dict(norm="layernorm", parallel_block=True,
                            n_kv_heads=2, qkv_bias=False,
                            tie_embeddings=False),
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


def _close(got: torch.Tensor, want, what=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-4,
                               atol=1e-5 * scale, err_msg=what)


def _prompt(cfg, batch, length, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (batch, length), dtype=np.int32)


@pytest.mark.parametrize("cache_len", [None, 7, "per-row"])
def test_decode_attention_matches_reference(cache_len):
    from repro.models.attention import decode_attention as jdecode
    from repro_torch.models.attention import decode_attention as tdecode

    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 1, 4, 16), (3, 10, 2, 16), (3, 10, 2, 16)))
    lens = np.array([3, 10, 5], np.int32) if cache_len == "per-row" \
        else cache_len
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   None if lens is None else jnp.asarray(lens))
    got = tdecode(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v),
                  torch.from_numpy(lens) if cache_len == "per-row" else lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_kv_cache_matches_reference(variant):
    jcfg, tcfg = _configs(variant)
    jc = jtf.init_kv_cache(jcfg, 3, 20)
    tc = ttf.init_kv_cache(tcfg, 3, 20, device="cpu")
    assert tc.keys() == jc.keys() and tc["scan"].keys() == jc["scan"].keys()
    for name in jc["scan"]:
        assert tuple(tc["scan"][name].shape) == jc["scan"][name].shape
        assert tc["scan"][name].dtype == tcfg.torch_dtype
        assert not tc["scan"][name].any()
    assert tc["length"] == int(jc["length"]) == 0
    conv = cache_from_numpy(jax.device_get(jc), "cpu")
    assert conv.keys() == tc.keys() and conv["length"] == 0
    for name in jc["scan"]:
        assert torch.equal(conv["scan"][name], tc["scan"][name])


def test_cache_from_numpy_carries_bf16_bit_for_bit():
    jcfg = dataclasses.replace(jqwen.smoke_config(), dtype="bfloat16")
    jc = jtf.init_kv_cache(jcfg, 2, 4)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        jc["scan"]["k"].shape), jnp.bfloat16)
    jc = dict(jc, scan={"k": x, "v": -x}, length=jnp.int32(3))
    tc = cache_from_numpy(jc, "cpu")
    assert tc["length"] == 3 and tc["scan"]["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tc["scan"]["v"].view(torch.int16).numpy(),
                                  np.asarray(-x).view(np.int16))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_serve_step_matches_reference_over_eight_steps(variant):
    jcfg, tcfg = _configs(variant)
    jparams, tparams = _weights(jcfg)
    toks = _prompt(jcfg, 2, 8, seed=1)
    jstep = jax.jit(jtf.make_serve_step(jcfg))
    tstep = ttf.make_serve_step(tcfg)
    jc = jtf.init_kv_cache(jcfg, 2, 10)
    tc = cache_from_numpy(jax.device_get(jc), "cpu")
    for i in range(8):
        jl, jc = jstep(jparams, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc2 = tstep(tparams, tc, torch.from_numpy(toks[:, i:i + 1]))
        assert tc2 is tc  # written in place, the same tree returned
        assert tl.shape == (2, tcfg.vocab) and tl.dtype == torch.float32
        _close(tl, jl, f"logits step {i}")
    assert tc["length"] == int(jc["length"]) == 8
    for name in ("k", "v"):
        _close(tc["scan"][name], jc["scan"][name], name)
        assert not tc["scan"][name][:, :, 8:].any()  # untouched positions


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_matches_reference(variant):
    jcfg, tcfg = _configs(variant)
    jparams, tparams = _weights(jcfg, seed=2)
    toks = _prompt(jcfg, 2, 24, seed=3)
    jl = jax.jit(jtf.make_prefill(jcfg))(jparams, jnp.asarray(toks))
    tl = ttf.make_prefill(tcfg)(tparams, torch.from_numpy(toks))
    assert tl.shape == (2, tcfg.vocab)
    _close(tl, jl)
    # the prefill's last-token logits are the decode's after the prompt
    tc = ttf.init_kv_cache(tcfg, 2, 24, device="cpu")
    step = ttf.make_serve_step(tcfg)
    for i in range(24):
        dl, tc = step(tparams, tc, torch.from_numpy(toks[:, i:i + 1]))
    _close(dl, tl.numpy(), "decode vs prefill")
    # the plain attention route computes the same function
    pl = ttf.make_prefill(tcfg, attention="plain")(tparams,
                                                   torch.from_numpy(toks))
    _close(pl, tl.numpy(), "plain vs flash prefill")


def test_prefill_runs_without_autograd_and_checks_its_route():
    _, tcfg = _configs("qwen-smoke")
    params = ttf.init_params(tcfg, device="cpu")
    for p in tree_leaves_by_key(params).values():
        p.requires_grad_(True)
    out = ttf.make_prefill(tcfg)(params, torch.zeros((1, 8), dtype=torch.long))
    assert not out.requires_grad
    with pytest.raises(ValueError, match="attention"):
        ttf.make_prefill(tcfg, attention="sdpa")


def _reference_decode(jcfg, jparams, batch, prompt_len, gen):
    """The reference driver's loop (``repro.launch.serve.main``), greedy."""
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


@pytest.mark.parametrize("direct", [False, True])
def test_launch_serve_greedy_tokens_match_reference(direct, capsys):
    jcfg, tcfg = _configs("qwen-smoke")
    jparams, tparams = _weights(jcfg, seed=4)
    argv = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "6", "--gen", "8"]
    out = serve.main(argv + (["--direct"] if direct else []),
                     params=tparams)
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[serve]")]
    assert any("generated 14 tokens" in l for l in lines)
    assert any("first sequence token ids" in l for l in lines)
    assert any("bit-exact vs hosted" in l for l in lines) != direct
    want = _reference_decode(jcfg, jparams, 2, 6, 8)
    np.testing.assert_array_equal(out["tokens"].numpy(), want)


def test_replica_pull_round_trips_bf16_weights():
    cfg = dataclasses.replace(tqwen.smoke_config(), dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(5)
    params = ttf.init_params(cfg, gen, "cpu")
    served, rs = serve._pull_params_via_replicas(params, 2)
    for k, p in tree_leaves_by_key(params).items():
        got = tree_leaves_by_key(served)[k]
        assert got.dtype == p.dtype and torch.equal(got, p), k
    assert rs.n_publishes == 1 and len(rs.replicas) == 2


def test_sampled_decode_is_reproducible_from_its_generator():
    _, tcfg = _configs("qwen-smoke")
    params = ttf.init_params(tcfg, device="cpu")
    prompt = torch.from_numpy(_prompt(tcfg, 2, 4))
    runs = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(1)
        runs.append(serve.decode(tcfg, params, prompt, 6, temperature=0.8,
                                 generator=g)["tokens"])
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (2, 6)


def test_launch_serve_refuses_other_families_and_a_missing_card():
    with pytest.raises(ValueError, match="not an LM"):
        serve.main(["--arch", "dlrm-rm2", "--device", "cpu"])
    with pytest.raises(ValueError, match="not an LM"):
        serve.main(["--arch", "gin-tu", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "qwen1.5-0.5b", "--smoke"])
