"""MLA (deepseek-v2's compressed-KV attention) in the port: one layer's
un-absorbed attention (training and prefill) and its absorbed decode
step against the reference's ``_mla_attention`` and ``_decode_attn_mla``
on the same weights, cache and inputs; the absorbed decode against the
un-absorbed prefill inside the port with no token dropped by the MoE's
capacity; and the prefill's attention route chosen from the config.

Tolerances: float32 on the CPU, rtol 1e-4 with atol 1e-5 x the largest
magnitude, as ``tests/test_torch_serve.py`` holds logits and caches (XLA
and PyTorch sum the products and softmax in different orders, and their
RoPE tables differ in the last bit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_236b as jds
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs import deepseek_v2_236b as tds
from repro_torch.configs import registry
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.ps import runtime as truntime


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-4,
                               atol=1e-5 * scale, err_msg=what)


def _layer(seed=0):
    """deepseek's smoke config and its first scanned layer's attention
    weights, both packages."""
    jcfg, tcfg = jds.smoke_config(), tds.smoke_config()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree_util.tree_map(lambda x: x[0], jparams["layers"]["attn"])
    return jcfg, tcfg, jp, truntime.tree_from_numpy(jp, "cpu")


@pytest.mark.parametrize("chunk", [0, 4])
def test_mla_attention_matches_reference(chunk):
    jcfg, tcfg, jp, tp = _layer()
    jcfg = dataclasses.replace(jcfg, attn_chunk_k=chunk)
    tcfg = dataclasses.replace(tcfg, attn_chunk_k=chunk)
    x = np.random.default_rng(1).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32)
    rope = jcfg.mla.qk_rope_dim
    jc, js = jlayers.rope_frequencies(rope, 12, jcfg.rope_theta)
    tc, ts = tlayers.rope_frequencies(rope, 12, tcfg.rope_theta)
    want = jtf._mla_attention(jcfg, jp, jnp.asarray(x), jc, js)
    got = ttf._mla_attention(tcfg, tp, torch.from_numpy(x), tc, ts)
    assert got.shape == (2, 12, tcfg.d_model)
    _close(got.numpy(), want)


def test_absorbed_decode_step_matches_reference():
    jcfg, tcfg, jp, tp = _layer(seed=2)
    m = jcfg.mla
    rng = np.random.default_rng(3)
    b, smax, length = 3, 10, 6
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((b, smax, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((b, smax, m.qk_rope_dim)).astype(np.float32)
    ckv[:, length:] = kr[:, length:] = 0.0
    jcos, jsin = jlayers.rope_row(jnp.int32(length), m.qk_rope_dim,
                                  jcfg.rope_theta)
    tcos, tsin = tlayers.rope_row(length, m.qk_rope_dim, tcfg.rope_theta)
    want, jckv, jkr = jtf._decode_attn_mla(
        jcfg, jp, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
        jnp.int32(length), jcos, jsin)
    tckv, tkr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    got = ttf._decode_attn_mla(tcfg, tp, torch.from_numpy(x), length, tcos,
                               tsin, tckv, tkr)
    assert got.shape == (b, 1, tcfg.d_model)
    _close(got.numpy(), want, "out")
    _close(tckv.numpy(), jckv, "ckv written in place")
    _close(tkr.numpy(), jkr, "k_rope written in place")
    assert not tckv[:, length + 1:].any()


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-236b"])
def test_decode_equals_prefill_without_capacity_drops(arch):
    """With a capacity factor of E / k no token is dropped, so decoding
    the prompt one token at a time (B tokens a MoE call; MLA absorbed)
    gives the prefill's last-token logits (B x S tokens a call; MLA
    un-absorbed).  At the published factor the two differ by design."""
    cfg = registry.get_smoke_config(arch)
    cfg = dataclasses.replace(
        cfg, moe_capacity_factor_override=cfg.moe.n_experts / cfg.moe.top_k)
    gen = torch.Generator()
    gen.manual_seed(4)
    params = ttf.init_params(cfg, gen, "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (3, 20), dtype=np.int32))
    pre = ttf.make_prefill(cfg)(params, toks)
    cache = ttf.init_kv_cache(cfg, 3, 20, device="cpu")
    step = ttf.make_serve_step(cfg)
    for i in range(20):
        logits, cache = step(params, cache, toks[:, i:i + 1])
    _close(logits.numpy(), pre.numpy())


def test_prefill_route_follows_the_config(monkeypatch):
    """K7 for GQA configs by default, the plain attention for MLA; an
    explicit ``attention="flash"`` on an MLA config raises."""
    calls = []
    real = tattn.flash_attention

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tattn, "flash_attention", counting)
    toks = torch.zeros((1, 8), dtype=torch.long)
    for arch, n_flash in (("granite-moe-1b-a400m", 2),
                          ("deepseek-v2-236b", 0)):
        cfg = registry.get_smoke_config(arch)
        params = ttf.init_params(cfg, device="cpu")
        calls.clear()
        out = ttf.make_prefill(cfg)(params, toks)
        assert len(calls) == n_flash and out.shape == (1, cfg.vocab)
    with pytest.raises(ValueError, match="MLA"):
        ttf.make_prefill(cfg, attention="flash")
    with pytest.raises(ValueError, match="MLA"):
        ttf.forward_hidden(cfg, params, toks, attention="flash")
    with pytest.raises(ValueError, match="attention"):
        ttf.make_prefill(cfg, attention="sdpa")


def test_mla_cache_is_the_compressed_latent():
    cfg = tds.config()
    jc = jax.eval_shape(lambda: jtf.init_kv_cache(jds.config(), 2, 16))
    tc = ttf.init_kv_cache(dataclasses.replace(cfg, n_layers=3), 2, 16,
                           device="meta")
    assert tc["scan"]["ckv"].shape == (2, 2, 16, 512)
    assert tc["scan"]["k_rope"].shape == (2, 2, 16, 64)
    assert tc["dense"]["ckv"].shape == (1, 2, 16, 512)
    assert tc["scan"]["ckv"].dtype == torch.bfloat16
    assert jc["scan"]["ckv"].shape[1:] == tc["scan"]["ckv"].shape[1:]
    assert jc["dense"]["k_rope"].shape == tc["dense"]["k_rope"].shape
    assert cfg.rope_dim == 64 and cfg.head_dim == 40
