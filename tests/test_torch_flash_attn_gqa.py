"""The flash attention wrapper's GQA head mapping and ``chip_smoke``'s
plain version with the bf16 kernel's rounding, both held against the
reference's oracle ``repro.kernels.flash_attn.ref.flash_attention_ref``
on the same numpy inputs.

Query head h reads kv head h // (HQ / HK): the wrapper's plain version
(its CPU route) at head dims 64 and 128 over the GQA groups of the
model configs (granite-8b 32 / 8, command-r 96 / 8) and others (MHA,
groups of 2, 3 and 4), causal and not, float32 within rtol = atol =
2e-5 (the two packages sum in different orders).

``chip_smoke.k7_plain_bf16_p`` (the online softmax over key tiles with P
rounded to bf16 for P V, the yardstick of the card's short causal rows)
on bf16 inputs: within rtol = atol = 2e-2 of the oracle, the reference's
own bf16 tolerance for this kernel (``tests/test_kernels.py``), and apart
from the wrapper's plain version (P in float32) by P's rounding alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from repro.kernels.flash_attn.ref import flash_attention_ref
from repro_torch.kernels.flash_attn import ops
from repro_torch.tree import array_to_tensor

HEADS = [(32, 8), (96, 8), (16, 16), (12, 4), (6, 3), (8, 4)]  # (HQ, HK)


def _inputs(s, hq, hk, d, jd, seed):
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.standard_normal((1, s, h, d)), jd)
            for h in (hq, hk, hk)]
    return arrs, [array_to_tensor(a) for a in arrs]


def _oracle(q, k, v, causal):
    """``flash_attention_ref`` on model-layout inputs, GQA expanded as
    the reference's wrapper expands it; float32 numpy."""
    rep = q.shape[2] // k.shape[2]
    k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    out = t(flash_attention_ref(t(q), t(k), t(v), causal=causal))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hk", HEADS)
def test_gqa_heads_match_reference(hq, hk, d, causal):
    (jq, jk, jv), (q, k, v) = _inputs(130, hq, hk, d, jnp.float32,
                                      seed=hq + d)
    got = ops.flash_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), _oracle(jq, jk, jv, causal),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_p_matches_reference(causal):
    (jq, jk, jv), (q, k, v) = _inputs(300, 8, 2, 128, jnp.bfloat16, seed=5)
    want = _oracle(jq, jk, jv, causal)
    tiled = cs.k7_plain_bf16_p(q, k, v, causal=causal, bk=128)
    assert tiled.dtype == torch.bfloat16 and tiled.shape == q.shape
    np.testing.assert_allclose(tiled.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    unrounded = ops.flash_attention(q, k, v, causal=causal).float().numpy()
    err = np.abs(tiled.float().numpy() - unrounded).max()
    assert 0 < err <= 2e-2  # P's rounding shows, within bf16's tolerance
