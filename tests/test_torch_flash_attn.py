"""The flash attention kernel's plain version (``repro_torch.kernels
.flash_attn``, K7) held against the reference's oracles on the same numpy
inputs: ``repro.kernels.flash_attn.ref.flash_attention_ref`` (heads
first) and ``repro.models.attention.chunked_attention`` (model layout).
The Pallas kernel itself does not run on the installed jax, so it is not
the comparison.  S_q = S_k throughout, the shape where the reference's
two causal masks agree.

Tolerances.  float32: rtol = atol = 2e-5 (the two packages sum the
products and the softmax in different orders, and the plain version's
softmax is exact where the chunked one is online).  bfloat16: rtol =
atol = 2e-2, the reference's own bf16 tolerance for this kernel
(``tests/test_kernels.py``): the reference rounds q*scale, the scores'
inputs and the probabilities to bf16, the port keeps them in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ref import flash_attention_ref
from repro.models.attention import chunked_attention as j_chunked
from repro_torch.kernels.flash_attn import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.tree import array_to_tensor

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(b, s, hq, hk, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    arrs = [jnp.asarray(rng.standard_normal((b, s, h, d)), jd)
            for h in (hq, hk, hk)]
    return arrs, [array_to_tensor(a) for a in arrs]


def _close(got: torch.Tensor, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _ref_heads_first(q, k, v, causal):
    """``flash_attention_ref`` on model-layout inputs (GQA expanded as the
    reference's wrapper expands it)."""
    rep = q.shape[2] // k.shape[2]
    k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    return t(flash_attention_ref(t(q), t(k), t(v), causal=causal))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [128, 200, 384])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference(causal, s, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(2, s, 4, 4, 32, dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, _ref_heads_first(jq, jk, jv, causal), dtype)
    _close(got, j_chunked(jq, jk, jv, causal=causal, chunk_k=s // 2), dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_gqa_matches_reference(causal):
    (jq, jk, jv), (q, k, v) = _inputs(1, 200, 8, 2, 64, "float32", seed=1)
    got = ops.flash_attention(q, k, v, causal=causal)
    _close(got, _ref_heads_first(jq, jk, jv, causal), "float32")
    _close(got, j_chunked(jq, jk, jv, causal=causal, chunk_k=100), "float32")


@pytest.mark.parametrize("d", [16, 128])
def test_plain_query_chunks_do_not_change_the_result(d):
    """Chunking the queries (the plain version's memory bound) is an
    execution-order change only: bit for bit."""
    _, (q, k, v) = _inputs(1, 200, 4, 2, d, "float32", seed=2)
    whole = ref.flash_attention_plain(q, k, v, chunk_q=1024)
    parts = ref.flash_attention_plain(q, k, v, chunk_q=48)
    assert torch.equal(whole, parts)


def test_model_flash_attention_dispatches_to_plain_on_cpu():
    _, (q, k, v) = _inputs(1, 128, 4, 4, 16, "float32", seed=3)
    assert torch.equal(tattn.flash_attention(q, k, v, causal=True),
                       ref.flash_attention_plain(q, k, v, causal=True))
    # the training path's full attention computes the same function
    torch.testing.assert_close(tattn.flash_attention(q, k, v),
                               tattn.full_attention(q, k, v), rtol=2e-5,
                               atol=2e-5)
    assert ops.flash_attention.launches == 0  # no kernel on the CPU


def test_wrapper_refuses_inputs_that_require_grad():
    _, (q, k, v) = _inputs(1, 128, 4, 4, 16, "float32")
    with pytest.raises(RuntimeError, match="forward only"):
        ops.flash_attention(q.clone().requires_grad_(True), k, v)
    with torch.inference_mode():  # the prefill's mode
        ops.flash_attention(q, k, v)


def test_wrapper_validates_shapes_and_dtypes():
    _, (q, k, v) = _inputs(1, 128, 4, 2, 16, "float32")
    with pytest.raises(ValueError, match="S_q <= S_k"):
        ops.flash_attention(torch.cat([q, q], 1), k, v, causal=True)
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.double(), v.double())
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError):
        ops.flash_attention(q[0], k, v)
