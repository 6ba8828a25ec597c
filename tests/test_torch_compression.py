"""Push-path compression of the port (``repro_torch.ps.compression``)
held against the reference's (``repro.ps.compression``) on the same
numpy-seeded inputs, and the reference's own properties mirrored.

Against the reference's EAGER functions the port is bit for bit: int8
codes, block scales, dequantized values, ``ef_transform``'s q and
residual, bf16 round trips.  Under ``jax.jit`` XLA regroups
``q * s / 127``, so there the codes and scales stay equal and the
dequantized values and residuals are within 1 ulp.

Mirrors ``tests/test_compression.py`` with two changes: the wire-bytes
property is asserted for n >= 4 only (at n = 1 the model's 5 bytes exceed
half of fp32's 4), and the round-trip bound allows float32 rounding at
the block's scale (4 ulp of the scale) where the reference allows a
fixed 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # fallback shim; see requirements-dev.txt
    from _hypothesis_shim import given, settings, strategies as st

from repro.ps import compression as J
from repro_torch.ps.compression import (
    BLOCK,
    ErrorFeedback,
    _block_scales,
    compress_decompress,
    dequantize_int8,
    ef_transform,
    quantize_int8,
    wire_bytes,
)


def _np(seed, n, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(n) * scale
            ).astype(np.float32)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def ulp_diff(a, b) -> int:
    a = _bits(a).astype(np.int64)
    b = _bits(b).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


# ------------------------------------------------------ against the reference
@pytest.mark.parametrize("n", [1, 7, 2048, 2049, 5000, 100_003])
def test_quantize_int8_equals_reference(n):
    x = _np(n, n, 3.0)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = J.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
    np.testing.assert_array_equal(
        _bits(dequantize_int8(q, s).numpy()),
        _bits(J.dequantize_int8(jq, js)))


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("n", [1, 333, 5000, 100_003])
def test_ef_transform_equals_eager_reference_bit_for_bit(kind, n):
    g, ef = _np(2 * n, n, 2.0), _np(2 * n + 1, n, 0.01)
    q, r = ef_transform(torch.from_numpy(g), torch.from_numpy(ef), kind)
    jq, jr = J.ef_transform(jnp.asarray(g), jnp.asarray(ef), kind)
    np.testing.assert_array_equal(_bits(q.numpy()), _bits(jq))
    np.testing.assert_array_equal(_bits(r.numpy()), _bits(jr))


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_against_jitted_reference_codes_equal_values_within_one_ulp(kind):
    """Under jit XLA regroups ``q * s / 127``: the int8 codes and scales
    stay equal, the dequantized values and residuals move by at most 1
    ulp (bf16 is a cast, equal either way)."""
    n = 100_003
    g, ef = _np(5, n, 2.0), _np(6, n, 0.01)
    x = g + ef
    jq, js = jax.jit(J.quantize_int8)(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
    tq, tr = ef_transform(torch.from_numpy(g), torch.from_numpy(ef), kind)
    jq, jr = jax.jit(J.ef_transform, static_argnums=2)(
        jnp.asarray(g), jnp.asarray(ef), kind)
    assert ulp_diff(tq.numpy(), jq) <= 1
    # The residual g' - q is exact around a 1-ulp q, so it moves by the
    # same absolute amount: one ulp of q, at most.
    step = np.spacing(np.abs(np.asarray(jq)))
    assert np.all(np.abs(tr.numpy() - np.asarray(jr)) <= step)
    if kind == "bf16":
        np.testing.assert_array_equal(_bits(tq.numpy()), _bits(jq))


def test_compress_decompress_and_block_scales_equal_reference():
    x = _np(9, 4099, 7.0)
    for kind in ("bf16", "int8"):
        np.testing.assert_array_equal(
            _bits(compress_decompress(torch.from_numpy(x), kind).numpy()),
            _bits(J.compress_decompress(jnp.asarray(x), kind)))
    for block in (1, 3, 32, 2048):
        np.testing.assert_array_equal(
            _block_scales(torch.from_numpy(x), block).numpy(),
            np.asarray(J._block_scales(jnp.asarray(x), block)))


def test_error_feedback_chain_equals_reference():
    n, kind = 3001, "int8"
    ef, jef = ErrorFeedback((n,)), J.ErrorFeedback((n,))
    for t in range(6):
        g = _np(100 + t, n)
        q = ef.step(torch.from_numpy(g), kind)
        jq = jef.step(jnp.asarray(g), kind)
        np.testing.assert_array_equal(_bits(q.numpy()), _bits(jq))
    np.testing.assert_array_equal(_bits(ef.residual.numpy()),
                                  _bits(jef.residual))


# ------------------------------------------- the reference's properties
@settings(deadline=None, max_examples=25)
@given(seed=st.integers(min_value=0, max_value=10_000),
       n=st.integers(min_value=1, max_value=5000),
       scale=st.floats(min_value=1e-3, max_value=1e3))
def test_int8_round_trip_error_bound(seed, n, scale):
    """Within half a quantization step, plus float32 rounding of the
    quotient and the dequantization at the block's scale."""
    x = torch.from_numpy(_np(seed, n, scale))
    q, scales = quantize_int8(x)
    err = (x - dequantize_int8(q, scales)).abs().numpy()
    per_elem = np.repeat(scales.numpy(), BLOCK)[:n].astype(np.float64)
    slack = 4 * np.spacing(per_elem.astype(np.float32))
    assert np.all(err <= per_elem / 127.0 * 0.5 + slack)


@settings(deadline=None, max_examples=25)
@given(seed=st.integers(min_value=0, max_value=10_000),
       n=st.integers(min_value=1, max_value=5000))
def test_int8_quantizer_outputs(seed, n):
    q, scales = quantize_int8(torch.from_numpy(_np(seed, n)))
    assert q.dtype == torch.int8 and tuple(q.shape) == (n,)
    assert tuple(scales.shape) == (-(-n // BLOCK),)
    # The clip keeps the codes symmetric: a block's max |x| maps to
    # exactly +-127, never -128.
    assert int(q.to(torch.int32).abs().max()) <= 127


def test_block_scales_all_zero_block():
    """A zero block quantizes to zeros and back (the safe-scale guard,
    not a 0/0 NaN)."""
    x = torch.zeros(100)
    assert torch.equal(_block_scales(x, 32), torch.zeros(4))
    q, s = quantize_int8(x, block=32)
    assert torch.equal(q, torch.zeros(100, dtype=torch.int8))
    assert torch.equal(dequantize_int8(q, s, block=32), x)


def test_block_scales_length_one():
    x = torch.tensor([-3.5])
    torch.testing.assert_close(_block_scales(x, 8), torch.tensor([3.5]))
    q, s = quantize_int8(x, block=8)
    torch.testing.assert_close(dequantize_int8(q, s, block=8), x,
                               rtol=1e-6, atol=0)


@settings(deadline=None, max_examples=20)
@given(n=st.integers(min_value=1, max_value=300),
       block=st.sampled_from([1, 3, 7, 32, 256]))
def test_block_scales_ragged_lengths(n, block):
    """Lengths not a multiple of the block: the padding never leaks into
    a block's max."""
    x = torch.arange(1, n + 1, dtype=torch.float32) * torch.where(
        torch.arange(n) % 2 == 0, 1.0, -1.0)
    scales = _block_scales(x, block).numpy()
    assert scales.shape == (-(-n // block),)
    xa = x.abs().numpy()
    for b in range(scales.size):
        assert scales[b] == xa[b * block:(b + 1) * block].max()


def test_compress_decompress_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown compression"):
        compress_decompress(torch.ones(4), "fp8")


def test_bf16_round_trip_is_cast():
    x = torch.from_numpy(_np(3, 257))
    assert torch.equal(compress_decompress(x, "bf16"),
                       x.to(torch.bfloat16).to(torch.float32))


@settings(deadline=None, max_examples=15)
@given(seed=st.integers(min_value=0, max_value=10_000),
       n=st.integers(min_value=1, max_value=3000),
       kind=st.sampled_from(["bf16", "int8"]),
       steps=st.integers(min_value=1, max_value=12))
def test_error_feedback_invariant(seed, n, kind, steps):
    """EF-SGD telescopes: the emitted updates plus the final residual sum
    to the gradients (each round keeps q_t + r_t = g_t + r_{t-1}), so the
    applied updates track the gradients within the last round's
    quantization error."""
    grads = [torch.from_numpy(_np(seed * 16 + t, n)) for t in range(steps)]
    ef = ErrorFeedback((n,))
    total_q = torch.zeros(n)
    for g in grads:
        total_q = total_q + ef.step(g, kind)
    total_g = sum(grads)
    torch.testing.assert_close(total_q + ef.residual, total_g, rtol=1e-5,
                               atol=1e-5)
    if kind == "int8":
        gap = (total_g - total_q).abs().numpy()
        bound = np.repeat(_block_scales(total_g.abs() + total_q.abs(),
                                        BLOCK).numpy(), BLOCK)[:n]
        assert np.all(gap <= bound / 127.0 + 1e-5)


def test_ef_transform_matches_manual_recurrence():
    g = torch.from_numpy(_np(5, 400))
    ef = torch.from_numpy(_np(6, 400) * 0.01)
    q, resid = ef_transform(g, ef, "int8")
    assert torch.equal(q, compress_decompress(g + ef, "int8"))
    assert torch.equal(resid, g + ef - q)


def test_wire_bytes_model():
    assert wire_bytes(100, None) == 400
    assert wire_bytes(100, "bf16") == 200
    assert wire_bytes(100, "int8") == 100 + 4  # one scale block
    assert wire_bytes(BLOCK + 1, "int8") == BLOCK + 1 + 8  # two blocks
    assert wire_bytes(0, "int8") == 0
    with pytest.raises(ValueError, match="unknown compression"):
        wire_bytes(10, "fp8")
    with pytest.raises(ValueError):
        wire_bytes(-1, None)
    for n in (0, 1, 5, 4096, 100_001):
        for kind in (None, "bf16", "int8"):
            assert wire_bytes(n, kind) == J.wire_bytes(n, kind)


@settings(deadline=None, max_examples=20)
@given(n=st.integers(min_value=4, max_value=100_000))
def test_wire_bytes_int8_under_half(n):
    """int8 payload and scales cost at most half the fp32 bytes from
    n = 4 up (below that one 4-byte scale outweighs the saving)."""
    assert wire_bytes(n, "int8") <= 0.5 * wire_bytes(n, None)
    assert wire_bytes(n, "bf16") == 0.5 * wire_bytes(n, None)
