"""The port's dense Adam (kernel K5's plain version on the CPU) and its
functional optimizer, held against the reference on the same numpy
inputs.

Tolerances.  Against the reference's eager ``runtime._adam_math`` (the
same grouping: reciprocal-multiply bias correction, ``(lr*mu_hat)/(sqrt +
eps)``, ``1-b`` folded in doubles) the budget is 1 ulp of the result's
own format: the one possible difference is the float32 bias-correction
scalar (ROADMAP Queue 3).  The Pallas kernel in interpret mode runs as
one jitted XLA program, which contracts ``b1*mu + (1-b1)*g`` into a
fused multiply-add, so it is held at the reference's own kernel-vs-oracle
tolerance, rtol 2e-5 and atol 2e-6 (``tests/test_kernels.py``); a bf16 p
is compared there after both sides rounded to bf16, so a float32 pair
that straddles a bf16 rounding boundary may differ by one bf16 ulp.
The optimizers: the unfused paths, eager in both packages, follow
``_adam_update`` (division by ``1 - b**t``) and are held at 1 ulp; the
fused ones follow the kernel's grouping, the reference's in interpret
mode (rtol 2e-5, atol 2e-6 as above).  Fused vs
unfused, in either package, differ in the last bits; after 3 steps they
are held at rtol 1e-5 (the reference's own fused-vs-unfused test uses
1e-6 after one step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.agg_adam import ops as jops
from repro.optim import adam as jadam
from repro.ps.runtime import _adam_math
from repro_torch.kernels.agg_adam import ops as tops
from repro_torch.optim import adam as tadam
from repro_torch.ps.runtime import tree_from_numpy
from repro_torch.tree import tree_leaves_by_key

ULP_BUDGET = 1


def ulp_diff(a, b) -> int:
    """Largest distance in units in the last place of the arrays' own
    format (float32, or bfloat16 given as its int16 bit patterns)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if a.dtype == np.int16:
        bits, sign = (a.astype(np.int64), b.astype(np.int64)), 0x7FFF
    else:
        bits = (a.astype(np.float32).view(np.int32).astype(np.int64),
                b.astype(np.float32).view(np.int32).astype(np.int64))
        sign = 0x7FFFFFFF
    x, y = (np.where(t < 0, -(t & sign), t) for t in bits)
    return int(np.abs(x - y).max()) if x.size else 0


def bits(t: torch.Tensor) -> np.ndarray:
    """A port tensor as numpy: float32 as is, bfloat16 as int16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def jbits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _case(seed, n, p_dtype, g_dtype, workers):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    mu = (rng.standard_normal(n) * 0.1).astype(np.float32)
    nu = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    g = rng.standard_normal((workers, n) if workers else n).astype(np.float32)
    jp, jg = jnp.asarray(p).astype(p_dtype), jnp.asarray(g).astype(g_dtype)
    return jp, jg, mu, nu


DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("p_dt,g_dt", [("f32", "f32"), ("bf16", "bf16"),
                                       ("bf16", "f32")])
def test_k5_plain_matches_reference(p_dt, g_dt, workers, wd):
    n = 5003  # ragged: not a multiple of 4, nor of the reference's block
    jp, jg, mu, nu = _case(workers + 7 * int(wd > 0), n, DTYPES[p_dt],
                           DTYPES[g_dt], workers)
    count, kw = 5, dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    out_k = jops.aggregate_adam(jp, jg, jnp.asarray(mu), jnp.asarray(nu),
                                jnp.int32(count), wd=wd, interpret=True,
                                **kw)
    tp = tree_from_numpy(np.asarray(jp), "cpu")
    out_t = tops.aggregate_adam(tp, tree_from_numpy(np.asarray(jg), "cpu"),
                                torch.from_numpy(mu.copy()),
                                torch.from_numpy(nu.copy()), count, wd=wd,
                                **kw)
    assert out_t[0] is tp  # in place, in p's dtype
    assert tp.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[p_dt]
    for name, t, k in zip(("p", "mu", "nu"), out_t, out_k):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(k, np.float32),
                                   rtol=2e-5, atol=2e-6, err_msg=name)
    if wd:
        return
    g32 = jg.astype(jnp.float32)
    out_e = _adam_math(jp.astype(jnp.float32),
                       g32.sum(axis=0) if workers else g32, jnp.asarray(mu),
                       jnp.asarray(nu), jnp.int32(count), **kw)
    want_p = out_e[0].astype(jp.dtype)
    assert ulp_diff(bits(out_t[0]), jbits(want_p)) <= ULP_BUDGET
    for name, t, e in zip(("mu", "nu"), out_t[1:], out_e[1:]):
        assert ulp_diff(t.numpy(), np.asarray(e)) <= ULP_BUDGET, name


def test_k5_wrapper_checks_inputs():
    p = torch.zeros(8)
    z = torch.zeros(8)
    with pytest.raises(TypeError):
        tops.aggregate_adam(p.double(), z, z.clone(), z.clone(), 1, lr=1e-3)
    with pytest.raises(ValueError):  # grads of another shape
        tops.aggregate_adam(p, torch.zeros(9), z.clone(), z.clone(), 1,
                            lr=1e-3)
    with pytest.raises(TypeError):  # moments must be float32
        tops.aggregate_adam(p, z, z.bfloat16(), z.clone(), 1, lr=1e-3)
    with pytest.raises(ValueError):
        tops.aggregate_adam(torch.zeros(4, 4).t(), torch.zeros(4, 4),
                            torch.zeros(4, 4), torch.zeros(4, 4), 1, lr=1e-3)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(300).astype(np.float32),
            "b": {"c": rng.standard_normal((4, 40)).astype(np.float32),
                  "d": rng.standard_normal(7).astype(np.float32)}}


def _run_jax(opt, params, grads_seq):
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(params)
    for g in grads_seq:
        params, state = opt.step(params, jax.tree_util.tree_map(
            jnp.asarray, g), state)
    return {k: np.asarray(v) for k, v in tree_leaves_by_key(
        jax.tree_util.tree_map(np.asarray, params)).items()}, state


def _run_torch(opt, params, grads_seq):
    params = tree_from_numpy(params, "cpu")
    state = opt.init(params)
    for g in grads_seq:
        params, state = opt.step(params, tree_from_numpy(g, "cpu"), state)
    return {k: v.float().numpy()
            for k, v in tree_leaves_by_key(params).items()}, state


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_optimizer_matches_reference_three_steps(wd):
    params = _tree(0)
    grads_seq = [jax.tree_util.tree_map(lambda x, s=s: 0.1 * (s + 1) * x,
                                        _tree(10 + s)) for s in range(3)]
    out = {}
    for fused in (False, True):
        out["j", fused], _ = _run_jax(jadam(1e-2, weight_decay=wd,
                                            fused=fused), params, grads_seq)
        out["t", fused], st = _run_torch(
            tadam(1e-2, weight_decay=wd, fused=fused), params, grads_seq)
        assert st.count == 3
    for key in out["j", False]:
        # Unfused, eager in both packages, same grouping: within 1 ulp.
        assert ulp_diff(out["t", False][key], out["j", False][key]) \
            <= ULP_BUDGET, key
        # Fused: the reference runs its kernel in interpret mode.
        np.testing.assert_allclose(out["t", True][key], out["j", True][key],
                                   rtol=2e-5, atol=2e-6, err_msg=key)
        # Fused vs unfused inside each package: the groupings differ.
        for pkg in ("j", "t"):
            np.testing.assert_allclose(out[pkg, True][key],
                                       out[pkg, False][key], rtol=1e-5,
                                       err_msg=f"{pkg} {key}")


def test_fused_optimizer_updates_in_place_and_unfused_does_not():
    params = tree_from_numpy(_tree(1), "cpu")
    grads = tree_from_numpy(_tree(2), "cpu")
    before = {k: v.clone() for k, v in tree_leaves_by_key(params).items()}
    opt = tadam(1e-2)
    new, st = opt.step(params, grads, opt.init(params))
    for k, v in tree_leaves_by_key(params).items():
        assert torch.equal(v, before[k])
        assert tree_leaves_by_key(new)[k] is not v
    opt = tadam(1e-2, fused=True)
    new, st = opt.step(params, grads, opt.init(params))
    for k, v in tree_leaves_by_key(params).items():
        assert tree_leaves_by_key(new)[k] is v
        assert tree_leaves_by_key(st.mu)[k].dtype == torch.float32


def test_bf16_params_keep_dtype_and_float32_moments():
    rng = np.random.default_rng(3)
    jp = {"w": jnp.asarray(rng.standard_normal((8, 16))).astype(jnp.bfloat16)}
    jg = {"w": jnp.asarray(rng.standard_normal((8, 16))).astype(jnp.bfloat16)}
    want, _ = _run_jax(jadam(1e-2), jp, [jg])
    for fused in (False, True):
        got, st = _run_torch(tadam(1e-2, fused=fused),
                             {"w": np.asarray(jp["w"])},
                             [{"w": np.asarray(jg["w"])}])
        assert st.mu["w"].dtype == torch.float32
        # One bf16 ulp: the float32 updates agree to a few float32 ulps
        # and are rounded once to bf16.
        np.testing.assert_allclose(got["w"], np.asarray(want["w"],
                                                        np.float32),
                                   rtol=2 ** -8)
