"""The port's MoE FFN (``repro_torch.models.moe``) held against the
reference's ``repro.models.moe`` on the same numpy inputs and the
reference's weights, carried across bit for bit with ``tree_from_numpy``,
in float32 on the CPU.

Tolerances.  Routing is held exactly: the top-k expert ids, the slot
ranks and so the set of dropped (token, choice) pairs.  The router's
gates, its load-balance loss and its z-loss come from one float32 product,
a softmax and a log-sum-exp, which XLA and PyTorch sum in different
orders: rtol 1e-6 (a few float32 ulps).  The FFN's output: rtol 1e-5
with atol 1e-6 x its largest magnitude; its gradients (input, router,
experts, shared experts): the dense LM's bound, rtol 1e-4 with atol 1e-6
x the leaf's largest magnitude (``tests/test_torch_transformer.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from repro_torch.ps import runtime as truntime
from repro_torch.tree import tree_leaves_by_key, value_and_grad

E, K, D, F_FF = 8, 2, 16, 24


def _cfgs(cf=1.25, shared=False):
    kw = dict(n_experts=E, top_k=K, d_ff=F_FF, capacity_factor=cf)
    if shared:
        kw.update(n_shared=2, d_ff_shared=2 * F_FF)
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _weights(jcfg, seed=0):
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), D, jcfg)
    return jp, truntime.tree_from_numpy(jp, "cpu")


def _x(t, seed=1):
    x = np.random.default_rng(seed).standard_normal((t, D)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("shape", [(64,), (3, 48), (1, 1)])
def test_expert_positions_match_reference_exactly(shape):
    rng = np.random.default_rng(sum(shape))
    eid = rng.integers(0, E, shape, dtype=np.int32)
    if len(shape) == 1:
        want = np.asarray(jmoe.expert_positions(jnp.asarray(eid), E))
    else:  # the grouped call: one row per group, as moe_ffn vmaps it
        want = np.asarray(jax.vmap(lambda r: jmoe.expert_positions(r, E))(
            jnp.asarray(eid)))
    got = tmoe.expert_positions(torch.from_numpy(eid), E)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a rank is the count of earlier slots of the same expert
    flat_e, flat_r = eid.reshape(-1, shape[-1]), got.numpy().reshape(
        -1, shape[-1])
    for row_e, row_r in zip(flat_e, flat_r):
        for i in range(row_e.size):
            assert row_r[i] == int((row_e[:i] == row_e[i]).sum())


@pytest.mark.parametrize("normalize", [True, False])
def test_route_matches_reference(normalize):
    jcfg, tcfg = (type(c)(**{**c.__dict__, "normalize_gates": normalize})
                  for c in _cfgs())
    jp, tp = _weights(jcfg)
    jx, tx = _x(96)
    jg, ji, ja, jz = jmoe.route(jx, jp["router"], jcfg)
    tg, ti, ta, tz = tmoe.route(tx, tp["router"], tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    np.testing.assert_allclose(float(tz), float(jz), rtol=1e-6)
    assert tg.dtype == torch.float32


def _close(got, want, rtol, atol_frac, what):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol_frac * scale, err_msg=what)


# (n_groups, capacity factor, shared experts): 0.5 drops tokens, E / K
# (a capacity of every token of the group) drops none; 5 groups do not
# divide T = 96, so one group is used.
CASES = [(1, 0.5, False), (1, E / K, False), (2, 0.5, True),
         (2, E / K, True), (5, 1.25, True)]


@pytest.mark.parametrize("n_groups,cf,shared", CASES)
def test_moe_ffn_forward_and_gradients_match_reference(n_groups, cf,
                                                       shared):
    jcfg, tcfg = _cfgs(cf, shared)
    jp, tp = _weights(jcfg, seed=n_groups)
    t = 96
    jx, tx = _x(t, seed=7 + n_groups)
    r = np.random.default_rng(3).standard_normal((t, D)).astype(np.float32)

    # the dropped (token, choice) pairs: equal in both, and present (or
    # absent) as the capacity factor says
    g = n_groups if t % n_groups == 0 else 1
    tg_ = t // g
    cap = max(1, int(cf * tg_ * K / E))
    _, ji, _, _ = jmoe.route(jx, jp["router"], jcfg)
    _, ti, _, _ = tmoe.route(tx, tp["router"], tcfg)
    jpos = np.asarray(jax.vmap(lambda e: jmoe.expert_positions(e, E))(
        ji.reshape(g, tg_ * K)))
    tpos = tmoe.expert_positions(ti.reshape(g, tg_ * K), E).numpy()
    np.testing.assert_array_equal(tpos, jpos)
    dropped = tpos >= cap
    assert dropped.any() == (cf < E / K)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(x, p, jcfg, n_groups=n_groups)
        return jnp.sum(y * r) + aux, (y, aux)

    def tloss(p, x):
        y, aux = tmoe.moe_ffn(x, p, tcfg, n_groups=n_groups)
        return torch.sum(y * torch.from_numpy(r)) + aux

    (jl, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jx)
    ty, taux = tmoe.moe_ffn(tx, tp, tcfg, n_groups=n_groups)
    _close(ty.numpy(), jy, 1e-5, 1e-6, "y")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert ty.dtype == torch.float32 and ty.shape == (t, D)

    tl, tgrads = value_and_grad(
        lambda tree, _: tloss(tree["p"], tree["x"]))({"p": tp, "x": tx},
                                                     None)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    tg = tree_leaves_by_key(tgrads)
    _close(tg["x"].numpy(), jgx, 1e-4, 1e-6, "dx")
    for key, want in jgp.items():
        _close(tg[f"p/{key}"].numpy(), want, 1e-4, 1e-6, key)
    assert set(tg) == {"x"} | {f"p/{k}" for k in jgp}


def test_moe_ffn_bf16_buffer_keeps_dtype_and_drops_overflow():
    """bf16 tokens stay bf16 through dispatch and combine; a token whose
    every choice overflows gets only the shared experts' output (zero
    here: no shared experts)."""
    _, tcfg = _cfgs(0.25)
    gen = torch.Generator()
    gen.manual_seed(0)
    p = tmoe.init_moe_params(
        lambda shape, s, dt: (s * torch.randn(shape, generator=gen)).to(dt),
        D, tcfg, torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].dtype == torch.bfloat16
    x = torch.randn(64, D, generator=gen).to(torch.bfloat16)
    y, aux = tmoe.moe_ffn(x, p, tcfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _, idx, _, _ = tmoe.route(x, p["router"], tcfg)
    pos = tmoe.expert_positions(idx.reshape(1, -1), E).reshape(64, K)
    cap = max(1, int(0.25 * 64 * K / E))
    all_dropped = (pos >= cap).all(-1)
    assert all_dropped.any()
    assert not y[all_dropped].any()
