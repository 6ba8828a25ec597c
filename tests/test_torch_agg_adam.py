"""The port's multi-job Adam (kernels K1 and K3, plain versions on the CPU)
held against the reference on the same numpy inputs.

Tolerances.  Against the reference's eager CPU paths -- the jnp path its
engine ticks through off-TPU (``ops.multi_job_adam_update_fused``) and
``runtime._adam_math``, the block step's update -- the budget is 1 ulp:
the port keeps their operation grouping exactly, and the one possible
difference is the bias-correction scalar ``1/(1 - b**t)``, whose float32
power XLA computes with an approximation that can sit 1 ulp from the
correctly rounded power the port uses (moving ``bc``, and so p, by at
most 1 ulp).  The Pallas kernels in interpret mode run as one jitted XLA
program, and XLA:CPU contracts ``b1*mu + (1-b1)*g`` into a fused
multiply-add there (tens of ulps where the two terms cancel, below 1e-7
absolute); those, and the jnp oracles in ``ref.py`` (which divide by
``1 - b**t`` and group ``lr`` differently), are held at the reference's
own kernel-vs-oracle tolerance, rtol 2e-5 and atol 2e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.agg_adam import kernel as jkernel
from repro.kernels.agg_adam import ops as jops
from repro.kernels.agg_adam import ref as jref
from repro.ps.runtime import _adam_math
from repro_torch.kernels.agg_adam import ops as tops

ULP_BUDGET = 1


def ulp_diff(a, b) -> int:
    """Largest distance in float32 units in the last place."""
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


def _case(seed, block, job_blocks, n_blocks, workers):
    rng = np.random.default_rng(seed)
    n = block * n_blocks
    perm = rng.permutation(n_blocks)
    bi, off = [], 0
    for nb in job_blocks:
        bi.append(np.sort(perm[off:off + nb]).astype(np.int32))
        off += nb
    block_idx = np.concatenate(bi)
    m = block_idx.size * block
    p = rng.standard_normal(n).astype(np.float32)
    mu = (np.abs(rng.standard_normal(n)) * 0.1).astype(np.float32)
    nu = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    gshape = (workers, m) if workers else (m,)
    g = rng.standard_normal(gshape).astype(np.float32)
    return p, mu, nu, g, block_idx, tuple(int(b.size) for b in bi)


# K jobs with their own lr/b1/b2/eps and step counts from 1 to 10^4,
# one job owning a single block.
HP_CASES = [
    dict(counts=[1], lr=1e-3, b1=0.9, b2=0.999, eps=1e-8),
    dict(counts=[5, 2], lr=(1e-2, 3e-3), b1=(0.9, 0.8), b2=(0.999, 0.99),
         eps=(1e-8, 1e-6)),
    dict(counts=[1, 37, 10_000], lr=(3e-4, 1e-1, 2e-2), b1=(0.9, 0.95, 0.5),
         b2=(0.999, 0.98, 0.9), eps=(1e-8, 1e-7, 1e-3)),
]


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("hp_case", range(len(HP_CASES)))
def test_k1_plain_matches_reference_kernel_and_oracle(hp_case, workers):
    kw = dict(HP_CASES[hp_case])
    counts = kw.pop("counts")
    k = len(counts)
    job_blocks = [3, 1, 4][:k] if k > 1 else [1]
    block = 128
    p, mu, nu, g, block_idx, sizes = _case(hp_case * 10 + workers, block,
                                           job_blocks, 12, workers)
    job_slot = np.repeat(np.arange(k, dtype=np.int32), sizes)

    jcounts = [jnp.int32(c) for c in counts]
    out_e = jops.multi_job_adam_update_fused(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(mu), jnp.asarray(nu),
        jcounts, block_idx=block_idx, job_sizes=sizes, block=block,
        interpret=True, **kw)
    jhp = jops.multi_job_hp(jcounts, **kw)
    out_k = jkernel.aggregate_adam_multijob_fused(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(mu), jnp.asarray(nu), jhp,
        jnp.asarray(block_idx), jnp.asarray(job_slot), block=block,
        interpret=True)
    out_r = jref.aggregate_adam_multijob_fused_ref(
        p, jnp.asarray(g), mu, nu, jcounts, block_idx, sizes, block=block,
        **kw)

    tp, tmu, tnu = (torch.from_numpy(x.copy()) for x in (p, mu, nu))
    out_t = tops.aggregate_adam_multijob_fused(
        tp, torch.from_numpy(g), tmu, tnu, tops.multi_job_hp(counts, **kw),
        torch.from_numpy(block_idx), torch.from_numpy(job_slot), block=block)
    assert out_t[0] is tp  # in place
    for name, t, e, a, b in zip(("p", "mu", "nu"), out_t, out_e, out_k,
                                out_r):
        assert ulp_diff(t.numpy(), np.asarray(e)) <= ULP_BUDGET, name
        for other in (a, b):
            np.testing.assert_allclose(t.numpy(), np.asarray(other),
                                       rtol=2e-5, atol=2e-6, err_msg=name)
    # Non-owned lanes ride through untouched.
    own = (block_idx.astype(np.int64)[:, None] * block
           + np.arange(block)).reshape(-1)
    untouched = np.setdiff1d(np.arange(p.size), own)
    np.testing.assert_array_equal(tp.numpy()[untouched], p[untouched])


@pytest.mark.parametrize("p_packed", [True, False])
@pytest.mark.parametrize("workers", [0, 3])
def test_k3_plain_matches_reference_kernel(p_packed, workers):
    block = 128
    p, mu, nu, g, block_idx, _ = _case(7 + workers, block, [5], 9, workers)
    own = (block_idx.astype(np.int64)[:, None] * block
           + np.arange(block)).reshape(-1)
    p_in = p[own] if p_packed else p
    count, kw = 3, dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8)
    out_k = jkernel.aggregate_adam_blocks(
        jnp.asarray(p_in), jnp.asarray(g), jnp.asarray(mu), jnp.asarray(nu),
        jnp.int32(count), jnp.asarray(block_idx), block=block,
        interpret=True, **kw)
    out_e = _adam_math(jnp.asarray(p[own]), jnp.asarray(g).sum(axis=0)
                       if workers else jnp.asarray(g), jnp.asarray(mu[own]),
                       jnp.asarray(nu[own]), jnp.int32(count), **kw)
    out_t = tops.block_adam_update(
        torch.from_numpy(p_in.copy()), torch.from_numpy(g),
        torch.from_numpy(mu), torch.from_numpy(nu), count,
        block_idx=block_idx, block=block, p_packed=p_packed, **kw)
    for name, t, e, a in zip(("p", "mu", "nu"), out_t, out_e, out_k):
        assert t.shape == (own.size,)
        assert ulp_diff(t.numpy(), np.asarray(e)) <= ULP_BUDGET, name
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=2e-6, err_msg=name)


def test_multi_job_hp_tables_equal():
    """Every column equal, bias corrections included, at the step counts
    the tests and the service reach; beyond them the bias corrections
    stay within 1 ulp (XLA's float32 power is an approximation)."""
    kw = dict(lr=(1e-2, 3e-4, 0.5), b1=(0.9, 0.95, 0.8),
              b2=(0.999, 0.99, 0.98), eps=(1e-8, 1e-7, 1e-6),
              wd=(0.0, 0.01, 0.0))
    for counts in ([1, 2, 3], [10, 20, 50], [100, 200, 400]):
        j = np.asarray(jops.multi_job_hp([jnp.int32(c) for c in counts],
                                         **kw))
        t = tops.multi_job_hp(counts, **kw).numpy()
        np.testing.assert_array_equal(t, j)
    for counts in ([900, 2000, 3000], [5000, 7500, 10_000]):
        j = np.asarray(jops.multi_job_hp([jnp.int32(c) for c in counts],
                                         **kw))
        t = tops.multi_job_hp(counts, **kw).numpy()
        np.testing.assert_array_equal(np.delete(t, [6, 7], axis=1),
                                      np.delete(j, [6, 7], axis=1))
        assert ulp_diff(t[:, 6:8], j[:, 6:8]) <= ULP_BUDGET


def test_kernel_wrappers_check_inputs():
    block = 128
    p, mu, nu, g, block_idx, sizes = _case(0, block, [2], 4, 0)
    hp = tops.multi_job_hp([1], lr=1e-3)
    args = [torch.from_numpy(x.copy()) for x in (p, g, mu, nu)]
    slot = torch.zeros(block_idx.size, dtype=torch.int32)
    with pytest.raises(TypeError):
        tops.aggregate_adam_multijob_fused(
            args[0].double(), *args[1:], hp, torch.from_numpy(block_idx),
            slot, block=block)
    with pytest.raises(ValueError):
        tops.aggregate_adam_multijob_fused(
            *args, hp, torch.from_numpy(block_idx).long(), slot, block=block)
    with pytest.raises(ValueError):
        tops.aggregate_adam_blocks(
            args[0], args[1], args[2], args[3], hp,
            torch.from_numpy(block_idx), block=block, p_packed=True)


def test_scatter_rows_matches_reference():
    block = 16
    rng = np.random.default_rng(4)
    buf = rng.standard_normal(8 * block).astype(np.float32)
    rows = np.array([1, 4, 6], np.int32)
    packed = rng.standard_normal(rows.size * block).astype(np.float32)
    want = jops.scatter_rows(jnp.asarray(buf), jnp.asarray(packed), rows,
                             block)
    t = torch.from_numpy(buf.copy())
    got = tops.scatter_rows(t, torch.from_numpy(packed), rows, block)
    assert got is t
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------- K4: packed multi-job
def _k4_case(hp_case, workers, p_packed, seed=0):
    kw = dict(HP_CASES[hp_case])
    counts = kw.pop("counts")
    k = len(counts)
    block = 128
    p, mu, nu, g, block_idx, sizes = _case(seed + hp_case * 10 + workers,
                                           block, [3, 1, 4][:k], 12, workers)
    own = (block_idx.astype(np.int64)[:, None] * block
           + np.arange(block)).reshape(-1)
    p_in = p[own] if p_packed else p
    return p, p_in, mu, nu, g, block_idx, sizes, counts, kw, block


@pytest.mark.parametrize("p_packed", [False, True])
@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("hp_case", [0, 2])
def test_k4_plain_matches_reference_kernel_and_update(hp_case, workers,
                                                      p_packed):
    """K4's plain version against the reference's Pallas K4 in interpret
    mode (FMA-contracted: rtol 2e-5, atol 2e-6) and against its eager
    ``multi_job_adam_update`` (1 ulp), W = 1 and 2, p full and packed."""
    (_, p_in, mu, nu, g, block_idx, sizes, counts, kw,
     block) = _k4_case(hp_case, workers, p_packed)
    k = len(counts)
    job_slot = np.repeat(np.arange(k, dtype=np.int32), sizes)
    jcounts = [jnp.int32(c) for c in counts]
    out_k = jkernel.aggregate_adam_multijob(
        jnp.asarray(p_in), jnp.asarray(g), jnp.asarray(mu), jnp.asarray(nu),
        jops.multi_job_hp(jcounts, **kw), jnp.asarray(block_idx),
        jnp.asarray(job_slot), block=block, p_packed=p_packed,
        interpret=True)
    out_e = jops.multi_job_adam_update(
        jnp.asarray(p_in), jnp.asarray(g), jnp.asarray(mu), jnp.asarray(nu),
        jcounts, block_idx=block_idx, job_sizes=sizes, block=block,
        p_packed=p_packed, interpret=True, **kw)
    tmu, tnu = torch.from_numpy(mu.copy()), torch.from_numpy(nu.copy())
    out_t = tops.multi_job_adam_update(
        torch.from_numpy(p_in.copy()), torch.from_numpy(g), tmu, tnu, counts,
        block_idx=block_idx, job_sizes=sizes, block=block, p_packed=p_packed,
        **kw)
    for name, t, a, e in zip(("p", "mu", "nu"), out_t, out_k, out_e):
        assert t.shape == (block_idx.size * block,), name
        assert ulp_diff(t.numpy(), np.asarray(e)) <= ULP_BUDGET, name
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=2e-6, err_msg=name)
    # mu/nu are read, never written.
    np.testing.assert_array_equal(tmu.numpy(), mu)
    np.testing.assert_array_equal(tnu.numpy(), nu)


@pytest.mark.parametrize("workers", [0, 2])
def test_k4_then_scatter_equals_k1_bit_for_bit(workers):
    """The contract of ``multi_job_adam_update``: its packed outputs,
    scattered onto their rows, equal the fused tick (K1) bit for bit, for
    a list of per-job gradients and for one concatenated vector."""
    p, _, mu, nu, g, block_idx, sizes, counts, kw, block = _k4_case(
        1, workers, False, seed=40)
    offs = np.cumsum((0,) + sizes) * block
    gs = [torch.from_numpy(g[..., a:b].copy())
          for a, b in zip(offs[:-1], offs[1:])]
    fused = [torch.from_numpy(x.copy()) for x in (p, mu, nu)]
    tops.multi_job_adam_update_fused(
        *fused[:1], gs, *fused[1:], counts, block_idx=block_idx,
        job_sizes=sizes, block=block, **kw)
    for grads in (gs, torch.from_numpy(g)):
        packed = tops.multi_job_adam_update(
            torch.from_numpy(p), grads, torch.from_numpy(mu),
            torch.from_numpy(nu), counts, block_idx=block_idx,
            job_sizes=sizes, block=block, **kw)
        for name, full, new, want in zip(("p", "mu", "nu"), (p, mu, nu),
                                         packed, fused):
            got = tops.scatter_rows(torch.from_numpy(full.copy()), new,
                                    block_idx, block)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), name


def test_k4_wrappers_check_inputs_and_never_infer_the_layout():
    block = 128
    # Two jobs own every block: M == N, so only the flag tells the layouts
    # apart, and the two give different updates.
    p, mu, nu, g, block_idx, sizes = _case(3, block, [2, 2], 4, 0)
    args = [torch.from_numpy(x.copy()) for x in (p, g, mu, nu)]
    kw = dict(block_idx=block_idx, job_sizes=sizes, block=block, lr=1e-2)
    full = tops.multi_job_adam_update(args[0], args[1], args[2], args[3],
                                      [1, 2], **kw)
    packed = tops.multi_job_adam_update(args[0], args[1], args[2], args[3],
                                        [1, 2], p_packed=True, **kw)
    assert not torch.equal(full[0], packed[0])
    with pytest.raises(ValueError, match="sum to"):
        tops.multi_job_adam_update(*args, [1, 2], **{**kw,
                                                     "job_sizes": (2, 1)})
    with pytest.raises(ValueError, match="counts"):
        tops.multi_job_adam_update(*args, [1], **kw)
    hp = tops.multi_job_hp([1, 2], lr=1e-3)
    bi = torch.from_numpy(block_idx)
    slot = torch.zeros(block_idx.size, dtype=torch.int32)
    with pytest.raises(TypeError):
        tops.aggregate_adam_multijob(args[0].double(), args[1], args[2],
                                     args[3], hp, bi, slot, block=block,
                                     p_packed=False)
    with pytest.raises(ValueError, match="job_slot"):
        tops.aggregate_adam_multijob(*args, hp, bi, slot.long(), block=block,
                                     p_packed=False)
    with pytest.raises(ValueError, match="packed"):
        tops.aggregate_adam_multijob(args[0][:-1], *args[1:], hp, bi, slot,
                                     block=block, p_packed=True)
    assert tops.aggregate_adam_multijob.launches == 0  # CPU: plain version
