"""Which package is off where the LM family's float32 gradients differ.

``tests/test_torch_lm_family.py`` holds the port's float32 gradients
against the reference's at an atol of 2e-6 x a leaf's largest magnitude.
Here the same weights and batch go through both packages again in
float64, the float64 value standing for the exact one: the two packages'
float64 gradients must agree to 1e-12 x the leaf's largest magnitude (the
same function), and each float32 gradient of the port must lie no
farther from the float64 value than twice the reference's float32
gradient does, plus 1e-7 x that magnitude (rounding on both sides, none
of it the port's alone).

Neither package computes a model in float64 on its own: the float64 run
is a subprocess (this file run as a script) in which ``jnp.float32``,
``torch.float32`` and ``Tensor.float`` stand for float64 before either
package is imported, with x64 enabled in jax.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ARCHS = ["granite-8b", "command-r-plus-104b", "granite-moe-1b-a400m",
         "deepseek-v2-236b"]


def _grads(arch, weights=None):
    """Both packages' loss and gradients of ``arch``'s smoke config on the
    batch of ``test_torch_lm_family`` (seed 0, 2 x 32): the reference's
    seed-0 weights, or ``weights`` (leaf key -> array) in their place.
    Returns (weights, jax loss, torch loss, jax grads, torch grads)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import registry as jregistry
    from repro.data import lm_batch
    from repro.models import transformer as jtf
    from repro.ps import runtime as jruntime
    from repro_torch.configs import registry
    from repro_torch.models import transformer as ttf
    from repro_torch.ps import runtime as truntime
    from repro_torch.tree import tree_leaves_by_key, value_and_grad

    jcfg = jregistry.get_smoke_config(arch)
    tcfg = registry.get_smoke_config(arch)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    flat, tdef = jax.tree_util.tree_flatten_with_path(jparams)
    if weights is not None:
        jparams = jax.tree_util.tree_unflatten(tdef, [
            jnp.asarray(weights[jruntime._leaf_key(p)]) for p, _ in flat])
        flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tparams = truntime.tree_from_numpy(jparams, "cpu")
    b = lm_batch(np.random.default_rng(0), 2, 32, jcfg.vocab)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(jcfg, p, b)))(
            jparams, {k: jnp.asarray(v) for k, v in b.items()})
    tloss, tg = value_and_grad(lambda p, b: ttf.loss_fn(tcfg, p, b))(
        tparams, {k: torch.from_numpy(v) for k, v in b.items()})
    w = {jruntime._leaf_key(p): np.asarray(v) for p, v in flat}
    jgrads = {jruntime._leaf_key(p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(jg)[0]}
    tgrads = {k: v.detach().numpy() for k, v in
              tree_leaves_by_key(tg).items()}
    return w, float(jloss), float(tloss), jgrads, tgrads


def _float64_run(arch, weights_npz, out_npz):
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    jnp.float32 = jnp.float64
    torch.float32 = torch.float64
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda self, *a, **k: self.double()
    w = {k: v.astype(np.float64) for k, v in np.load(weights_npz).items()}
    _, jloss, tloss, jg, tg = _grads(arch, w)
    if any(v.dtype != np.float64 for v in (*jg.values(), *tg.values())):
        raise SystemExit("a gradient is not float64")
    np.savez(out_npz, **{"J:" + k: v for k, v in jg.items()},
             **{"T:" + k: v for k, v in tg.items()},
             loss=np.array([jloss, tloss]))


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_gradient_differences_are_rounding(arch, tmp_path):
    w, _, _, j32, t32 = _grads(arch)
    assert all(v.dtype == np.float32 for v in t32.values())
    np.savez(tmp_path / "w.npz", **w)
    subprocess.run([sys.executable, str(Path(__file__).resolve()), arch,
                    str(tmp_path / "w.npz"), str(tmp_path / "g.npz")],
                   check=True, timeout=600)
    g = np.load(tmp_path / "g.npz")
    jloss, tloss = g["loss"]
    assert abs(tloss - jloss) <= 1e-12 * abs(jloss)
    for k in j32:
        x64, t64 = g["J:" + k], g["T:" + k]
        scale = float(np.abs(x64).max()) or 1.0
        assert np.abs(t64 - x64).max() <= 1e-12 * scale, k
        port = np.abs(t32[k] - x64).max()
        ref = np.abs(j32[k] - x64).max()
        assert port <= 2 * ref + 1e-7 * scale, (k, port / scale,
                                                ref / scale)


if __name__ == "__main__":
    _float64_run(*sys.argv[1:4])
