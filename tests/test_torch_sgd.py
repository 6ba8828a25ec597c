"""The port's SGD (``repro_torch.optim.sgd``) against the reference's
(``repro.optim.sgd``): plain, with momentum and with weight decay, in
float32 and bfloat16 (a bf16 leaf and a float32 one in the same tree),
three steps on the same numpy parameters and gradients.  Both packages
run each operation of the reference's grouping eagerly, correctly
rounded in the leaf's format, so the tolerance is 0: bit for bit."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import sgd as jsgd
from repro_torch.optim import sgd as tsgd
from repro_torch.tree import array_to_tensor, tree_leaves_by_key

SETTINGS = {"plain": {}, "momentum": {"momentum": 0.9},
            "weight_decay": {"weight_decay": 0.01},
            "both": {"momentum": 0.9, "weight_decay": 0.01}}


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _tbits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_three_steps_equal_reference(setting, dtype):
    rng = np.random.default_rng(0)
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16

    def arr(*shape, dt=npdt):
        return rng.standard_normal(shape).astype(np.float32).astype(dt)

    params = {"w": arr(17, 5), "layers": [{"b": arr(5)},
                                          {"eps": arr(dt=np.float32)}]}
    grads = [{"w": arr(17, 5), "layers": [{"b": arr(5)},
                                          {"eps": arr(dt=np.float32)}]}
             for _ in range(3)]
    jopt, topt = jsgd(0.1, **SETTINGS[setting]), tsgd(0.1, **SETTINGS[setting])
    jp = {"w": jnp.asarray(params["w"]),
          "layers": [{k: jnp.asarray(v) for k, v in d.items()}
                     for d in params["layers"]]}
    tp = {"w": array_to_tensor(params["w"]),
          "layers": [{k: array_to_tensor(v) for k, v in d.items()}
                     for d in params["layers"]]}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jg = {"w": jnp.asarray(g["w"]),
              "layers": [{k: jnp.asarray(v) for k, v in d.items()}
                         for d in g["layers"]]}
        tg = {"w": array_to_tensor(g["w"]),
              "layers": [{k: array_to_tensor(v) for k, v in d.items()}
                         for d in g["layers"]]}
        jp, js = jopt.step(jp, jg, js)
        tp, ts = topt.step(tp, tg, ts)
    assert ts.count == int(js.count) == 3
    got, want = tree_leaves_by_key(tp), tree_leaves_by_key(jp)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 or dtype == "bfloat16"
        np.testing.assert_array_equal(_tbits(got[k]), _bits(want[k]),
                                      err_msg=k)
    if "momentum" in SETTINGS[setting]:
        gm, wm = (tree_leaves_by_key(ts.momentum),
                  tree_leaves_by_key(js.momentum))
        for k in wm:
            np.testing.assert_array_equal(_tbits(gm[k]), _bits(wm[k]),
                                          err_msg=k)
    else:
        assert ts.momentum is None and js.momentum is None
