"""The port's cells (``repro_torch.launch.cells.build_cell``) against the
reference's on the production single-pod mesh (16 x 16), for every
(arch, shape): every argument leaf's shape and dtype, its spec, the
donated arguments and the model flops per step, exactly.

The reference builds its cells over 256 XLA host devices in a child
process (``--xla_force_host_platform_device_count=512``, as its dry-run
does); the port's rules read only the mesh's axes, so its cells build on
a shape-only mesh here.  The optimizer's step count and the cache's
length are int32 scalars there and host ints here: the only leaves not
compared."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import registry as jreg
from repro_torch.launch import cells as tcells
from repro_torch.launch.mesh import make_abstract_mesh

ROOT = Path(__file__).resolve().parents[1]
ALL = [(a, s) for a in sorted(jreg.ARCHS)
       for s in jreg._module(a).spec().cells]
# the optimizer's step count and the cache's length, by leaf key
HOST_SCALARS = {"/".join(k) for k in (("0", "opt", "count"),
                                       ("1", "length"))}


def _key(path):
    out = []
    for p in path:
        for attr in ("key", "idx", "name"):
            if hasattr(p, attr):
                out.append(str(getattr(p, attr)))
                break
    return "/".join(out)


def _spec_json(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def _reference(out, arch):
    import jax
    from repro.launch.cells import build_cell
    from repro.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    res = {}
    for shape in jreg._module(arch).spec().cells:
        cell = build_cell(arch, shape, mesh)
        args, specs = {}, {}
        for i, (a, s) in enumerate(zip(cell.args, cell.in_shardings)):
            for p, x in jax.tree_util.tree_flatten_with_path(a)[0]:
                args[f"{i}/{_key(p)}".rstrip("/")] = [list(x.shape),
                                                      str(x.dtype)]
            for p, x in jax.tree_util.tree_flatten_with_path(s)[0]:
                specs[f"{i}/{_key(p)}".rstrip("/")] = _spec_json(tuple(x.spec))
        res[f"{arch}__{shape}"] = {
            "args": args, "specs": specs,
            "donate": list(cell.donate_argnums),
            "flops": cell.model_flops_per_step}
    Path(out).write_text(json.dumps(res))


def _port_leaves(tree, path=""):
    """{key: leaf} with NamedTuple fields by name, as JAX names them."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_leaves(tree[k], f"{path}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_port_leaves(getattr(tree, f), f"{path}/{f}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, f"{path}/{i}"))
        return out
    return {path.lstrip("/"): tree}


def _port_specs(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_specs(tree[k], f"{path}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_port_specs(getattr(tree, f), f"{path}/{f}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_specs(v, f"{path}/{i}"))
        return out
    return {path.lstrip("/"): _spec_json(tree)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One child per arch, all at once (the LM cells' parameter counts
    trace the full models several times over)."""
    d = tmp_path_factory.mktemp("cells")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               str(d / f"{a}.json"), a], env=env)
             for a in sorted(jreg.ARCHS)]
    for p in procs:
        assert p.wait(timeout=600) == 0
    res = {}
    for a in sorted(jreg.ARCHS):
        res.update(json.loads((d / f"{a}.json").read_text()))
    return res


@pytest.mark.parametrize("arch,shape", ALL)
def test_cell_equals_reference(reference, arch, shape):
    want = reference[f"{arch}__{shape}"]
    cell = tcells.build_cell(arch, shape,
                             make_abstract_mesh((16, 16), ("data", "model")))
    assert (cell.arch, cell.shape) == (arch, shape)
    assert list(cell.donate_argnums) == want["donate"]
    assert cell.model_flops_per_step == want["flops"]
    args, specs = {}, {}
    for i, (a, s) in enumerate(zip(cell.args, cell.in_shardings)):
        for k, x in _port_leaves(a).items():
            if isinstance(x, torch.Tensor):
                args[f"{i}/{k}".rstrip("/")] = [
                    list(x.shape), str(x.dtype).replace("torch.", "")]
        for k, v in _port_specs(s).items():
            specs[f"{i}/{k}".rstrip("/")] = v
    want_args = {k: v for k, v in want["args"].items()
                 if k not in HOST_SCALARS}
    want_specs = {k: v for k, v in want["specs"].items()
                  if k not in HOST_SCALARS}
    assert args == want_args
    specs = {k: v for k, v in specs.items() if k not in HOST_SCALARS}
    assert specs == want_specs
    assert all(x.device.type == "meta" for a in cell.args
               for x in _port_leaves(a).values()
               if isinstance(x, torch.Tensor))


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
