"""The port stands alone: every ``repro_torch`` module imports with ``jax``
blocked, and neither the package, ``chip_smoke.py`` nor the port's
examples (``examples/torch_*.py``) import anything of the JAX package
``repro``."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
IMPORT_REPRO = re.compile(r"^\s*(from|import)\s+repro(\.|\s|$)", re.M)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    mods = list(_modules())
    for m in ("repro_torch.ps.service_runtime", "repro_torch.ps.compression",
              "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
              "repro_torch.sim", "repro_torch.sim.trace",
              "repro_torch.sim.simulator", "repro_torch.sim.replay",
              "repro_torch.core.cyclic", "repro_torch.core.ip_model",
              "repro_torch.core.profiler", "repro_torch.models.gnn",
              "repro_torch.data.graph_sampler", "repro_torch.optim.sgd",
              "repro_torch.configs.gin_tu", "repro_torch.arch",
              "repro_torch.launch.mesh", "repro_torch.launch.cells",
              "repro_torch.launch.op_cost", "repro_torch.launch.dryrun",
              "repro_torch.ps.sharding", "repro_torch.ps.act_sharding"):
        assert m in mods
    code = ("import sys\nsys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            + "".join(f"import {m}\n" for m in mods)
            + "assert not any(k == 'jax' or k.startswith('jax.') "
              "for k, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_source_imports_the_reference_package():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 4
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert (ROOT / "chip_smoke.py").exists()
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if IMPORT_REPRO.search(f.read_text())
                 or re.search(r"^\s*(from|import)\s+jax\b", f.read_text(),
                              re.M)]
    assert not offenders, offenders
