"""What the benchmark may import: never JAX or the JAX package ``repro``
(top-level names compared whole, so ``repro_torch`` passes), never the
repository's older measuring scripts, and in ``psbench/reference`` nothing
of the program either."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "psbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "chip_smoke", "scripts",
             "benchmarks"}


def _imports(path: Path):
    """Top-level names of every absolute import in ``path``, and the
    modules of this package its relative imports reach."""
    names, local = set(), set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            else:
                base = path.parent
                for _ in range(node.level - 1):
                    base = base.parent
                parts = node.module.split(".") if node.module else []
                target = base.joinpath(*parts)
                for a in node.names:
                    local.add(target / a.name)
                local.add(target)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names, local


def _sources():
    return [p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts]


def test_nothing_in_the_benchmark_imports_jax_or_the_jax_package():
    offenders = {}
    for path in _sources():
        bad = _imports(path)[0] & FORBIDDEN
        if bad:
            offenders[str(path.relative_to(ROOT))] = sorted(bad)
    assert not offenders, offenders


def _closure(start):
    """Every file of this package that ``start``'s imports reach."""
    seen, todo = set(), list(start)
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for target in _imports(path)[1]:
            for cand in (target.with_suffix(".py"), target / "__init__.py"):
                if cand.is_file():
                    todo.append(cand)
    return seen


def test_the_reference_imports_nothing_of_the_program():
    files = _closure(list((PKG / "reference").glob("*.py")))
    assert any(f.parent.name == "reference" for f in files)
    offenders = {str(f.relative_to(ROOT)): sorted(_imports(f)[0] & {
        "repro_torch", "repro", "jax"}) for f in files}
    assert not any(offenders.values()), offenders


def test_the_harness_imports_with_jax_and_the_jax_package_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import psbench.harness, psbench.service_fleet, psbench.trace\n"
            "import psbench.lm_job, psbench.reference.service\n"
            "import psbench.reference.lm, psbench.yardstick\n"
            "import repro_torch.ps.service_runtime\n"
            "from psbench import harness\n"
            "assert harness.forbidden_modules() == []\n"
            "sys.modules['repro'] = sys\n"
            "assert harness.forbidden_modules() == ['repro']\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
