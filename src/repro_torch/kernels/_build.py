"""Build and load the port's hand-written CUDA kernels.

Each kernel family keeps its sources in ``repro_torch/kernels/<name>/csrc``.
On first use they are compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface under ``build/repro_torch_kernels/``
at the repository root (git-ignored), and loaded with ``ctypes``.  The
library name carries a hash of the sources, so an edited kernel rebuilds
and a stale library is never loaded.  No PyTorch header is included:
a plain C interface builds in seconds.

Every C entry point takes raw device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.  A missing ``nvcc`` or a failed
build raises too: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
FAMILIES = ("agg_adam", "relayout")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source on first use")
    return path


def _sources(name: str) -> List[Path]:
    srcs = sorted((KERNELS_DIR / name / "csrc").glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources for kernel family {name!r}")
    return srcs


def library_path(name: str) -> Path:
    """Where ``name``'s library lives once built (content-addressed)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one family; returns (process, tmp path, final)."""
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):"
                           f"\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build(names: Iterable[str] = FAMILIES) -> Dict[str, str]:
    """Build every named family that is not built yet, one ``nvcc`` per
    family, all started together.  Returns each family's ptxas report
    (registers, shared memory, spills) from its build log."""
    names = list(names)
    with _lock:
        started = {n: _start_build(n) for n in names
                   if not library_path(n).exists()}
        errors = []
        for n, (proc, tmp, out) in started.items():
            try:
                _finish_build(n, proc, tmp, out)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
    logs = {}
    for n in names:
        log = library_path(n).with_suffix(".log")
        logs[n] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The family's loaded library, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
    return lib


def entry(name: str, fn: str, argtypes):
    """One declared C entry point of family ``name`` (built on first use):
    every pointer and the stream are ``c_void_p`` (a Python int passed as
    a plain int would be cut to 32 bits), and every entry returns its
    ``cudaError_t`` as an int."""
    key = f"{name}:{fn}"
    f = _entries.get(key)
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _entries[key] = f
    return f


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError_t {code}")


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float
