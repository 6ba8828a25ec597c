"""Architecture registry (``repro.configs.registry``): --arch <id> ->
config constructors.

Every arch id of the reference is listed and ported.  Each arch module
exposes ``config()`` (the published dims), ``smoke_config()`` (a
reduced config of the same family for CPU tests) and ``spec()`` (its
``ArchSpec``: the reference's cells); ``gin_tu`` also its four
``GRAPH_SHAPES`` and ``model_for_shape``.  Modules are imported
lazily.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List

# arch id -> module name under repro_torch.configs (the reference's names)
ARCHS: Dict[str, str] = {
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "granite-8b": "granite_8b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "gin-tu": "gin_tu",
    "dlrm-rm2": "dlrm_rm2",
    "sasrec": "sasrec",
    "dien": "dien",
    "dlrm-mlperf": "dlrm_mlperf",
}
FAMILIES: Dict[str, str] = {
    "command-r-plus-104b": "lm", "qwen1.5-0.5b": "lm", "granite-8b": "lm",
    "granite-moe-1b-a400m": "lm", "deepseek-v2-236b": "lm", "gin-tu": "gnn",
    "dlrm-rm2": "recsys", "sasrec": "recsys", "dien": "recsys",
    "dlrm-mlperf": "recsys",
}
PORTED = frozenset(ARCHS)  # every arch of the reference


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def family(arch: str) -> str:
    if arch not in FAMILIES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return FAMILIES[arch]


def get_config(arch: str) -> Any:
    return _module(arch).config()


def get_smoke_config(arch: str) -> Any:
    return _module(arch).smoke_config()


def spec(arch: str) -> Any:
    """The arch's ``ArchSpec`` (``repro_torch.arch``)."""
    return _module(arch).spec()


def list_archs() -> List[str]:
    return sorted(ARCHS)
