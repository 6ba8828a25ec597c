"""Architecture registry (``repro.configs.registry``): --arch <id> ->
config constructors.

Every arch id of the reference is listed.  Each ported arch module exposes
``config()`` (the published dims) and ``smoke_config()`` (a reduced config
of the same family for CPU tests); the others raise NotImplementedError
naming the ROADMAP item that ports them.  Modules are imported lazily.
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
PORTED = frozenset({"command-r-plus-104b", "qwen1.5-0.5b", "granite-8b",
                    "granite-moe-1b-a400m", "deepseek-v2-236b", "dlrm-rm2",
                    "sasrec", "dien", "dlrm-mlperf"})


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} ({FAMILIES[arch]}) is not ported yet "
            f"(ROADMAP.md, Queue 1 item 15, part 4)")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def family(arch: str) -> str:
    if arch not in FAMILIES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return FAMILIES[arch]


def get_config(arch: str) -> Any:
    return _module(arch).config()


def get_smoke_config(arch: str) -> Any:
    return _module(arch).smoke_config()


def list_archs() -> List[str]:
    return sorted(ARCHS)
