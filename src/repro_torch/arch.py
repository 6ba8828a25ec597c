"""ArchSpec (``repro.arch``): a uniform description of (architecture x
input-shape) cells.

Every architecture module under ``repro_torch.configs`` exposes ``spec()
-> ArchSpec``.  The mesh layer's cells (``launch/cells.py``) and the
dry-run (``launch/dryrun.py``) consume only this interface.  The cells'
batches, sequence lengths and overrides are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class ShapeCell:
    """One (arch x shape) cell.

    kind: 'train' | 'prefill' | 'decode' | 'forward' | 'retrieval'
    model_overrides: dataclasses.replace kwargs applied to the model config
    for this cell (dtype, attention chunking, remat, ...).
    run_overrides: runner knobs (n_microbatches, cache length, ...).
    """

    name: str
    kind: str
    batch: int = 0
    seq: int = 0
    extras: Dict[str, Any] = field(default_factory=dict)
    model_overrides: Dict[str, Any] = field(default_factory=dict)
    run_overrides: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # 'lm' | 'gnn' | 'recsys'
    model: Any  # base model config (LMConfig / GINConfig / DLRMConfig ...)
    cells: Dict[str, ShapeCell]
    recsys_kind: str = ""  # 'dlrm' | 'sasrec' | 'dien' for family == 'recsys'
    notes: str = ""

    def cell(self, name: str) -> ShapeCell:
        if name not in self.cells:
            raise KeyError(f"{self.arch_id} has no shape {name!r}; has "
                           f"{sorted(self.cells)}")
        return self.cells[name]


# Standard LM shape set: seq_len x global_batch.
def lm_cells(
    train_microbatches: int = 1,
    prefill_chunk: int = 1024,
    train_overrides: Optional[Dict[str, Any]] = None,
) -> Dict[str, ShapeCell]:
    # Chunked (online-softmax) attention in training keeps the S x S
    # scores out of device memory; 512-wide KV chunks.
    t_over = {"dtype": "bfloat16", "attn_chunk_k": 512, "moe_groups": 256,
              **(train_overrides or {})}
    return {
        "train_4k": ShapeCell(
            "train_4k", "train", batch=256, seq=4096,
            model_overrides=t_over,
            run_overrides={"n_microbatches": train_microbatches},
        ),
        "prefill_32k": ShapeCell(
            "prefill_32k", "prefill", batch=32, seq=32768,
            model_overrides={"dtype": "bfloat16",
                             "attn_chunk_k": prefill_chunk,
                             "max_seq_len": 32768, "moe_groups": 256},
        ),
        "decode_32k": ShapeCell(
            "decode_32k", "decode", batch=128, seq=32768,
            model_overrides={"dtype": "bfloat16", "max_seq_len": 32768,
                             "moe_groups": 128},
        ),
        "long_500k": ShapeCell(
            "long_500k", "decode", batch=1, seq=524288,
            model_overrides={"dtype": "bfloat16", "max_seq_len": 524288},
        ),
    }
