"""The port's ``ArchSpec``s (``repro_torch.arch``, every config's
``spec()`` and ``registry.spec``) against the reference's, field by
field: ids, families, notes, every cell's name, kind, batch, sequence,
extras and overrides, and the model config's every field (nested MoE and
MLA configs included).  Exact equality throughout."""

import dataclasses

import pytest

from repro import arch as jarch
from repro.configs import registry as jreg
from repro_torch import arch as tarch
from repro_torch.configs import registry as treg


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_spec_equals_reference_field_by_field(arch):
    want = jreg._module(arch).spec()
    got = treg.spec(arch)
    assert isinstance(got, tarch.ArchSpec)
    for f in ("arch_id", "family", "recsys_kind", "notes"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.family == treg.family(arch)
    assert _fields(got.model) == _fields(want.model)
    assert list(got.cells) == list(want.cells)
    for name, cell in want.cells.items():
        assert isinstance(got.cells[name], tarch.ShapeCell)
        assert dataclasses.asdict(got.cells[name]) == \
            dataclasses.asdict(cell), name
        assert got.cell(name) is got.cells[name]


def test_lm_cells_and_unknown_shape():
    assert {k: dataclasses.asdict(v) for k, v in tarch.lm_cells(
        4, 2048, {"remat": False}).items()} == {
        k: dataclasses.asdict(v) for k, v in jarch.lm_cells(
            4, 2048, {"remat": False}).items()}
    with pytest.raises(KeyError, match="no shape"):
        treg.spec("qwen1.5-0.5b").cell("train_8k")
