"""The port's graph data (``repro_torch.data``: ``random_graph``,
``molecule_batch``, ``build_csr`` and ``NeighborSampler``) against the
reference's: numpy on both sides, so every array is compared exactly,
for the same ``numpy.random.Generator`` seeds."""

import dataclasses

import numpy as np
import pytest

from repro import data as jdata
from repro_torch import data as tdata


def _equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("power_law", [True, False])
def test_random_graph_equals_reference(power_law):
    args = (500, 4000, 12, 5)
    _equal(tdata.random_graph(np.random.default_rng(3), *args,
                              power_law=power_law),
           jdata.random_graph(np.random.default_rng(3), *args,
                              power_law=power_law))


def test_molecule_batch_equals_reference():
    args = (128, 30, 64, 7, 2)
    _equal(tdata.molecule_batch(np.random.default_rng(4), *args),
           jdata.molecule_batch(np.random.default_rng(4), *args))


def _graph(seed, n=600, e=6000):
    return jdata.random_graph(np.random.default_rng(seed), n, e, 6, 3)


def test_build_csr_equals_reference():
    g = _graph(0)
    for a, b in zip(tdata.build_csr(g["edge_src"], g["edge_dst"], 600),
                    jdata.build_csr(g["edge_src"], g["edge_dst"], 600)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("fanouts", [(5, 3), (15, 10)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampled_blocks_and_batches_equal_reference(seed, fanouts):
    """Three blocks in a row from one sampler (its rng's sequence of
    ``choice`` calls is the contract), each block and its batch."""
    g = _graph(seed)
    mk = dict(n_nodes=600, fanouts=fanouts, seed=seed)
    ts = tdata.NeighborSampler(g["edge_src"], g["edge_dst"], **mk)
    js = jdata.NeighborSampler(g["edge_src"], g["edge_dst"], **mk)
    assert ts.max_sizes(32) == js.max_sizes(32)
    seeds = np.random.default_rng(seed + 10).permutation(600)
    for i in range(3):
        batch_seeds = seeds[i * 32:(i + 1) * 32]
        tb, jb = ts.sample(batch_seeds), js.sample(batch_seeds)
        _equal(dataclasses.asdict(tb), dataclasses.asdict(jb))
        assert tb.n_active > tb.seed_count == 32
        _equal(ts.make_batch(tb, g["feats"], g["labels"]),
               js.make_batch(jb, g["feats"], g["labels"]))
