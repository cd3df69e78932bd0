"""The traffic generator: the genome mix's calls and the training table,
deterministic per seed."""

import numpy as np
import pytest

from benchmark import spec, traffic

GENOME = spec.traffic("genome")
TABLE = spec.traffic("train-epochs")


def test_genome_call_sizes():
    sizes = traffic.call_sizes(GENOME)
    assert len(sizes) == 24
    assert [n for n, _ in sizes][:2] == ["chr1", "chr2"]
    counts = [n for _, n in sizes]
    assert sum(counts) == pytest.approx(366_808, rel=2e-3)
    assert min(counts) == 5_547 and max(counts) == 29_567


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 2**40 + 3])
def test_genome_deterministic_per_seed(seed):
    a = traffic.calls(GENOME, seed)
    b = traffic.calls(GENOME, seed)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert np.array_equal(x, y)
    assert [len(s) for _, s in a] == [n for _, n in
                                      traffic.call_sizes(GENOME)]


def test_seeds_draw_other_specs_of_the_same_sizes():
    a = traffic.calls(GENOME, 1)
    b = traffic.calls(GENOME, 2)
    assert [len(s) for _, s in a] == [len(s) for _, s in b]
    assert not np.array_equal(a[0][1], b[0][1])


def test_specs_are_well_formed():
    specs = traffic.calls(GENOME, 5)[0][1]
    assert specs.shape[1] == 12 and specs.dtype == np.int64
    assert (specs[:, 3] > specs[:, 2]).all() and (specs[:, 8] > specs[:, 7]).all()
    assert set(np.unique(specs[:, 9])) <= {0, 1} and (specs[:, 4] == 1).all()


def test_training_table():
    specs, labels = traffic.table(TABLE, 9)
    assert specs.shape == (65_536, 12)
    assert np.array_equal(labels, np.arange(65_536) % 5)
    again, _ = traffic.table(TABLE, 9)
    assert np.array_equal(specs, again)
    assert TABLE["rows"] // TABLE["batch"] == 1024


def test_torch_seed_range():
    for seed in (0, 1, 2**31 + 1, 2**63):
        s = traffic.torch_seed(seed, "weights")
        assert 0 <= s < 2**63
    assert traffic.torch_seed(3, "a") != traffic.torch_seed(3, "b")
