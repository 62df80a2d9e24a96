"""The generators: the same seed gives the same inputs, another seed
others; keys distinct and in range; queries held out."""

import numpy as np

from portbench.data import make_dataset, query_order

ARGS = dict(rows=500, dim=16, n_queries=20, key_space=2000, clusters=8)


def test_same_seed_same_data():
    a = make_dataset(2**31 + 12345, **ARGS)
    b = make_dataset(2**31 + 12345, **ARGS)
    assert np.array_equal(a.vectors, b.vectors) and np.array_equal(a.queries, b.queries)
    assert np.array_equal(a.keys, b.keys) and a.uuids == b.uuids
    assert np.array_equal(query_order(7, 20), query_order(7, 20))


def test_other_seed_other_data():
    a = make_dataset(1, **ARGS)
    b = make_dataset(2, **ARGS)
    assert not np.array_equal(a.vectors, b.vectors)
    assert not np.array_equal(a.keys, b.keys)
    assert set(a.uuids).isdisjoint(b.uuids)


def test_shapes_keys_and_held_out_queries():
    d = make_dataset(99, **ARGS)
    assert d.vectors.shape == (500, 16) and d.vectors.dtype == np.float32
    assert d.queries.shape == (20, 16)
    assert len(set(d.keys.tolist())) == 500 and d.keys.min() >= 0 and d.keys.max() < 2000
    assert len(set(d.uuids)) == 500
    # no query is a corpus row
    dist = ((d.queries[:, None, :] - d.vectors[None]) ** 2).sum(-1)
    assert dist.min() > 1e-3
    assert sorted(query_order(99, 20).tolist()) == list(range(20))


def test_a_negative_or_huge_seed_works():
    for s in (-5, 2**63 + 7):
        assert make_dataset(s, **ARGS).vectors.shape == (500, 16)
