"""The plain reference against NumPy at a tiny size, and the judge:
sound answers pass, wrong ones fail, the TF32 control fails."""

import numpy as np
import pytest

from portbench.data import make_dataset
from portbench.reference import (Answer, allowed_rows, control_topk,
                                 exact_topk, judge)

K = 10


@pytest.fixture(scope="module")
def ds():
    return make_dataset(4242, rows=600, dim=24, n_queries=16, key_space=2400, clusters=6)


def _numpy_topk(ds, allow, k):
    x = ds.vectors.astype(np.float64)
    q = ds.queries.astype(np.float64)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d = 1.0 - q @ x.T
    d[:, ~allow] = np.inf
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, 1), idx


@pytest.mark.parametrize("flt", [None, {"property": "key", "operator": "GreaterThanEqual",
                                        "value": 1800}])
def test_exact_topk_matches_numpy(ds, flt, monkeypatch):
    import portbench.reference as ref

    monkeypatch.setattr(ref, "BLOCK_ROWS", 128)  # several blocks
    allow = allowed_rows(ds.keys, flt)
    d, i = exact_topk(ds.vectors, ds.queries, K, allow, "cpu")
    nd, ni = _numpy_topk(ds, allow, K)
    assert np.array_equal(i, ni)
    np.testing.assert_allclose(d, nd, rtol=0, atol=1e-12)


def _answers(ds, d, i, alter=None):
    out = []
    for q in range(len(i)):
        uu = [ds.uuids[r] for r in i[q]]
        dd = d[q].astype(np.float32)
        if alter is not None:
            uu, dd = alter(q, uu, dd)
        out.append(Answer(query=q, count=3, uuids=uu, dists=dd))
    return out


def _judge(ds, answers, allow, exact=True):
    return judge(answers, ds.vectors, ds.queries, {u: r for r, u in enumerate(ds.uuids)},
                 allow, K, 1e-5, exact, 0, "cpu")


def test_sound_answers_pass(ds):
    allow = allowed_rows(ds.keys, None)
    d, i = exact_topk(ds.vectors, ds.queries, K, allow, "cpu")
    v = _judge(ds, _answers(ds, d, i), allow)
    assert v.correct and v.recall == 1.0 and v.answers == 48


@pytest.mark.parametrize("fault", ["swapped_uuid", "distance_off", "dropped", "duplicate",
                                   "unsorted", "filtered_out", "next_best"])
def test_wrong_answers_fail(ds, fault):
    flt = {"property": "key", "operator": "GreaterThanEqual", "value": 600}
    allow = allowed_rows(ds.keys, flt)
    d, i = exact_topk(ds.vectors, ds.queries, K + 1, allow, "cpu")
    banned = ds.uuids[int(np.flatnonzero(~allow)[0])]

    def alter(q, uu, dd):
        uu, dd = list(uu[:K + 1]), dd[:K + 1].copy()
        if fault == "next_best":  # the 11th in place of the 10th
            return uu[:K - 1] + [uu[K]], np.append(dd[:K - 1], dd[K])
        uu, dd = uu[:K], dd[:K]
        if q == 3:
            if fault == "swapped_uuid":
                uu[2], uu[5] = uu[5], uu[2]
            elif fault == "distance_off":
                dd[4] += 1e-4
            elif fault == "dropped":
                uu, dd = uu[:-1], dd[:-1]
            elif fault == "duplicate":
                uu[1] = uu[0]
            elif fault == "unsorted":
                dd = dd[::-1].copy()
                uu = uu[::-1]
            elif fault == "filtered_out":
                uu[0] = banned
        return uu, dd

    v = _judge(ds, _answers(ds, d, i, alter), allow)
    assert not v.correct, v.checks


def test_the_tf32_control_fails(ds):
    allow = allowed_rows(ds.keys, None)
    d, i = control_topk(ds.vectors, ds.queries, K, allow, "cpu")
    v = _judge(ds, _answers(ds, d, i), allow, exact=False)
    assert not v.correct
    assert v.checks["max_dist_gap"][0] > 3 * 1e-5


@pytest.mark.card
def test_the_tf32_control_fails_on_the_card(card):
    big = make_dataset(77, rows=20000, dim=768, n_queries=64, key_space=80000,
                       clusters=64, device=card)
    allow = allowed_rows(big.keys, None)
    d, i = control_topk(big.vectors, big.queries, 100, allow, card)
    answers = [Answer(q, 1, [big.uuids[r] for r in i[q]], d[q].astype(np.float32))
               for q in range(len(i))]
    v = judge(answers, big.vectors, big.queries, {u: r for r, u in enumerate(big.uuids)},
              allow, 100, 1e-5, True, 0, card)
    assert not v.correct
