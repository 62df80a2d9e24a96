"""The port's BM25F scoring and hybrid fusion (``weaviate_tpu_torch/ops/bm25.py``
and the plain version of the ``bm25_block`` kernel) against the JAX package.

- ``bm25_block_plain`` equals the JAX ``bm25_block`` run in Pallas interpret
  mode and ``_bm25_neg_scores_xla`` bit for bit (tolerance 0) on operands
  that ``bm25_pack`` builds, across k1/b, boosted multi-property queries,
  a ``^0`` boost, stopword-heavy queries, terms without postings, a
  pure-vector row and candidate axes of 512 and 1024;
- ``bm25_pack`` and ``stack_sparse_operands`` give the reference's arrays,
  ``cand_bits`` word for word;
- ``fuse_topk`` and ``hybrid_topk`` give the reference's ids and
  bit-equal scores (the only sum is a join with at most one nonzero
  term), and rank like the host fusion of ``text/hybrid.py`` (which sums
  in Python floats, hence its rtol of 1e-6).
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.db import Database as JDatabase
from weaviate_tpu.ops import bm25 as jbm25
from weaviate_tpu.ops.pallas_kernels import bm25_block as jbm25_block
from weaviate_tpu.schema import config as jschema
from weaviate_tpu.text.hybrid import fusion_ranked as j_fusion_ranked
from weaviate_tpu_torch.db import Database as TDatabase
from weaviate_tpu_torch.ops import bm25 as tbm25
from weaviate_tpu_torch.ops import kernels as K
from weaviate_tpu_torch.ops.candidates import masked_candidate_topk
from weaviate_tpu_torch.schema import config as tschema
from weaviate_tpu_torch.text.hybrid import fusion_ranked, fusion_relative_score

PACK_KEYS = ("seg_tf", "seg_len", "seg_term", "seg_boost", "seg_avg", "idf")
STACK_KEYS = ("slots", "seg_tf", "seg_len", "seg_term", "seg_boost", "seg_avg",
              "idf", "k1", "b", "omb", "alpha", "kind", "fetch", "is_hybrid")


def _config(schema):
    return schema.CollectionConfig(
        name="Doc",
        properties=[schema.Property(name="body", data_type="text"),
                    schema.Property(name="title", data_type="text")],
        vectors=[schema.VectorConfig()])


def _random_texts(rng, n=800):
    """``common`` in ~90% of the bodies (a 1024-wide candidate axis), a
    handful of mid words, ``rare`` words below 512 documents, titles with
    their own mix."""
    mid = [f"mid{j}" for j in range(12)]
    rare = [f"rare{j}" for j in range(6)]
    bodies, titles = [], []
    for _ in range(n):
        words = list(rng.choice(mid, int(rng.integers(3, 30))))
        if rng.random() < 0.9:
            words += ["common"] * int(rng.integers(1, 4))
        if rng.random() < 0.08:
            words += [str(rng.choice(rare))] * int(rng.integers(1, 3))
        words += list(rng.choice(["the", "of", "and", "to"], int(rng.integers(0, 6))))
        rng.shuffle(words)
        bodies.append(" ".join(words))
        titles.append(" ".join(rng.choice(mid[:4] + rare[:2], int(rng.integers(1, 5)))))
    return bodies, titles


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    rng = np.random.default_rng(11)
    bodies, titles = _random_texts(rng)
    vecs = rng.standard_normal((len(bodies), 8)).astype(np.float32)
    objs = [{"uuid": f"00000000-0000-4000-8000-{i:012d}",
             "properties": {"body": b, "title": t}, "vector": vecs[i]}
            for i, (b, t) in enumerate(zip(bodies, titles))]
    root = tmp_path_factory.mktemp("bm25")
    jdb = JDatabase(str(root / "j"))
    tdb = TDatabase(str(root / "t"), device="cpu")
    try:
        jcol = jdb.create_collection(_config(jschema))
        tcol = tdb.create_collection(_config(tschema))
        jcol.batch_put(objs)
        tcol.batch_put(objs)
        yield next(iter(jcol.shards.values())), next(iter(tcol.shards.values()))
    finally:
        jdb.close()
        tdb.close()


def _ops(pkg, shard, queries, alpha=0.5, fusion=0, fetch=100):
    """One SparseOperand per (query, properties); None stays None (a
    pure-vector row)."""
    idx = shard.vector_indexes[""]
    out = []
    for q in queries:
        if q is None:
            out.append(None)
            continue
        text, props = q
        pack = shard._inverted.bm25_pack(text, props)
        assert pack is not None, text
        out.append(pkg.SparseOperand(
            pack["doc_ids"], idx.slots_for_doc_ids(pack["doc_ids"]),
            pack["seg_tf"], pack["seg_len"], pack["seg_term"], pack["seg_boost"],
            pack["seg_avg"], pack["idf"], pack["k1"], pack["b"],
            pack["one_minus_b"], alpha, fusion, fetch, pack["stats"]))
    return out


def _port_scores(p: dict) -> np.ndarray:
    t = tbm25.pack_to_device(p, "cpu")
    return tbm25.bm25_neg_scores(t["seg_tf"], t["seg_len"], t["seg_term"],
                                 t["seg_boost"], t["seg_avg"], t["idf"], t["k1"],
                                 t["b"], t["omb"], t["cand_bits"]).numpy()


def _assert_stacks_equal(jp: dict, tp: dict):
    for key in STACK_KEYS:
        np.testing.assert_array_equal(tp[key], np.asarray(jp[key]), err_msg=key)
        assert tp[key].dtype == np.asarray(jp[key]).dtype, key
    np.testing.assert_array_equal(tp["cand_bits"].astype(np.uint32),
                                  np.asarray(jp["cand_bits"]).astype(np.uint32))


QUERY_SETS = {
    # C = 1024: ``common`` sits in ~720 bodies
    "common_multiprop": [("common mid1", ["body", "title^2"]), ("mid3 mid4", None),
                         None, ("rare1 mid2", ["body^2", "title"])],
    # C = 512: rare words only, a ^0 boost, a term without postings
    "rare_zero_boost": [("rare0 rare2", ["body", "title^0"]),
                        ("rare3 zzznothere", ["body"]), None],
    # stopword-heavy: the stopwords drop out of the plan
    "stopwords": [("the rare4 of and to rare5", None), ("of the mid2 and", ["title"])],
}


@pytest.mark.parametrize("k1,b", [(1.2, 0.75), (0.5, 0.0), (2.0, 1.0), (1.0, 0.4)])
@pytest.mark.parametrize("qset", sorted(QUERY_SETS))
def test_bm25_block_plain_bitexact_vs_jax(shards, k1, b, qset):
    js, ts = shards
    for inv in (js._inverted, ts._inverted):
        inv.k1, inv.b = k1, b
    try:
        queries = QUERY_SETS[qset]
        jp = jbm25.stack_sparse_operands(_ops(jbm25, js, queries), 4)
        tp = tbm25.stack_sparse_operands(_ops(tbm25, ts, queries), 4)
        _assert_stacks_equal(jp, tp)
        want_c = 1024 if qset == "common_multiprop" else 512
        assert tp["seg_tf"].shape[2] == want_c
        xla = np.asarray(jbm25._bm25_neg_scores_xla(
            jp["seg_tf"], jp["seg_len"], jp["seg_term"], jp["seg_boost"],
            jp["seg_avg"], jp["idf"], jp["k1"], jp["b"], jp["omb"], jp["slots"]))
        pal = np.asarray(jbm25_block(
            jp["seg_tf"], jp["seg_len"], jp["seg_term"], jp["seg_boost"],
            jp["seg_avg"], jp["idf"], jp["k1"], jp["b"], jp["omb"],
            jp["cand_bits"], interpret=True))
        got = _port_scores(tp)
        np.testing.assert_array_equal(got, pal)
        np.testing.assert_array_equal(got, xla)
        # the pure-vector row scores nothing
        none_rows = [r for r, q in enumerate(queries) if q is None]
        assert (got[none_rows] == np.float32(K.MASKED_DISTANCE)).all()
    finally:
        for inv in (js._inverted, ts._inverted):
            inv.k1, inv.b = 1.2, 0.75


@pytest.mark.parametrize("text,props", [
    ("common mid1", ["body", "title^2"]), ("rare0 rare2", ["body", "title^0"]),
    ("the of and", None), ("zzznothere", None), ("rare3", ["title"]),
])
def test_bm25_pack_matches_reference(shards, text, props):
    js, ts = shards
    jp = js._inverted.bm25_pack(text, props)
    tp = ts._inverted.bm25_pack(text, props)
    if jp is None:
        assert tp is None
        return
    for key in ("doc_ids",) + PACK_KEYS:
        np.testing.assert_array_equal(tp[key], jp[key], err_msg=key)
    for key in ("k1", "b", "one_minus_b", "stats"):
        assert tp[key] == jp[key], key


def test_stack_sparse_operands_pads_like_reference(shards):
    js, ts = shards
    queries = QUERY_SETS["common_multiprop"] + QUERY_SETS["rare_zero_boost"]
    # b_pad above the row count: padded rows stay dense-only
    jp = jbm25.stack_sparse_operands(_ops(jbm25, js, queries, 0.3, 1, 70), 16)
    tp = tbm25.stack_sparse_operands(_ops(tbm25, ts, queries, 0.3, 1, 70), 16)
    _assert_stacks_equal(jp, tp)
    assert tp["slots"].shape[0] == 16
    assert tbm25.fusion_kind("relativeScore") == jbm25.fusion_kind("relativeScore") \
        == tbm25.FUSION_RELATIVE
    assert tbm25.fusion_kind("rankedFusion") == tbm25.FUSION_RANKED


def test_bm25_block_checks_its_operands():
    t = tbm25.pack_to_device(tbm25.stack_sparse_operands([None], 1), "cpu")
    args = [t[k] for k in ("seg_tf", "seg_len", "seg_term", "seg_boost", "seg_avg",
                           "idf", "k1", "b", "omb", "cand_bits")]
    with pytest.raises(ValueError, match="k1"):
        K.bm25_block(*args[:6], args[6][:0], *args[7:])
    with pytest.raises(ValueError, match="multiple of 512"):
        K.bm25_block(args[0][:, :, :500], args[1][:, :, :500], *args[2:])


# -- device top-k vs the port's host scorer on a tie-free corpus ---------------

def _tiefree_texts(n=48):
    """Doc i carries a doc-unique alpha term frequency (i+1) so BM25 scores
    stay gapped even at b=0; bravo skips every third doc with its own
    unique tf; pad varies the length (the reference test's corpus)."""
    out = []
    for i in range(n):
        words = ["alpha"] * (i + 1)
        if i % 3:
            words += ["bravo"] * (i + 2)
        words += ["pad"] * (1 + (7 * i) % 17)
        out.append(" ".join(words))
    return out


@pytest.mark.parametrize("k1,b", [(1.2, 0.75), (0.5, 0.0), (2.0, 1.0)])
def test_device_topk_equals_host_scorer(tmp_path, k1, b):
    tdb = TDatabase(str(tmp_path / "t"), device="cpu")
    try:
        col = tdb.create_collection(_config(tschema))
        col.batch_put([{"properties": {"body": t}, "vector": np.ones(8, np.float32)}
                       for t in _tiefree_texts()])
        shard = next(iter(col.shards.values()))
        inv = shard._inverted
        inv.k1, inv.b = k1, b
        for q in ("alpha", "alpha bravo", "the alpha of and bravo to"):
            h_ids, h_scores = inv.bm25_search(q, 10, ["body"])
            pack = inv.bm25_pack(q, ["body"])
            op = tbm25.SparseOperand(
                pack["doc_ids"], pack["doc_ids"].astype(np.int32), pack["seg_tf"],
                pack["seg_len"], pack["seg_term"], pack["seg_boost"], pack["seg_avg"],
                pack["idf"], pack["k1"], pack["b"], pack["one_minus_b"], 0.0,
                tbm25.FUSION_RANKED, 10)
            p = tbm25.pack_to_device(tbm25.stack_sparse_operands([op], 1), "cpu")
            neg = tbm25.bm25_neg_scores(p["seg_tf"], p["seg_len"], p["seg_term"],
                                        p["seg_boost"], p["seg_avg"], p["idf"],
                                        p["k1"], p["b"], p["omb"], p["cand_bits"])
            d, i = masked_candidate_topk(neg, p["slots"], 10)
            d, i = d.numpy()[0], i.numpy()[0]
            assert len(set(h_scores.tolist())) == len(h_scores)  # tie-free
            np.testing.assert_array_equal(i[i >= 0], h_ids)
            np.testing.assert_array_equal(-d[i >= 0], h_scores)
    finally:
        tdb.close()


# -- fusion ---------------------------------------------------------------------

class _Res:
    __slots__ = ("uuid", "score", "distance")

    def __init__(self, uuid, score):
        self.uuid = uuid
        self.score = score
        self.distance = None


def _host_fuse(kind, sp, dn, alpha, k):
    legs, weights = [], []
    if alpha < 1.0:
        legs.append([_Res(i, s) for i, s in sp])
        weights.append(1.0 - alpha)
    if alpha > 0.0:
        legs.append([_Res(i, -d) for i, d in dn])
        weights.append(alpha)
    fuse = fusion_relative_score if kind == tbm25.FUSION_RELATIVE else fusion_ranked
    return [(r.uuid, s) for s, r in fuse(legs, weights, k)]


def _legs(sp, dn):
    sp_ids = np.array([[i for i, _ in sp]], np.int32)
    sp_neg = np.array([[-s for _, s in sp]], np.float32)
    dn_i = np.array([[i for i, _ in dn]], np.int32)
    dn_d = np.array([[d for _, d in dn]], np.float32)
    return sp_neg, sp_ids, dn_d, dn_i


def _both_fuse(kind, sp, dn, alpha, k, fetch=100):
    """(port ids, port scores), checked equal to the JAX fuse_topk's."""
    legs = _legs(sp, dn)
    params = (np.array([alpha], np.float32), np.array([kind], np.int32),
              np.array([fetch], np.int32))
    jd, ji = jbm25.fuse_topk(*legs, *params, k)
    td, ti = tbm25.fuse_topk(*(torch.from_numpy(a) for a in legs + params), k)
    td, ti = td.numpy()[0], ti.numpy()[0]
    np.testing.assert_array_equal(ti, np.asarray(ji)[0])
    np.testing.assert_array_equal(td, np.asarray(jd)[0])
    live = ti >= 0
    return list(zip(ti[live].tolist(), (-td[live]).tolist()))


@pytest.mark.parametrize("kind", [tbm25.FUSION_RANKED, tbm25.FUSION_RELATIVE])
@pytest.mark.parametrize("alpha", [0.0, 0.25, 0.5, 0.75, 1.0])
def test_fuse_topk_parity_overlapping_legs(kind, alpha):
    sp = [(3, 9.0), (1, 7.5), (7, 4.0), (2, 1.0)]
    dn = [(1, 0.1), (9, 0.2), (3, 0.35), (8, 0.9)]
    dev = _both_fuse(kind, sp, dn, alpha, 6)
    host = _host_fuse(kind, sp, dn, alpha, 6)
    assert [i for i, _ in dev] == [i for i, _ in host]
    np.testing.assert_allclose([s for _, s in dev], [s for _, s in host],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", [tbm25.FUSION_RANKED, tbm25.FUSION_RELATIVE])
def test_fuse_topk_exact_tie_goes_to_sparse_entry(kind):
    """Doc 5 only-sparse at rank 0 and doc 6 only-dense at rank 0 tie
    exactly at alpha=0.5; the host dict inserts the sparse leg first."""
    sp = [(5, 2.0), (1, 1.0)]
    dn = [(6, 0.3), (2, 0.7)]
    dev = _both_fuse(kind, sp, dn, 0.5, 4)
    host = _host_fuse(kind, sp, dn, 0.5, 4)
    assert host[0][0] == 5 and host[1][0] == 6
    assert [i for i, _ in dev] == [i for i, _ in host]
    assert dev[0][1] == dev[1][1]


def test_fuse_topk_constant_leg_and_fetch_cap():
    sp = [(1, 3.0), (2, 3.0), (3, 3.0)]
    dn = [(2, 0.1), (4, 0.5)]
    dev = _both_fuse(tbm25.FUSION_RELATIVE, sp, dn, 0.4, 5)
    host = _host_fuse(tbm25.FUSION_RELATIVE, sp, dn, 0.4, 5)
    assert sorted(i for i, _ in dev) == sorted(i for i, _ in host)
    np.testing.assert_allclose(sorted(s for _, s in dev), sorted(s for _, s in host),
                               rtol=1e-6)
    # entries past the fetch horizon must not contribute
    sp = [(1, 5.0), (2, 4.0), (3, 3.0)]
    dn = [(4, 0.1)]
    for kind in (tbm25.FUSION_RANKED, tbm25.FUSION_RELATIVE):
        dev = _both_fuse(kind, sp, dn, 0.5, 4, fetch=2)
        assert [i for i, _ in dev] == [i for i, _ in _host_fuse(kind, sp[:2], dn, 0.5, 4)]


def test_host_fusion_copy_matches_reference_and_keeps_results():
    shared = [_Res(i, float(10 - i)) for i in range(5)]
    before = [r.score for r in shared]
    a = [(s, r.uuid) for s, r in fusion_ranked([shared, shared[::-1]], [0.3, 0.7], 5)]
    b = [(s, r.uuid) for s, r in j_fusion_ranked([shared, shared[::-1]], [0.3, 0.7], 5)]
    assert a == b
    assert [r.score for r in shared] == before


@pytest.mark.parametrize("k", [4, 16])
def test_hybrid_topk_parity_mixed_drain(shards, k):
    """The whole fused program over a drain of hybrid rows (both fusions,
    several alphas) and pure-vector rows, against the JAX program."""
    js, ts = shards
    queries = QUERY_SETS["common_multiprop"] + QUERY_SETS["rare_zero_boost"]
    alphas = [0.0, 0.3, 0.75, 1.0, 0.5, 0.25, 0.9]
    kinds = [0, 1, 1, 0, 1, 0, 1]
    jops = _ops(jbm25, js, queries)
    tops = _ops(tbm25, ts, queries)
    for r, (a, kd) in enumerate(zip(alphas, kinds)):
        for ops in (jops, tops):
            if ops[r] is not None:
                ops[r].alpha, ops[r].fusion, ops[r].fetch = a, kd, 50 + 10 * r
    jp = jbm25.stack_sparse_operands(jops, 8)
    tp = tbm25.stack_sparse_operands(tops, 8)
    # a dense leg over store slots: ascending distances, a dead tail
    rng = np.random.default_rng(5)
    f = 128
    dn_d = np.sort(rng.random((8, f)).astype(np.float32), axis=1)
    dn_i = np.stack([rng.permutation(800)[:f] for _ in range(8)]).astype(np.int32)
    dn_d[:, 120:] = K.MASKED_DISTANCE
    dn_i[:, 120:] = -1
    jd, ji = jbm25.hybrid_topk(dn_d, dn_i, jp, k, use_pallas=False)
    td, ti = tbm25.hybrid_topk(torch.from_numpy(dn_d), torch.from_numpy(dn_i),
                               tbm25.pack_to_device(tp, "cpu"), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
