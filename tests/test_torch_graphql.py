"""The port's copy of tests/test_graphql.py (CPU ``Database``).

GraphQL API tests: parser unit tests + black-box queries over REST.

Reference pattern: test/acceptance/graphql_resolvers — Get with
near/bm25/hybrid/where/sort args, _additional props, Aggregate, Explore.
"""

import numpy as np
import pytest

from weaviate_tpu_torch.api.client import Client
from weaviate_tpu_torch.api.graphql import GraphQLError, parse_query
from weaviate_tpu_torch.api.rest import RestServer
from weaviate_tpu_torch.db.database import Database
from weaviate_tpu_torch.modules import Provider
from weaviate_tpu_torch.modules.text2vec_hash import HashVectorizer


# -- parser ------------------------------------------------------------------


def test_parse_basic_shapes():
    q = """
    query Foo($v: [Float]) {
      Get {
        Doc(limit: 3, nearVector: {vector: $v, distance: 0.5}) {
          title
          other: body
          _additional { id distance }
        }
      }
    }
    """
    roots = parse_query(q)
    assert len(roots) == 1 and roots[0].name == "Get"
    doc = roots[0].selections[0]
    assert doc.name == "Doc"
    assert doc.args["limit"] == 3
    assert doc.args["nearVector"]["distance"] == 0.5
    aliased = doc.sel("body")
    assert aliased.alias == "other"
    assert doc.sel("_additional").sel("distance") is not None


def test_parse_values():
    q = '{ Get { D(a: [1, 2.5, "x", true, null, ENUM], b: {c: -4}) { p } } }'
    d = parse_query(q)[0].selections[0]
    assert d.args["a"] == [1, 2.5, "x", True, None, "ENUM"]
    assert d.args["b"] == {"c": -4}


def test_parse_errors():
    with pytest.raises(GraphQLError):
        parse_query("mutation { x }")
    with pytest.raises(GraphQLError):
        parse_query("{ Get { Doc(limit: }")


# -- execution (black-box over REST) ----------------------------------------


@pytest.fixture(scope="module")
def gql(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gql")
    db = Database(str(tmp), device="cpu")
    provider = Provider(db).register(HashVectorizer())
    srv = RestServer(db, modules=provider)
    srv.start()
    c = Client(srv.address)
    c.create_class({
        "class": "Article",
        "vectorizer": "text2vec-hash",
        "moduleConfig": {"text2vec-hash": {"dim": 32}},
        "properties": [
            {"name": "title", "dataType": ["text"]},
            {"name": "wordCount", "dataType": ["int"]},
        ],
    })
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "delta", "epsilon"]
    objs = []
    for i in range(40):
        objs.append({
            "class": "Article",
            "properties": {"title": f"{words[i % 5]} article {i}",
                           "wordCount": i * 10},
        })
    c.batch_objects(objs)

    def run(query, variables=None):
        return c.graphql(query, variables)

    yield run
    srv.stop()
    db.close()


def test_get_near_vector(gql):
    # embed "alpha article 0" through the same hash vectorizer the class uses
    out = gql("""
    { Get { Article(limit: 5,
                    nearText: {concepts: ["alpha article 0"]}) {
        title
        _additional { id distance certainty }
    } } }""")
    assert "errors" not in out, out
    arts = out["data"]["Get"]["Article"]
    assert len(arts) == 5
    assert arts[0]["title"].startswith("alpha")
    assert arts[0]["_additional"]["distance"] is not None
    assert arts[0]["_additional"]["id"]
    # results ascend by distance
    dists = [a["_additional"]["distance"] for a in arts]
    assert dists == sorted(dists)


def test_get_bm25_and_where(gql):
    out = gql("""
    { Get { Article(limit: 10, bm25: {query: "gamma"},
                    where: {path: ["wordCount"], operator: GreaterThan,
                            valueInt: 100}) {
        title wordCount
        _additional { score }
    } } }""")
    assert "errors" not in out, out
    arts = out["data"]["Get"]["Article"]
    assert arts, "bm25 returned nothing"
    for a in arts:
        assert "gamma" in a["title"]
        assert a["wordCount"] > 100
        assert a["_additional"]["score"] is not None


def test_get_hybrid(gql):
    out = gql("""
    { Get { Article(limit: 5, hybrid: {query: "delta article", alpha: 0.5}) {
        title
    } } }""")
    assert "errors" not in out, out
    assert len(out["data"]["Get"]["Article"]) == 5


def test_get_listing_sort_offset(gql):
    out = gql("""
    { Get { Article(limit: 3, offset: 2,
                    sort: [{path: ["wordCount"], order: desc}]) {
        wordCount
    } } }""")
    assert "errors" not in out, out
    counts = [a["wordCount"] for a in out["data"]["Get"]["Article"]]
    assert counts == [370, 360, 350]


def test_get_variables(gql):
    out = gql(
        "query Q($lim: Int!) { Get { Article(limit: $lim) { title } } }",
        {"lim": 4})
    assert "errors" not in out, out
    assert len(out["data"]["Get"]["Article"]) == 4


def test_get_near_object(gql):
    seed = gql('{ Get { Article(limit: 1) { _additional { id } } } }')
    uid = seed["data"]["Get"]["Article"][0]["_additional"]["id"]
    out = gql("""
    query N($id: String!) {
      Get { Article(limit: 3, nearObject: {id: $id}) {
        _additional { id distance }
      } }
    }""", {"id": uid})
    assert "errors" not in out, out
    arts = out["data"]["Get"]["Article"]
    assert arts[0]["_additional"]["id"] == uid
    assert arts[0]["_additional"]["distance"] == pytest.approx(0.0, abs=1e-4)


def test_aggregate_meta_and_stats(gql):
    out = gql("""
    { Aggregate { Article {
        meta { count }
        wordCount { count mean minimum maximum sum }
    } } }""")
    assert "errors" not in out, out
    agg = out["data"]["Aggregate"]["Article"][0]
    assert agg["meta"]["count"] == 40
    wc = agg["wordCount"]
    assert wc["count"] == 40
    assert wc["minimum"] == 0 and wc["maximum"] == 390
    assert wc["mean"] == pytest.approx(195.0)


def test_aggregate_group_by(gql):
    out = gql("""
    { Aggregate { Article(groupBy: ["title"]) {
        groupedBy { value }
        meta { count }
    } } }""")
    assert "errors" not in out, out
    groups = out["data"]["Aggregate"]["Article"]
    assert len(groups) >= 1


def test_explore(gql):
    out = gql("""
    { Explore(limit: 4, nearText: {concepts: ["beta article"]}) {
        beacon className distance certainty
    } }""")
    assert "errors" not in out, out
    hits = out["data"]["Explore"]
    assert len(hits) == 4
    assert all(h["className"] == "Article" for h in hits)
    assert hits[0]["beacon"].startswith("weaviate://localhost/Article/")


def test_unknown_class_reports_error(gql):
    out = gql("{ Get { Nope { title } } }")
    assert out["errors"]


def test_unknown_root_reports_error(gql):
    out = gql("{ Borked { x } }")
    assert out["errors"]


def test_get_group_by(gql):
    """Get-level groupBy: one entry per group, hits under
    _additional.group (reference: groupBy arg + group additional)."""
    out = gql("""
    { Get { Article(limit: 40,
                    nearText: {concepts: ["article"]},
                    groupBy: {path: ["title"], groups: 3,
                              objectsPerGroup: 2}) {
        title
        _additional { group { id count groupedBy { value }
                              minDistance maxDistance
                              hits { wordCount _additional { id } } } }
    } } }""")
    assert "errors" not in out, out
    rows = out["data"]["Get"]["Article"]
    assert 1 <= len(rows) <= 3
    for row in rows:
        g = row["_additional"]["group"]
        assert 1 <= g["count"] <= 2
        assert len(g["hits"]) == g["count"]
        assert g["groupedBy"]["value"]
        assert g["hits"][0]["_additional"]["id"]


def test_near_media_requires_module(gql):
    out = gql("""
    { Get { Article(limit: 1, nearImage: {image: "AAAA"}) { title } } }""")
    assert out["errors"]  # hash vectorizer is not a multi2vec module


def test_aggregate_near_text_object_limit(gql):
    out = gql("""
    { Aggregate { Article(nearText: {concepts: ["alpha"]},
                          objectLimit: 8) {
        meta { count }
    } } }""")
    assert "errors" not in out, out
    assert out["data"]["Aggregate"]["Article"][0]["meta"]["count"] == 8


def test_aggregate_near_respects_distance_threshold(gql):
    """distance on an Aggregate near-arg restricts the aggregation set
    (reference: certainty/distance restrict the object set)."""
    out = gql("""
    { Aggregate { Article(nearText: {concepts: ["alpha article 0"],
                                     distance: 0.0001}) {
        meta { count }
    } } }""")
    assert "errors" not in out, out
    # only near-identical objects pass the tight threshold
    assert out["data"]["Aggregate"]["Article"][0]["meta"]["count"] <= 2


def test_group_by_hits_respect_selection(gql):
    out = gql("""
    { Get { Article(limit: 40, nearText: {concepts: ["article"]},
                    groupBy: {path: ["title"], groups: 2,
                              objectsPerGroup: 2}) {
        title
        _additional { group { hits { wordCount } } }
    } } }""")
    assert "errors" not in out, out
    hit = out["data"]["Get"]["Article"][0]["_additional"]["group"]["hits"][0]
    assert "wordCount" in hit
    assert "title" not in hit  # only requested fields are rendered


def test_group_by_without_search_is_clean_error(gql):
    out = gql("""
    { Get { Article(groupBy: {path: ["title"]}) { title } } }""")
    assert out["errors"]
    assert "groupBy requires" in out["errors"][0]["message"]
