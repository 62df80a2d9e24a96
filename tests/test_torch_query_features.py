"""The port's copy of tests/test_query_features.py (CPU ``Database``).

Aggregations, sorting, autocut, cursor listing.

Mirrors reference test intents: aggregator/numerical_test.go,
aggregator/text_test.go, sorter/objects_sorter_test.go,
entities/autocut semantics.
"""

import numpy as np
import pytest

from weaviate_tpu_torch.db.database import Database
from weaviate_tpu_torch.query.aggregator import (
    PropertyAggregator,
    aggregate_objects,
    combine_partials,
    finalize_aggregation,
)
from weaviate_tpu_torch.query.autocut import autocut
from weaviate_tpu_torch.query.sorter import sort_objects
from weaviate_tpu_torch.schema.config import CollectionConfig, Property
from weaviate_tpu_torch.storage.objects import StorageObject


def _obj(uuid, props):
    return StorageObject(uuid=uuid, properties=props)


# -- autocut -------------------------------------------------------------------


def test_autocut_cuts_at_first_jump():
    # 4 close values then a big jump: cut should land at the jump
    vals = [1.0, 1.1, 1.2, 1.3, 9.0, 9.1]
    assert autocut(vals, 1) == 4


def test_autocut_second_jump():
    vals = [1.0, 1.1, 4.0, 4.1, 9.0, 9.1]
    cut1 = autocut(vals, 1)
    cut2 = autocut(vals, 2)
    assert cut1 == 2
    assert cut2 == 4
    assert autocut(vals, 0) == len(vals)  # disabled


def test_autocut_flat_returns_all():
    assert autocut([2.0, 2.0, 2.0], 1) == 3
    assert autocut([5.0], 1) == 1
    assert autocut([], 1) == 0


# -- aggregator ----------------------------------------------------------------


def test_numerical_aggregation_exact():
    objs = [_obj(f"u{i}", {"price": p}) for i, p in
            enumerate([10.0, 20.0, 20.0, 30.0, 40.0])]
    partial = aggregate_objects(objs, ["price"])
    result = finalize_aggregation(combine_partials([partial]))
    agg = result["properties"]["price"]
    assert agg["count"] == 5
    assert agg["minimum"] == 10.0
    assert agg["maximum"] == 40.0
    assert agg["sum"] == 120.0
    assert agg["mean"] == pytest.approx(24.0)
    assert agg["median"] == 20.0
    assert agg["mode"] == 20.0
    assert result["meta"]["count"] == 5


def test_partials_merge_equals_single_pass():
    """Cross-shard combine must equal aggregating everything at once
    (shard_combiner.go contract)."""
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 50, size=200).astype(float).tolist()
    objs = [_obj(f"u{i}", {"v": v}) for i, v in enumerate(vals)]
    whole = finalize_aggregation(combine_partials([aggregate_objects(objs, ["v"])]))
    parts = [aggregate_objects(objs[i::4], ["v"]) for i in range(4)]
    merged = finalize_aggregation(combine_partials(parts))
    assert whole["properties"]["v"] == merged["properties"]["v"]
    assert whole["meta"] == merged["meta"]


def test_text_top_occurrences():
    objs = [_obj(f"u{i}", {"color": c}) for i, c in
            enumerate(["red"] * 5 + ["blue"] * 3 + ["green"] * 2)]
    result = finalize_aggregation(combine_partials([aggregate_objects(objs, ["color"])]))
    top = result["properties"]["color"]["topOccurrences"]
    assert top[0] == {"value": "red", "occurs": 5}
    assert top[1] == {"value": "blue", "occurs": 3}


def test_boolean_aggregation():
    objs = [_obj(f"u{i}", {"ok": b}) for i, b in enumerate([True, True, True, False])]
    result = finalize_aggregation(combine_partials([aggregate_objects(objs, ["ok"])]))
    agg = result["properties"]["ok"]
    assert agg["totalTrue"] == 3
    assert agg["totalFalse"] == 1
    assert agg["percentageTrue"] == pytest.approx(0.75)


def test_date_aggregation():
    objs = [_obj(f"u{i}", {"when": d}) for i, d in enumerate([
        "2023-01-01T00:00:00Z", "2024-06-15T12:00:00Z", "2022-03-03T00:00:00Z"])]
    result = finalize_aggregation(combine_partials([aggregate_objects(objs, ["when"])]))
    agg = result["properties"]["when"]
    assert agg["minimum"] == "2022-03-03T00:00:00Z"
    assert agg["maximum"] == "2024-06-15T12:00:00Z"
    assert agg["count"] == 3


def test_group_by_aggregation():
    objs = [_obj(f"u{i}", {"team": t, "score": s}) for i, (t, s) in
            enumerate([("a", 1.0), ("a", 3.0), ("b", 10.0)])]
    result = finalize_aggregation(combine_partials(
        [aggregate_objects(objs, ["score"], group_by="team")]))
    groups = {g["groupedBy"]["value"]: g for g in result["groups"]}
    assert groups["a"]["meta"]["count"] == 2
    assert groups["a"]["properties"]["score"]["sum"] == 4.0
    assert groups["b"]["properties"]["score"]["mean"] == 10.0


def test_aggregator_none_and_mixed_values():
    agg = PropertyAggregator()
    agg.add(None)
    agg.add(1.5)
    agg.add(2.5)
    out = agg.finalize()
    assert out["count"] == 2
    assert out["mean"] == 2.0


# -- sorter --------------------------------------------------------------------


def test_sort_by_property_asc_desc():
    objs = [_obj("c", {"n": 3}), _obj("a", {"n": 1}), _obj("b", {"n": 2})]
    asc = sort_objects(objs, [{"path": "n", "order": "asc"}])
    assert [o.uuid for o in asc] == ["a", "b", "c"]
    desc = sort_objects(objs, [{"path": "n", "order": "desc"}])
    assert [o.uuid for o in desc] == ["c", "b", "a"]


def test_sort_multi_key_and_nulls_last():
    objs = [
        _obj("1", {"grp": "x", "n": 2}),
        _obj("2", {"grp": "x", "n": 1}),
        _obj("3", {"grp": "a", "n": 9}),
        _obj("4", {"n": 0}),  # missing grp -> last
    ]
    out = sort_objects(objs, [{"path": "grp", "order": "asc"},
                              {"path": "n", "order": "asc"}])
    assert [o.uuid for o in out] == ["3", "2", "1", "4"]


def test_sort_by_id_and_date_strings():
    objs = [_obj("b", {"d": "2024-01-01T00:00:00Z"}),
            _obj("a", {"d": "2022-01-01T00:00:00Z"})]
    by_id = sort_objects(objs, [{"path": "_id", "order": "asc"}])
    assert [o.uuid for o in by_id] == ["a", "b"]
    by_date = sort_objects(objs, [{"path": "d", "order": "desc"}])
    assert [o.uuid for o in by_date] == ["b", "a"]


# -- collection-level integration ---------------------------------------------


@pytest.fixture
def db(tmp_path):
    database = Database(str(tmp_path), device="cpu")
    yield database
    database.close()


def _seed(db, n=30, shards=2):
    col = db.create_collection(CollectionConfig(
        name="Agg",
        properties=[Property("name", "text"), Property("price", "number"),
                    Property("instock", "boolean")],
    ))
    rng = np.random.default_rng(0)
    for i in range(n):
        col.put_object(
            {"name": f"item {i % 3}", "price": float(i), "instock": i % 2 == 0},
            vector=rng.standard_normal(8).astype(np.float32),
            uuid=f"00000000-0000-0000-0000-{i:012d}",
        )
    return col


def test_collection_aggregate(db):
    col = _seed(db, 30)
    res = col.aggregate(properties=["price", "instock", "name"])
    assert res["meta"]["count"] == 30
    assert res["properties"]["price"]["minimum"] == 0.0
    assert res["properties"]["price"]["maximum"] == 29.0
    assert res["properties"]["instock"]["totalTrue"] == 15
    top = res["properties"]["name"]["topOccurrences"]
    assert sum(t["occurs"] for t in top) == 30


def test_collection_aggregate_with_filter(db):
    from weaviate_tpu_torch.filters import Filter

    col = _seed(db, 30)
    res = col.aggregate(properties=["price"],
                        where=Filter.where("price", "LessThan", 10.0))
    assert res["meta"]["count"] == 10
    assert res["properties"]["price"]["maximum"] == 9.0


def test_collection_aggregate_group_by(db):
    col = _seed(db, 30)
    res = col.aggregate(properties=["price"], group_by="name")
    assert len(res["groups"]) == 3
    assert sum(g["meta"]["count"] for g in res["groups"]) == 30


def test_fetch_objects_cursor_pagination(db):
    col = _seed(db, 30)
    page1 = col.fetch_objects(limit=10)
    assert len(page1) == 10
    page2 = col.fetch_objects(limit=10, after=page1[-1].uuid)
    assert len(page2) == 10
    assert not {o.uuid for o in page1} & {o.uuid for o in page2}
    # uuid-ordered cursor: page2 strictly after page1
    assert min(o.uuid for o in page2) > max(o.uuid for o in page1)


def test_fetch_objects_sorted(db):
    col = _seed(db, 10)
    objs = col.fetch_objects(limit=5, sort=[{"path": "price", "order": "desc"}])
    prices = [o.properties["price"] for o in objs]
    assert prices == sorted(prices, reverse=True)
    with pytest.raises(ValueError):
        col.fetch_objects(after="x", sort=[{"path": "price"}])


def test_near_vector_autocut(db):
    col = db.create_collection(CollectionConfig(name="Cut"))
    # 5 points near the query, 5 far away
    for i in range(5):
        col.put_object({"i": i}, vector=[1.0 + 0.01 * i, 0.0])
    for i in range(5):
        col.put_object({"i": i}, vector=[100.0 + i, 50.0])
    hits = col.near_vector([1.0, 0.0], k=10, autocut=1)
    assert len(hits) == 5
    assert all(r.distance < 1.0 for r in hits)

