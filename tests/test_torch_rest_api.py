"""REST API black-box tests over a real socket, against the port's
RestServer over a CPU ``Database`` (a copy of tests/test_rest_api.py).

Reference pattern: test/acceptance/ runs black-box REST tests against a
live server — here against RestServer on localhost. Multi-tenancy and the
cluster are not ported (ROADMAP Queue 1 item 7): their cases pin the 500
that names the item.
"""

import numpy as np
import pytest

from weaviate_tpu_torch.api.client import Client, RestError
from weaviate_tpu_torch.api.rest import RestServer
from weaviate_tpu_torch.db.database import Database


@pytest.fixture
def server(tmp_path):
    db = Database(str(tmp_path), device="cpu")
    srv = RestServer(db)
    srv.start()
    yield srv
    srv.stop()
    db.close()


@pytest.fixture
def client(server):
    return Client(server.address)


def test_meta_and_wellknown(client):
    assert client.ready()
    meta = client.meta()
    assert meta["version"]
    nodes = client.nodes()
    assert nodes[0]["status"] == "HEALTHY"


def test_nodes_per_host_hbm_rollup(client):
    """ISSUE 13 acceptance: /v1/nodes reports per-host hbmBytes that
    SUM to the ledger total (the hierarchical-sharding attribution)."""
    from weaviate_tpu_torch.runtime.hbm_ledger import ledger

    client.create_class({"class": "HostBytes"})
    client.create_object("HostBytes", {}, vector=[1.0, 2.0, 3.0, 4.0])
    nodes = client.request("GET", "/v1/nodes?output=verbose")["nodes"]
    stats = nodes[0]["stats"]
    hosts = stats["hbmHostBytes"]
    assert hosts and all(h.startswith("host-") for h in hosts)
    assert sum(hosts.values()) == stats["hbmLedgerBytes"] \
        == ledger.total_bytes()
    # per-shard breakdown still rides verbose output alongside
    assert any(s["class"] == "HostBytes" for s in nodes[0]["shards"])


def test_schema_crud(client):
    client.create_class({"name": "Article", "properties": [
        {"name": "title", "data_type": "text"},
        {"name": "wordCount", "data_type": "int"},
    ]})
    schema = client.get_schema()
    assert [c["class"] for c in schema["classes"]] == ["Article"]
    cls = client.get_class("Article")
    assert {p["name"] for p in cls["properties"]} == {"title", "wordCount"}
    # weaviate-style property payload
    client.add_property("Article", {"name": "tag", "dataType": ["text"]})
    assert any(p["name"] == "tag"
               for p in client.get_class("Article")["properties"])
    client.delete_class("Article")
    with pytest.raises(RestError) as e:
        client.get_class("Article")
    assert e.value.status == 404


def test_object_crud_roundtrip(client):
    client.create_class({"name": "Doc", "properties": [
        {"name": "body", "data_type": "text"}]})
    created = client.create_object("Doc", {"body": "hello world"},
                                   vector=[1.0, 2.0, 3.0])
    uid = created["id"]
    got = client.get_object("Doc", uid)
    assert got["properties"]["body"] == "hello world"
    assert got["vector"] == [1.0, 2.0, 3.0]
    patched = client.patch_object("Doc", uid, {"extra": "yes"})
    assert patched["properties"] == {"body": "hello world", "extra": "yes"}
    assert patched["vector"] == [1.0, 2.0, 3.0]  # merge keeps the vector
    client.delete_object("Doc", uid)
    with pytest.raises(RestError) as e:
        client.get_object("Doc", uid)
    assert e.value.status == 404
    with pytest.raises(RestError):
        client.delete_object("Doc", uid)  # second delete -> 404


def test_batch_and_listing(client):
    client.create_class({"name": "Item", "properties": [
        {"name": "n", "data_type": "int"}]})
    rng = np.random.default_rng(0)
    results = client.batch_objects([
        {"class": "Item", "properties": {"n": i},
         "vector": rng.standard_normal(4).tolist()}
        for i in range(30)
    ])
    assert all(r["result"]["status"] == "SUCCESS" for r in results)
    page = client.list_objects("Item", limit=10)
    assert len(page["objects"]) == 10
    page2 = client.list_objects("Item", limit=10,
                                after=page["objects"][-1]["id"])
    assert not {o["id"] for o in page["objects"]} & \
        {o["id"] for o in page2["objects"]}
    # sorted listing
    top = client.list_objects("Item", limit=3, sort="n", order="desc")
    assert [o["properties"]["n"] for o in top["objects"]] == [29, 28, 27]
    # filtered listing
    flt = client.list_objects("Item", limit=50, where={
        "path": "n", "operator": "LessThan", "value": 5})
    assert len(flt["objects"]) == 5


def test_batch_partial_failure(client):
    client.create_class({"name": "Part"})
    results = client.batch_objects([
        {"class": "Part", "properties": {"a": 1}, "vector": [1.0, 2.0]},
        {"class": "DoesNotExist", "properties": {}},
    ])
    assert results[0]["result"]["status"] == "SUCCESS"
    assert results[1]["result"]["status"] == "FAILED"


def test_multi_tenant_rest(client):
    """A multi-tenant class is refused with the item that ports it."""
    with pytest.raises(RestError) as e:
        client.create_class({"name": "MT",
                             "multi_tenancy": {"enabled": True}})
    assert e.value.status == 500
    assert "item 7" in str(e.value)
    assert "MT" not in [c["class"] for c in client.get_schema()["classes"]]


def test_tenant_routes_on_a_plain_class(client):
    """A class without tenants lists none, as the JAX server's does, and
    adding tenants answers 500 naming item 7."""
    client.create_class({"name": "Plain"})
    assert client.get_tenants("Plain") == []
    with pytest.raises(RestError) as e:
        client.add_tenants("Plain", ["alpha"])
    assert e.value.status == 500 and "item 7" in str(e.value)


def test_rest_over_cluster(tmp_path):
    """The cluster (gossip + Raft + the internal data plane) is not
    ported: a server asked to join one raises before it serves."""
    from weaviate_tpu_torch.config import ServerConfig
    from weaviate_tpu_torch.server import Server

    for kw in ({"raft_join": ["n0", "n1", "n2"]},
               {"cluster_join": ["10.0.0.1:7946"]}):
        cfg = ServerConfig(data_path=str(tmp_path / "d"), rest_port=0,
                           grpc_port=0, disable_telemetry=True, **kw)
        srv = Server(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="item 7"):
            srv.start()
        assert srv.rest is None and srv.db is None


def test_validation_errors(client):
    with pytest.raises(RestError) as e:
        client.create_class({"name": "lowercase"})
    assert e.value.status == 422
    with pytest.raises(RestError) as e:
        client.request("POST", "/v1/objects", body={"properties": {}})
    assert e.value.status == 422
    with pytest.raises(RestError) as e:
        client.request("GET", "/v1/unknown")
    assert e.value.status == 404


def test_batch_cross_tenant_grouping(client):
    """Per-tenant batch grouping needs tenants (item 7): a tenant named on
    a plain class is ignored, as the JAX server ignores it, and every
    object lands in the class."""
    client.create_class({"name": "MTB"})
    res = client.batch_objects([
        {"class": "MTB", "tenant": "alpha", "properties": {"x": "a"}},
        {"class": "MTB", "tenant": "beta", "properties": {"x": "b"}},
    ])
    assert all(r["result"]["status"] == "SUCCESS" for r in res)
    a, b = res[0]["id"], res[1]["id"]
    assert client.get_object("MTB", a)["properties"]["x"] == "a"
    assert client.get_object("MTB", b)["properties"]["x"] == "b"


def test_patch_preserves_named_vectors_and_creation_time(client):
    client.create_class({"name": "NV", "vectors": [
        {"name": "title", "index": {"index_type": "flat"}}]})
    created = client.request("POST", "/v1/objects", body={
        "class": "NV", "properties": {"a": "one"},
        "vectors": {"title": [1.0, 2.0, 3.0]}})
    uid = created["id"]
    before = client.get_object("NV", uid)
    patched = client.patch_object("NV", uid, {"b": "two"})
    after = client.get_object("NV", uid)
    assert after["properties"] == {"a": "one", "b": "two"}
    assert after["vectors"]["title"] == [1.0, 2.0, 3.0]
    assert after["creationTimeUnix"] == before["creationTimeUnix"]


def test_schema_mixed_property_styles(client):
    """Reference-style and native-style properties may mix in one payload;
    types and index flags must survive (regression: first-entry sniffing
    coerced native entries to text)."""
    client.create_class({"name": "Mixed", "properties": [
        {"name": "a", "dataType": ["text"], "indexSearchable": False},
        {"name": "n", "data_type": "int"},
    ]})
    props = {p["name"]: p for p in client.get_class("Mixed")["properties"]}
    assert props["n"]["dataType"] == ["int"]
    assert props["a"]["indexSearchable"] is False


def test_config_from_json_reference_shape():
    """The reference's class JSON (models.Class): top-level vectorizer,
    vectorIndexType/Config, camelCase sub-configs — must parse."""
    from weaviate_tpu_torch.api.rest import config_from_json

    cfg = config_from_json({
        "class": "Doc",
        "vectorizer": "none",
        "vectorIndexType": "hnsw",
        "vectorIndexConfig": {
            "distance": "cosine", "efConstruction": 64,
            "maxConnections": 16, "pq": {"enabled": True, "segments": 8},
        },
        "invertedIndexConfig": {"bm25": {"k1": 1.4, "b": 0.6}},
        "shardingConfig": {"desiredCount": 2},
        "multiTenancyConfig": {"enabled": True},
        "replicationConfig": {"factor": 3},
        "moduleConfig": {"generative-openai": {}},
        "properties": [{"name": "title", "dataType": ["text"]}],
    })
    v = cfg.vector_config("")
    assert v.index.index_type == "hnsw"
    assert v.index.metric == "cosine"
    assert v.index.quantization == "pq" and v.index.pq_segments == 8
    assert v.index.ef_construction == 64 and v.index.max_connections == 16
    assert cfg.inverted.bm25_k1 == 1.4 and cfg.inverted.bm25_b == 0.6
    assert cfg.sharding.desired_count == 2
    assert cfg.multi_tenancy.enabled
    assert cfg.replication.factor == 3
    assert "generative-openai" in cfg.module_config


def test_config_from_json_named_vectors():
    from weaviate_tpu_torch.api.rest import config_from_json

    cfg = config_from_json({
        "class": "Multi",
        "vectorConfig": {
            "title": {"vectorizer": {"text2vec-hash": {"dim": 64}},
                      "vectorIndexType": "flat"},
            "body": {"vectorizer": {"none": {}}},
        },
    })
    t = cfg.vector_config("title")
    assert t.vectorizer == "text2vec-hash"
    assert t.module_config == {"dim": 64}
    assert cfg.vector_config("body").vectorizer == "none"


def test_patch_revectorizes_changed_text(tmp_path):
    """PATCH that edits text of a vectorizer-backed class must re-embed the
    merged properties, not carry the stale vector forward (reference
    re-vectorizes on merge)."""
    from weaviate_tpu_torch.modules import Provider
    from weaviate_tpu_torch.modules.text2vec_hash import HashVectorizer

    db = Database(str(tmp_path), device="cpu")
    provider = Provider(db).register(HashVectorizer())
    srv = RestServer(db, modules=provider)
    srv.start()
    try:
        c = Client(srv.address)
        c.create_class({
            "class": "Note", "vectorizer": "text2vec-hash",
            "properties": [{"name": "body", "dataType": ["text"]}],
        })
        created = c.create_object("Note", {"body": "alpha"})
        uid = created["id"]
        v0 = c.get_object("Note", uid)["vector"]
        c.patch_object("Note", uid, {"body": "completely different"})
        v1 = c.get_object("Note", uid)["vector"]
        assert v0 != v1, "stale embedding survived a text-changing PATCH"
    finally:
        srv.stop()
        db.close()


def test_batch_delete_rest(client):
    client.create_class({"class": "BD", "properties": [
        {"name": "n", "data_type": "int"}]})
    for i in range(10):
        client.create_object("BD", {"n": i}, vector=[float(i), 1.0])
    # dry run counts without deleting
    out = client.request("DELETE", "/v1/batch/objects", body={
        "match": {"class": "BD",
                  "where": {"path": ["n"], "operator": "GreaterThanEqual",
                            "valueInt": 5}},
        "dryRun": True})
    assert out["results"]["matches"] == 5
    assert len(client.list_objects("BD", limit=25)["objects"]) == 10
    # real delete
    out = client.request("DELETE", "/v1/batch/objects", body={
        "match": {"class": "BD",
                  "where": {"path": ["n"], "operator": "GreaterThanEqual",
                            "valueInt": 5}},
        "output": "verbose"})
    assert out["results"]["successful"] == 5
    assert len(out["results"]["objects"]) == 5
    assert len(client.list_objects("BD", limit=25)["objects"]) == 5
    from weaviate_tpu_torch.api.client import RestError
    with pytest.raises(RestError) as e:
        client.request("DELETE", "/v1/batch/objects", body={"match": {}})
    assert e.value.status == 422


def test_update_class_config(client):
    client.create_class({"class": "UC", "properties": [
        {"name": "t", "data_type": "text"}]})
    # mutable: bm25 params, description, replication factor stays 1
    out = client.request("PUT", "/v1/schema/UC", body={
        "class": "UC",
        "description": "updated",
        "invertedIndexConfig": {"bm25": {"k1": 1.5, "b": 0.5}},
    })
    assert out["description"] == "updated"
    assert out["invertedIndexConfig"]["bm25"]["k1"] == 1.5
    # immutable: vectorizer change rejected
    from weaviate_tpu_torch.api.client import RestError
    with pytest.raises(RestError) as e:
        client.request("PUT", "/v1/schema/UC", body={
            "class": "UC", "vectorizer": "text2vec-hash"})
    assert e.value.status == 422


def test_shard_status_endpoints(client):
    client.create_class({"class": "SH", "properties": [
        {"name": "n", "data_type": "int"}]})
    client.create_object("SH", {"n": 1}, vector=[1.0, 2.0])
    shards = client.request("GET", "/v1/schema/SH/shards")
    assert shards[0]["status"] == "READY"
    name = shards[0]["name"]
    client.request("PUT", f"/v1/schema/SH/shards/{name}",
                   body={"status": "READONLY"})
    from weaviate_tpu_torch.api.client import RestError
    with pytest.raises(RestError):  # writes refused while readonly
        client.create_object("SH", {"n": 2}, vector=[1.0, 2.0])
    # reads still work
    assert client.list_objects("SH", limit=5)["objects"]
    client.request("PUT", f"/v1/schema/SH/shards/{name}",
                   body={"status": "READY"})
    client.create_object("SH", {"n": 3}, vector=[3.0, 4.0])


def test_shard_readonly_survives_restart(tmp_path):
    from weaviate_tpu_torch.db.database import Database

    db = Database(str(tmp_path), device="cpu")
    db.create_collection(config_from_json_for_test := __import__(
        "weaviate_tpu_torch.api.rest", fromlist=["config_from_json"]
    ).config_from_json({"class": "RS", "properties": [
        {"name": "n", "dataType": ["int"]}]}))
    col = db.get_collection("RS")
    col.put_object({"n": 1}, vector=[1.0])
    col._load_shard("shard-0").set_read_only(True)
    db.close()

    db2 = Database(str(tmp_path), device="cpu")
    col2 = db2.get_collection("RS")
    assert col2._load_shard("shard-0").read_only is True
    import pytest as _pytest
    from weaviate_tpu_torch.db.shard import ShardReadOnlyError

    with _pytest.raises(ShardReadOnlyError):
        col2.put_object({"n": 2}, vector=[2.0])
    db2.close()


def test_update_class_runtime_knobs_reach_live_objects(client, server):
    client.create_class({"class": "RT", "properties": [
        {"name": "t", "data_type": "text"}]})
    client.create_object("RT", {"t": "x"}, vector=[1.0])
    col = server.db.get_collection("RT")
    shard = col._load_shard("shard-0")
    assert shard._inverted.k1 == 1.2
    client.request("PUT", "/v1/schema/RT", body={
        "invertedIndexConfig": {"bm25": {"k1": 1.7, "b": 0.4}}})
    assert shard._inverted.k1 == 1.7
    assert shard._inverted.b == 0.4


def test_nodes_verbose_shard_details(client):
    client.create_class({"class": "NV", "properties": [
        {"name": "n", "data_type": "int"}]})
    client.create_object("NV", {"n": 1}, vector=[1.0])
    out = client.request("GET", "/v1/nodes", params={"output": "verbose"})
    node = out["nodes"][0]
    assert "shards" in node
    sh = [s for s in node["shards"] if s["class"] == "NV"]
    assert sh and sh[0]["objectCount"] == 1
    assert sh[0]["vectorIndexingStatus"] == "READY"


def test_legacy_classless_object_routes(client):
    client.create_class({"class": "LG", "properties": [
        {"name": "t", "data_type": "text"}]})
    uid = client.create_object("LG", {"t": "x"}, vector=[1.0])["id"]
    # deprecated GET /v1/objects/{id} (no class) still resolves
    got = client.request("GET", f"/v1/objects/{uid}")
    assert got["class"] == "LG" and got["id"] == uid
    client.request("DELETE", f"/v1/objects/{uid}")
    from weaviate_tpu_torch.api.client import RestError
    with pytest.raises(RestError) as e:
        client.request("GET", f"/v1/objects/{uid}")
    assert e.value.status == 404


def test_legacy_classless_patch(client):
    client.create_class({"class": "LP", "properties": [
        {"name": "t", "data_type": "text"}]})
    uid = client.create_object("LP", {"t": "x"}, vector=[1.0])["id"]
    out = client.request("PATCH", f"/v1/objects/{uid}",
                         body={"properties": {"extra": "y"}})
    assert out["properties"] == {"t": "x", "extra": "y"}


def test_request_body_validation(server):
    """Structural 422s with field-path messages (reference: go-swagger
    validates against embedded_spec.go before handlers run)."""
    base = f"http://{server.address}" if "://" not in server.address         else server.address
    import json
    import urllib.error
    import urllib.request

    def post(path, payload):
        req = urllib.request.Request(
            f"{base}{path}", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    # malformed object: properties must be an object, vector numeric
    status, out = post("/v1/objects", {
        "class": "Article", "properties": ["not", "a", "dict"],
        "vector": "nope"})
    assert status == 422, (status, out)
    msg = out["error"][0]["message"]
    assert "properties" in msg and "vector" in msg  # ALL errors listed

    # malformed schema: property missing dataType
    status, out = post("/v1/schema", {
        "class": "Broken",
        "properties": [{"name": "x"}]})
    assert status == 422, (status, out)
    assert "dataType" in out["error"][0]["message"]

    # schema: class required
    status, out = post("/v1/schema", {"properties": []})
    assert status == 422
    assert "class is required" in out["error"][0]["message"]

    # batch: objects must be a list of objects
    status, out = post("/v1/batch/objects", {"objects": "nope"})
    assert status == 422

    # malformed id
    status, out = post("/v1/objects", {
        "class": "Article", "id": "not-a-uuid", "properties": {}})
    assert status == 422
    assert "uuid" in out["error"][0]["message"]
