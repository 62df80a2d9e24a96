"""Multi-tenancy on one node: the port held to the JAX package's oracles.

Every scenario below is one of the JAX package's tenant tests
(tests/test_tenant_offload.py, test_db.py::test_auto_tenant_creation_persists,
test_rest_api.py::test_multi_tenant_rest and ::test_batch_cross_tenant_grouping,
test_grpc_api.py::test_tenants_get), written once against a package
namespace and run through both packages on the same seeded numpy inputs
(``device="cpu"`` for the port). Each run keeps the oracle's own asserts
and returns what it observed; the two observations must agree: ids equal,
distances within rtol 2e-4 / atol 2e-3 (the reference's own kernel
tolerance, tests/test_pallas_kernels.py:32). The port's own cases follow:
tenant-scoped answers against a one-tenant collection, the manifest
path-escape refusal, the roll-back of a failed freeze, and the device
memory a COLD or FROZEN tenant gives back.
"""

import json
import os
import tempfile

import numpy as np
import pytest

RTOL, ATOL = 2e-4, 2e-3


@pytest.fixture(autouse=True)
def _port_planes_isolation():
    yield
    from weaviate_tpu_torch.runtime import (degrade, driftwatch, kernelscope,
                                            tailboard)

    kernelscope.reset_for_tests()
    driftwatch.reset_for_tests()
    tailboard.reset_for_tests()
    degrade.reset()


class _Pkg:
    """One package's tenant surface, so a scenario runs the same calls
    through either."""

    def __init__(self, which: str):
        self.which = which
        if which == "jax":
            from weaviate_tpu.api import rest
            from weaviate_tpu.api.client import Client, RestError
            from weaviate_tpu.api.grpc import v1_pb2
            from weaviate_tpu.api.grpc.server import GrpcServer
            from weaviate_tpu import filters
            from weaviate_tpu.db.database import Database
            from weaviate_tpu.modules.backup_backends import FilesystemBackend
            from weaviate_tpu.runtime.hbm_ledger import ledger
            from weaviate_tpu.schema import config
            self.open = lambda d: Database(str(d))
        else:
            from weaviate_tpu_torch.api import rest
            from weaviate_tpu_torch.api.client import Client, RestError
            from weaviate_tpu_torch.api.grpc import v1_pb2
            from weaviate_tpu_torch.api.grpc.server import GrpcServer
            from weaviate_tpu_torch import filters
            from weaviate_tpu_torch.db.database import Database
            from weaviate_tpu_torch.modules.backup_backends import \
                FilesystemBackend
            from weaviate_tpu_torch.runtime.hbm_ledger import ledger
            from weaviate_tpu_torch.schema import config
            self.open = lambda d: Database(str(d), device="cpu")
        self.rest = rest
        self.Client, self.RestError = Client, RestError
        self.pb, self.GrpcServer = v1_pb2, GrpcServer
        self.FilesystemBackend = FilesystemBackend
        self.filters = filters
        self.ledger = ledger
        self.config = config

    def mt_config(self, auto_activation=False):
        return self.rest.config_from_json({
            "class": "MT",
            "multiTenancyConfig": {"enabled": True,
                                   "autoTenantActivation": auto_activation},
            "properties": [{"name": "p", "dataType": ["text"]}]})

    def serve(self, db):
        srv = self.rest.RestServer(db)
        srv.start()
        return srv, self.Client(srv.address)


def _both(scenario):
    """Run ``scenario(pkg, tmpdir)`` through each package; returns the
    two observations (JAX first)."""
    out = []
    for which in ("jax", "torch"):
        with tempfile.TemporaryDirectory() as d:
            out.append(scenario(_Pkg(which), d))
    return out


def _hits(results):
    return ([r.uuid for r in results],
            np.asarray([r.distance for r in results], np.float64))


def _same(a, b):
    """Observations agree: hit lists by uuid exactly and distance within
    the tolerance; everything else equal."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple) and len(a) == 2 and isinstance(a[1], np.ndarray):
        assert a[0] == b[0]
        np.testing.assert_allclose(b[1], a[1], rtol=RTOL, atol=ATOL)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def _uuid(i: int) -> str:
    return f"00000000-0000-4000-8000-{i:012d}"


# -- the JAX package's oracles ---------------------------------------------------


def _cold_tenant_unloads_and_rejects(pkg, d):
    db = pkg.open(d)
    try:
        db.create_collection(pkg.mt_config())
        db.add_tenants("MT", ["acme"])
        col = db.get_collection("MT")
        rng = np.random.default_rng(3)
        vecs = rng.standard_normal((12, 8)).astype(np.float32)
        for i, v in enumerate(vecs):
            col.put_object({"p": f"x{i}"}, vector=v, uuid=_uuid(i),
                           tenant="acme")
        assert "acme" in col.shards  # loaded
        q = rng.standard_normal(8).astype(np.float32)
        before = _hits(col.near_vector(q, k=5, tenant="acme"))
        col.set_tenant_status("acme", "COLD")
        db._persist(col)
        assert "acme" not in col.shards  # unloaded from device memory
        with pytest.raises(ValueError):
            col.near_vector(q, k=1, tenant="acme")
        with pytest.raises(ValueError):
            col.put_object({"p": "y"}, vector=vecs[0], tenant="acme")
        # reactivate: data intact
        col.set_tenant_status("acme", "HOT")
        after = _hits(col.near_vector(q, k=5, tenant="acme"))
        assert after[0] == before[0]
        return {"before": before, "after": after}
    finally:
        db.close()


def _cold_survives_restart_and_stays_unloaded(pkg, d):
    db = pkg.open(d)
    db.create_collection(pkg.mt_config())
    db.add_tenants("MT", ["a", "b"])
    col = db.get_collection("MT")
    col.put_object({"p": "x"}, vector=[1.0], tenant="a")
    col.put_object({"p": "y"}, vector=[2.0], tenant="b")
    col.set_tenant_status("b", "COLD")
    db._persist(col)
    db.close()

    db2 = pkg.open(d)
    try:
        col2 = db2.get_collection("MT")
        assert "a" in col2.shards
        assert "b" not in col2.shards  # COLD stays unloaded at startup
        assert col2.sharding.status_of("b") == "COLD"
        return {"shards": sorted(col2.shards),
                "status": {t: col2.sharding.status_of(t)
                           for t in col2.tenants()}}
    finally:
        db2.close()


def _auto_tenant_activation(pkg, d):
    db = pkg.open(d)
    try:
        db.create_collection(pkg.mt_config(auto_activation=True))
        db.add_tenants("MT", ["acme"])
        col = db.get_collection("MT")
        col.put_object({"p": "x"}, vector=[1.0], uuid=_uuid(1),
                       tenant="acme")
        col.set_tenant_status("acme", "COLD")
        # access auto-activates instead of failing
        res = col.near_vector(np.asarray([1.0]), k=1, tenant="acme")
        assert len(res) == 1
        assert col.sharding.status_of("acme") == "HOT"
        return {"hits": _hits(res)}
    finally:
        db.close()


def _tenant_status_rest(pkg, d):
    db = pkg.open(d)
    srv, c = pkg.serve(db)
    try:
        c.create_class({"class": "MT",
                        "multiTenancyConfig": {"enabled": True},
                        "properties": [{"name": "p", "dataType": ["text"]}]})
        c.add_tenants("MT", ["t1", "t2"])
        listed = c.request("GET", "/v1/schema/MT/tenants")
        assert {t["name"]: t["activityStatus"] for t in listed} == \
            {"t1": "HOT", "t2": "HOT"}
        out = c.request("PUT", "/v1/schema/MT/tenants", body=[
            {"name": "t2", "activityStatus": "COLD"}])
        assert out[0]["activityStatus"] == "COLD"
        with pytest.raises(pkg.RestError) as e:
            c.create_object("MT", {"p": "x"}, vector=[1.0], tenant="t2")
        assert e.value.status == 422
        with pytest.raises(pkg.RestError) as e2:
            c.request("PUT", "/v1/schema/MT/tenants", body=[
                {"name": "t2", "activityStatus": "LUKEWARM"}])
        return {"listed": listed, "put": out, "cold_write": e.value.status,
                "bad_status": e2.value.status}
    finally:
        srv.stop()
        db.close()


def _objects_validate_endpoint(pkg, d):
    db = pkg.open(d)
    srv, c = pkg.serve(db)
    try:
        c.create_class({"class": "V", "properties": [
            {"name": "t", "dataType": ["text"]}]})
        c.request("POST", "/v1/objects/validate",
                  body={"class": "V", "properties": {"t": "ok"},
                        "vector": [1.0, 2.0]})
        with pytest.raises(pkg.RestError) as e:
            c.request("POST", "/v1/objects/validate",
                      body={"class": "V", "properties": {"nope": 1}})
        assert e.value.status == 422
        with pytest.raises(pkg.RestError) as e2:
            c.request("POST", "/v1/objects/validate",
                      body={"class": "Missing", "properties": {}})
        assert e2.value.status == 404
        return {"codes": [e.value.status, e2.value.status]}
    finally:
        srv.stop()
        db.close()


def _partial_class_update_preserves_omitted_fields(pkg, d):
    db = pkg.open(d)
    srv, c = pkg.serve(db)
    try:
        c.create_class({
            "class": "PU", "vectorizer": "text2vec-bigram",
            "moduleConfig": {"text2vec-bigram": {"dim": 64}},
            "invertedIndexConfig": {"bm25": {"k1": 1.9, "b": 0.2}},
            "properties": [{"name": "t", "dataType": ["text"]}]})
        out = c.request("PUT", "/v1/schema/PU",
                        body={"description": "updated"})
        assert out["description"] == "updated"
        assert out["invertedIndexConfig"]["bm25"]["k1"] == 1.9  # untouched
        assert out["vectorizer"] == "text2vec-bigram"  # untouched
        assert out["moduleConfig"] == {"text2vec-bigram": {"dim": 64}}
        return {"class": out}
    finally:
        srv.stop()
        db.close()


def _shards_listing_does_not_load_cold_tenants(pkg, d):
    db = pkg.open(d)
    srv, c = pkg.serve(db)
    try:
        c.create_class({"class": "MT",
                        "multiTenancyConfig": {"enabled": True},
                        "properties": [{"name": "p", "dataType": ["text"]}]})
        c.add_tenants("MT", ["hot1", "cold1"])
        c.create_object("MT", {"p": "x"}, vector=[1.0], tenant="cold1")
        c.request("PUT", "/v1/schema/MT/tenants", body=[
            {"name": "cold1", "activityStatus": "COLD"}])
        col = db.get_collection("MT")
        assert "cold1" not in col.shards
        shards = c.request("GET", "/v1/schema/MT/shards")
        by_name = {s["name"]: s["status"] for s in shards}
        assert by_name["cold1"] == "COLD"
        assert by_name["hot1"] == "READY"
        assert "cold1" not in col.shards  # listing did NOT load it
        with pytest.raises(pkg.RestError) as e:
            c.request("PUT", "/v1/schema/MT/shards/cold1",
                      body={"status": "READONLY"})
        assert e.value.status == 422
        return {"shards": by_name, "readonly": e.value.status}
    finally:
        srv.stop()
        db.close()


def _frozen_tenant_offloads_files_and_unfreezes(pkg, d):
    from pathlib import Path

    tmp_path = Path(d)
    c = pkg.config
    db = pkg.open(tmp_path / "data")
    backend = pkg.FilesystemBackend()
    backend.init({"path": str(tmp_path / "offload")})
    db.set_offload_backend(backend)
    try:
        col = db.create_collection(c.CollectionConfig(
            name="FZ", properties=[c.Property(name="t", data_type="text")],
            multi_tenancy=c.MultiTenancyConfig(enabled=True)))
        col.add_tenant("acme")
        rng = np.random.default_rng(0)
        uuids = [col.put_object(
            {"t": f"doc {i}"}, uuid=_uuid(i),
            vector=rng.standard_normal(8).astype(np.float32),
            tenant="acme") for i in range(20)]
        q = rng.standard_normal(8).astype(np.float32)
        before = _hits(col.near_vector(q, k=5, tenant="acme"))

        col.set_tenant_status("acme", "FROZEN")
        assert not (tmp_path / "data" / "FZ" / "acme").exists()
        assert "acme" not in col.shards
        with pytest.raises(ValueError, match="FROZEN"):
            col.get_object(uuids[0], tenant="acme")
        offload_files = []
        for _root, _dirs, files in os.walk(tmp_path / "offload"):
            offload_files += files
        assert any(f.endswith(".gz") for f in offload_files)

        col.set_tenant_status("acme", "HOT")
        obj = col.get_object(uuids[3], tenant="acme")
        assert obj is not None and obj.properties["t"] == "doc 3"
        after = _hits(col.near_vector(q, k=5, tenant="acme"))
        assert after[0] == before[0]
        return {"before": before, "after": after,
                "offloaded": "manifest.json" in offload_files}
    finally:
        db.close()


def _auto_tenant_creation_persists(pkg, d):
    c = pkg.config
    rng = np.random.default_rng(42)
    db = pkg.open(d)
    db.create_collection(c.CollectionConfig(
        name="Article",
        properties=[c.Property(name="title", data_type="text")],
        multi_tenancy=c.MultiTenancyConfig(enabled=True,
                                           auto_tenant_creation=True)))
    col = db.get_collection("Article")
    col.put_object({"title": "x"}, uuid=_uuid(7),
                   vector=rng.standard_normal(8).astype(np.float32),
                   tenant="auto-t")
    db.flush()
    db.close()
    db2 = pkg.open(d)
    try:
        col2 = db2.get_collection("Article")
        assert "auto-t" in col2.tenants()
        assert col2.object_count(tenant="auto-t") == 1
        with pytest.raises(KeyError):
            col2.get_object(_uuid(7), tenant="nobody")
        return {"tenants": col2.tenants(),
                "count": col2.object_count(tenant="auto-t")}
    finally:
        db2.close()


def _multi_tenant_rest(pkg, d):
    db = pkg.open(d)
    srv, client = pkg.serve(db)
    try:
        client.create_class({"name": "MT",
                             "multi_tenancy": {"enabled": True}})
        client.add_tenants("MT", ["alpha", "beta"])
        names = {t["name"] for t in client.get_tenants("MT")}
        assert names == {"alpha", "beta"}
        created = client.create_object("MT", {"x": 1}, vector=[1.0, 0.0],
                                       tenant="alpha")
        got = client.get_object("MT", created["id"], tenant="alpha")
        assert got["properties"]["x"] == 1
        with pytest.raises(pkg.RestError) as e:
            client.get_object("MT", created["id"], tenant="beta")
        return {"names": sorted(names), "x": got["properties"]["x"],
                "other_tenant": e.value.status}
    finally:
        srv.stop()
        db.close()


def _batch_cross_tenant_grouping(pkg, d):
    db = pkg.open(d)
    srv, client = pkg.serve(db)
    try:
        client.create_class({"name": "MTB",
                             "multi_tenancy": {"enabled": True}})
        client.add_tenants("MTB", ["alpha", "beta"])
        res = client.batch_objects([
            {"class": "MTB", "tenant": "alpha", "properties": {"x": "a"}},
            {"class": "MTB", "tenant": "beta", "properties": {"x": "b"}},
        ])
        assert all(r["result"]["status"] == "SUCCESS" for r in res)
        a, b = res[0]["id"], res[1]["id"]
        xa = client.get_object("MTB", a, tenant="alpha")["properties"]["x"]
        xb = client.get_object("MTB", b, tenant="beta")["properties"]["x"]
        assert (xa, xb) == ("a", "b")
        with pytest.raises(pkg.RestError) as e:
            client.get_object("MTB", b, tenant="alpha")
        return {"x": [xa, xb], "other_tenant": e.value.status,
                "counts": [db.get_collection("MTB").object_count(tenant=t)
                           for t in ("alpha", "beta")]}
    finally:
        srv.stop()
        db.close()


def _tenants_get(pkg, d):
    import grpc

    c = pkg.config
    db = pkg.open(d)
    srv = pkg.GrpcServer(db, port=0).start()
    chan = grpc.insecure_channel(f"127.0.0.1:{srv.port}")
    pb = pkg.pb
    tenants_get = chan.unary_unary(
        "/weaviate.v1.Weaviate/TenantsGet",
        request_serializer=pb.TenantsGetRequest.SerializeToString,
        response_deserializer=pb.TenantsGetReply.FromString)
    try:
        db.create_collection(c.CollectionConfig(
            name="MT", properties=[c.Property(name="t", data_type="text")],
            multi_tenancy=c.MultiTenancyConfig(enabled=True)))
        db.add_tenants("MT", ["alice", "bob"])
        reply = tenants_get(pb.TenantsGetRequest(collection="MT"))
        names = [t.name for t in reply.tenants]
        assert names == ["alice", "bob"]
        assert all(t.activity_status == pkg.pb.TENANT_ACTIVITY_STATUS_HOT
                   for t in reply.tenants)
        req = pkg.pb.TenantsGetRequest(collection="MT")
        req.names.values.append("bob")
        named = [t.name for t in tenants_get(req).tenants]
        assert named == ["bob"]
        db.update_tenant_status("MT", [{"name": "bob",
                                        "activityStatus": "COLD"}])
        statuses = [int(t.activity_status) for t in
                    tenants_get(pb.TenantsGetRequest(
                        collection="MT")).tenants]
        return {"names": names, "named": named, "statuses": statuses}
    finally:
        chan.close()
        srv.stop()
        db.close()


ORACLES = {
    "cold_tenant_unloads_and_rejects": _cold_tenant_unloads_and_rejects,
    "cold_survives_restart_and_stays_unloaded":
        _cold_survives_restart_and_stays_unloaded,
    "auto_tenant_activation": _auto_tenant_activation,
    "tenant_status_rest": _tenant_status_rest,
    "objects_validate_endpoint": _objects_validate_endpoint,
    "partial_class_update_preserves_omitted_fields":
        _partial_class_update_preserves_omitted_fields,
    "shards_listing_does_not_load_cold_tenants":
        _shards_listing_does_not_load_cold_tenants,
    "frozen_tenant_offloads_files_and_unfreezes":
        _frozen_tenant_offloads_files_and_unfreezes,
    "auto_tenant_creation_persists": _auto_tenant_creation_persists,
    "multi_tenant_rest": _multi_tenant_rest,
    "batch_cross_tenant_grouping": _batch_cross_tenant_grouping,
    "tenants_get": _tenants_get,
}


@pytest.mark.parametrize("oracle", sorted(ORACLES))
def test_oracle_parity(oracle):
    """The JAX oracle passes through both packages, and the port observes
    what the JAX package observes."""
    ref, got = _both(ORACLES[oracle])
    _same(ref, got)


# -- the port's own cases ---------------------------------------------------------


def test_tenant_answers_equal_one_tenant_collections():
    """A tenant-scoped nearVector (with and without a filter) answers as a
    collection holding only that tenant's rows, in the port and in the JAX
    package; tenants never see each other's rows."""
    def scenario(pkg, d):
        c = pkg.config
        rng = np.random.default_rng(29)
        db = pkg.open(d)
        try:
            vc = [c.VectorConfig(index=c.VectorIndexConfig(
                index_type="flat", metric="cosine"))]
            props = [c.Property(name="n", data_type="int")]
            mt = db.create_collection(c.CollectionConfig(
                name="Tn", properties=props, vectors=vc,
                multi_tenancy=c.MultiTenancyConfig(enabled=True)))
            tenants = [f"t{i}" for i in range(4)]
            db.add_tenants("Tn", tenants)
            out = {}
            for ti, t in enumerate(tenants):
                vecs = rng.standard_normal((40, 16)).astype(np.float32)
                objs = [{"uuid": _uuid(1000 * ti + i), "properties": {"n": i},
                         "vector": vecs[i]} for i in range(40)]
                assert all(r["status"] == "SUCCESS"
                           for r in mt.batch_put(objs, tenant=t))
                solo = db.create_collection(c.CollectionConfig(
                    name=f"Solo{ti}", properties=props, vectors=vc))
                solo.batch_put(objs)
                where = pkg.filters.Filter.where(
                    "n", pkg.filters.Operator.LESS_THAN, 20)
                for qi, q in enumerate(rng.standard_normal((3, 16))
                                       .astype(np.float32)):
                    for w in (None, where):
                        a = _hits(mt.near_vector(q, k=7, tenant=t, where=w,
                                                 include_objects=False))
                        b = _hits(solo.near_vector(q, k=7, where=w,
                                                   include_objects=False))
                        assert a[0] == b[0]
                        np.testing.assert_array_equal(a[1], b[1])
                        assert all(int(u[-12:]) // 1000 == ti for u in a[0])
                        out[f"{t}/{qi}/{w is not None}"] = a
            return out
        finally:
            db.close()

    ref, got = _both(scenario)
    _same(ref, got)


def _frozen_db(tmp_path, backend_cls=None):
    from weaviate_tpu_torch.db.database import Database
    from weaviate_tpu_torch.modules.backup_backends import FilesystemBackend
    from weaviate_tpu_torch.schema.config import (CollectionConfig,
                                                  MultiTenancyConfig, Property)

    db = Database(str(tmp_path / "data"), device="cpu")
    backend = (backend_cls or FilesystemBackend)()
    backend.init({"path": str(tmp_path / "offload")})
    db.set_offload_backend(backend)
    col = db.create_collection(CollectionConfig(
        name="FZ", properties=[Property(name="t", data_type="text")],
        multi_tenancy=MultiTenancyConfig(enabled=True)))
    col.add_tenant("acme")
    rng = np.random.default_rng(5)
    for i in range(10):
        col.put_object({"t": f"doc {i}"}, uuid=_uuid(i), tenant="acme",
                       vector=rng.standard_normal(8).astype(np.float32))
    return db, col, backend


def test_manifest_path_escape_is_refused():
    """A thaw whose offload manifest names a path outside the tenant's
    shard directory is refused before it writes anything there, and the
    tenant stays FROZEN, in both packages."""
    def scenario(pkg, d):
        from pathlib import Path

        tmp = Path(d)
        c = pkg.config
        db = pkg.open(tmp / "data")
        backend = pkg.FilesystemBackend()
        backend.init({"path": str(tmp / "offload")})
        db.set_offload_backend(backend)
        try:
            col = db.create_collection(c.CollectionConfig(
                name="FZ", properties=[c.Property(name="t", data_type="text")],
                multi_tenancy=c.MultiTenancyConfig(enabled=True)))
            col.add_tenant("acme")
            col.put_object({"t": "doc"}, uuid=_uuid(1), tenant="acme",
                           vector=np.ones(8, np.float32))
            col.set_tenant_status("acme", "FROZEN")
            oid = col._offload_id("acme")
            escape = "../../escaped.txt"
            backend.put(oid, "manifest.json",
                        json.dumps({"files": [escape]}).encode())
            with pytest.raises(ValueError, match="escapes the shard") as e:
                col.set_tenant_status("acme", "HOT")
            assert col.sharding.status_of("acme") == "FROZEN"
            assert "acme" not in col.shards
            assert not (tmp / "data" / "escaped.txt").exists()
            assert not (tmp / "escaped.txt").exists()
            return {"error": str(e.value),
                    "status": col.sharding.status_of("acme")}
        finally:
            db.close()

    ref, got = _both(scenario)
    _same(ref, got)


def test_failed_freeze_rolls_back_to_hot(tmp_path):
    """A freeze whose backend fails leaves the tenant in its previous
    state (HOT, files on disk, answers unchanged), in both packages; a
    missing backend refuses FROZEN before anything moves."""
    def scenario(pkg, d):
        from pathlib import Path

        tmp = Path(d)
        c = pkg.config

        class Failing(pkg.FilesystemBackend):
            def put_file(self, backup_id, key, src_path):
                raise OSError("offload store unavailable")

        db = pkg.open(tmp / "data")
        try:
            col = db.create_collection(c.CollectionConfig(
                name="FZ", properties=[c.Property(name="t", data_type="text")],
                multi_tenancy=c.MultiTenancyConfig(enabled=True)))
            col.add_tenant("acme")
            rng = np.random.default_rng(5)
            for i in range(10):
                col.put_object({"t": f"doc {i}"}, uuid=_uuid(i),
                               tenant="acme",
                               vector=rng.standard_normal(8).astype(np.float32))
            q = rng.standard_normal(8).astype(np.float32)
            before = _hits(col.near_vector(q, k=4, tenant="acme"))
            with pytest.raises(RuntimeError, match="offload backend"):
                col.set_tenant_status("acme", "FROZEN")
            assert col.sharding.status_of("acme") == "HOT"
            backend = Failing()
            backend.init({"path": str(tmp / "offload")})
            db.set_offload_backend(backend)
            with pytest.raises(OSError, match="unavailable"):
                col.set_tenant_status("acme", "FROZEN")
            assert col.sharding.status_of("acme") == "HOT"
            assert (tmp / "data" / "FZ" / "acme").is_dir()
            after = _hits(col.near_vector(q, k=4, tenant="acme"))
            assert after[0] == before[0]
            return {"before": before, "after": after}
        finally:
            db.close()

    ref, got = _both(scenario)
    _same(ref, got)


@pytest.mark.parametrize("status", ["COLD", "FROZEN"])
def test_offloaded_tenant_releases_device_memory(tmp_path, status):
    """A COLD or FROZEN tenant's stores leave the device: the ledger drops
    by the tenant's footprint, its canary and batcher are gone (nothing
    that holds the tensors survives the shard's close), and HOT brings
    the same answers back."""
    import gc

    from weaviate_tpu_torch.runtime import driftwatch
    from weaviate_tpu_torch.runtime.hbm_ledger import ledger

    db, col, _ = _frozen_db(tmp_path)
    try:
        col.add_tenant("other")
        col.put_object({"t": "o"}, vector=np.ones(8, np.float32),
                       tenant="other")
        q = np.linspace(-1, 1, 8).astype(np.float32)
        before = _hits(col.near_vector(q, k=5, tenant="acme"))
        gc.collect()  # earlier tests' garbage must not move the total
        tenant_bytes = ledger.shard_bytes("FZ", "acme")
        assert tenant_bytes > 0
        total0 = ledger.total_bytes()
        assert any(k.startswith("FZ/acme/") for k in driftwatch._canaries)
        col.set_tenant_status("acme", status)
        # released when the collection lets go of the shard: no gc pass
        assert ledger.shard_bytes("FZ", "acme") == 0
        assert ledger.total_bytes() == total0 - tenant_bytes
        assert not any(k.startswith("FZ/acme/") for k in driftwatch._canaries)
        assert any(k.startswith("FZ/other/") for k in driftwatch._canaries)
        col.set_tenant_status("acme", "HOT")
        after = _hits(col.near_vector(q, k=5, tenant="acme"))
        assert after[0] == before[0]
        np.testing.assert_array_equal(after[1], before[1])
        assert ledger.shard_bytes("FZ", "acme") == tenant_bytes
    finally:
        db.close()


def test_tenant_meter_labels_and_remove(tmp_path):
    """Each tenant shard's batcher meters under its own tenant label; a
    removed tenant leaves the sharding state and its shard closes."""
    from weaviate_tpu_torch.db.database import Database
    from weaviate_tpu_torch.runtime import kernelscope
    from weaviate_tpu_torch.schema.config import (CollectionConfig,
                                                  MultiTenancyConfig)

    db = Database(str(tmp_path), device="cpu")
    try:
        col = db.create_collection(CollectionConfig(
            name="Mt", multi_tenancy=MultiTenancyConfig(enabled=True)))
        db.add_tenants("Mt", ["a", "b", "c"])
        rng = np.random.default_rng(9)
        for t in ("a", "b", "c"):
            col.batch_put([{"vector": v} for v in
                           rng.standard_normal((16, 8)).astype(np.float32)],
                          tenant=t)
        for _ in range(3):
            col.near_vector(rng.standard_normal(8).astype(np.float32), k=3,
                            tenant="a")
        col.near_vector(rng.standard_normal(8).astype(np.float32), k=3,
                        tenant="b")
        meters = kernelscope.meters_snapshot()
        assert meters.get(("Mt", "a"), 0) > 0 and meters.get(("Mt", "b"), 0) > 0
        assert ("Mt", "c") not in meters
        assert sum(meters.values()) == pytest.approx(
            kernelscope.total_device_seconds(), rel=1e-9)
        db.remove_tenants("Mt", ["c"])
        assert col.tenants() == ["a", "b"] and "c" not in col.shards
        with pytest.raises(KeyError):
            col.near_vector(np.ones(8, np.float32), k=1, tenant="c")
        with pytest.raises(ValueError, match="requires a tenant"):
            col.near_vector(np.ones(8, np.float32), k=1)
    finally:
        db.close()
