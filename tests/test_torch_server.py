"""The port's copy of tests/test_server.py (CPU ``Database``).

Server entry point + config tests: full assembly over real sockets.

Reference pattern: the acceptance suite boots the real server binary;
here Server.start() is driven in-process against ephemeral ports.
"""

import json
import urllib.request

import numpy as np
import pytest

from weaviate_tpu_torch.config import ServerConfig
from weaviate_tpu_torch.server import Server


def test_config_from_env_defaults():
    cfg = ServerConfig.from_env(env={})
    assert cfg.data_path == "./data"
    assert cfg.rest_port == 8080
    assert cfg.query_defaults_limit == 25
    assert not cfg.async_indexing
    assert cfg.enabled_modules is None


def test_config_from_env_full():
    cfg = ServerConfig.from_env(env={
        "PERSISTENCE_DATA_PATH": "/tmp/wv",
        "PORT": "8181",
        "GRPC_PORT": "50052",
        "QUERY_DEFAULTS_LIMIT": "50",
        "ENABLE_MODULES": "text2vec-hash, backup-filesystem",
        "CLUSTER_HOSTNAME": "n7",
        "RAFT_JOIN": "n7,n8,n9",
        "ASYNC_INDEXING": "true",
        "PROMETHEUS_MONITORING_ENABLED": "true",
        "PROMETHEUS_MONITORING_PORT": "9999",
        "LOG_LEVEL": "debug",
        "DISABLE_TELEMETRY": "1",
    })
    assert cfg.data_path == "/tmp/wv"
    assert cfg.rest_port == 8181 and cfg.grpc_port == 50052
    assert cfg.enabled_modules == ["text2vec-hash", "backup-filesystem"]
    assert cfg.raft_join == ["n7", "n8", "n9"]
    assert cfg.async_indexing and cfg.prometheus_enabled
    assert cfg.prometheus_port == 9999
    assert cfg.disable_telemetry


def test_config_file_overlay(tmp_path):
    p = tmp_path / "conf.json"
    p.write_text(json.dumps({"rest_port": 9090, "log_level": "warn"}))
    cfg = ServerConfig.from_env(env={"CONFIG_FILE": str(p), "PORT": "8282"})
    assert cfg.rest_port == 9090  # file wins over env
    assert cfg.log_level == "warn"
    # flat yaml subset
    y = tmp_path / "conf.yaml"
    y.write_text("rest_port: 7070\nasync_indexing: true\n")
    cfg2 = ServerConfig.from_env(env={"CONFIG_FILE": str(y)})
    assert cfg2.rest_port == 7070
    assert cfg2.async_indexing is True


def test_config_bad_int():
    with pytest.raises(ValueError):
        ServerConfig.from_env(env={"PORT": "eighty"})


def test_server_single_node_end_to_end(tmp_path):
    cfg = ServerConfig(
        data_path=str(tmp_path), rest_port=0, grpc_port=0,
        prometheus_enabled=True, prometheus_port=0,
        disable_telemetry=True, enabled_modules=["text2vec-hash"])
    srv = Server(cfg, device="cpu").start()
    try:
        base = f"http://{srv.rest.address}/v1"

        def req(method, path, body=None):
            r = urllib.request.Request(
                base + path, method=method,
                data=None if body is None else json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(r, timeout=30) as resp:
                return json.loads(resp.read() or b"null")

        meta = req("GET", "/meta")
        assert meta["version"]
        req("POST", "/schema", {
            "class": "Doc", "vectorizer": "text2vec-hash",
            "moduleConfig": {"text2vec-hash": {"dim": 24}},
            "properties": [{"name": "t", "dataType": ["text"]}]})
        req("POST", "/batch/objects", {"objects": [
            {"class": "Doc", "properties": {"t": f"doc {i}"}}
            for i in range(20)]})
        out = req("POST", "/graphql", {"query": """
            { Get { Doc(limit: 3, nearText: {concepts: ["doc 7"]}) {
                t _additional { distance } } } }"""})
        assert "errors" not in out, out
        assert out["data"]["Get"]["Doc"][0]["t"] == "doc 7"
        # gRPC listener answers too
        import grpc as _grpc

        from weaviate_tpu_torch.api.grpc import v1_pb2 as pb
        from weaviate_tpu_torch.api.grpc.server import _SERVICE

        chan = _grpc.insecure_channel(f"127.0.0.1:{srv.grpc.port}")
        search = chan.unary_unary(
            f"/{_SERVICE}/Search",
            request_serializer=pb.SearchRequest.SerializeToString,
            response_deserializer=pb.SearchReply.FromString)
        reply = search(pb.SearchRequest(collection="Doc", limit=2))
        assert len(reply.results) == 2
        chan.close()
        # metrics listener exposes prometheus text
        murl = f"http://127.0.0.1:{srv.metrics_server.server_address[1]}/metrics"
        with urllib.request.urlopen(murl, timeout=10) as resp:
            text = resp.read().decode()
        assert "weaviate" in text or "# TYPE" in text
    finally:
        srv.stop()


def test_server_restart_preserves_data(tmp_path):
    cfg = ServerConfig(data_path=str(tmp_path), rest_port=0, grpc_port=0,
                       disable_telemetry=True)
    srv = Server(cfg, device="cpu").start()
    base = f"http://{srv.rest.address}/v1"

    def req(method, path, body=None, addr=None):
        r = urllib.request.Request(
            (addr or base) + path, method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=30) as resp:
            return json.loads(resp.read() or b"null")

    req("POST", "/schema", {"class": "Doc", "properties": [
        {"name": "n", "dataType": ["int"]}]})
    req("POST", "/batch/objects", {"objects": [
        {"class": "Doc", "properties": {"n": i},
         "vector": np.random.default_rng(i).standard_normal(8).tolist()}
        for i in range(10)]})
    srv.stop()

    srv2 = Server(cfg, device="cpu").start()
    try:
        base2 = f"http://{srv2.rest.address}/v1"
        out = req("GET", "/objects?class=Doc&limit=25", addr=base2)
        assert len(out["objects"]) == 10
    finally:
        srv2.stop()


def test_cluster_statistics_standalone(tmp_path):
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.api.rest import RestServer
    from weaviate_tpu_torch.db.database import Database

    db = Database(str(tmp_path), device="cpu")
    srv = RestServer(db)
    srv.start()
    try:
        out = Client(srv.address).request("GET", "/v1/cluster/statistics")
        assert out["synchronized"] is True
        assert out["statistics"][0]["standalone"] is True
    finally:
        srv.stop()
        db.close()


def test_slow_query_logging(tmp_path, monkeypatch, caplog):
    import logging

    from weaviate_tpu_torch.runtime import tracing

    # parser unit checks (one source of truth: runtime/tracing.py)
    monkeypatch.setenv("QUERY_SLOW_LOG_ENABLED", "enabled")
    monkeypatch.setenv("QUERY_SLOW_LOG_THRESHOLD", "250ms")
    assert tracing._compute_slow_threshold() == pytest.approx(0.25)
    monkeypatch.setenv("QUERY_SLOW_LOG_THRESHOLD", "3s")
    assert tracing._compute_slow_threshold() == pytest.approx(3.0)
    monkeypatch.setenv("QUERY_SLOW_LOG_ENABLED", "false")
    assert tracing._compute_slow_threshold() == 0.0
    # env set AFTER import still applies (threshold is lazily cached)
    monkeypatch.setenv("QUERY_SLOW_LOG_ENABLED", "true")
    monkeypatch.setenv("QUERY_SLOW_LOG_THRESHOLD", "0.0001")
    tracing.reset_policy_for_tests()
    from weaviate_tpu_torch.api.rest import config_from_json
    from weaviate_tpu_torch.db.database import Database

    db = Database(str(tmp_path), device="cpu")
    try:
        db.create_collection(config_from_json({
            "class": "Doc", "properties": [
                {"name": "t", "dataType": ["text"]}]}))
        col = db.get_collection("Doc")
        col.put_object({"t": "x"}, vector=[1.0, 2.0])
        with caplog.at_level(logging.WARNING, "weaviate_tpu_torch.slow_query"):
            col.near_vector(np.asarray([1.0, 2.0]), k=1)
        assert any("slow vector query" in r.getMessage()
                   for r in caplog.records)
    finally:
        db.close()
        tracing.reset_policy_for_tests()  # drop the cached 0.1ms threshold
