"""The port's flat nearVector slice end to end against the JAX package:
``Database`` -> ``Collection.near_vector(where=...)`` on the same objects,
a JAX-written data directory reopened by the port, concurrent clients
through the query batcher, and the port's import rules.

Uuids must match exactly on tie-free data; distances within rtol 2e-4 /
atol 2e-3 (the reference's own kernel tolerance).
"""

import ast
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from weaviate_tpu.db import Database as JDatabase
from weaviate_tpu.filters import Filter as JFilter
from weaviate_tpu.filters import Operator as JOperator
from weaviate_tpu.schema import config as jschema
from weaviate_tpu_torch.db import Database as TDatabase
from weaviate_tpu_torch.filters import Filter as TFilter
from weaviate_tpu_torch.filters import Operator as TOperator
from weaviate_tpu_torch.schema import config as tschema

RTOL, ATOL = 2e-4, 2e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "weaviate_tpu_torch")


def _config(schema, metric="cosine", storage_dtype="float32", shards=1):
    return schema.CollectionConfig(
        name="Article",
        properties=[schema.Property(name="category", data_type="text"),
                    schema.Property(name="views", data_type="int")],
        vectors=[schema.VectorConfig(index=schema.VectorIndexConfig(
            index_type="flat", metric=metric, storage_dtype=storage_dtype))],
        sharding=schema.ShardingConfig(desired_count=shards))


def _objects(rng, n=500, d=24):
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    return [{"uuid": f"00000000-0000-4000-8000-{i:012d}",
             "properties": {"category": f"c{i % 7}", "views": int(i)},
             "vector": vecs[i]} for i in range(n)]


def _same_results(a, b):
    assert [r.uuid for r in b] == [r.uuid for r in a]
    np.testing.assert_allclose([r.distance for r in b], [r.distance for r in a],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric,storage_dtype,shards", [
    ("cosine", "float32", 1),
    ("l2-squared", "bfloat16", 1),
    ("dot", "float32", 2),
])
def test_collection_parity_with_jax(tmp_path, metric, storage_dtype, shards):
    rng = np.random.default_rng(17)
    objs = _objects(rng)
    jdb = JDatabase(str(tmp_path / "j"))
    tdb = TDatabase(str(tmp_path / "t"), device="cpu")
    try:
        jc = jdb.create_collection(_config(jschema, metric, storage_dtype, shards))
        tc = tdb.create_collection(_config(tschema, metric, storage_dtype, shards))
        jc.batch_put(objs)
        tc.batch_put(objs)
        assert tc.object_count() == jc.object_count() == len(objs)
        qs = rng.standard_normal((6, 24)).astype(np.float32)
        for q in qs:
            _same_results(jc.near_vector(q, k=10), tc.near_vector(q, k=10))
            _same_results(
                jc.near_vector(q, k=10, where=JFilter.where(
                    "views", JOperator.GREATER_THAN_EQUAL, 250)),
                tc.near_vector(q, k=10, where=TFilter.where(
                    "views", TOperator.GREATER_THAN_EQUAL, 250)))
            _same_results(
                jc.near_vector(q, k=5, where=JFilter.where(
                    "category", JOperator.EQUAL, "c3")),
                tc.near_vector(q, k=5, where=TFilter.where(
                    "category", TOperator.EQUAL, "c3")))
        for o in objs[:120:4]:
            assert jc.delete_object(o["uuid"]) == tc.delete_object(o["uuid"])
        tc.put_object({"category": "c1", "views": 7}, vector=objs[0]["vector"],
                      uuid=objs[1]["uuid"])
        jc.put_object({"category": "c1", "views": 7}, vector=objs[0]["vector"],
                      uuid=objs[1]["uuid"])
        for q in qs:
            _same_results(jc.near_vector(q, k=10), tc.near_vector(q, k=10))
        got = tc.get_object(objs[1]["uuid"])
        assert got.properties == {"category": "c1", "views": 7}
    finally:
        jdb.close()
        tdb.close()


def test_port_reopens_jax_data_directory(tmp_path):
    rng = np.random.default_rng(23)
    objs = _objects(rng, n=300)
    qs = rng.standard_normal((4, 24)).astype(np.float32)
    jdb = JDatabase(str(tmp_path / "data"))
    jc = jdb.create_collection(_config(jschema))
    jc.batch_put(objs)
    jc.delete_object(objs[5]["uuid"])
    want = [jc.near_vector(q, k=8, where=JFilter.where(
        "views", JOperator.LESS_THAN, 150)) for q in qs]
    jdb.close()
    tdb = TDatabase(str(tmp_path / "data"), device="cpu")
    try:
        tc = tdb.get_collection("Article")
        assert tc.object_count() == 299
        for q, w in zip(qs, want):
            _same_results(w, tc.near_vector(q, k=8, where=TFilter.where(
                "views", TOperator.LESS_THAN, 150)))
        # and the port's own writes survive its own reopen
        tc.put_object({"category": "new", "views": 1}, vector=qs[0],
                      uuid="00000000-0000-4000-8000-999999999999")
    finally:
        tdb.close()
    tdb = TDatabase(str(tmp_path / "data"), device="cpu")
    try:
        top = tdb.get_collection("Article").near_vector(qs[0], k=1)
        assert top[0].uuid == "00000000-0000-4000-8000-999999999999"
    finally:
        tdb.close()


def test_concurrent_clients_match_serial_path(tmp_path):
    """8 client threads through the shard's query batcher (coalesced,
    pipelined, mixed filtered/unfiltered) give the serial answers."""
    rng = np.random.default_rng(29)
    objs = _objects(rng, n=400)
    tdb = TDatabase(str(tmp_path / "t"), device="cpu")
    try:
        tc = tdb.create_collection(_config(tschema))
        tc.batch_put(objs)
        shard = next(iter(tc.shards.values()))
        qs = rng.standard_normal((32, 24)).astype(np.float32)
        where = TFilter.where("views", TOperator.GREATER_THAN_EQUAL, 100)
        shard.dynamic_batching = False
        serial = [tc.near_vector(q, k=10, where=where if i % 2 else None)
                  for i, q in enumerate(qs)]
        shard.dynamic_batching = True
        out = [None] * len(qs)
        errors = []

        def client(c):
            try:
                for i in range(c, len(qs), 8):
                    out[i] = tc.near_vector(qs[i], k=10,
                                            where=where if i % 2 else None)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and not any(t.is_alive() for t in threads)
        for a, b in zip(serial, out):
            assert [r.uuid for r in a] == [r.uuid for r in b]
        batcher = shard._query_batchers[""]
        assert batcher.async_dispatches > 0
        assert batcher.batched_queries == len(qs)
    finally:
        tdb.close()


def test_port_imports_without_jax():
    """Every module of the port imports with ``jax`` blocked."""
    mods = []
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    code = ("import sys; sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
            "assert not any(k == 'weaviate_tpu' or k.startswith('weaviate_tpu.')"
            " for k in sys.modules), 'the JAX package was imported'\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_the_jax_package():
    """Every module of the port (the cluster's among them), and
    chip_smoke.py, which drives it on the card."""
    offenders = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for mod in ("transport", "membership", "raft", "fsm", "remote", "node"):
        assert os.path.join(PORT, "cluster", f"{mod}.py") in paths, mod
    for path in paths:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in ("weaviate_tpu", "jax", "jaxlib"):
                    offenders.append(f"{path}:{node.lineno} {n}")
    assert not offenders, offenders


def test_entry_point_without_device_raises_on_cpu_only_box(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        TDatabase(str(tmp_path / "d"))
    assert not (tmp_path / "d").exists()
