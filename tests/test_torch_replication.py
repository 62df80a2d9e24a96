"""Replication in the port: 2PC writes, consistency levels, read repair,
anti-entropy and the scaler, on three port ClusterNodes with their shards
on the CPU (the tests of tests/test_replication.py, ported), and held to
the JAX package: the hashtree, the shard's digests, the replica
handlers' replies and a replicated collection's nearVector answers.
"""

import copy
import time
import uuid as uuid_mod

import numpy as np
import pytest

from weaviate_tpu_torch.cluster import ClusterNode, transport
from weaviate_tpu_torch.cluster.scaler import ScaleError
from weaviate_tpu_torch.db.database import Database as TDatabase
from weaviate_tpu_torch.replication import (ConsistencyError, HashBeater,
                                            MerkleTree, required_acks)
from weaviate_tpu_torch.replication.hashbeater import replication_status
from weaviate_tpu_torch.replication.hashtree import digest_rank, entry_hash
from weaviate_tpu_torch.runtime import degrade, faultline
from weaviate_tpu_torch.schema.config import (CollectionConfig, Property,
                                              ReplicationConfig,
                                              ShardingConfig)
from weaviate_tpu_torch.storage.objects import StorageObject

RTOL, ATOL = 2e-4, 2e-3  # the reference's f32 tolerance
DIM = 16


@pytest.fixture(autouse=True)
def _port_replication_isolation():
    yield
    faultline.disarm()
    faultline.heal()
    degrade.reset()
    transport.reset_breakers()
    replication_status.reset()


def _wait(cond, timeout=10.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


# -- units ---------------------------------------------------------------------


def test_required_acks():
    assert required_acks("ONE", 3) == 1
    assert required_acks("QUORUM", 3) == 2
    assert required_acks("QUORUM", 5) == 3
    assert required_acks("ALL", 3) == 3
    with pytest.raises(ValueError):
        required_acks("MOST", 3)


def test_merkle_tree_diff_finds_divergent_bucket():
    a, b = MerkleTree(6), MerkleTree(6)
    for i in range(200):
        u = f"00000000-0000-0000-0000-{i:012d}"
        a.insert(u, 1000 + i, False, b"h" * 16)
        b.insert(u, 1000 + i, False, b"h" * 16)
    assert a.root == b.root
    assert a.diff_buckets(lambda lv, pos: b.level_hashes(lv, pos)) == []
    # one entry differs (newer mtime on b)
    u = "00000000-0000-0000-0000-000000000007"
    b.insert(u, 1007, False, b"h" * 16)   # remove old (xor) ...
    b.insert(u, 9999, False, b"x" * 16)   # ... add new
    diff = a.diff_buckets(lambda lv, pos: b.level_hashes(lv, pos))
    assert diff == [MerkleTree.bucket_of(u, 6)]


def test_merkle_leaf_is_order_independent():
    a, b = MerkleTree(4), MerkleTree(4)
    entries = [(f"00000000-0000-0000-0000-{i:012d}", 5 * i) for i in range(50)]
    for u, t in entries:
        a.insert(u, t, False, b"c" * 16)
    for u, t in reversed(entries):
        b.insert(u, t, False, b"c" * 16)
    assert a.root == b.root
    assert entry_hash("u", 1, False, b"") != entry_hash("u", 1, True, b"")


# -- cluster fixture (replication factor 3) ------------------------------------


def _boot(tmp_path, names=("n0", "n1", "n2")):
    names = list(names)
    nodes = [ClusterNode(name, str(tmp_path / name), raft_peers=names,
                         gossip_interval=0.1, election_timeout=(0.2, 0.4),
                         device="cpu")
             for name in names]
    for n in nodes:
        n.membership.join([p.address for p in nodes])
    for n in nodes:
        n.start()
    for n in nodes:
        n.raft.wait_for_leader(timeout=10.0)
    return nodes


def _close(nodes):
    for n in nodes:
        try:
            n.close()
        except Exception:  # noqa: BLE001
            pass


@pytest.fixture
def cluster(tmp_path):
    nodes = _boot(tmp_path)
    yield nodes
    _close(nodes)


def _create(nodes, cfg, attempts=4):
    """Bounded-retry create against whichever node leads (a propose that
    timed out after committing shows up as the collection existing)."""
    for attempt in range(attempts):
        node = next((n for n in nodes if n.raft.is_leader), nodes[0])
        try:
            node.create_collection(cfg)
            break
        except Exception:  # noqa: BLE001 — leadership moved under it
            if any(cfg.name in n.db.collections for n in nodes):
                break
            if attempt == attempts - 1:
                raise
            node.raft.wait_for_leader(timeout=10.0)
    _wait(lambda: all(cfg.name in n.db.collections for n in nodes),
          msg="schema everywhere")
    return [n.db.get_collection(cfg.name) for n in nodes]


def _make_replicated(nodes, name="Rep", shards=2, factor=3):
    return _create(nodes, CollectionConfig(
        name=name, properties=[Property("body", "text")],
        sharding=ShardingConfig(desired_count=shards),
        replication=ReplicationConfig(factor=factor)))


def test_replicated_write_lands_on_all_replicas(cluster):
    cols = _make_replicated(cluster)
    u = str(uuid_mod.uuid4())
    cols[0].put_object({"body": "replicated doc"}, vector=[1.0, 2.0], uuid=u,
                       consistency="ALL")
    # every node holds the object LOCALLY (not via remote fetch)
    for col in cols:
        shard_name = col.sharding.shard_for(u)
        local = col._load_shard(shard_name).get_object(u)
        assert local is not None
        assert local.properties["body"] == "replicated doc"
    # replicated delete with tombstones everywhere
    assert cols[1].delete_object(u, consistency="ALL")
    for col in cols:
        shard = col._load_shard(col.sharding.shard_for(u))
        assert shard.get_object(u) is None
        assert shard.tombstones.get(u.encode()) is not None


def test_consistency_levels_on_node_failure(cluster):
    cols = _make_replicated(cluster, name="Cons")
    # kill n2's server: only 2/3 replicas reachable
    cluster[2].server.stop()
    u = str(uuid_mod.uuid4())
    with pytest.raises(ConsistencyError):
        cols[0].put_object({"body": "x"}, vector=[1.0, 0.0], uuid=u,
                           consistency="ALL")
    # QUORUM still succeeds (reference: write degrades via level)
    u2 = str(uuid_mod.uuid4())
    cols[0].put_object({"body": "y"}, vector=[0.0, 1.0], uuid=u2,
                       consistency="QUORUM")
    assert cols[0].get_object(u2) is not None


def test_read_repair(cluster):
    cols = _make_replicated(cluster, name="Heal")
    u = str(uuid_mod.uuid4())
    cols[0].put_object({"body": "v1"}, vector=[1.0, 1.0], uuid=u,
                       consistency="ALL")
    shard_name = cols[0].sharding.shard_for(u)
    # simulate a missed update: newer version lands only on n0's replica
    newer = StorageObject(uuid=u, properties={"body": "v2"},
                          last_update_time_ms=int(time.time() * 1000) + 5000)
    newer.vector = np.asarray([2.0, 2.0], dtype=np.float32)
    cols[0]._load_shard(shard_name).put_object_batch([newer])
    # consistent read via another node returns v2 and repairs the stale
    got = cols[2].get_object(u, consistency="ALL")
    assert got is not None and got.properties["body"] == "v2"
    _wait(lambda: all(
        c._load_shard(shard_name).get_object(u).properties["body"] == "v2"
        for c in cols), msg="read repair convergence")


def test_hashbeat_converges_divergent_replicas(cluster):
    cols = _make_replicated(cluster, name="Beat")
    base = int(time.time() * 1000)
    # n0 has an object the others never saw; n1 has a deletion the
    # others never saw
    u_extra, u_del = str(uuid_mod.uuid4()), str(uuid_mod.uuid4())
    cols[0].put_object({"body": "keep"}, vector=[1.0, 0.0], uuid=u_del,
                       consistency="ALL")
    s_extra = cols[0].sharding.shard_for(u_extra)
    extra = StorageObject(uuid=u_extra, properties={"body": "lonely"},
                          last_update_time_ms=base)
    extra.vector = np.asarray([3.0, 3.0], dtype=np.float32)
    cols[0]._load_shard(s_extra).put_object_batch([extra])
    s_del = cols[1].sharding.shard_for(u_del)
    cols[1]._load_shard(s_del).delete_object(u_del)

    for col in cols:
        HashBeater(col).beat()
    # everyone has the lonely object; nobody has the deleted one
    for col in cols:
        assert col._load_shard(s_extra).get_object(u_extra) is not None
        assert col._load_shard(s_del).get_object(u_del) is None


def test_hashbeat_converges_same_mtime_conflict(cluster):
    """Same-millisecond divergent writes (partition scenario) must still
    converge via the deterministic content-hash tie-break."""
    cols = _make_replicated(cluster, name="Tie")
    u = str(uuid_mod.uuid4())
    ts = int(time.time() * 1000)
    shard_name = cols[0].sharding.shard_for(u)
    a = StorageObject(uuid=u, properties={"body": "version-A"},
                      creation_time_ms=ts, last_update_time_ms=ts)
    a.vector = np.asarray([1.0, 0.0], dtype=np.float32)
    b = StorageObject(uuid=u, properties={"body": "version-B"},
                      creation_time_ms=ts, last_update_time_ms=ts)
    b.vector = np.asarray([0.0, 1.0], dtype=np.float32)
    cols[0]._load_shard(shard_name).put_object_batch([a])
    cols[1]._load_shard(shard_name).put_object_batch([b])
    for _ in range(2):  # two rounds so the winner reaches every replica
        for col in cols:
            HashBeater(col).beat()
    bodies = {c._load_shard(shard_name).get_object(u).properties["body"]
              for c in cols}
    assert len(bodies) == 1, bodies  # all replicas agree on ONE version
    # and a further beat is a no-op (converged, no eternal re-diff)
    assert all(HashBeater(c).beat() is False for c in cols)


def test_hashbeat_noop_when_converged(cluster):
    cols = _make_replicated(cluster, name="Idle")
    for i in range(10):
        cols[0].put_object({"body": f"d{i}"}, vector=[float(i), 0.0],
                           consistency="ALL")
    assert HashBeater(cols[0]).beat() is False


def test_node_registers_the_replication_plane(tmp_path):
    """The node mounts the replica handlers beside the shard data plane
    and runs the hashbeat cycle beside the device-memory gossip."""
    node, = _boot(tmp_path, ["solo"])
    try:
        routes = set(node.server.routes)
        assert "/replicas/" in routes and "/indices/" in routes
        cycles = set(node.db.cycles._callbacks)
        assert {"hashbeat", "hbm-gossip"} <= cycles
        # a factor above the cluster's size is the scaler's refusal, not a
        # NotImplementedError, and nothing reaches the log
        node.create_collection(CollectionConfig(name="One"))
        _wait(lambda: "One" in node.db.collections, msg="class applied")
        before = node.raft.log_start + len(node.raft.log)
        cfg = copy.deepcopy(node.db.get_collection("One").config)
        cfg.replication.factor = 2
        with pytest.raises(ScaleError, match="exceeds cluster size"):
            node.update_collection(cfg)
        assert node.raft.log_start + len(node.raft.log) == before
        assert node.db.get_collection("One").config.replication.factor == 1
    finally:
        node.close()


def test_concurrent_replicated_writes_lose_no_row(cluster):
    """Commits land on every replica from the handler threads of whichever
    node receives them: several coordinators writing at ALL at once must
    leave every node's shards holding every row, in the object store and
    live in the vector index (the shard lock serializes the scatter)."""
    import sys
    import threading

    cols = _make_replicated(cluster, name="Race", shards=2)
    rng = np.random.default_rng(7)
    n_threads, per_thread = 12, 6
    vecs = rng.standard_normal((n_threads * per_thread, DIM)).astype(np.float32)
    errors = []

    def writer(t):
        col = cols[t % 3]
        try:
            for j in range(per_thread):
                i = t * per_thread + j
                col.put_object({"body": f"r{i}"}, vector=vecs[i],
                               uuid=f"00000000-0000-4000-8000-{i:012d}",
                               consistency="ALL")
        except Exception as e:  # noqa: BLE001 — collected, asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60.0)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    total = n_threads * per_thread
    for col in cols:
        shards = [col._load_shard(s) for s in col.sharding.shard_names]
        assert sum(s.object_count() for s in shards) == total
        assert sum(len(s.vector_indexes[""]) for s in shards) == total


# -- the scaler ----------------------------------------------------------------


def test_scaler_one_to_three_puts_every_row_on_every_node(cluster):
    """A factor-1 collection scaled to 3 through a node's update_collection
    (the scaler's copies, then the placement through Raft): every node then
    holds every row and answers nearVector locally, as before the scale."""
    cols = _create(cluster, CollectionConfig(
        name="Grow", properties=[Property("body", "text")],
        sharding=ShardingConfig(desired_count=3)))
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((45, DIM)).astype(np.float32)
    res = cols[0].batch_put([{"uuid": f"00000000-0000-4000-8000-{i:012d}",
                              "properties": {"body": f"b{i}"},
                              "vector": vecs[i]} for i in range(45)])
    assert all(r["status"] == "SUCCESS" for r in res)
    assert {cols[0].sharding.nodes_for(s)[0]
            for s in cols[0].sharding.shard_names} == {"n0", "n1", "n2"}
    q = rng.standard_normal(DIM).astype(np.float32)
    before = [(r.uuid, r.distance)
              for r in cols[0].near_vector(q, k=20, include_objects=False)]
    cfg = copy.deepcopy(cols[0].config)
    cfg.replication.factor = 3
    cluster[0].update_collection(cfg)
    _wait(lambda: all(c.config.replication.factor == 3
                      and all(len(c.sharding.nodes_for(s)) == 3
                              for s in c.sharding.shard_names)
                      for c in cols), msg="factor 3 everywhere")
    for col in cols:
        shards = [col._load_shard(s) for s in col.sharding.shard_names]
        assert sum(s.object_count() for s in shards) == 45
        got = [(r.uuid, r.distance)
               for r in col.near_vector(q, k=20, include_objects=False)]
        assert got == before
        assert col.object_count() == 45
    # the scaled collection takes replicated writes at ALL
    cols[1].put_object({"body": "after"}, vector=vecs[0],
                       uuid="00000000-0000-4000-8000-000000000999",
                       consistency="ALL")
    for col in cols:
        assert col.object_count() == 46


@pytest.mark.parametrize("factor,match", [
    (0, "must be >= 1"), (2, "exceeds cluster size")])
def test_scaler_refusals_match_the_jax_scaler(tmp_path, factor, match):
    """A factor below 1 or above the node count is refused before anything
    moves, by the port's scaler as by the JAX one."""
    from weaviate_tpu.cluster.scaler import ScaleError as JScaleError
    from weaviate_tpu.cluster.scaler import Scaler as JScaler
    from weaviate_tpu.db.database import Database as JDatabase
    from weaviate_tpu.schema.config import CollectionConfig as JConfig

    from weaviate_tpu_torch.cluster.scaler import Scaler

    tdb = TDatabase(str(tmp_path / "t"), device="cpu")
    jdb = JDatabase(str(tmp_path / "j"))
    try:
        tdb.create_collection(CollectionConfig(name="S"))
        jdb.create_collection(JConfig(name="S"))
        with pytest.raises(JScaleError, match=match) as je:
            JScaler(jdb).scale("S", factor)
        with pytest.raises(ScaleError, match=match) as te:
            Scaler(tdb).scale("S", factor)
        assert str(te.value) == str(je.value)
        assert isinstance(te.value, ValueError)  # the REST layer's 422
        assert tdb.get_collection("S").config.replication.factor == 1
        assert tdb.get_collection("S").sharding.placement == \
            jdb.get_collection("S").sharding.placement
    finally:
        tdb.close()
        jdb.close()


# -- parity with the JAX package -----------------------------------------------


def _digests(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        deleted = bool(rng.random() < 0.2)
        out.append({"uuid": str(uuid_mod.UUID(bytes=rng.bytes(16))),
                    "mtime": int(rng.integers(1, 2 ** 40)),
                    "deleted": deleted,
                    "hash": b"" if deleted else rng.bytes(16)})
    return out


@pytest.mark.parametrize("depth", [4, 8])
def test_hashtree_parity_with_jax(depth):
    from weaviate_tpu.replication import hashtree as jh

    from weaviate_tpu_torch.replication import hashtree as th

    ds = _digests(depth, 300)
    ta, ja = th.MerkleTree(depth), jh.MerkleTree(depth)
    for d in ds:
        assert th.entry_hash(d["uuid"], d["mtime"], d["deleted"], d["hash"]) \
            == jh.entry_hash(d["uuid"], d["mtime"], d["deleted"], d["hash"])
        assert th.MerkleTree.bucket_of(d["uuid"], depth) \
            == jh.MerkleTree.bucket_of(d["uuid"], depth)
        ta.insert(d["uuid"], d["mtime"], d["deleted"], d["hash"])
        ja.insert(d["uuid"], d["mtime"], d["deleted"], d["hash"])
    assert ta.root == ja.root
    for level in range(depth + 1):
        pos = list(range(1 << level))
        assert ta.level_hashes(level, pos) == ja.level_hashes(level, pos)
    assert sorted(ds, key=digest_rank) == sorted(ds, key=jh.digest_rank)


def _fixed_objects(seed: int, n: int, base_ms: int = 1_700_000_000_000):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    out = []
    for i in range(n):
        out.append(dict(uuid=f"00000000-0000-4000-8000-{i:012d}",
                        properties={"body": f"doc {i}", "n": int(i % 7)},
                        creation_time_ms=base_ms + i,
                        last_update_time_ms=base_ms + 1000 + i,
                        vector=vecs[i]))
    return out


def _storage_objects(cls, specs):
    objs = []
    for s in specs:
        o = cls(uuid=s["uuid"], properties=dict(s["properties"]),
                creation_time_ms=s["creation_time_ms"],
                last_update_time_ms=s["last_update_time_ms"])
        o.vector = np.asarray(s["vector"], dtype=np.float32)
        objs.append(o)
    return objs


class _Routes:
    """Stands in for the internal server: collects the mounted handler."""

    def __init__(self):
        self.routes = {}

    def route(self, path, handler):
        self.routes[path] = handler


@pytest.fixture
def twin_shards(tmp_path):
    """One port and one JAX single-node Database holding the same objects
    (fixed times) and the same tombstones in a 2-shard collection."""
    from weaviate_tpu.db.database import Database as JDatabase
    from weaviate_tpu.replication import register_replication as j_register
    from weaviate_tpu.schema.config import CollectionConfig as JConfig
    from weaviate_tpu.schema.config import Property as JProperty
    from weaviate_tpu.schema.config import ShardingConfig as JSharding
    from weaviate_tpu.storage.objects import StorageObject as JObject

    from weaviate_tpu_torch.replication import register_replication

    tdb = TDatabase(str(tmp_path / "t"), device="cpu")
    jdb = JDatabase(str(tmp_path / "j"))
    specs = _fixed_objects(5, 40)
    tcol = tdb.create_collection(CollectionConfig(
        name="Twin", properties=[Property("body", "text"), Property("n", "int")],
        sharding=ShardingConfig(desired_count=2)))
    jcol = jdb.create_collection(JConfig(
        name="Twin", properties=[JProperty("body", "text"), JProperty("n", "int")],
        sharding=JSharding(desired_count=2)))
    assert tcol.sharding.to_dict() == jcol.sharding.to_dict()
    for col, cls in ((tcol, StorageObject), (jcol, JObject)):
        by_shard = {}
        for o in _storage_objects(cls, specs):
            by_shard.setdefault(col.sharding.shard_for(o.uuid), []).append(o)
        for name, objs in sorted(by_shard.items()):
            col._load_shard(name).put_object_batch(objs)
        for s in specs[::9]:  # deletes with fixed tombstone times
            shard = col._load_shard(col.sharding.shard_for(s["uuid"]))
            shard.delete_object(s["uuid"], tombstone_ms=1_800_000_000_000)
    troutes, jroutes = _Routes(), _Routes()
    register_replication(troutes, tdb)
    j_register(jroutes, jdb)
    yield tcol, jcol, troutes.routes["/replicas/"], jroutes.routes["/replicas/"], specs
    tdb.close()
    jdb.close()


def test_object_digest_parity_with_jax(twin_shards):
    """The shard's digest (mtime, tombstone flag, content hash over the
    vector bytes) equals the JAX shard's for every object and tombstone."""
    tcol, jcol, _th, _jh, specs = twin_shards
    seen = {"live": 0, "deleted": 0}
    for s in specs + [{"uuid": "00000000-0000-4000-8000-999999999999"}]:
        u = s["uuid"]
        name = tcol.sharding.shard_for(u)
        td = tcol._load_shard(name).object_digest(u)
        jd = jcol._load_shard(name).object_digest(u)
        assert td == jd, u
        if td is not None:
            seen["deleted" if td["deleted"] else "live"] += 1
    assert seen == {"live": 35, "deleted": 5}
    # a vector that is not contiguous float32 hashes as its f32 bytes
    o = _storage_objects(StorageObject, specs[:1])[0]
    h = o.content_hash()
    o.vector = np.asarray(specs[0]["vector"], dtype=np.float64)[::1]
    assert o.content_hash() == h


@pytest.mark.parametrize("op", ["digest", "digests:bucket", "hashtree:level"])
def test_replica_handler_replies_match_jax(twin_shards, op):
    """Each package's /replicas handler answers the same payloads with the
    same replies, equal on the wire (each package's encoder) too."""
    from weaviate_tpu.cluster import transport as jtransport

    tcol, _jcol, th, jh, specs = twin_shards
    for shard in sorted(tcol.sharding.shard_names):
        if op == "digest":
            payloads = [{"uuid": s["uuid"]} for s in specs[:12]]
        elif op == "digests:bucket":
            payloads = [{"depth": 4, "buckets": list(range(16))},
                        {"depth": 8, "buckets": [0, 3, 77, 200, 255]}]
        else:
            payloads = [{"depth": 8, "level": lv, "positions":
                         list(range(min(1 << lv, 32))), "token": None}
                        for lv in (0, 1, 5, 8)]
        for p in payloads:
            tr = th(f"Twin/{shard}/{op}", dict(p))
            jr = jh(f"Twin/{shard}/{op}", dict(p))
            if op == "hashtree:level":
                # each walk's snapshot token is a fresh uuid4
                assert isinstance(tr.pop("token"), str)
                jr.pop("token")
            assert tr == jr
            assert transport.dumps(tr) == jtransport.dumps(jr)


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    return [{"uuid": f"00000000-0000-4000-8000-{i:012d}",
             "properties": {"body": f"row {i}"}, "vector": vecs[i]}
            for i in range(n)], rng.standard_normal((5, DIM)).astype(np.float32)


def test_replicated_near_vector_matches_jax(cluster, tmp_path):
    """Three port nodes at factor 3 answer nearVector through every node
    from the local replica, as a JAX Database does on the same rows."""
    from weaviate_tpu.db.database import Database as JDatabase
    from weaviate_tpu.schema.config import CollectionConfig as JConfig
    from weaviate_tpu.schema.config import Property as JProperty
    from weaviate_tpu.schema.config import ShardingConfig as JSharding

    cols = _make_replicated(cluster, name="Par", shards=3)
    rows, queries = _rows(21, 60)
    for s in range(0, len(rows), 20):
        res = cols[s // 20 % 3].batch_put(rows[s:s + 20], consistency="QUORUM")
        assert all(r["status"] == "SUCCESS" for r in res), res
    jdb = JDatabase(str(tmp_path / "jax"))
    try:
        jcol = jdb.create_collection(JConfig(
            name="Par", properties=[JProperty("body", "text")],
            sharding=JSharding(desired_count=3)))
        assert all(r["status"] == "SUCCESS" for r in jcol.batch_put(rows))
        # QUORUM acks may return before the straggler commit lands
        _wait(lambda: all(sum(c._load_shard(s).object_count()
                              for s in c.sharding.shard_names) == 60
                          for c in cols), msg="every replica committed")
        calls = []
        for c in cols:
            c.remote.search_shard = lambda *a, **k: calls.append(a)
        for q in queries:
            want = jcol.near_vector(q, k=15, include_objects=False)
            for col in cols:
                got = col.near_vector(q, k=15, include_objects=False)
                assert [r.uuid for r in got] == [r.uuid for r in want]
                np.testing.assert_allclose([r.distance for r in got],
                                           [r.distance for r in want],
                                           rtol=RTOL, atol=ATOL)
        assert calls == []  # every read served by the local replica
    finally:
        jdb.close()


def test_read_repair_kills_the_old_slot(cluster, tmp_path):
    """A read repair of v2 over a replica's v1 re-assigns the doc id: v1's
    slot must die in the vector index, so a search with v1's vector finds
    the row at v2's distance on every node (as the JAX package does after
    the same overwrite), once, and never at v1's."""
    from weaviate_tpu.db.database import Database as JDatabase
    from weaviate_tpu.schema.config import CollectionConfig as JConfig
    from weaviate_tpu.schema.config import Property as JProperty

    cols = _make_replicated(cluster, name="Slot", shards=1)
    rows, _q = _rows(33, 20)
    assert all(r["status"] == "SUCCESS"
               for r in cols[0].batch_put(rows, consistency="ALL"))
    u, v1 = rows[3]["uuid"], rows[3]["vector"]
    v2 = -v1 + 0.5
    shard_name = cols[0].sharding.shard_for(u)
    newer = StorageObject(uuid=u, properties={"body": "v2"},
                          last_update_time_ms=int(time.time() * 1000) + 5000)
    newer.vector = v2.astype(np.float32)
    cols[0]._load_shard(shard_name).put_object_batch([newer])
    got = cols[2].get_object(u, consistency="ALL")
    assert got is not None and got.properties["body"] == "v2"
    jdb = JDatabase(str(tmp_path / "jax"))
    try:
        jcol = jdb.create_collection(JConfig(
            name="Slot", properties=[JProperty("body", "text")]))
        jcol.batch_put(rows)
        jcol.put_object({"body": "v2"}, vector=v2, uuid=u)
        want = {r.uuid: r.distance
                for r in jcol.near_vector(v1, k=20, include_objects=False)}
        for col in cols:
            res = col.near_vector(v1, k=20, include_objects=False)
            ids = [r.uuid for r in res]
            assert len(ids) == 20 and len(set(ids)) == 20
            dist = {r.uuid: r.distance for r in res}
            assert dist[u] > 0.5  # v1's own distance would be ~0
            np.testing.assert_allclose(dist[u], want[u], rtol=RTOL, atol=ATOL)
            shard = col._load_shard(shard_name)
            assert len(shard.vector_indexes[""]) == 20
    finally:
        jdb.close()


def test_shard_hashtree_follows_every_write(tmp_path):
    """The shard keeps its digest list and hashtrees until a write changes
    a digest: after every kind of write the tree equals one rebuilt from
    ``iter_digests``, and an unchanged shard hands back the same tree. An
    anti-entropy push of two copies of one uuid keeps the newer."""
    db = TDatabase(str(tmp_path / "t"), device="cpu")
    try:
        col = db.create_collection(CollectionConfig(
            name="Tree", properties=[Property("body", "text")]))
        shard = col._load_shard("shard-0")
        roots = []

        def check():
            tree = shard.build_hashtree(8)
            fresh = MerkleTree(8)
            for d in shard.iter_digests():
                fresh.insert(d["uuid"], d["mtime"], d["deleted"], d["hash"])
            assert tree.root == fresh.root
            assert shard.build_hashtree(8) is tree
            assert shard.bucket_digests(8, list(range(256))) \
                == list(shard.iter_digests())
            roots.append(tree.root)

        check()
        objs = _storage_objects(StorageObject, _fixed_objects(9, 3))
        shard.put_object_batch(objs)
        check()
        newer = _storage_objects(StorageObject, _fixed_objects(9, 1))[0]
        newer.last_update_time_ms += 10
        shard.put_object_batch([newer])
        check()
        shard.delete_object(objs[1].uuid, tombstone_ms=1_900_000_000_000)
        check()
        unseen = "00000000-0000-4000-8000-000000000777"
        assert shard.apply_sync([], [{"uuid": unseen, "mtime": 5}]) == 1
        check()
        a, b = _storage_objects(StorageObject, _fixed_objects(4, 1) * 2)
        a.uuid = b.uuid = "00000000-0000-4000-8000-000000000778"
        b.last_update_time_ms += 7
        b.properties = {"body": "newer", "n": 1}
        assert shard.apply_sync([b.to_bytes(), a.to_bytes()], []) == 1
        assert shard.get_object(b.uuid).properties["body"] == "newer"
        check()
        shard.mark_migrating([objs[2].uuid], "elsewhere")
        shard.migrate_out([objs[2].uuid], "elsewhere")
        check()
        assert len(set(roots)) == len(roots)
        assert len(shard.vector_indexes[""]) == shard.object_count() == 2
    finally:
        db.close()
