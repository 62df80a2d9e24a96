"""The crashtest subprocess worker + verifier (the port's copy of
``tools/crashtest/workload.py``: the same op sequence and oracle, over
``weaviate_tpu_torch``'s stores; ``--device`` places the HNSW index).

One module holds BOTH the op-sequence generator and its simulator so
the worker (executes ops against the real store) and the verifier
(recomputes the expected state) can never drift: the verifier's oracle
is ``simulate(op_sequence(...), upto)``, pure Python over dicts.

The worker is deliberately single-threaded: that is what turns "no
acked durable write lost" into the sharp *prefix* invariant — the
durable state must be exactly ``apply(ops[:j])`` or ``apply(ops[:j+1])``
where ``j`` is the count of journal lines (op ``j`` was in flight when
the crash landed; it may or may not have become durable, nothing else
may differ). Concurrency is chaos-tested elsewhere (tests/test_chaos);
crash-durability wants determinism.

The journal is the client's own ledger: a JSONL file appended+fsynced
AFTER each op returns, outside every faultline point, so a crash
inside op ``j`` leaves exactly ``j`` lines.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HNSW_DIM = 8


# -- deterministic op sequence ------------------------------------------------


def op_sequence(n_ops: int, seed: int = 0) -> list[dict]:
    """The full deterministic workload. Op kinds:

    put / update / delete     objects bucket (replace)
    radd                      bitmap bucket (roaringset)
    mset                      postings bucket (map)
    flush                     force seal + segment write (round-robin)
    raft                      one solo-raft propose (persists log+meta)
    raft_snap                 raft snapshot + log compaction
    hadd                      HNSW insert (op-logged)
    hsnap                     HNSW condense (snapshot + log reset)
    """
    import random

    rng = random.Random(seed)
    ops: list[dict] = []
    for i in range(n_ops):
        if i and i % 97 == 0:
            ops.append({"op": "raft_snap", "i": i})
        elif i and i % 61 == 0:
            ops.append({"op": "hsnap", "i": i})
        elif i and i % 17 == 0:
            ops.append({"op": "flush", "i": i,
                        "bucket": ("objects", "bitmap", "postings")[i % 3]})
        elif i % 11 == 0:
            ops.append({"op": "raft", "i": i})
        elif i % 7 == 0:
            ops.append({"op": "hadd", "i": i, "doc": i})
        elif i % 5 == 0:
            ops.append({"op": "radd", "i": i, "key": f"tag{i % 3}",
                        "ids": [i, i + 100000]})
        elif i % 3 == 0:
            ops.append({"op": "mset", "i": i, "key": f"term{i % 4}",
                        "doc": i, "tf": (i % 9) + 1})
        elif i > 20 and rng.random() < 0.15:
            victim = rng.randrange(0, i)
            ops.append({"op": "delete", "i": i, "key": f"k{victim}"})
        else:
            ops.append({"op": "put", "i": i, "key": f"k{i}", "value": i})
    return ops


def hnsw_vector(doc: int) -> np.ndarray:
    """Deterministic per-doc vector (distinct, reproducible)."""
    return np.sin((doc + 1) * (np.arange(HNSW_DIM) + 1)).astype(np.float32)


def simulate(ops: list[dict], upto: int) -> dict:
    """Expected logical state after ops[:upto] — the verifier's oracle."""
    objects: dict[str, int] = {}
    bitmap: dict[str, set[int]] = {}
    postings: dict[str, dict[int, list[int]]] = {}
    raft_is: list[int] = []
    hnsw_docs: set[int] = set()
    for op in ops[:upto]:
        kind = op["op"]
        if kind == "put":
            objects[op["key"]] = op["value"]
        elif kind == "delete":
            objects.pop(op["key"], None)
        elif kind == "radd":
            bitmap.setdefault(op["key"], set()).update(op["ids"])
        elif kind == "mset":
            postings.setdefault(op["key"], {})[op["doc"]] = [op["tf"], 100]
        elif kind == "raft":
            raft_is.append(op["i"])
        elif kind == "hadd":
            hnsw_docs.add(op["doc"])
    return {"objects": objects, "bitmap": bitmap, "postings": postings,
            "raft": raft_is, "hnsw": hnsw_docs}


def touched_key(op: dict) -> tuple[str, str] | None:
    """(state-domain, key) op mutates — the verifier's one-op tolerance."""
    kind = op["op"]
    if kind in ("put", "delete", "radd", "mset"):
        domain = {"put": "objects", "delete": "objects",
                  "radd": "bitmap", "mset": "postings"}[kind]
        return (domain, op["key"])
    if kind == "raft":
        return ("raft", str(op["i"]))
    if kind == "hadd":
        return ("hnsw", str(op["doc"]))
    return None


# -- store assembly (shared by run and verify) --------------------------------


class _StubServer:
    """RaftNode wants routes; the solo worker never serves them."""

    def route(self, path, fn):
        pass


def _open_state(base: str, sync_wal: bool = True, device: str = "cuda"):
    from weaviate_tpu_torch.cluster.raft import RaftNode
    from weaviate_tpu_torch.engine.hnsw import HNSWIndex
    from weaviate_tpu_torch.storage.kv import KVStore

    store = KVStore(os.path.join(base, "store"), sync_wal=sync_wal)
    # small memtables so seals/segment writes happen ORGANICALLY inside
    # the op budget — every crashpoint must be reachable
    objects = store.bucket("objects", "replace", memtable_limit=4096)
    bitmap = store.bucket("bitmap", "roaringset", memtable_limit=4096)
    postings = store.bucket("postings", "map", memtable_limit=4096)
    raft_bucket = store.bucket("raft", "replace", sync_wal=True)

    applied: list[int] = []
    raft = RaftNode(
        "solo", ["solo"], lambda n: None, _StubServer(),
        apply_fn=lambda op: applied.append(op["i"]),
        store_bucket=raft_bucket,
        snapshot_fn=lambda: {"is": list(applied)},
        restore_fn=lambda s: applied.extend(s["is"]),
        snapshot_threshold=10 ** 9)  # explicit raft_snap ops only
    hnsw = HNSWIndex(dim=HNSW_DIM, commit_log_dir=os.path.join(base, "hnsw"),
                     condense_above_bytes=1 << 30,  # explicit hsnap only
                     device=device)
    return {"store": store, "objects": objects, "bitmap": bitmap,
            "postings": postings, "raft": raft, "applied": applied,
            "hnsw": hnsw}


# -- worker -------------------------------------------------------------------


def run_worker(base: str, n_ops: int, seed: int, start: int = 0,
               sync_wal: bool = True, device: str = "cuda") -> int:
    """Execute ops[start:] against ``base``, journaling each ack. The
    caller arms faultline (env) BEFORE the store opens so crashpoints
    inside recovery/open fire too. Returns 0 when the whole sequence
    completed (the armed schedule never fired)."""
    from weaviate_tpu_torch.cluster.raft import LEADER

    st = _open_state(base, sync_wal=sync_wal, device=device)
    raft = st["raft"]
    if raft.role != LEADER:
        raft._run_election()  # solo: unconditional, no RPC
    jf = open(os.path.join(base, "journal.jsonl"), "a")

    def ack(i: int) -> None:
        jf.write(json.dumps({"i": i}) + "\n")
        jf.flush()
        os.fsync(jf.fileno())

    for op in op_sequence(n_ops, seed)[start:]:
        kind = op["op"]
        if kind == "put":
            st["objects"].put(op["key"].encode(), op["value"])
        elif kind == "delete":
            st["objects"].delete(op["key"].encode())
        elif kind == "radd":
            st["bitmap"].bitmap_add(op["key"].encode(), op["ids"])
        elif kind == "mset":
            st["postings"].map_set(op["key"].encode(),
                                   {op["doc"]: [op["tf"], 100]})
        elif kind == "flush":
            st[op["bucket"]].flush()
        elif kind == "raft":
            raft.propose_local({"type": "crash_op", "i": op["i"]},
                               timeout=10.0)
        elif kind == "raft_snap":
            raft.take_snapshot()
        elif kind == "hadd":
            st["hnsw"].add(op["doc"], hnsw_vector(op["doc"]))
        elif kind == "hsnap":
            st["hnsw"].condense()
        ack(op["i"])
    jf.close()
    st["store"].close()
    st["hnsw"].close()
    return 0


# -- verifier -----------------------------------------------------------------


def _journal_count(base: str) -> int:
    path = os.path.join(base, "journal.jsonl")
    if not os.path.exists(path):
        return 0
    n = 0
    with open(path) as f:
        for line in f:
            if line.endswith("\n"):  # a torn final line never acked
                n += 1
    return n


def verify(base: str, n_ops: int, seed: int, device: str = "cuda") -> dict:
    """Reopen everything and check the prefix-durability invariants.
    Returns a report dict; ``report["ok"]`` is the verdict."""
    ops = op_sequence(n_ops, seed)
    j = _journal_count(base)
    expected = simulate(ops, j)
    # the in-flight op (index j) may have become durable before the
    # crash — its one (domain, key) is allowed to match either state
    tolerance = touched_key(ops[j]) if j < len(ops) else None
    with_op_j = simulate(ops, j + 1)

    lost: list[str] = []
    phantom: list[str] = []

    def check(domain: str, key: str, actual, exp, exp2):
        want = exp.get(key)
        alt = exp2.get(key) if tolerance == (domain, key) else want
        if actual == want or actual == alt:
            return
        if actual is None or (isinstance(actual, (set, dict)) and not actual
                              and want):
            lost.append(f"{domain}/{key}: acked {want!r}, recovered "
                        f"{actual!r}")
        else:
            phantom.append(f"{domain}/{key}: recovered {actual!r}, "
                           f"expected {want!r}")

    st = _open_state(base, sync_wal=True, device=device)
    try:
        keys = set(expected["objects"]) | set(with_op_j["objects"]) | \
            {op["key"] for op in ops if op["op"] in ("put", "delete")}
        for k in sorted(keys):
            check("objects", k, st["objects"].get(k.encode()),
                  expected["objects"], with_op_j["objects"])
        for k in sorted(set(expected["bitmap"]) | set(with_op_j["bitmap"])):
            actual = set(st["bitmap"].get_bitmap(k.encode()).tolist())
            check("bitmap", k, actual or None,
                  {k2: v or None for k2, v in expected["bitmap"].items()},
                  {k2: v or None for k2, v in with_op_j["bitmap"].items()})
        for k in sorted(set(expected["postings"]) |
                        set(with_op_j["postings"])):
            actual = {int(d): list(v) for d, v in
                      st["postings"].get_map(k.encode()).items()} or None
            check("postings", k, actual,
                  expected["postings"], with_op_j["postings"])

        # raft: every journaled propose must be in snapshot-state + log
        node = st["raft"]
        present = set(st["applied"])
        for e in node.log:
            op = e.get("op") or {}
            if op.get("type") == "crash_op":
                present.add(op["i"])
        for i in expected["raft"]:
            if i not in present:
                lost.append(f"raft/{i}: acked propose missing after restart")
        meta_ok = node.current_term > 0 or not expected["raft"]

        # hnsw: journaled inserts findable with their exact vector
        idx = st["hnsw"]
        for doc in sorted(expected["hnsw"]):
            slot = idx._id_to_slot.get(doc)
            if slot is None:
                lost.append(f"hnsw/{doc}: acked insert missing after "
                            "restart")
            elif not np.allclose(idx._vecs[slot], hnsw_vector(doc)):
                phantom.append(f"hnsw/{doc}: vector mismatch after replay")
    finally:
        st["store"].close()
        st["hnsw"].close()

    from weaviate_tpu_torch.storage import recovery

    report = {
        "ok": not lost and not phantom and meta_ok,
        "journaled_ops": j,
        "total_ops": len(ops),
        "lost_acked_writes": lost,
        "phantom_or_mismatched": phantom,
        "raft_meta_ok": meta_ok,
        "hnsw_device": str(idx.device),
        "recovery": recovery.snapshot(),
    }
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crashtest-workload")
    ap.add_argument("mode", choices=("run", "verify"))
    ap.add_argument("base")
    ap.add_argument("--ops", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default="cuda",
                    help="where the HNSW index opens (default cuda; raises "
                         "without CUDA unless cpu is named)")
    args = ap.parse_args(argv)
    from weaviate_tpu_torch.device import resolve

    resolve(args.device)  # before anything opens: no CUDA, no silent CPU
    if args.mode == "run":
        from weaviate_tpu_torch.runtime import faultline

        faultline.arm_from_env()
        return run_worker(args.base, args.ops, args.seed, start=args.start,
                          device=args.device)
    report = verify(args.base, args.ops, args.seed, device=args.device)
    out = json.dumps(report, indent=2, default=str)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out)
    else:
        print(out)
    return 0 if report["ok"] else 2


if __name__ == "__main__":
    sys.exit(main())
