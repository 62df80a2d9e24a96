"""One port cluster node as a real subprocess — the clusterchaos kill
target. ``--device`` places its stores (default cuda: on the card, and
raising without one). Beside the JAX tool's routes it reports what only
this process sees: ``/chaos/status`` carries the process's kernel launch
counters (``weaviate_tpu_torch/ops/kernels.launch_counts``), its remote
search legs, each shard's rebuild of its device store from the LSM after
a restart (seconds and rows) and its flat stores' device bytes; and
``/chaos/near_vector`` runs nearVector through this node's own
``Collection`` (its coordinator path), so a harness can query a replica
it cannot reach in-process.

The harness spawns this (fixed port, shared bootstrap peer set), SIGKILLs
it mid-workload, and respawns it on the same data directory: the restart
has to recover raft state, rejoin gossip, and converge through hashbeat
like any crashed production node. Faults (including the node's own side
of a partition, and crashpoints that fire mid-2PC) arm from
``WEAVIATE_TPU_FAULTLINE`` BEFORE the node opens its stores, exactly
like the crashtest worker, so schedules inside recovery fire too.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _clock_rebuilds(device) -> list:
    """Time every shard's rebuild of its device store from the LSM
    (``Shard._restore_vector_indexes``, then the staged rows' flush to
    the device, synchronized): one record a shard, in open order."""
    import torch

    from weaviate_tpu_torch.db.shard import Shard

    rebuilds: list = []
    restore = Shard._restore_vector_indexes

    def timed(shard):
        t = time.perf_counter()
        restore(shard)
        for idx in shard.vector_indexes.values():
            flush = getattr(idx.store, "flush_staged", None)
            if flush is not None:
                flush()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rebuilds.append({"collection": shard.collection_name,
                         "shard": shard.name,
                         "rows": len(shard._doc_to_uuid),
                         "seconds": time.perf_counter() - t})

    Shard._restore_vector_indexes = timed
    return rebuilds


def _store_bytes(node) -> dict:
    """Device bytes and live rows of each loaded shard's flat store."""
    out = {}
    for cname, col in sorted(node.db.collections.items()):
        for sname, shard in sorted(col.shards.items()):
            idx = shard.vector_indexes.get("")
            st = getattr(idx, "store", None)
            if st is None:
                continue
            nbytes = sum(t.numel() * t.element_size()
                         for t in (getattr(st, a, None)
                                   for a in ("vectors", "valid", "sq_norms"))
                         if t is not None)
            out.setdefault(cname, {})[sname] = {"bytes": nbytes,
                                                "live": len(idx)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="clusterchaos-nodeproc")
    ap.add_argument("name")
    ap.add_argument("data_dir")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--peers", required=True, help="csv bootstrap names")
    ap.add_argument("--seeds", default="", help="csv seed addresses")
    ap.add_argument("--gossip", type=float, default=0.1)
    ap.add_argument("--elect", default="0.2,0.4")
    ap.add_argument("--dead-after", type=float, default=1.5)
    ap.add_argument("--remote-timeout", type=float, default=1.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from weaviate_tpu_torch.device import resolve
    from weaviate_tpu_torch.ops import kernels
    from weaviate_tpu_torch.runtime import faultline

    device = resolve(args.device)

    # arm BEFORE the node opens anything: a crashpoint scheduled inside
    # recovery/boot must be reachable, and this node's own partition
    # rules must govern its very first gossip/raft packets
    armed = faultline.arm_from_env()
    faultline.bind_node(args.name)
    rebuilds = _clock_rebuilds(device)

    from weaviate_tpu_torch.cluster.node import ClusterNode

    lo, hi = (float(x) for x in args.elect.split(","))
    node = ClusterNode(args.name, args.data_dir,
                       raft_peers=args.peers.split(","),
                       port=args.port,
                       gossip_interval=args.gossip,
                       election_timeout=(lo, hi),
                       remote_timeout=args.remote_timeout,
                       device=device)
    node.membership.dead_after = args.dead_after
    node.membership.suspect_after = args.dead_after * 0.6
    remote_calls: list = []
    search_shard = node.remote.search_shard

    def counted_search(*a, **kw):
        remote_calls.append(a[:3])
        return search_shard(*a, **kw)

    node.remote.search_shard = counted_search

    def status(_payload):
        return {"ok": True, "name": args.name,
                "collections": sorted(node.db.collections),
                "leader": node.raft.leader_id,
                "role": node.raft.role,
                "term": node.raft.current_term,
                "device": str(device),
                "launches": dict(kernels.launch_counts),
                "remote_searches": len(remote_calls),
                "rebuilds": list(rebuilds),
                "stores": _store_bytes(node),
                # armed schedule progress — how the harness diagnoses a
                # crashpoint that is not being driven toward firing
                "faults": [{"point": s.point, "action": s.action,
                            "calls": s.calls, "injected": s.injected}
                           for s in armed
                           if isinstance(s, faultline.Schedule)]}

    def near_vector(payload):
        """nearVector of each of ``vectors`` through this node's
        Collection: ``where`` is [path, operator, value] or None,
        ``selection`` the flat stores' selection for these queries."""
        from weaviate_tpu_torch.filters import Filter

        col = node.db.get_collection(payload["collection"])
        where = payload.get("where")
        where = None if where is None else Filter.where(*where)
        stores = [s.vector_indexes[""].store for s in col.shards.values()
                  if "" in s.vector_indexes]
        saved = [st.selection for st in stores]
        before = len(remote_calls)
        uuids, dists = [], []
        try:
            if payload.get("selection"):
                for st in stores:
                    st.selection = payload["selection"]
            for q in payload["vectors"]:
                res = col.near_vector(np.asarray(q, np.float32),
                                      k=int(payload["k"]), where=where,
                                      include_objects=False)
                uuids.append([r.uuid for r in res])
                dists.append([float(r.distance) for r in res])
        finally:
            for st, sel in zip(stores, saved):
                st.selection = sel
        return {"uuids": uuids, "distances": dists,
                "remote_searches": len(remote_calls) - before}

    node.server.route("/chaos/status", status)
    node.server.route("/chaos/near_vector", near_vector)
    seeds = [s for s in args.seeds.split(",") if s]
    node.start(seed_addrs=seeds or None)
    # serve until killed — the harness owns this process's lifetime
    while True:
        time.sleep(1.0)


if __name__ == "__main__":
    sys.exit(main())
