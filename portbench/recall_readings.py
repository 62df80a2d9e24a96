"""The readings that set a quantized cell's recall limit: the program's
own index for the cell's configuration (the one its shard builds), filled
with the seeded corpus at the cell's size and asked the cell's whole
query set, judged by the plain reference as a run's replies are. Sound,
its ``1 - recall`` gives the lower reading; with a scan fault planted
(``--fault rescore_limit_1``: the scan keeps k candidates, not
rescore_limit x k; ``--fault random_candidates``: the scan's candidates
replaced by random rows) the upper one. The benchmark's own runs never
run it.

    python3 -m portbench.recall_readings --workload <name> --seeds 1,2,3 [--fault F]

One line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BATCH = 128  # queries a search call, the plane's largest batch

FAULTS = ("rescore_limit_1", "random_candidates")


def _plant(index, fault: str | None) -> None:
    import torch

    store = index.store
    if fault == "rescore_limit_1":
        store.rescore_limit = 1
    elif fault == "random_candidates":
        orig = store._scan
        g = torch.Generator(device=store.device).manual_seed(7)

        def random_scan(q, k_cand, valid, **kw):
            d, i = orig(q, k_cand, valid, **kw)
            return d, torch.randint(0, store.count, i.shape, generator=g,
                                    device=i.device, dtype=i.dtype)

        store._scan = random_scan
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")


def reading(workload: str, seed: int, device: str, fault: str | None = None,
            root=None) -> dict:
    from weaviate_tpu_torch.db.shard import _make_vector_index
    from weaviate_tpu_torch.schema.config import CollectionConfig

    from portbench.data import make_dataset
    from portbench.manifest import ROOT, load_cell
    from portbench.reference import Answer, allowed_rows, judge

    cell = load_cell(workload, root or ROOT)
    cfg, traffic = cell.config, cell.traffic
    k = traffic["limit"]
    ds = make_dataset(seed, cfg["rows"], cfg["dim"], traffic["queries"],
                      cfg["key_space"], cfg["clusters"], device)
    vc = CollectionConfig.from_dict(cfg["collection"]).vectors[0]
    t0 = time.perf_counter()
    index = _make_vector_index(vc, cfg["dim"], device=device)
    index.add_batch(np.arange(cfg["rows"]), ds.vectors)
    _plant(index, fault)
    answers = []
    for s in range(0, len(ds.queries), BATCH):
        ids, dists = index.search_by_vector_batch(ds.queries[s:s + BATCH], k)
        for j in range(len(ids)):
            keep = ids[j] >= 0
            answers.append(Answer(query=s + j, count=1,
                                  uuids=[ds.uuids[r] for r in ids[j][keep]],
                                  dists=np.asarray(dists[j][keep], np.float32)))
    t_prog = time.perf_counter() - t0
    del index
    allow = allowed_rows(ds.keys, traffic.get("filter"))
    uuid_row = {u: i for i, u in enumerate(ds.uuids)}
    v = judge(answers, ds.vectors, ds.queries, uuid_row, allow, k,
              cfg["correct"]["max_dist_gap"], cfg["correct"]["exact_topk"], 0, device,
              shortfall_limit=cfg["correct"].get("recall_shortfall"))
    return {"workload": workload, "seed": seed, "fault": fault, "correct": v.correct,
            "recall": v.recall, "program_s": t_prog,
            "checks": {n: {"value": x, "limit": lim} for n, (x, lim) in v.checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=FAULTS, default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps(reading(a.workload, seed, a.device, a.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
