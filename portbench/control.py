"""The control of the comparison that decides ``correct``: the reference
put in the program's place one precision below the configuration's
float32 (products in TF32), its answers judged as a run's replies are.
It has to come out as not correct; its readings set the upper end of
each limit. The benchmark's own runs never run it.

    python3 -m portbench.control --workload <name> --seeds 1,2,3

One line a seed: each number compared, beside its limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def control_verdict(workload: str, seed: int, device: str, root=None):
    from portbench.data import make_dataset
    from portbench.manifest import ROOT, load_cell
    from portbench.reference import Answer, allowed_rows, control_topk, judge

    cell = load_cell(workload, root or ROOT)
    cfg, traffic = cell.config, cell.traffic
    ds = make_dataset(seed, cfg["rows"], cfg["dim"], traffic["queries"],
                      cfg["key_space"], cfg["clusters"], device)
    allow = allowed_rows(ds.keys, traffic.get("filter"))
    d, rows = control_topk(ds.vectors, ds.queries, traffic["limit"], allow, device)
    answers = [Answer(query=q, count=1, uuids=[ds.uuids[r] for r in rows[q]],
                      dists=d[q].astype(np.float32)) for q in range(len(rows))]
    uuid_row = {u: i for i, u in enumerate(ds.uuids)}
    return judge(answers, ds.vectors, ds.queries, uuid_row, allow, traffic["limit"],
                 cfg["correct"]["max_dist_gap"], cfg["correct"]["exact_topk"], 0, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(",")):
        v = control_verdict(a.workload, seed, a.device)
        print(json.dumps({"workload": a.workload, "seed": seed, "correct": v.correct,
                          "recall": v.recall,
                          "checks": {k: {"value": x, "limit": lim}
                                     for k, (x, lim) in v.checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
