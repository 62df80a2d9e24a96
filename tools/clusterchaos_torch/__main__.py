"""CLI: ``python -m tools.clusterchaos_torch [--device cpu]``.

Default: the deterministic scenario matrix. ``--sweep N`` runs N
randomized seeded rounds; ``--sweep-round K --seed S`` replays exactly
one sweep round from its printed seed — same schedule, same verdict.
"""

from __future__ import annotations

import argparse
import json
import sys


def _print_verdict(v: dict) -> None:
    status = "PASS" if v["ok"] else "FAIL"
    print(f"{status:5s} {v['scenario']:28s} seed={v['seed']} "
          f"ops={v['stats']['ops']} acked={v['stats']['acked_writes']} "
          f"rounds={v['stats']['beat_rounds']} wall={v.get('wall_s')}s")
    for inv in v["invariants"]:
        if not inv["ok"]:
            print(f"      INVARIANT {inv['name']} VIOLATED:")
            for viol in inv["violations"][:6]:
                print(f"        - {viol}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="clusterchaos",
        description="cluster-scale chaos harness: partitions + crashes "
                    "+ a history-checked consistency verdict")
    ap.add_argument("--scenario", default="",
                    help="run one named scenario from the matrix")
    ap.add_argument("--list", action="store_true",
                    help="list matrix scenario names")
    ap.add_argument("--sweep", type=int, default=0,
                    help="run N randomized seeded rounds")
    ap.add_argument("--sweep-round", type=int, default=-1,
                    help="replay ONE sweep round (with --seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where every node holds its stores (default cuda; "
                         "raises without CUDA unless cpu is named)")
    args = ap.parse_args(argv)

    from weaviate_tpu_torch.device import resolve

    resolve(args.device)

    from tools.clusterchaos_torch.harness import (
        SCENARIOS,
        run_matrix,
        run_scenario,
        run_sweep,
        sweep_spec,
    )

    if args.list:
        for name in SCENARIOS:
            print(name)
        return 0
    dev = args.device
    if args.sweep_round >= 0:
        verdicts = [run_scenario(sweep_spec(args.seed, args.sweep_round),
                                 device=dev)]
    elif args.sweep:
        verdicts = run_sweep(rounds=args.sweep, seed=args.seed, device=dev)
    elif args.scenario:
        verdicts = [run_scenario(SCENARIOS[args.scenario], device=dev)]
    else:
        verdicts = run_matrix(device=dev)

    ok = all(v["ok"] for v in verdicts)
    if args.json:
        print(json.dumps({"ok": ok, "verdicts": verdicts}, indent=2,
                         default=str))
    else:
        for v in verdicts:
            _print_verdict(v)
        print("clusterchaos: all invariants held" if ok
              else "clusterchaos: FAILURES above")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
