"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up: the cell's data from the seed, the
port's server started with the native gRPC data plane, the corpus
imported through ``Collection.batch_put``, the LSM drained, the plane's
registration and reply cache filled and the cell's traffic warmed. Then
the load generator, a process of its own, holds the cell's closed loop
for ``--seconds``; after it, every reply of the window is judged against
the plain reference. The last line of standard output is the result;
the last lines of standard error are the numbers compared, each beside
its limit. ``--trace 1`` reports the per-layer metrics instead of the
end-to-end ones, from wrappers around the layers' calls and a profiler
trace of part of the window.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

from portbench.manifest import ROOT, load_cell, reader

FORBIDDEN = ("jax", "jaxlib", "flax", "weaviate_tpu")
CACHE = os.path.join(ROOT, "build", "portbench")


def _fixed_caches() -> None:
    """Every build cache at a fixed path inside the checkout; nothing
    else of the environment is read. The port's kernels and host library
    build under ``build/`` beside the package on their own."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"


def _boot_s() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def _process_start_s() -> float:
    """When this process started, on the CLOCK_BOOTTIME scale."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def _io() -> dict:
    with open("/proc/self/io") as f:
        return {k: int(v) for k, v in (ln.split(": ") for ln in f.read().splitlines())}


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str,
             fault=None, root: str = ROOT, tmp_root: str | None = None) -> dict:
    """Set up, measure and judge one run; returns the result line's dict.
    ``fault(dep)``, where given, plants a fault in the running program
    before the window (the tests that show a broken path reads wrong)."""
    import torch

    from portbench import client
    from portbench.data import make_dataset, query_order
    from portbench.reference import allowed_rows, judge
    from portbench.serve import Deployment, LayerProbe

    cell = load_cell(workload, root)
    cfg, traffic = cell.config, cell.traffic
    on_card = torch.device(device).type == "cuda"
    t_proc = _process_start_s()
    io0 = _io()

    phases = {}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    ds = make_dataset(seed, cfg["rows"], cfg["dim"], traffic["queries"],
                      cfg["key_space"], cfg["clusters"], device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    client.binary()
    lap("data_s")
    work = tempfile.mkdtemp(prefix="portbench-", dir=tmp_root)
    dep = Deployment(cfg, os.path.join(work, "db"), device)
    proc = None
    try:
        order = query_order(seed, traffic["queries"])
        qfile, hfile = os.path.join(work, "queries.f32"), os.path.join(work, "head.pb")
        ds.queries[order].tofile(qfile)
        dep.start()
        with open(hfile, "wb") as f:
            f.write(dep.request_head(traffic))
        lap("server_s")
        import_s = dep.create_and_import(ds)
        lap("import_s")
        # the first Search registers the collection with the plane, which
        # fills its reply cache on a thread of its own while the LSM drains
        client.finish(client.start(dep.port, traffic, 0, cfg["dim"], qfile, hfile,
                                   conns=1, streams=1), timeout=300)
        drain_passes = dep.drain()
        lap("drain_s")
        dep.warm_plane()
        lap("plane_warm_s")
        if fault is not None:
            fault(dep)
        probe = None
        if trace:
            probe = LayerProbe()
            probe.install()
            _profile_once(on_card)  # the profiler's own start-up, out of the window
        c0 = dep.counters()
        live_rows = dep.live_rows()
        out = os.path.join(work, "window")
        # the cell's own traffic warms and flows on into the window
        boot0, mono0 = _boot_s(), time.monotonic_ns()
        proc = client.start(dep.port, traffic, seconds, cfg["dim"], qfile, hfile,
                            out=out, warmup_s=traffic["warmup_s"])
        dtrace = None
        if trace:
            dtrace = _trace_window(traffic["warmup_s"], seconds, on_card)
        summary = client.finish(proc, timeout=seconds + traffic["drain_s"] + 120)
        proc = None
        c1 = dep.counters()
        win = client.read_window(summary, out, order)
        setup_s = boot0 + (int(summary["t0_ns"]) - mono0) / 1e9 - t_proc
        phases["traffic_warm_s"] = (int(summary["t0_ns"]) - mono0) / 1e9
        mem_peak = torch.cuda.max_memory_allocated() if on_card else 0
        if probe is not None:
            probe.uninstall()
    finally:
        if proc is not None:
            proc.kill()
            proc.communicate()
        dep.stop()
    del dep
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    io1 = _io()

    allow = allowed_rows(ds.keys, traffic.get("filter"))
    uuid_row = {u: i for i, u in enumerate(ds.uuids)}
    failed = int((~win.ok).sum()) + win.warm_failed
    verdict = judge(win.answers, ds.vectors, ds.queries, uuid_row, allow,
                    traffic["limit"], cfg["correct"]["max_dist_gap"],
                    cfg["correct"]["exact_topk"], failed, device,
                    unordered=int(summary["unordered"]),
                    shortfall_limit=cfg["correct"].get("recall_shortfall"))
    if summary["overflow"]:
        verdict.checks["answers_unkept"] = (int(summary["overflow"]), 0)
    shutil.rmtree(work, ignore_errors=True)

    run = SimpleNamespace(
        cell=cell, seconds=seconds, trace=trace, lat=win.lat, ok=win.ok, lat_all=win.lat_all,
        ok_since_c0=int(win.ok.sum()) + win.warm_ok,
        window_s=float(summary["window_s"]), t0_ns=int(summary["t0_ns"]),
        setup_s=setup_s, import_s=import_s, rows=cfg["rows"], dim=cfg["dim"],
        live_rows=live_rows, verdict=verdict, c0=c0, c1=c1, probe=probe,
        dtrace=dtrace)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        v = reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell.chips, "memory_peak_bytes": int(mem_peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    result = {"correct": verdict.correct, "attempted": int(len(win.lat_all)),
              "failed": failed, "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_s
        dev["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": dtrace.top_ops(),
                               "idle_gaps": dtrace.top_gaps()}
    launches = {k: c1["launches"][k] - c0["launches"][k] for k in c1["launches"]
                if c1["launches"][k] != c0["launches"][k]}
    cycles = {k: c1["cycles"][k] - c0["cycles"][k] for k in c1["cycles"]
              if c1["cycles"][k] != c0["cycles"][k]}
    result["run"] = {
        "workload": workload, "seed": seed, "seconds": seconds, "trace": int(trace),
        "window_s": run.window_s, "replies": int(win.ok.sum()),
        "distinct_answers": verdict.distinct, "drain_passes": drain_passes, "setup_phases": phases,
        "replies_by_second": _by_second(win, traffic["warmup_s"]), "launches": launches,
        "cycles_in_warmup_and_window": cycles,
        "plane": {"fast": c1["fast"] - c0["fast"], "fallback": c1["fallback"] - c0["fallback"],
                  "cache_misses": c1["cache_misses"] - c0["cache_misses"]},
        "bytes_written": io1["write_bytes"] - io0["write_bytes"],
        "chars_written": io1["wchar"] - io0["wchar"], "recall": verdict.recall}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in verdict.checks.items()}
    return result


def _by_second(win, warmup_s: float) -> list:
    """Good replies in each whole second from the warm-up's start (the
    drain's last part second left out), to show whether the rate held."""
    import numpy as np

    lat = win.lat_all[(win.lat_all["status"] == 0) & (win.lat_all["t_done"] > -warmup_s * 1e9)]
    t = lat["t_done"] / 1e9 + warmup_s
    n = int(t.max()) if len(t) else 0
    return np.bincount(t.astype(np.int64), minlength=n)[:n].tolist()


def _profile_once(on_card: bool) -> None:
    from portbench.serve import profiled

    with profiled(True):
        if on_card:
            import torch

            torch.cuda.synchronize()


def _trace_window(warmup_s: float, seconds: float, on_card: bool):
    """Profile the middle of the window: from a quarter in, for up to 3 s.
    Returns the reduced trace."""
    from portbench.serve import profiled
    from portbench.trace import read_trace

    span = min(3.0, seconds / 2)
    time.sleep(warmup_s + seconds / 4)
    with profiled(True) as prof:
        t0 = time.monotonic_ns()
        time.sleep(span)
        if on_card:
            import torch

            torch.cuda.synchronize()
        t1 = time.monotonic_ns()
    return read_trace(prof, (t1 - t0) / 1e9)


def _check_lines(result: dict) -> list[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in result["checks"].items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _fixed_caches()
    import torch

    cell = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for m in result["metrics"].values():
        if not math.isfinite(m["value"]):
            print(f"portbench: a metric is not finite: {result['metrics']}", file=sys.stderr)
            return 5
    print("portbench run: " + json.dumps(result["run"]), flush=True)
    sys.stderr.flush()
    for line in _check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
