"""Kernelscope in the port, held to the JAX package's tests/test_kernelscope.py.

The module-level units (memcpy estimator, attribution, apportionment,
variant roll-up, the explain sink, trace summaries, captures) run the
same calls through both packages' modules and must agree. The
integrations drive the port's batcher, engines and servers on the CPU,
where a drain is attributed as the JAX package attributes it (the window
minus the memcpy estimate), and compare the engine's EXPLAIN plan with
the JAX package's. On the card the residency is CUDA-event time: the
batcher's event path is driven here through a stand-in timer, and the
kernel registry is held to the symbols of ``csrc/*.cu`` (the
``fused_topk_pairs`` trap: it must not classify as the scan).
"""

from __future__ import annotations

import ast
import glob
import json
import os
import re
import threading
import time

import numpy as np
import pytest

from weaviate_tpu.runtime import kernelscope as jks
from weaviate_tpu_torch.runtime import kernelscope as tks

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolation():
    tks.reset_for_tests()
    jks.reset_for_tests()
    yield
    tks.reset_for_tests()
    jks.reset_for_tests()
    from weaviate_tpu_torch.runtime import degrade, driftwatch, tailboard

    driftwatch.reset_for_tests()
    tailboard.reset_for_tests()
    degrade.reset()


@pytest.fixture(params=["jax", "torch"])
def ks(request):
    return jks if request.param == "jax" else tks


# -- face 1 units: estimator / attribution / apportionment ------------------------


def test_memcpy_estimator_fallback_chain(ks):
    assert ks.memcpy_estimate(4096) == 0.0
    assert ks.attribute(0.01, 4096) == (0.01, 0.0)
    ks.observe_memcpy(0.002, 4096)
    assert ks.memcpy_estimate(4096) == pytest.approx(0.002)
    assert ks.memcpy_estimate(5000) == pytest.approx(0.002)
    assert ks.memcpy_estimate(1) == pytest.approx(0.002)
    ks.observe_memcpy(0.004, 4096)
    assert ks.memcpy_estimate(4096) == pytest.approx(0.2 * 0.004 + 0.8 * 0.002)
    ks.observe_memcpy(-1.0, 4096)
    assert ks.memcpy_estimate(4096) == pytest.approx(0.0024)


def test_attribute_clamps_into_window(ks):
    ks.observe_memcpy(0.05, 1024)
    assert ks.attribute(0.01, 1024) == (0.0, pytest.approx(0.01))
    assert ks.attribute(-5.0, 1024) == (0.0, 0.0)
    dev, mem = ks.attribute(0.2, 1024)
    assert dev + mem == pytest.approx(0.2) and mem == pytest.approx(0.05)


def test_result_nbytes_walks_pytrees(ks):
    ids = np.zeros((4, 8), np.int64)
    dists = np.zeros((4, 8), np.float32)
    assert ks.result_nbytes((ids, dists)) == ids.nbytes + dists.nbytes
    assert ks.result_nbytes([(ids,), [dists, None], 7]) == \
        ids.nbytes + dists.nbytes
    assert ks.result_nbytes(None) == 0


def test_apportion_shares_sum_exactly(ks):
    shares = ks.apportion(0.9, [1.0, 2.0, 3.0])
    assert sum(shares) == pytest.approx(0.9) and shares[2] == pytest.approx(0.45)
    assert ks.apportion(0.6, [0.0, 0.0, -1.0]) == pytest.approx([0.2] * 3)
    assert ks.apportion(1.0, []) == []


def test_record_dispatch_and_meter_roll_up_in_snapshot():
    """The same calls give the same snapshot in both packages (the port's
    adds the CUDA-event pool size)."""
    snaps = []
    for ks in (jks, tks):
        ks.record_dispatch("flat", 8, 16, 0.010, "drain")
        ks.record_dispatch("flat", 8, 16, 0.020, "drain")
        ks.meter("c0", "t0", 0.030)
        ks.meter("c0", "t0", -1.0)
        snap = ks.snapshot()
        v = snap["variants"]["flat/b8/k16"]
        assert v["n"] == 2 and v["source"] == "drain"
        assert v["ewma_ms"] == pytest.approx(0.2 * 20.0 + 0.8 * 10.0)
        snaps.append(snap)
    assert snaps[1].pop("cuda_event_pairs") == 0
    assert snaps[0] == snaps[1]


# -- face 2 units: the explain sink -------------------------------------------------


def test_explain_sink_merges_and_scopes(ks):
    assert not ks.explain_enabled()
    ks.explain_note("ivf", nprobe=4)  # no sink: a no-op
    token = ks.explain_begin()
    ks.explain_note("ivf", nprobe=4, nlist=64)
    ks.explain_note("ivf", candidates=128)
    inner = {}
    with ks.explain_scope(inner):
        ks.explain_note("a", x=1)
    ks.explain_note("store", path="full_scan")
    plan = ks.explain_end(token)
    assert not ks.explain_enabled()
    assert plan == {"ivf": {"nprobe": 4, "nlist": 64, "candidates": 128},
                    "store": {"path": "full_scan"}}
    assert inner == {"a": {"x": 1}}
    into = {"store": {"path": "x"}}
    ks.merge_plan(into, {"store": {"rows": 3}, "batcher": 5})
    assert into == {"store": {"path": "x", "rows": 3}, "batcher": 5}


# -- face 1 integration: the batcher's attribution ---------------------------------


def _drain_batcher(window_s=0.05, kind="flat", device=None):
    from weaviate_tpu_torch.runtime.query_batcher import QueryBatcher
    from weaviate_tpu_torch.runtime.transfer import DeviceResultHandle

    def async_fn(queries, k, allow):
        b = len(queries)

        def fin():
            time.sleep(window_s)
            return (np.arange(b * k, dtype=np.int64).reshape(b, k),
                    np.zeros((b, k), np.float32))

        return DeviceResultHandle((), finish=fin)

    def sync_fn(queries, k, allow):  # pragma: no cover — must not run
        raise AssertionError("sync path used")

    return QueryBatcher(sync_fn, async_batch_fn=async_fn, kind=kind,
                        device=device)


def _one(qb, k=3):
    from weaviate_tpu_torch.runtime.query_batcher import _Pending

    p = _Pending(np.zeros(4, np.float32), k, None)
    p.t_enqueue = time.perf_counter()
    qb._dispatch([p])
    assert p.event.wait(timeout=10.0)
    return p


def test_drain_attribution_populates_device_phase():
    """On the CPU an unsampled async dispatch is attributed as in the JAX
    package: the drain window minus the memcpy EWMA, source "drain"."""
    for _ in range(4):
        tks.observe_memcpy(0.004, 48)
    qb = _drain_batcher(window_s=0.05)
    try:
        p = _one(qb)
        assert p.error is None and p.device_source == "drain"
        assert p.device_s >= 0.03
        assert p.transfer_s == pytest.approx(0.004)
    finally:
        qb.stop()
    snap = tks.snapshot()
    v = snap["variants"]["flat/b1/k4"]
    assert snap["dispatches"]["drain"] >= 1
    assert v["source"] == "drain" and v["last_ms"] >= 30.0
    assert sum(tks.meters_snapshot().values()) == pytest.approx(
        tks.total_device_seconds(), rel=1e-6)
    from weaviate_tpu_torch.runtime import tailboard

    rec = tailboard.debug_flight()["dispatches"][-1]
    assert rec["t_source"] == "drain"
    assert rec["device_ms"] <= rec["window_ms"]


class _FakeTimer:
    """Stands in for the pooled CUDA-event pair on a CPU-only machine."""

    def __init__(self, elapsed=0.004, fail=None):
        self.elapsed, self.fail = elapsed, fail
        self.stopped = self.released = 0

    def stop(self):
        self.stopped += 1

    def elapsed_s(self):
        if self.fail is not None:
            raise self.fail
        return self.elapsed

    def release(self):
        self.released += 1


def test_card_residency_is_the_event_pair(monkeypatch):
    """With a device, the drain's residency is the event pair's elapsed
    time, read after the handle's result: not the window, never a wall
    fallback. The pair goes back to the pool once read; the transfer
    share stays inside the window."""
    timers = []

    def fake_start(device):
        assert device == "cuda-stand-in"
        timers.append(_FakeTimer(elapsed=0.004))
        return timers[-1]

    monkeypatch.setattr(tks, "start_timer", fake_start)
    tks.observe_memcpy(1.0, 48)  # far larger than the window: clamped
    qb = _drain_batcher(window_s=0.03, device="cuda-stand-in")
    try:
        p = _one(qb)
        assert p.error is None and p.device_source == "drain"
        assert p.device_s == pytest.approx(0.004)
        window = p.t_fetch_end - p.t_exec_start
        assert p.device_s + p.transfer_s <= window + 1e-9
    finally:
        qb.stop()
    (t,) = timers
    assert (t.stopped, t.released) == (1, 1)
    assert tks.snapshot()["variants"]["flat/b1/k4"]["last_ms"] == \
        pytest.approx(4.0)


def test_failed_event_read_raises_to_the_waiters(monkeypatch):
    """A CUDA-event read that fails is an error for the dispatch's
    waiters, not a quiet fall back to wall time."""
    t = _FakeTimer(fail=RuntimeError("cudaErrorNotReady"))
    monkeypatch.setattr(tks, "start_timer", lambda device: t)
    qb = _drain_batcher(window_s=0.0, device="cuda-stand-in")
    try:
        p = _one(qb)
        assert isinstance(p.error, RuntimeError)
        assert "cudaErrorNotReady" in str(p.error)
    finally:
        qb.stop()
    assert t.released == 1
    assert tks.snapshot()["dispatches"] == {"drain": 0, "wall": 0}


def test_start_timer_is_none_off_the_card():
    import torch

    assert tks.start_timer(None) is None
    assert tks.start_timer(torch.device("cpu")) is None


@pytest.mark.parametrize("path", ["null_device", "solo_filtered"])
def test_sync_paths_attribute_wall(path):
    """A sync path with no drain is attributed to the dispatch wall
    window, source "wall" (the JAX package's only meaning of it)."""
    from weaviate_tpu_torch.runtime.query_batcher import QueryBatcher

    def batch_fn(queries, k, allow):
        time.sleep(0.01)
        b = len(queries)
        return (np.arange(b * k, dtype=np.int64).reshape(b, k),
                np.zeros((b, k), np.float32))

    if path == "null_device":
        qb = QueryBatcher(batch_fn, async_batch_fn=lambda *a: None,
                          kind="flat")
        key, allow = "flat/b1/k4", None
    else:
        qb = QueryBatcher(batch_fn, supports_filter_batching=False,
                          kind="hnsw")
        key, allow = "hnsw/b1/k3", [1, 2, 3]
    try:
        ids, _ = qb.search(np.zeros(4, np.float32), 3, allow)
        assert ids.shape == (3,)
    finally:
        qb.stop()
    snap = tks.snapshot()
    assert snap["dispatches"]["wall"] == 1 and snap["dispatches"]["drain"] == 0
    assert snap["variants"][key]["source"] == "wall"
    assert snap["variants"][key]["last_ms"] > 0.0


def test_two_tenant_metering_sums_to_total():
    from weaviate_tpu_torch.runtime.query_batcher import QueryBatcher

    def batch_fn(queries, k, allow):
        b = len(queries)
        return (np.zeros((b, k), np.int64), np.zeros((b, k), np.float32))

    batchers = {t: QueryBatcher(batch_fn, max_batch=16,
                                owner={"collection": "Ks", "tenant": t})
                for t in ("t0", "t1")}
    try:
        for _ in range(40):
            for qb in batchers.values():
                qb.search(np.zeros(4, np.float32), 4)
    finally:
        for qb in batchers.values():
            qb.stop()
    meters = tks.meters_snapshot()
    assert meters[("Ks", "t0")] > 0 and meters[("Ks", "t1")] > 0
    total = tks.total_device_seconds()
    assert abs(sum(meters.values()) - total) / total < 0.05


# -- face 2 integration: EXPLAIN through the engines --------------------------------


def _plan(ks, fn):
    token = ks.explain_begin()
    try:
        out = fn()
    finally:
        plan = ks.explain_end(token)
    return plan, out


@pytest.mark.parametrize("case", ["unfiltered", "shared_mask", "gathered",
                                  "per_query"])
def test_flat_explain_plan_matches_jax(case):
    """The flat index and its store note the same EXPLAIN sections, with
    the same host integers, as the JAX package's, and explaining changes
    no answer."""
    from weaviate_tpu.engine.flat import FlatIndex as JFlat
    from weaviate_tpu_torch.engine.flat import FlatIndex as TFlat

    rng = np.random.default_rng(13)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    qs = rng.standard_normal((3, 16)).astype(np.float32)
    ids = np.arange(300)
    allow = {"unfiltered": None,
             "shared_mask": np.arange(0, 300, 2),
             "gathered": np.arange(10),
             "per_query": [np.arange(50), None, np.arange(100, 200)]}[case]
    plans = []
    for ks, idx in ((jks, JFlat(16, capacity=512)),
                    (tks, TFlat(16, capacity=512, device="cpu"))):
        idx.add_batch(ids, vecs)
        plan, (got_i, _) = _plan(
            ks, lambda: idx.search_by_vector_batch(qs, 5, allow))
        plain_i, _ = idx.search_by_vector_batch(qs, 5, allow)
        np.testing.assert_array_equal(got_i, plain_i)
        plans.append(plan)
    assert plans[0] == plans[1]
    assert plans[1]["index"]["kind"] == "flat"


def test_ivf_explain_plan_sections_match_jax():
    """A filtered IVF search notes the probe plan in the port as in the
    JAX package (same keys; the probe shape from the same settings), and
    sync equals async."""
    from weaviate_tpu.engine.ivf import IVFStore as JIVF
    from weaviate_tpu_torch.engine.ivf import IVFStore as TIVF

    rng = np.random.default_rng(7)
    data = rng.standard_normal((512, 16)).astype(np.float32)
    qs = rng.standard_normal((3, 16)).astype(np.float32)
    plans = []
    for ks, st in ((jks, JIVF(dim=16, nlist=8, nprobe=2, train_threshold=256,
                              delta_threshold=64)),
                   (tks, TIVF(dim=16, nlist=8, nprobe=2, train_threshold=256,
                              delta_threshold=64, device="cpu"))):
        st.add(data)
        allow = np.zeros(st.capacity, dtype=bool)
        allow[:256] = True
        plan, (d, i) = _plan(ks, lambda: st.search(qs, 10, allow))
        d2, i2 = st.search_async(qs, 10, allow).result()
        np.testing.assert_array_equal(i, i2)
        np.testing.assert_array_equal(d, d2)
        plans.append(plan["ivf"])
    assert plans[0].keys() == plans[1].keys()
    for key in ("nprobe", "nlist", "lists_frac", "quantized", "filtered",
                "queries", "k", "merge_legs", "delta_leg", "rescored"):
        assert plans[0][key] == plans[1][key], key


@pytest.fixture
def served(tmp_path, monkeypatch):
    """The port's REST server with sampling effectively off."""
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.api.rest import RestServer
    from weaviate_tpu_torch.db.database import Database
    from weaviate_tpu_torch.runtime import tracing

    monkeypatch.setenv("TRACE_SAMPLE_RATE", "0.001")
    tracing.reset_policy_for_tests()
    db = Database(str(tmp_path), device="cpu")
    srv = RestServer(db)
    srv.start()
    client = Client(srv.address)
    client.create_class({"name": "Ks", "properties": [
        {"name": "n", "data_type": "int"}]})
    rng = np.random.default_rng(11)
    for i in range(24):
        client.create_object("Ks", {"n": i}, vector=[
            float(x) for x in rng.standard_normal(8)])
    yield client, srv, db
    srv.stop()
    db.close()
    tracing.reset_policy_for_tests()


def _gql(client, explain=False):
    q = ('{ Get { Ks(limit: 3, '
         'where: {path: ["n"], operator: GreaterThanEqual, valueInt: 8}, '
         'nearVector: {vector: [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]}) '
         '{ _additional { id distance } } } }')
    path = "/v1/graphql" + ("?explain=true" if explain else "")
    return client.request("POST", path, body={"query": q, "variables": {}})


def test_rest_explain_and_debug_kernelscope(served):
    """``?explain=true`` returns the batcher and engine sections with the
    same results as the plain request; ``/v1/debug/kernelscope`` then
    reports variants, meters and dispatches."""
    from weaviate_tpu_torch.api.rest import DEBUG_ENDPOINTS

    client, srv, db = served
    plain = _gql(client)
    assert "_explain" not in plain
    resp = _gql(client, explain=True)
    plan = resp["_explain"]
    assert plan["batcher"]["batch"] >= 1 and plan["batcher"]["filtered"] >= 1
    assert plan["batcher"]["kind"] == "flat"
    assert "index" in plan or "store" in plan
    assert resp["data"] == plain["data"]
    assert _gql(client, explain=True)["data"] == plain["data"]
    out = client.request("GET", "/v1/debug/kernelscope")
    assert out["dispatches"]["drain"] + out["dispatches"]["wall"] >= 1
    assert out["total_device_seconds"] > 0 and out["variants"]
    assert out["meters"]
    assert "kernelscope" in DEBUG_ENDPOINTS and "profile" in DEBUG_ENDPOINTS


def test_grpc_x_explain_rides_trailing_metadata(tmp_path):
    grpc = pytest.importorskip("grpc")
    from weaviate_tpu_torch.api.grpc import v1_pb2 as pb
    from weaviate_tpu_torch.api.grpc.server import GrpcServer
    from weaviate_tpu_torch.db.database import Database
    from weaviate_tpu_torch.schema.config import CollectionConfig

    db = Database(str(tmp_path), device="cpu")
    server = GrpcServer(db).start()
    channel = grpc.insecure_channel(f"127.0.0.1:{server.port}")
    try:
        db.create_collection(CollectionConfig(name="Doc"))
        col = db.get_collection("Doc")
        rng = np.random.default_rng(5)
        for _ in range(8):
            col.put_object({}, vector=rng.standard_normal(8).astype(np.float32))
        search = channel.unary_unary(
            "/weaviate.v1.Weaviate/Search",
            request_serializer=pb.SearchRequest.SerializeToString,
            response_deserializer=pb.SearchReply.FromString)
        req = pb.SearchRequest(collection="Doc", limit=3)
        req.near_vector.vector_bytes = \
            rng.standard_normal(8).astype("<f4").tobytes()
        reply, call = search.with_call(req, metadata=(("x-explain", "true"),))
        assert len(reply.results) == 3
        plan = json.loads(dict(call.trailing_metadata() or ())["x-explain"])
        assert plan["batcher"]["batch"] >= 1
        _, call2 = search.with_call(req)
        assert "x-explain" not in dict(call2.trailing_metadata() or ())
    finally:
        channel.close()
        server.stop()
        db.close()


# -- the no-new-host-sync pin -------------------------------------------------------

_HOST_READS = {"item", "cpu", "tolist", "numpy", "synchronize"}


def test_explain_and_attribution_read_no_device_values():
    """Every ``explain_note`` call in the port's dispatch path passes host
    values only (no ``.item()`` / ``.cpu()`` / ``.tolist()`` /
    ``.numpy()`` on its arguments), and the batcher calls no
    ``synchronize``: the residency comes from the event pair the drain
    reads after its existing wait."""
    files = (glob.glob(os.path.join(REPO_ROOT, "weaviate_tpu_torch/engine/*.py"))
             + glob.glob(os.path.join(REPO_ROOT, "weaviate_tpu_torch/parallel/*.py"))
             + [os.path.join(REPO_ROOT, "weaviate_tpu_torch/runtime/query_batcher.py")])
    bad, notes = [], 0
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "explain_note":
                notes += 1
                for arg in ast.walk(node):
                    if (isinstance(arg, ast.Attribute)
                            and arg.attr in _HOST_READS):
                        bad.append((path, node.lineno, arg.attr))
            if (path.endswith("query_batcher.py")
                    and isinstance(f, ast.Attribute)
                    and f.attr == "synchronize"):
                bad.append((path, node.lineno, "synchronize"))
    assert notes >= 13 and bad == []


# -- face 4: on-demand kernel profiles ------------------------------------------------


_FAKE_EVENTS = [
    {"ph": "X", "cat": "kernel",
     "name": "void fused_topk_scan_kernel<float, 2, true, 4>(float const*)",
     "dur": 1500.0},
    {"ph": "X", "cat": "kernel",
     "name": "void fused_topk_pairs_kernel<true>(float const*, int const*)",
     "dur": 900.0},
    {"ph": "X", "cat": "kernel",
     "name": "void pq4_lut_block_kernel<true>(__nv_bfloat16 const*)",
     "dur": 800.0},
    {"ph": "X", "cat": "kernel",
     "name": "void at::native::vectorized_elementwise_kernel<4>()",
     "dur": 100.0},
    {"ph": "M", "name": "process_name"},  # metadata event: ignored
]


def test_capture_ranks_kernels_and_prunes(tmp_path):
    calls = []

    def fake(ms):
        calls.append(ms)
        return list(_FAKE_EVENTS)

    tks.configure(data_dir=str(tmp_path), keep=2, capturer=fake)
    rec = tks.capture_profile(7)
    assert calls == [7] and rec["ms"] == 7 and rec["raw_events"] == 5
    ranked = [(k["kernel"], k["device_ms"]) for k in rec["kernels"]]
    assert ranked == [("fused_topk_scan", 1.5), ("merge_epoch_topk", 0.9),
                      ("pq4_scan_reduce", 0.8), ("other", 0.1)]
    assert rec["total_device_ms"] == pytest.approx(3.3)
    tks.capture_profile(8)
    rec3 = tks.capture_profile(9)
    caps = tks.list_captures()
    assert len(caps) == 2 and caps[0]["id"] == rec3["id"]
    assert tks.load_capture(rec3["id"])["kernels"][0]["kernel"] == \
        "fused_topk_scan"
    assert tks.load_capture("../../etc/passwd") is None


def test_summaries_agree_with_jax_on_shared_names(ks):
    """``summarize_trace_events`` is the JAX package's, unchanged: on
    names both registries read alike the summaries are equal."""
    events = [{"ph": "X", "name": "distance_block", "dur": 500.0},
              {"ph": "X", "name": "merge_topk.2", "dur": 250.0},
              {"ph": "X", "name": "x", "dur": 0}, "junk", 3]
    out = ks.summarize_trace_events(events)
    assert [(k["kernel"], k["device_ms"]) for k in out["kernels"]] == \
        [("distance_block", 0.5), ("merge_epoch_topk", 0.25)]
    assert ks.summarize_trace_events(None) == \
        {"kernels": [], "total_device_ms": 0}


def _kernel_symbols(name: str) -> list[str]:
    """The ``__global__`` functions a counter's source (and the headers it
    includes) defines, as a CUDA trace names them."""
    csrc = os.path.join(REPO_ROOT, "weaviate_tpu_torch", "csrc")
    src = open(os.path.join(csrc, f"{name}.cu")).read()
    for inc in re.findall(r'#include\s+"([^"]+\.cuh)"', src):
        src += open(os.path.join(csrc, inc)).read()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)\s*\(", src)


from weaviate_tpu_torch.ops import kernels as _kernels  # noqa: E402


@pytest.mark.parametrize("counter", sorted(_kernels.launch_counts))
def test_every_kernel_classifies_to_its_friendly_name(counter):
    """Each launch counter's CUDA kernels classify to the counter's
    friendly name, never "other" — ``fused_topk_pairs_kernel`` to the
    survivor merge, not to ``fused_topk_scan``."""
    friendly = tks.KERNEL_FRIENDLY[counter]
    names = [n for n, _ in tks.KERNEL_REGISTRY]
    assert friendly in names
    syms = _kernel_symbols(counter)
    assert syms, counter
    for sym in syms:
        cupti = f"void {sym}<float, 2, true, 4>(float const*, int)"
        assert tks.classify_kernel(cupti) == friendly, cupti
        assert tks.classify_kernel(sym) == friendly, sym


@pytest.mark.parametrize("name,friendly", [
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nt_n_tilesize128x128x32", "distance_block"),
    ("void gemv2T_kernel_val<int, int, float, 128, 16>", "distance_block"),
    ("void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>", "merge_epoch_topk"),
    ("void at::native::mbtopk::radixFindKthValues<float>", "merge_epoch_topk"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor>", "other"),
])
def test_library_kernels_classify(name, friendly):
    assert tks.classify_kernel(name) == friendly


def test_attribute_to_spans_names_glue_after_its_kernel_span():
    """A device event takes the innermost ``kernel_span`` range its launch
    ran in (through the launch's correlation, or the operator's External
    id); a port kernel keeps its own name; an event launched outside any
    range stays "other"."""
    def x(cat, name, ts, dur, tid, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid, "pid": 1, "args": args}

    events = [
        x("user_annotation", "chunked_topk", 100, 100, 7),
        x("user_annotation", "distance_block", 110, 20, 7),
        x("cuda_runtime", "cudaLaunchKernel", 115, 1, 7, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 150, 1, 7, correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", 160, 1, 7, correlation=3),
        x("cpu_op", "aten::cat", 170, 5, 7, **{"External id": 9}),
        x("cuda_runtime", "cudaMemcpyAsync", 300, 1, 8, correlation=4),
        x("kernel", "void at::native::reduce_kernel<512>", 1000, 4, 20, correlation=1),
        x("kernel", "void at::native::FillFunctor<float>", 1004, 2, 20, correlation=2),
        x("kernel", "void distance_block_kernel<float, 2, true, 4>", 1006, 9, 20,
          correlation=3),
        x("kernel", "void at::native::CatArrayBatchedCopy<4>", 1015, 3, 20,
          **{"External id": 9}),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1020, 2, 21, correlation=4),
    ]
    out = tks.attribute_to_spans(events)
    assert events[7]["name"] == "void at::native::reduce_kernel<512>"  # untouched
    names = [e["name"] for e in out if e["cat"] in tks.DEVICE_CATEGORIES]
    assert names == ["distance_block: void at::native::reduce_kernel<512>",
                     "chunked_topk: void at::native::FillFunctor<float>",
                     "void distance_block_kernel<float, 2, true, 4>",
                     "chunked_topk: void at::native::CatArrayBatchedCopy<4>",
                     "Memcpy DtoH (Device -> Pageable)"]
    ranked = [(k["kernel"], k["device_ms"]) for k in tks.summarize_trace_events(
        [e for e in out if e["cat"] in tks.DEVICE_CATEGORIES])["kernels"]]
    assert ranked == [("distance_block", 0.013), ("merge_epoch_topk", 0.005),
                      ("other", 0.002)]


def test_kernel_span_opens_a_range_only_during_a_capture(monkeypatch):
    import torch

    opened = []

    class Probe:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Probe)

    @tks.kernel_span("fused_topk_pairs")
    def f(a, b=2):
        return a + b

    assert f(1) == 3 and opened == []
    monkeypatch.setattr(tks, "_spans_on", True)
    assert f(1, b=5) == 6 and opened == ["fused_topk_pairs"]
    assert f.__name__ == "f"


def test_torch_capture_sees_the_worker_thread(tmp_path):
    """The real capture on the CPU: torch.profiler traces the operators of
    a thread other than the asking one (the batcher's worker), names them
    after the port function they ran in (the scan's running top-k), and a
    second capture while one runs raises, as a second
    ``jax.profiler.start_trace`` does."""
    import torch

    from weaviate_tpu_torch.ops.topk import chunked_topk_distances

    seen = []

    def capture(ms):  # the real capture, its events kept for the checks
        events = tks._torch_capture(ms)
        seen.extend(events)
        return events

    tks.configure(data_dir=str(tmp_path), device="cpu", capturer=capture)
    stop = threading.Event()
    a = torch.randn(64, 64)
    x = torch.randn(512, 64)

    def work():
        while not stop.is_set():
            torch.topk(torch.mm(a, a), 4)
            chunked_topk_distances(a[:4], x, 5, 256, metric="dot",
                                   selection="approx")

    th = threading.Thread(target=work)
    th.start()
    errors = []
    try:
        time.sleep(0.05)

        def second():
            time.sleep(0.05)
            try:
                tks.capture_profile(10)
            except RuntimeError as e:
                errors.append(str(e))

        t2 = threading.Thread(target=second)
        t2.start()
        rec = tks.capture_profile(300)
        t2.join()
    finally:
        stop.set()
        th.join()
    kernels = {k["kernel"]: k for k in rec["kernels"]}
    assert "merge_epoch_topk" in kernels  # aten::topk
    spanned = [e["name"] for e in seen if e["name"].startswith("chunked_topk: aten::")]
    assert spanned and all(tks.classify_kernel(n) == "merge_epoch_topk"
                           for n in spanned)
    assert rec["raw_events"] > 0
    assert errors == ["a profile capture is already running"]
    assert tks.list_captures()[0]["id"] == rec["id"]


def test_profile_rest_endpoint(served, tmp_path):
    client, srv, db = served
    from weaviate_tpu_torch.api.client import RestError

    calls = []

    def fake(ms):
        calls.append(ms)
        return list(_FAKE_EVENTS)

    tks.configure(data_dir=str(tmp_path / "caps"), capturer=fake)
    assert client.request("GET", "/v1/debug/profile") == {"captures": []}
    assert calls == []
    rec = client.request("GET", "/v1/debug/profile?ms=5")
    assert calls == [5] and rec["kernels"][0]["kernel"] == "fused_topk_scan"
    assert client.request("GET", "/v1/debug/profile")["captures"][0]["id"] == \
        rec["id"]
    full = client.request("GET", f"/v1/debug/profile?id={rec['id']}")
    assert full["total_device_ms"] == rec["total_device_ms"]
    for bad in ("ms=abc", "ms=0", "ms=999999"):
        with pytest.raises(RestError) as e:
            client.request("GET", f"/v1/debug/profile?{bad}")
        assert e.value.status == 422, bad
    with pytest.raises(RestError) as e:
        client.request("GET", "/v1/debug/profile?id=cap-0-0")
    assert e.value.status == 404


# -- PROFILING_PORT ------------------------------------------------------------------


def test_profiling_port_is_configuration_and_starts_nothing(caplog):
    """PROFILING_PORT parses as in the JAX package; torch has no profiler
    server, so the port starts none on any port and says where captures
    are served."""
    import logging

    from weaviate_tpu_torch.config import ServerConfig
    from weaviate_tpu_torch.server import Server

    cfg = ServerConfig.from_env({})
    assert cfg.profiling_port == 0 and cfg.profile_keep == 8
    cfg = ServerConfig.from_env({"PROFILING_PORT": "9431",
                                 "PROFILING_KEEP": "3"})
    assert cfg.profiling_port == 9431 and cfg.profile_keep == 3
    srv = Server.__new__(Server)
    with caplog.at_level(logging.INFO, "weaviate_tpu_torch.server"):
        assert srv._start_profiler(0) is False
        assert caplog.text == ""
        assert srv._start_profiler(9431) is False
    assert "/v1/debug/profile" in caplog.text
    assert "item 8" not in caplog.text
