"""The whole harness on the CPU at a tiny size (the chip's look skipped,
the kernels' plain versions): a sound run of each cell reads correct, and
a run with the timed path broken underneath reads not correct."""

import numpy as np
import pytest

from portbench.run import run_cell

FLAT, BQ, FILTER = ("cohere768-flat.grpc-k100", "cohere768-flat-bq.grpc-k100",
                    "cohere768-flat.grpc-k100-filter1p")


def _run(root, cell, fault=None, trace=False, seed=2**31 + 99):
    return run_cell(cell, seed, 1.0, trace, "cpu", fault=fault, root=root)


@pytest.mark.parametrize("cell,trace", [(FLAT, False), (BQ, False), (FILTER, True)])
def test_a_sound_run_is_correct(tiny_root, cell, trace):
    r = _run(tiny_root, cell, trace=trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    from portbench.manifest import load_cell

    c = load_cell(cell, tiny_root)
    # on the CPU the profiler sees no device: the device's metrics read nothing
    want = {x["name"] for x in (c.per_layer if trace else c.end_to_end)
            if x["source"] != "device_trace"}
    assert want <= set(r["metrics"]), r["metrics"]


def _patch_results(monkeypatch, change):
    """Plant ``change(ids, dists, counts) -> (ids, dists, counts)`` where
    the shard finishes a batch's results."""
    from weaviate_tpu_torch.db.shard import Shard

    orig = Shard._finish_batch_results

    def broken(self, *a, **kw):
        return change(*orig(self, *a, **kw))

    return lambda dep: monkeypatch.setattr(Shard, "_finish_batch_results", broken)


def test_a_batch_answered_with_stale_results_fails(tiny_root, monkeypatch):
    first = []

    def stale(ids, dists, counts):
        if not first:
            first.append((ids[:1].copy(), dists[:1].copy(), counts[:1].copy()))
        i, d, c = first[0]
        n = len(ids)
        return np.repeat(i, n, 0), np.repeat(d, n, 0), np.repeat(c, n, 0)

    r = _run(tiny_root, FLAT, _patch_results(monkeypatch, stale))
    assert not r["correct"]


def test_half_of_each_batch_left_out_fails(tiny_root, monkeypatch):
    def half(ids, dists, counts):
        h = (len(ids) + 1) // 2
        ids, dists, counts = ids.copy(), dists.copy(), counts.copy()
        ids[h:] = ids[:len(ids) - h]
        dists[h:] = dists[:len(ids) - h]
        return ids, dists, counts

    r = _run(tiny_root, FLAT, _patch_results(monkeypatch, half))
    assert not r["correct"]


@pytest.mark.parametrize("cell", [FLAT, BQ])
def test_an_answer_altered_where_it_is_produced_fails(tiny_root, monkeypatch, cell):
    def alter(ids, dists, counts):
        ids = ids.copy()
        ids[:, [0, 1]] = ids[:, [1, 0]]  # two results trade uuids, not distances
        return ids, dists, counts

    r = _run(tiny_root, cell, _patch_results(monkeypatch, alter))
    assert not r["correct"]
    assert r["checks"]["max_dist_gap"]["value"] > r["checks"]["max_dist_gap"]["limit"]


def test_a_filter_dropped_fails(tiny_root, monkeypatch):
    from weaviate_tpu_torch.db.shard import Shard

    r = _run(tiny_root, FILTER,
             lambda dep: monkeypatch.setattr(Shard, "allow_mask", lambda self, where: None))
    assert not r["correct"]
    assert r["checks"]["bad_results"]["value"] > 0


def _bq_store(dep):
    shard = next(iter(dep.col.shards.values()))
    return shard.vector_indexes[""].store


def _rescore_one(dep):
    _bq_store(dep).rescore_limit = 1  # the scan keeps k candidates, not 16 k


def _random_candidates(monkeypatch):
    import torch

    from weaviate_tpu_torch.engine.quantized import QuantizedVectorStore

    orig = QuantizedVectorStore._scan

    def random_scan(self, q, k_cand, valid, **kw):
        d, i = orig(self, q, k_cand, valid, **kw)
        g = torch.Generator(device=i.device).manual_seed(7)
        return d, torch.randint(0, self.count, i.shape, generator=g, device=i.device,
                                dtype=i.dtype)

    return lambda dep: monkeypatch.setattr(QuantizedVectorStore, "_scan", random_scan)


@pytest.mark.parametrize("fault", ["rescore_limit_1", "random_candidates"])
def test_a_broken_bq_scan_fails(tiny_root, monkeypatch, fault):
    """The host rescore makes every returned distance exact whatever the
    scan passed it: only the recall held in ``correct`` sees the scan."""
    plant = _rescore_one if fault == "rescore_limit_1" else _random_candidates(monkeypatch)
    r = _run(tiny_root, BQ, plant)
    assert not r["correct"]
    c = r["checks"]["recall_shortfall"]
    assert c["value"] > c["limit"], r["checks"]
