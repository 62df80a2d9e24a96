"""Two processes x 4 CPU shards: the port's cross-process merge.

Each process joins one ``torch.distributed`` group (gloo) through
``parallel.mesh.maybe_initialize_distributed`` from the same three
``DCN_*`` variables the JAX package reads, holds only its own four row
shards, and runs the flat, two-level and BQ steps of
``parallel/sharded_search`` and a PQ4 store with its device rescore rows
(trained across the processes) over the global 8-shard mesh; the candidate
blocks cross the process boundary the way they would cross between hosts.
Every process's answers must equal the single-process 8-shard answers bit
for bit (the JAX package's tests/test_multihost.py, ported). NCCL refuses
two ranks on one GPU, so this leg is verified on the CPU only.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import torch

from weaviate_tpu_torch.parallel import mesh as tmesh
from weaviate_tpu_torch.parallel import sharded_search as tss

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    from weaviate_tpu_torch.parallel.mesh import (
        make_hierarchical_mesh, make_mesh, maybe_initialize_distributed)
    from weaviate_tpu_torch.parallel.sharded_search import (
        RowSharded, shard_array)
    sys.path.insert(0, sys.argv[2])
    from test_torch_multihost import _steps

    assert maybe_initialize_distributed()
    assert dist.get_world_size() == 2
    local = [torch.device("cpu")] * 4
    flat = make_mesh(devices=local)
    hier = make_hierarchical_mesh(devices=local)
    assert flat.shape == {"shard": 8}, flat.shape
    assert hier.shape == {"host": 2, "ici": 4}, hier.shape
    rank = dist.get_rank()
    # a process holds only its own shards
    held = shard_array(np.zeros((64, 2), np.float32), flat)
    assert [s for s, t in enumerate(held.parts) if t is not None] == \\
        list(range(4 * rank, 4 * rank + 4))
    out = _steps(flat, hier)
    np.savez(sys.argv[1], **{k: v.numpy() for k, v in out.items()})
    dist.destroy_process_group()
    print(f"proc {rank}: OK", flush=True)
""")


def _steps(flat, hier) -> dict:
    """The flat, per-query-filtered, two-level, BQ and PQ4 steps on both
    meshes; the same seed in every process."""
    from weaviate_tpu_torch.engine.quantized import QuantizedVectorStore
    from weaviate_tpu_torch.ops import bq as bq_ops

    n, d, b, k = 512, 16, 4, 5
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = torch.from_numpy(x[[7, 99, 255, 444]] + 0.01)
    valid = np.ones(n, dtype=bool)
    valid[::13] = False
    allow = rng.random((b, n)) > 0.4
    out = {}
    for name, mesh in (("flat", flat), ("hier", hier)):
        for sel in ("approx", "fused"):
            for masked in (False, True):
                dd, ii = tss.sharded_topk(
                    q, tss.shard_array(x, mesh), tss.shard_array(valid, mesh),
                    None, k=k, chunk_size=32, metric="l2-squared", mesh=mesh,
                    selection=sel,
                    allow_rows=(tss.shard_array(allow, mesh, dim=1)
                                if masked else None))
                out[f"{name}_{sel}_{masked}_d"] = dd
                out[f"{name}_{sel}_{masked}_i"] = ii
        xb = rng.standard_normal((n, 64)).astype(np.float32) if name == "flat" \
            else xb
        qb = torch.from_numpy(xb[[3, 200, 301, 500]] + 0.05)
        codes = bq_ops.bq_encode(torch.from_numpy(xb))
        for compact in (False, True):
            dd, ii = tss.sharded_quantized_topk(
                qb, bq_ops.bq_encode(qb), tss.shard_array(codes, mesh),
                tss.shard_array(valid, mesh), tss.shard_array(xb, mesh).__class__(
                    *_bf16(tss.shard_array(xb, mesh))), None, k=16, k_out=8,
                chunk_size=32, quantization="bq", metric="l2-squared",
                mesh=mesh, dcn_compact=compact)
            out[f"{name}_bq_{compact}_d"] = dd
            out[f"{name}_bq_{compact}_i"] = ii
        # a PQ4 store with the device rescore rows: train() fits its
        # codebook on rows that each process reads from every shard, so
        # every process fits the single-process codebook
        pq = QuantizedVectorStore(dim=d, metric="l2-squared", quantization="pq",
                                  capacity=n, chunk_size=32, rescore="device",
                                  mesh=mesh)
        pq.add(x)
        pq.delete(np.flatnonzero(~valid))
        pq.train(iters=4, seed=0)
        dd, ii = pq.search(q.numpy(), k)
        out[f"{name}_pq_centroids"] = pq.codebook.centroids.cpu()
        out[f"{name}_pq_d"] = torch.from_numpy(dd)
        out[f"{name}_pq_i"] = torch.from_numpy(ii)
    return out


def _bf16(rs):
    """The RowSharded rows as bf16 (the device rescore tier)."""
    return ([None if t is None else t.to(torch.bfloat16) for t in rs.parts],
            rs.shape, rs.dim, rs.mesh, torch.bfloat16)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_steps_equal_single_process(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for pid in range(2):
        env = dict(os.environ, DCN_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   DCN_NUM_PROCESSES="2", DCN_PROCESS_ID=str(pid),
                   PYTHONPATH=os.pathsep.join(sys.path))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp_path / f"out{pid}.npz"),
             here], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
            raise AssertionError("the two-process sharded step timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert "OK" in out, out
    cpu8 = [torch.device("cpu")] * 8
    want = _steps(tmesh.make_mesh(devices=cpu8),
                  tmesh.make_hierarchical_mesh(n_hosts=2, devices=cpu8))
    assert want["flat_approx_False_i"][:, 0].tolist() == [7, 99, 255, 444]
    for pid in range(2):
        got = np.load(tmp_path / f"out{pid}.npz")
        assert sorted(got.files) == sorted(want)
        for key, val in want.items():
            np.testing.assert_array_equal(got[key], val.numpy(),
                                          err_msg=f"proc {pid}: {key}")
    for key in want:  # 1-D and two-level agree bit for bit as well (the
        # bf16 cross-host block rounds the rescored distances, not the ids)
        if key.startswith("flat_") and not (key.startswith("flat_bq_True")
                                            and key.endswith("_d")):
            assert torch.equal(want[key], want["hier_" + key[5:]]), key
