"""Crashpoint: kill-restart-verify crash harness over the PyTorch port.

The port's copy of ``tools/crashtest``: the same plans, op sequence and
invariants, driving ``weaviate_tpu_torch``'s LSM store, Raft and HNSW
index. It imports nothing of the JAX package or of ``tools/crashtest``.
Worker, verifier and harness take ``--device`` (default ``cuda``: the
HNSW index opens on the card and raises without one; ``--device cpu``
runs on the CPU, as the tests do).

The storage layer's durability claims are only as good as the worst
byte boundary nobody ever crashed it at. This harness makes process
death at every persistence boundary a ROUTINE, deterministic test:

- ``tools/crashtest_torch/workload.py`` is the subprocess worker: a seeded,
  single-threaded write workload over every strategy of LSM bucket, a
  solo raft node (driving ``raft.persist.*``), and an HNSW commit log
  (driving ``hnsw.snap.*``), arming faultline crash/torn schedules from
  the ``WEAVIATE_TPU_FAULTLINE`` env. After each ACKED op it appends a
  line to a client-side journal (its own file, fsynced, outside every
  faultline point) — the journal is the lower bound of what the store
  promised.
- ``tools/crashtest_torch/harness.py`` runs the matrix: for every named
  crashpoint (``faultline.CRASHPOINTS``) it spawns the worker with a
  schedule that ``os._exit(137)``s (or tears a write at byte
  granularity) at that boundary, then re-opens the state and verifies
  the invariants:

  1. **prefix durability** — the worker is single-threaded, so the
     durable state must equal the deterministic op sequence applied up
     to the journaled count ``j`` or ``j+1`` (the in-flight op may or
     may not have become durable; anything else is a lost or phantom
     acked write),
  2. **clean opens** — every bucket reopens without error, filing a
     recovery report (storage/recovery),
  3. **raft persistence** — every journaled raft op is present in the
     restored snapshot+log; term/votedFor survive,
  4. **HNSW** — every journaled insert is findable with its exact
     vector after snapshot/log replay.

Run: ``python -m tools.crashtest_torch --device cpu`` (deterministic
matrix) or ``python -m tools.crashtest_torch --sweep N --seed S`` (randomized sweep:
seeded (point, action, nth, torn_bytes) draws, workload continuing
over the same store across restarts).
"""

from tools.crashtest_torch.harness import (  # noqa: F401
    CrashResult, run_matrix, run_sweep, verify_dir,
)
