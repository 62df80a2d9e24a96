"""The kernel build cache's metrics (port of
``weaviate_tpu/runtime/compile_cache.py``).

The JAX package warms a persistent XLA compilation cache. The port's
cache is the kernel build directory (``ops/_build.py``:
``build/torch_kernels``), whose library names carry a hash of each
kernel's sources and flags: a library found there loads without
``nvcc``. This module turns the build's events into the same metrics:

- ``compile_cache_events{event}``: ``hit`` when a library loads from the
  build directory, ``miss`` when ``nvcc`` builds it;
- ``jit_compile_duration{signature}``: the seconds of each ``nvcc``
  build, labelled ``nvcc:<kernel>``;
- one flat, labelled estimate in the device-memory ledger per loaded
  library (``executables``, ``sharding="estimate"``): the card keeps the
  loaded modules resident but reports no size for them.
"""

from __future__ import annotations

import logging
import os
import threading

logger = logging.getLogger(__name__)

_done = False
_metrics_installed = False

_exec_key: int | None = None
_exec_count = 0
_exec_lock = threading.Lock()


def _note_executable() -> None:
    """One more loaded library: bump the ledger's flat estimate
    (``HBM_EXECUTABLE_ESTIMATE_BYTES`` each, default 4 MiB, as in the
    JAX package). Called from the build's listener, under the build
    lock; the lock here keeps the ledger entry single."""
    global _exec_key, _exec_count
    try:
        from weaviate_tpu_torch.runtime.hbm_ledger import ledger

        est_each = int(os.environ.get("HBM_EXECUTABLE_ESTIMATE_BYTES",
                                      str(4 << 20)))
        with _exec_lock:
            _exec_count += 1
            if _exec_key is None:
                _exec_key = ledger.register(
                    "executables", est_each * _exec_count,
                    collection="_runtime", shard="-", tenant="",
                    sharding="estimate")
            else:
                ledger.update(_exec_key, est_each * _exec_count)
    except Exception:  # noqa: BLE001 — accounting is best-effort
        pass


def on_build_event(event: str, name: str, seconds: float | None = None):
    """``ops/_build.py`` reports each library it finds, builds or loads;
    counted once ``install_compile_metrics`` ran, as the JAX package
    counts the compiles its listeners see."""
    if not _metrics_installed:
        return
    from weaviate_tpu_torch.runtime.metrics import (compile_cache_events,
                                                    jit_compile_duration)

    if event == "miss":
        compile_cache_events.labels("miss").inc()
        if seconds is not None:
            jit_compile_duration.labels(f"nvcc:{name}").observe(seconds)
    elif event == "hit":
        compile_cache_events.labels("hit").inc()
    elif event == "loaded":
        _note_executable()


def install_compile_metrics() -> None:
    """Feed the build's hit / miss / duration / loaded events into the
    metrics and the ledger (idempotent)."""
    global _metrics_installed
    _metrics_installed = True


def ensure_compile_cache() -> None:
    """Idempotent; call before the first kernel launch. Makes the build
    directory and installs the metrics; the directory persists across
    processes, so every process after the first loads without nvcc."""
    global _done
    if _done:
        return
    _done = True
    install_compile_metrics()
    from weaviate_tpu_torch.ops import _build

    try:
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
    except OSError as e:
        logger.warning("kernel build directory unavailable: %s", e)
