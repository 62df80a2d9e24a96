"""Build and load the CUDA kernels in ``weaviate_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``. The first call builds every kernel at once (one ``nvcc`` per
source, all started together) into ``build/torch_kernels/`` beside the
package; a library's file name carries a hash of its sources and flags,
so an edited source never loads a stale build. Building happens under a
lock: the query batcher's worker and transfer threads can reach first
use together.

There is no fallback: if ``nvcc`` or the build fails, the call raises.
Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the kernels' entry points (csrc/*.cu ``extern "C"``)
SIGNATURES = {
    "distance_block": ("wtt_distance_block",
                       [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _P]),
    "fused_topk_scan": ("wtt_fused_topk_scan",
                        [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P, _P, _I, _P]),
    "fused_topk_pairs": ("wtt_fused_topk_pairs",
                         [_P, _P, _I, _I, _I, _P, _P, _P]),
    "bq_scan_reduce": ("wtt_bq_scan_reduce",
                       [_P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P, _P, _P]),
    "pq4_scan_reduce": ("wtt_pq4_scan_reduce",
                        [_P, _P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P, _P, _P]),
    "bm25_block": ("wtt_bm25_block",
                   [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                    _P, _P]),
    "bq_hamming_block": ("wtt_bq_hamming_block",
                         [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]),
    "bq_mxu_block": ("wtt_bq_mxu_block",
                     [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]),
    "pq4_lut_block": ("wtt_pq4_lut_block",
                      [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P]),
    "pq4_recon_block": ("wtt_pq4_recon_block",
                        [_P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P, _P]),
}
# Residency queries of the two selection kernels: (shape arguments...,
# int* dynamic shared memory bytes) -> CTAs per SM
# (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
RESIDENCY = {
    "fused_topk_scan": ("wtt_fused_topk_scan_residency", [_I, _I, _I, ctypes.POINTER(_I)]),
    "fused_topk_pairs": ("wtt_fused_topk_pairs_residency", [_I, ctypes.POINTER(_I)]),
}

_lock = threading.Lock()
_funcs: dict[str, object] = {}
build_seconds: float | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in [os.path.join(CSRC, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def log_path(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    return _lib_path(name)[:-3] + ".log"


def _build_all_locked() -> None:
    global build_seconds
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in SIGNATURES:
        so = _lib_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        log = open(log_path(name), "wb")
        procs.append((name, so, tmp, log, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC, f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT, cwd=CSRC)))
    failed = []
    for name, so, tmp, log, p in procs:
        rc = p.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, so)  # atomic: no process loads a half-written file
        else:
            with open(log_path(name), errors="replace") as f:
                failed.append(f"{name} (nvcc rc={rc}):\n{f.read()[-4000:]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    for name, (sym, argtypes) in SIGNATURES.items():
        fn = getattr(ctypes.CDLL(_lib_path(name)), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _funcs[name] = fn
    for name, (sym, argtypes) in RESIDENCY.items():
        fn = getattr(ctypes.CDLL(_lib_path(name)), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _funcs[f"{name}.residency"] = fn
    build_seconds = time.perf_counter() - t0


def build_variant(name: str, defines: tuple[str, ...]):
    """Build ``csrc/<name>.cu`` once more with extra ``-D`` macros (a
    diagnostic build, such as the scan's product alone) and return its
    entry point. Serving never calls this."""
    _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = hashlib.sha1(" ".join(defines).encode()).hexdigest()[:8]
    so = _lib_path(name)[:-3] + f"-{tag}.so"
    if not os.path.exists(so):
        flags = [f"-D{d}" for d in defines]
        with open(so[:-3] + ".log", "wb") as log:
            subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-o", so,
                            os.path.join(CSRC, f"{name}.cu")],
                           stdout=log, stderr=subprocess.STDOUT, cwd=CSRC, check=True)
    sym, argtypes = SIGNATURES[name]
    fn = getattr(ctypes.CDLL(so), sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_all() -> float:
    """Build (if needed) and load every kernel; returns the seconds the
    first call spent, 0.0 on later calls."""
    with _lock:
        if _funcs:
            return 0.0
        _build_all_locked()
        return build_seconds


def kernel(name: str):
    """The ctypes entry point of kernel ``name``, built on first use."""
    fn = _funcs.get(name)
    if fn is None:
        build_all()
        fn = _funcs[name]
    return fn
