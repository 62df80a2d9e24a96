"""The load generator (``loadgen/loadgen.cpp``): built once a checkout with
g++ against the system ``libnghttp2.so.14``, run as a process of its own,
its records read back."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import tempfile
from dataclasses import dataclass

import numpy as np

from portbench.manifest import PKG, ROOT
from portbench.reference import Answer

SRC = os.path.join(PKG, "loadgen", "loadgen.cpp")
HDR = os.path.join(PKG, "loadgen", "nghttp2_abi.h")
FLAGS = ["-O2", "-std=c++17"]
LINK = ["-l:libnghttp2.so.14"]
BUILD_DIR = os.path.join(ROOT, "build", "portbench")

LAT_DTYPE = np.dtype([("query", "<u4"), ("status", "<i4"),
                      ("t_send", "<i8"), ("t_done", "<i8")])
RESULT_DTYPE = np.dtype([("uuid", "S36"), ("dmin", "<f4"), ("dmax", "<f4")])


def binary() -> str:
    """The built load generator, under a name that carries a hash of its
    sources and flags: a fixed path in the checkout, built on first use
    (to a temporary name, then renamed, so that a run never sees half a
    file)."""
    h = hashlib.sha256()
    for p in (SRC, HDR):
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS + LINK).encode())
    path = os.path.join(BUILD_DIR, f"loadgen-{h.hexdigest()[:16]}")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".loadgen-")
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, SRC, "-o", tmp, *LINK], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


@dataclass
class Window:
    summary: dict
    lat: np.ndarray      # LAT_DTYPE, one record a request of the window
    lat_all: np.ndarray  # and the warm-up's requests too
    answers: list        # [Answer], the distinct replies of each query
    warm_ok: int         # good replies to requests sent in the warm-up
    warm_failed: int     # warm-up requests without a good reply

    @property
    def ok(self) -> np.ndarray:
        return self.lat["status"] == 0


def start(port: int, traffic: dict, seconds: float, dim: int, qfile: str,
          hfile: str, out: str | None = None, conns: int | None = None,
          streams: int | None = None, warmup_s: float = 0.0) -> subprocess.Popen:
    """The closed loop for ``warmup_s`` and then the window's ``seconds``:
    each client sends its next request as soon as its reply has come."""
    cmd = [binary(), "--port", str(port),
           "--conns", str(conns or traffic["connections"]),
           "--streams", str(streams or traffic["streams"]),
           "--seconds", str(seconds), "--dim", str(dim), "--queries", qfile,
           "--head", hfile, "--drain-s", str(traffic["drain_s"]),
           "--warmup-s", str(warmup_s)]
    if out is not None:
        cmd += ["--out", out]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc: subprocess.Popen, timeout: float) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"loadgen exited {proc.returncode}: {err.strip()[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def read_window(summary: dict, out: str, order: np.ndarray) -> Window:
    """The records of a run with ``--out``, the window's apart from the
    warm-up's (sent before the window's start, at time 0). ``order`` maps
    the query file's rows back to the query set's indices."""
    lat = np.fromfile(out + ".lat", LAT_DTYPE)
    lat["query"] = order[lat["query"]]
    lat_all = lat
    warm = lat[lat["t_send"] < 0]
    lat = lat[lat["t_send"] >= 0]
    raw = np.fromfile(out + ".ans", np.uint8)
    answers = []
    pos = 0
    while pos < len(raw):
        q, count, n = np.frombuffer(raw[pos:pos + 12].tobytes(), "<u4")
        pos += 12
        res = np.frombuffer(raw[pos:pos + n * RESULT_DTYPE.itemsize].tobytes(),
                            RESULT_DTYPE)
        pos += n * RESULT_DTYPE.itemsize
        answers.append(Answer(query=int(order[q]), count=int(count),
                              uuids=[u.decode() for u in res["uuid"]],
                              dists=res["dmin"].copy(), dists_max=res["dmax"].copy()))
    n_ok = int((warm["status"] == 0).sum())
    return Window(summary=summary, lat=lat, lat_all=lat_all, answers=answers, warm_ok=n_ok,
                  warm_failed=len(warm) - n_ok)
