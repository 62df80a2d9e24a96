"""The benchmark's own tests: ``python -m pytest portbench/tests``.

On the CPU they run the whole harness at a tiny size (a copy of the
manifest, the configurations and the traffic scaled down in a temporary
root), with the kernels' plain versions. Tests marked ``card`` need a
CUDA device and skip without one; they run on the chip with
``python3 -m pytest portbench/tests -m card``.
"""

import json
import os
import shutil

import pytest

from portbench.manifest import PKG, ROOT

TINY = {"rows": 3000, "dim": 32, "key_space": 12000, "clusters": 16}
TINY_TRAFFIC = {"queries": 64, "connections": 2, "streams": 2, "warmup_s": 1}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this machine has none")
    return "cuda"


def make_root(dst: str, scale: bool = True) -> str:
    """A checkout-like root at ``dst``: BENCHMARK.json and the benchmark's
    data files, scaled down to ``TINY``."""
    os.makedirs(os.path.join(dst, "portbench"), exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(os.path.join(PKG, sub), os.path.join(dst, "portbench", sub),
                        dirs_exist_ok=True)
    if not scale:
        return dst
    for name in os.listdir(os.path.join(dst, "portbench", "configs")):
        p = os.path.join(dst, "portbench", "configs", name)
        with open(p) as f:
            c = json.load(f)
        c.update(TINY)
        for v in c["collection"]["vectors"]:
            v["dim"] = TINY["dim"]
        with open(p, "w") as f:
            json.dump(c, f)
    for name in os.listdir(os.path.join(dst, "portbench", "workloads")):
        p = os.path.join(dst, "portbench", "workloads", name)
        with open(p) as f:
            t = json.load(f)
        t.update(TINY_TRAFFIC)
        if t.get("filter"):
            # a quarter of the tiny key space, so that the answers are full
            t["filter"]["value"] = int(TINY["key_space"] * 0.75)
        with open(p, "w") as f:
            json.dump(t, f)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """The scaled-down root; the whole harness needs g++ and the system
    libnghttp2.so.14 (the load generator and the port's data plane)."""
    import ctypes
    import shutil as sh

    if sh.which("g++") is None:
        pytest.skip("no g++: the load generator cannot be built")
    try:
        ctypes.CDLL("libnghttp2.so.14")
    except OSError:
        pytest.skip("no libnghttp2.so.14 on this machine")
    return make_root(str(tmp_path_factory.mktemp("tiny")))
