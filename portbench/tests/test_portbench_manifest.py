"""BENCHMARK.json against the contract the benchmark is written to, and
the harness finding a new cell and a new metric by name."""

import json
import os
import re

import pytest

from portbench.manifest import PKG, ROOT, load_cell, load_manifest, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def m():
    return load_manifest()


def test_top_level_keys(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) for p in m["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(TEXT.match(w) for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


def test_names_units_and_texts(m):
    metrics = m["end_to_end"] + m["per_layer"]
    for group in (m["configs"], m["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(m["paths"][0] + "/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(x["layer"])
    for x in metrics:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"


def test_every_cell_reports_what_the_contract_asks(m):
    """One chip each; every configuration used; every cell reports
    setup_s, another end-to-end metric and a per-layer metric; every
    per-layer metric's `moves` is reported in each of its cells."""
    assert {"setup_s"} <= {x["name"] for x in m["end_to_end"]}
    assert {c["name"] for c in m["configs"]} == {w["config"] for w in m["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in m["workloads"]:
        assert w["chips"] == 1
        cell = load_cell(w["name"])
        e2e = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for x in cell.per_layer:
            assert x["moves"] in e2e, (w["name"], x["name"])
    for x in m["per_layer"] + m["end_to_end"]:
        assert all(c in {w["name"] for w in m["workloads"]} for c in x.get("workloads", []))


def test_every_metric_has_a_reader(m):
    for x in m["end_to_end"] + m["per_layer"]:
        assert callable(reader(x["name"])), x["name"]


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """A throwaway traffic mix, configuration and metric reader, with
    their entries added to a copy of BENCHMARK.json, are found by name."""
    from portbench.tests.conftest import make_root

    root = make_root(str(tmp_path), scale=False)
    with open(os.path.join(PKG, "workloads", "grpc-k100.json")) as f:
        traffic = json.load(f)
    traffic.update(name="grpc-k10-q8", limit=10, connections=8, streams=1)
    with open(os.path.join(root, "portbench", "workloads", "grpc-k10-q8.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "portbench", "metrics", "p50_ms.py"), "w") as f:
        f.write("def read(run):\n    return 1.5\n")
    man = load_manifest(root)
    man["workloads"].append({"name": "cohere768-flat.grpc-k10-q8", "config": "cohere768-flat",
                             "traffic": "grpc-k10-q8", "chips": 1, "why": "throwaway"})
    man["per_layer"].append({"name": "p50_ms", "unit": "ms", "better": "lower",
                             "source": "host_clock", "layer": "client", "moves": "qps",
                             "workloads": ["cohere768-flat.grpc-k10-q8"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    cell = load_cell("cohere768-flat.grpc-k10-q8", root)
    assert cell.traffic["limit"] == 10 and cell.config["rows"] == 250000
    assert [x["name"] for x in cell.per_layer] == ["p50_ms"]
    assert reader("p50_ms", root)(None) == 1.5
