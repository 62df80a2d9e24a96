"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, read from
``portbench/workloads/<traffic>.json``. A metric is read by
``portbench/metrics/<metric>.py``: a module with ``read(run)`` that
returns the number, or None where it finds nothing to read. A new cell
or metric is new files and new entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, manifest: dict | None = None) -> Cell:
    m = manifest if manifest is not None else load_manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in m["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "workloads", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[x for x in m["end_to_end"] if _reports(x, name)],
                per_layer=[x for x in m["per_layer"] if _reports(x, name)])


def reader(metric_name: str, root: str = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric_name>.py``."""
    path = os.path.join(root, "portbench", "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
