"""BENCHMARK.json and the files each of its cells is made of.

A cell (an entry of `workloads`) names a configuration, whose file the
manifest gives, and a traffic mix, read from `traffic/<traffic>.json`;
the limits of its comparison are `limits/<cell>.json`; each per-layer
metric is read by `metrics/<metric>.py`.  A later cell or metric brings
its own files and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load(path: str = MANIFEST) -> dict:
    return _json(path)


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple  # the manifest's entries this cell reports with --trace 0
    per_layer: tuple  # ... and with --trace 1


def _reports(metric: dict, cell: str, moved: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in moved


def cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell `name` of the manifest, its files read."""
    m = load() if manifest is None else manifest
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    e2e = tuple(x for x in m["end_to_end"] if _reports(x, name, set()))
    moved = {x["name"] for x in e2e}
    layer = tuple(x for x in m["per_layer"] if _reports(x, name, moved))
    return Cell(name, int(entry["chips"]), _json(os.path.join(ROOT, conf["file"])),
                _json(os.path.join(HERE, "traffic", entry["traffic"] + ".json")),
                _json(os.path.join(HERE, "limits", name + ".json")), e2e, layer)


def reader(metric: str):
    """The `read(ctx)` of metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
