"""BENCHMARK.json against the benchmark's contract, and every cell
resolved to its files."""

import json
import math
import os
import re

import pytest

from perfbench import manifest, workload

M = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(M) == KEYS["top"]
    assert os.path.getsize(manifest.MANIFEST) <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(manifest.ROOT, p))
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_keys_and_names(group):
    entries = M[group]
    assert 1 <= len(entries) <= {"configs": 24, "workloads": 24, "end_to_end": 16, "per_layer": 128}[group]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher") and e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e and group != "end_to_end" and group != "per_layer":
                assert _line(e[key])
        if "layer" in e:
            assert _line(e["layer"])


def test_metric_names_are_unique_across_groups():
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(names)) == len(names)


def test_bounds():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_configs_resolve_and_state_their_cuts():
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in M["paths"]))
        assert _line(c["source"]) and c["source"].startswith("https://") and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(manifest.ROOT, c["file"]), encoding="utf-8") as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert set(conf["reduced"]) == set(c["reduced"])
        assert all(isinstance(conf[k], (int, float)) for k in c["reduced"])
        if "epochs" in conf:
            assert math.isfinite(conf["epochs"]["gamma"]) and math.isfinite(conf["epochs"]["lambda"])


def test_workloads_resolve_to_their_files():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"]) and _line(w["why"])
        cell = manifest.cell(w["name"], M)
        assert callable(workload.kind(cell.traffic["kind"]))  # built in, or its file under perfbench/kinds/
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
            assert callable(manifest.reader(m["name"]))


def test_per_layer_entries():
    e2e = {m["name"] for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= cells
        if m["name"].split(".", 1)[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in M["end_to_end"]:
        assert set(m.get("workloads", [])) <= cells


def test_layer_names_are_consistent():
    by_layer = {}
    for m in M["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_run_seconds_fit_the_check_with_24_cells():
    s = M["run_seconds"]
    assert 2 * (s + 60) + 24 * (14 * (s + 60) + 2 * 90) + 1200 <= 43200
