"""Tiny cells: each of BENCHMARK.json's cells with its traffic, limits and
metrics as committed, its design cut to a size the CPU runs in seconds;
and the "fits" loop's path cell, which BENCHMARK.json does not run yet,
on the rcv1-binary design with the path traffic and limits read at this
tiny size on the CPU (TINY_PATH_LIMITS)."""

import copy
import json
import os

import pytest
import torch

from perfbench import manifest

PATH_CELL = "rcv1-binary.path"
#: the path's limits at the tiny size, from CPU readings: the program's
#: lambda gap 4e-8-2.1e-6 (with the threads' order of sums) and worst
#: objective gap 1e-8-3e-8, the control's objective gap 2e-5-6e-5
#: (seeds 11 and 4000000012)
TINY_PATH_LIMITS = {"lambda_gap": 2.5e-5, "objective_gap": 1e-6}
CELLS = [w["name"] for w in manifest.load()["workloads"]] + [PATH_CELL]


def _path_cell() -> manifest.Cell:
    conf = next(c for c in manifest.load()["configs"] if c["name"] == "rcv1-binary")
    with open(os.path.join(manifest.ROOT, conf["file"]), encoding="utf-8") as f:
        config = json.load(f)
    with open(os.path.join(manifest.HERE, "traffic", "path.json"), encoding="utf-8") as f:
        traffic = json.load(f)
    e2e = tuple({"name": n, "unit": u} for n, u in (("fit_s", "s"), ("peak_mem_gib", "GiB"), ("setup_s", "s")))
    layer = tuple({"name": n, "unit": u} for n, u in (("ingest_s.path", "s"), ("epochs_per_fit.path", "epochs"),
                                                       ("device_idle.path", "%")))
    return manifest.Cell(PATH_CELL, 1, config, traffic, dict(TINY_PATH_LIMITS), e2e, layer)


def tiny(name: str):
    c = _path_cell() if name == PATH_CELL else manifest.cell(name)
    cfg = copy.deepcopy(c.config)
    cfg.update(n=3000, p=900, nnz_per_row=20)
    cfg["layout"].update(batch_size=256, max_head=128, coverage=0.9)
    if cfg["labels"]["kind"] == "softmax":
        cfg["labels"].update(classes=5, per_class=20, head=128)
    traffic = dict(c.traffic)
    if traffic["kind"] == "epochs":
        traffic.update(orders=64, trace_epochs=3)
    return manifest.Cell(c.name, c.chips, cfg, traffic, c.limits, c.end_to_end, c.per_layer)


@pytest.fixture
def tiny_cell():
    torch.set_num_threads(2)
    return tiny
