"""The plain reference against the port's CPU path at a tiny size, and the
control (the reference with an int8 head in the program's place) failing
the committed limits there."""

import time

import pytest
import torch

from conftest import CELLS

from perfbench import calibrate, check, run, workload

CPU = torch.device("cpu")


def _readings(cell, seed):
    fn = calibrate.epoch_readings if cell.traffic["kind"] == "epochs" else calibrate.fit_readings
    return {r["side"]: {k: v for k, v in r.items() if k in cell.limits} for r in fn(cell, seed, CPU, True, True)}


@pytest.mark.parametrize("name", CELLS)
def test_program_within_and_control_outside_the_limits(name, tiny_cell):
    cell = tiny_cell(name)
    r = _readings(cell, 11)
    assert check.judge(r["program"], cell.limits)[0], r
    assert not check.judge(r["control"], cell.limits)[0], r


@pytest.mark.parametrize("name", CELLS)
def test_a_run_on_the_cpu_is_correct(name, tiny_cell):
    cell = tiny_cell(name)
    out = workload.run(cell, 3_000_000_019, 0.3, False, CPU, time.perf_counter())
    assert out.failed == 0 and out.attempted >= 1
    assert check.judge(out.readings, cell.limits)[0], out.readings
    assert set(out.end_to_end) >= {m["name"].split(".", 1)[0] for m in cell.end_to_end}
    line = run.result(cell, out, False, {"platform": "gpu", "kind": "a card", "count": 1})
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks" and set(line["checks"]) == set(cell.limits)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end} and line["correct"]


def test_the_reference_takes_a_path_s_decisions_where_it_made_them(tiny_cell):
    from perfbench.reference import saga as ref

    cell = tiny_cell("rcv1-binary.path")
    x, y, _ = workload.make_data(cell.config, 5)
    settings = workload.fit_settings(cell.config, cell.traffic)
    own = ref.fit_path(x, y, settings, 5, CPU)
    same = ref.fit_path(x, y, settings, 5, CPU, follow=own["epoch_log"])
    assert same["epoch_log"] == own["epoch_log"] and not same["followed"]
    assert workload.fit_numbers(x, y, same, own) == {"lambda_gap": 0.0, "objective_gap": 0.0}
    early = {key: 1 for key in own["epoch_log"] if key[1] == 0}  # a path that stops after one epoch
    short = ref.fit_path(x, y, settings, 5, CPU, follow=early)
    assert short["epoch_log"] == early and len(short["followed"]) == len(early)
    assert workload.fit_numbers(x, y, short, own)["objective_gap"] > 1e-3
