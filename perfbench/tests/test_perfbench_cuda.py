"""On the card: each epoch cell's run at the tiny size, through the port's
kernels, held to the committed limits.  Skips without a CUDA card."""

import time

import pytest
import torch

from perfbench import check, manifest, workload

CELLS = [w["name"] for w in manifest.load()["workloads"] if manifest.cell(w["name"]).traffic["kind"] == "epochs"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_run_on_the_card_is_correct(name, tiny_cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny_cell(name)
    out = workload.run(cell, 3_000_000_023, 0.3, False, torch.device("cuda"), time.perf_counter())
    print(name, out.readings)
    assert out.failed == 0 and out.attempted >= 1
    assert check.judge(out.readings, cell.limits)[0], out.readings
