"""Traffic kinds from their own files, and one run over a cell's ranks: the
rules that make the ranks' reports one result line, and the runner on
two gloo ranks of the CPU (a rank that fails, hangs or loads JAX ends the
run with no result); on the card, its NCCL group over every card."""

import json
import math
import os
import subprocess
import sys
import time

import pytest
import rank_kind
import torch

from perfbench import manifest, ranks, run, workload

ROOT = manifest.ROOT
H100 = "NVIDIA H100 80GB HBM3"

DRIVE = """
import sys, time
t0 = time.perf_counter()
sys.path.insert(0, {tests!r})
import rank_kind
from perfbench import ranks
cell = rank_kind.cell(2, **{traffic!r})
sys.exit(ranks.main(cell, 5, 0.1, {traced}, t0, "cpu", {deadline}, rank_kind.HERE))
"""


def _drive(traffic: dict, traced: bool = False, deadline: float = 120.0, timeout: float = 150.0):
    """perfbench's run of the toy cell on two gloo ranks, in a process of its
    own: (exit code, stdout, stderr, seconds)."""
    code = DRIVE.format(tests=rank_kind.HERE, traffic=traffic, traced=traced, deadline=deadline)
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    return out.returncode, out.stdout, out.stderr, time.perf_counter() - t


# ---------------------------------------------------------------------------
# kinds
# ---------------------------------------------------------------------------


def test_built_in_kinds_resolve_to_their_loops():
    assert workload.kind("epochs") is workload.run_epochs
    assert workload.kind("fits") is workload.run_fits


def test_a_kind_file_is_found_and_called(tmp_path):
    (tmp_path / "echo.py").write_text("def run(cell, seed, seconds, traced, device, t0):\n"
                                      "    return (cell.name, seed, seconds, traced, device, t0)\n")
    cell = manifest.Cell("echo.cell", 1, {}, {"kind": "echo"}, {}, (), ())
    assert workload.run(cell, 7, 1.5, True, "dev", 2.0, str(tmp_path)) == ("echo.cell", 7, 1.5, True, "dev", 2.0)


@pytest.mark.parametrize("name", ["no_such_kind", "../rank_kind"])
def test_an_unknown_kind_names_its_file(name, tmp_path):
    with pytest.raises(LookupError, match="no_such_kind.py|rank_kind.py") as e:
        workload.kind(name, str(tmp_path))
    assert os.path.join(str(tmp_path), name + ".py") in str(e.value)


# ---------------------------------------------------------------------------
# the rules that combine the ranks' reports
# ---------------------------------------------------------------------------


def _report(rank: int, **kw) -> dict:
    rep = {"end_to_end": {"rate": 1000.0 + rank, "setup_s": 40.0 + rank}, "attempted": 10 + rank,
           "failed": 0, "readings": {"sum_gap": 0.0, "cards_shared": 0.0}, "peak_bytes": 1000 * (rank + 1),
           "device": {"platform": "gpu", "kind": H100, "power_limit_w": 700.0},
           "busy_s": None, "window_s": None}
    if rank == 0:
        rep.update(ctx={"kind": "epochs", "epochs": 1}, summary=None)
    rep.update(kw)
    return rep


def _line(reports, traced=False) -> dict:
    outcome, info, extra = ranks.combine(reports, len(reports))
    out = run.result(rank_kind.cell(len(reports)), outcome, traced, info)
    out["device"].update(extra)
    return out


def test_end_to_end_and_attempted_are_rank_0s_and_failed_the_sum():
    reps = [_report(r, failed=r) for r in range(4)]
    out = _line(reps)
    assert out["metrics"] == {"rate": {"value": 1000.0, "unit": "1/s"}, "setup_s": {"value": 40.0, "unit": "s"}}
    assert out["attempted"] == 10 and out["failed"] == 6 and not out["correct"]


def test_each_number_compared_is_the_worst_over_the_ranks():
    reps = [_report(0), _report(1, readings={"sum_gap": 3e-7, "cards_shared": 0.0}),
            _report(2, readings={"sum_gap": 2e-7}), _report(3, readings={"sum_gap": 1e-7, "only_here": 5.0})]
    outcome = ranks.combine(reps, 4)[0]
    assert outcome.readings == {"sum_gap": 3e-7, "cards_shared": 0.0, "only_here": 5.0}
    for bad in (None, math.nan, math.inf):
        reps[2]["readings"]["sum_gap"] = bad
        assert ranks.combine(reps, 4)[0].readings["sum_gap"] == math.inf


def test_correct_only_where_every_rank_is():
    assert _line([_report(r) for r in range(4)])["correct"]
    for wrong in range(4):
        reps = [_report(r) for r in range(4)]
        reps[wrong]["readings"]["sum_gap"] = 2e-6
        out = _line(reps)
        assert not out["correct"] and out["checks"]["sum_gap"] == {"value": 2e-6, "limit": 1e-6}


def test_the_peak_is_the_fullest_cards():
    dev = _line([_report(0, peak_bytes=7), _report(1, peak_bytes=9), _report(2, peak_bytes=8)])["device"]
    assert dev["memory_peak_bytes"] == 9 and dev["memory_peak_bytes_by_rank"] == [7, 9, 8]


def test_the_device_is_the_group_of_cards():
    reps = [_report(r) for r in range(4)]
    reps[2]["device"] = dict(reps[2]["device"], power_limit_w=650.0)
    dev = _line(reps)["device"]
    assert (dev["platform"], dev["kind"], dev["count"], dev["power_limit_w"]) == ("gpu", H100, 4, 650.0)
    reps[3]["device"] = dict(reps[3]["device"], kind="NVIDIA H100 PCIe", power_limit_w=None)
    assert _line(reps)["device"]["kind"] == f"{H100} + NVIDIA H100 PCIe"


def test_traced_the_readers_read_rank_0_and_busy_is_the_mean():
    s0 = {"ops": [("toy_kernel", 0.0, 0.25)], "window": (0.0, 1.0), "gaps": {"toy > host": 0.75}}
    reps = [_report(0, summary=s0, busy_s=0.25, window_s=1.0), _report(1, busy_s=0.5, window_s=1.5)]
    out = _line(reps, traced=True)
    assert out["metrics"] == {"device_idle.epochs": {"value": 75.0, "unit": "%"}}
    assert out["breakdown"] == {"device_ops": [["toy_kernel", 0.25]], "idle_gaps": [["toy > host", 0.75]]}
    dev = out["device"]
    assert (dev["busy_s"], dev["window_s"]) == (0.375, 1.25)
    assert dev["busy_s_by_rank"] == [0.25, 0.5] and dev["window_s_by_rank"] == [1.0, 1.5]
    assert list(out)[-1] == "checks"


def test_what_crosses_is_plain_data():
    out = workload.Outcome({"rate": torch.tensor(1.0).item()}, 1, 0, {"gap": torch.tensor(0.5).numpy()[()]}, 3,
                           {"blocks": [(1, 2)]}, None)
    rep = ranks.report(0, out, {"kind": "cpu"})
    assert type(rep["readings"]["gap"]) is float and rep["ctx"] == {"blocks": [(1, 2)]}
    bad = workload.Outcome({"rate": 1.0}, 1, 0, {}, 3, {"w": torch.zeros(2)}, None)
    with pytest.raises(TypeError, match=r"\['ctx'\]\['w'\] is a Tensor"):
        ranks.report(0, bad, {"kind": "cpu"})
    assert "ctx" not in ranks.report(1, bad, {"kind": "cpu"})


# ---------------------------------------------------------------------------
# the runner on two gloo ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("traced", [False, True])
def test_two_ranks_print_one_combined_line_last(traced):
    rc, stdout, stderr, _ = _drive({"gaps": [0.0, 5e-7], "failed_ranks": []}, traced)
    assert rc == 0, stderr[-3000:]
    assert len(stdout.strip().splitlines()) == 1  # what the ranks print goes to stderr
    assert "toy rank 0 of 2" in stderr and "toy rank 1 of 2" in stderr
    out = json.loads(stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks" and out["correct"] and (out["attempted"], out["failed"]) == (10, 0)
    assert out["checks"] == {"sum_gap": {"value": 5e-7, "limit": 1e-6}, "cards_shared": {"value": 0.0, "limit": 0.0}}
    dev = out["device"]
    assert (dev["platform"], dev["kind"], dev["count"], dev["memory_peak_bytes"]) == ("cpu", "cpu", 2, 2000)
    assert dev["memory_peak_bytes_by_rank"] == [1000, 2000]
    if traced:
        assert out["metrics"] == {"device_idle.epochs": {"value": 90.0, "unit": "%"}}
        assert out["breakdown"]["device_ops"] == [["toy_kernel", 0.1]]
        assert dev["busy_s"] == pytest.approx(0.15) and dev["busy_s_by_rank"] == [0.1, 0.2]
    else:
        assert out["metrics"]["rate"]["value"] == 1000.0 and out["metrics"]["setup_s"]["value"] > 0.0


@pytest.mark.parametrize("fault", ["raise", "exit"])
def test_a_failing_rank_ends_the_run(fault):
    rc, stdout, stderr, _ = _drive({"fault": fault, "fault_rank": 1})
    assert rc == 1 and stdout.strip() == ""
    assert "perfbench: rank 1 of 2" in stderr  # the rank at fault first, then rank 0 that waited on it
    if fault == "raise":
        assert "Traceback" in stderr and "the toy's fault on rank 1" in stderr
    else:
        assert "exited with code 7" in stderr


def test_a_hung_rank_is_killed_at_the_deadline():
    rc, stdout, stderr, seconds = _drive({"fault": "sleep", "fault_rank": 1}, deadline=20.0, timeout=90.0)
    assert rc == 1 and stdout.strip() == ""
    assert "did not finish within 20 s" in stderr and "ranks still running: [0, 1]" in stderr
    assert 19.0 < seconds < 35.0


def test_a_rank_that_loads_jax_exits_3():
    rc, stdout, stderr, _ = _drive({"fault": "forbid", "fault_rank": 0})
    assert rc == 3 and stdout.strip() == ""
    assert "rank 0 of 2 loaded jax" in stderr


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_nccl_ranks_one_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = torch.cuda.device_count()
    cell = rank_kind.cell(n)
    reps = ranks.run_group(cell, 5, 0.1, False, time.perf_counter(), "cuda", 120.0, rank_kind.HERE)
    cards = reps[0]["ctx"]["cards"]
    print(cards)
    assert [c[0] for c in cards] == list(range(n)) and len({c[1] for c in cards}) == n
    assert reps[0]["ctx"]["sum"] == n * (n + 1) / 2
    outcome, info, extra = ranks.combine(reps, n)
    out = run.result(cell, outcome, False, info)
    out["device"].update(extra)
    print(json.dumps(out))
    assert out["correct"] and out["device"]["count"] == n and out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("fault, says", [("sleep", "did not finish within 30 s"), ("raise", "failed")])
def test_a_failing_rank_on_a_card_ends_the_run(fault, says):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = torch.cuda.device_count()
    t = time.perf_counter()
    with pytest.raises(ranks.RankFailure, match=says) as e:
        ranks.run_group(rank_kind.cell(n, fault=fault, fault_rank=n - 1), 5, 0.1, False, t, "cuda", 30.0,
                        rank_kind.HERE)
    print(f"{fault}: {n} ranks ended {time.perf_counter() - t:.1f} s after the start; {str(e.value)[:200]!r}")
    assert time.perf_counter() - t < 45.0
    if fault == "raise":
        assert str(e.value).startswith(f"rank {n - 1} of {n} failed")
