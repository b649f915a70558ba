"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: `sgdnet_tpu_torch` is not `sgdnet_tpu`), the reference loads
nothing of the port, and a run without a card prints no result."""

import os
import subprocess
import sys

from perfbench import manifest, run

ROOT = manifest.ROOT

DRIVE = """
import sys, time
sys.path.insert(0, {tests!r})
import torch
from conftest import tiny
from perfbench import run, workload
cell = tiny({cell!r})
workload.run(cell, 3, 0.2, False, torch.device("cpu"), time.perf_counter())
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
print(run.forbidden_modules())
"""


def _py(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "sgdnet_tpu_torch", sys)
    monkeypatch.setitem(sys.modules, "sgdnet_tpu_torchx.core", sys)
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    for w in manifest.load()["workloads"]:
        lines = _py(DRIVE.format(tests=os.path.dirname(__file__), cell=w["name"])).strip().splitlines()
        loaded = eval(lines[-2])  # noqa: S307 - the list this test's child printed
        assert "sgdnet_tpu_torch" in loaded and "torch" in loaded
        assert not set(loaded) & set(run.FORBIDDEN), loaded
        assert lines[-1] == "[]"


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys\nimport perfbench.reference.saga, perfbench.check, perfbench.roofline\n"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))")
    loaded = eval(_py(code).strip().splitlines()[-1])  # noqa: S307
    assert not set(loaded) & {"sgdnet_tpu_torch", "sgdnet_tpu", "jax", "jaxlib", "flax"}, loaded


def test_without_a_card_a_run_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "rcv1-binary.epochs", "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
