"""The port's package surface: its exports cover the JAX package's, it
imports nothing of JAX, and its profiling hooks (utils/profiling.py).

  * `sgdnet_tpu_torch.__all__` holds every name of `sgdnet_tpu.__all__`,
    each a counterpart of the same kind (class or function);
  * no module of sgdnet_tpu_torch/ and nothing in chip_smoke.py imports
    `jax`, `jaxlib`, `sgdnet_tpu`, or the JAX side's `bench` or `tools`, at
    any depth of the file (read with `ast`, so an import inside a function
    counts);
  * `trace(log_dir)` writes a Chrome trace that names the ops it saw, and
    `time_fn` returns seconds a call, on the CPU here.
"""

import ast
import inspect
import json
import os

import numpy as np
import pytest
import torch

import sgdnet_tpu as jst
import sgdnet_tpu_torch as tst
from sgdnet_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the JAX package, and the JAX side's bench.py and tools/ (the port keeps
#: its own copies in sgdnet_tpu_torch/tools)
FORBIDDEN = ("jax", "jaxlib", "sgdnet_tpu", "bench", "tools")


def _port_files():
    pkg = os.path.join(ROOT, "sgdnet_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        found += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {m}" for m in mods if m.split(".")[0] in FORBIDDEN]
    return found


def test_exports_cover_the_jax_packages():
    missing = [n for n in jst.__all__ if n not in tst.__all__]
    assert not missing, missing
    for name in jst.__all__:
        a, b = getattr(jst, name), getattr(tst, name)
        assert inspect.isclass(a) == inspect.isclass(b), name
        assert callable(b), name


def test_no_module_of_the_port_imports_jax():
    files = _port_files()
    assert len(files) > 30 and any(f.endswith("utils/native.py") for f in files)
    bad = [hit for f in files for hit in _forbidden_imports(f)]
    assert not bad, bad


def test_the_guard_sees_a_nested_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\n\ndef f():\n    from jax import numpy\n    import sgdnet_tpu.api.fit\n"
                 "    import sgdnet_tpu_torch\n")
    hits = _forbidden_imports(str(p))
    assert [h.split()[-1] for h in hits] == ["jax", "sgdnet_tpu.api.fit"]


def test_the_guard_sees_bench_and_tools(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("def f():\n    import bench\n    from tools.bench_layout_sweep import tail_entries_for\n"
                 "    from bench import log\n    from sgdnet_tpu_torch.tools import bench\n"
                 "    import sgdnet_tpu_torch.tools.bench\n")
    hits = _forbidden_imports(str(p))
    assert [h.split()[-1] for h in hits] == ["bench", "tools.bench_layout_sweep", "bench"]


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64, dtype=torch.float64)
    with profiling.trace(str(tmp_path / "prof")) as prof:
        b = a @ a
    assert torch.isfinite(b).all()
    with open(tmp_path / "prof" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any("aten::mm" in e.key for e in prof.key_averages())
    assert profiling.device_kernels(prof) == []  # no card: no device time


def test_time_fn_seconds_per_call():
    calls = []

    def fn(n, scale=1.0):
        calls.append(n)
        return {"out": [torch.ones(n) * scale]}

    s = profiling.time_fn(fn, 8, iters=4, warmup=2, scale=2.0)
    assert s > 0 and len(calls) == 6


def test_time_fn_on_a_fit():
    x, y = tst.load_heart()
    s = profiling.time_fn(tst.fit, x, y, family="binomial", nlambda=2, device="cpu", iters=1, warmup=0)
    assert np.isfinite(s) and s > 0


@pytest.mark.parametrize("mod", ["utils.checkpoint", "utils.native", "utils.profiling", "benchmarks",
                                 "benchmarks.convergence", "benchmarks.relative", "api.plot"])
def test_each_new_module_has_its_jax_twin(mod):
    import importlib

    t = importlib.import_module(f"sgdnet_tpu_torch.{mod}")
    j = importlib.import_module(f"sgdnet_tpu.{mod}")
    public = getattr(j, "__all__", None) or [n for n, v in vars(j).items() if not n.startswith("_")
                                             and getattr(v, "__module__", None) == j.__name__]
    missing = [n for n in public if not hasattr(t, n)]
    assert not missing, missing
