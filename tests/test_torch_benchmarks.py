"""The port's benchmark protocol (benchmarks/) against the JAX package's.

With the `jax_sampling` fixture of test_torch_cv.py both packages fit on
the same batch orders, so on the same inputs the port's tolerance sweep
(`convergence_curve`) and the loss trace of `convergence_curve_trace` give
the JAX package's losses within 1e-8 relative and its epochs within one
(a lambda whose last epoch's change sits at thresh can stop an epoch apart
under another summation order); times are the host's and are not
compared.  `normalize_curves` is pure numpy: equal on the same curves.
`sklearn_curve` (gaussian lasso: coordinate descent, deterministic) gives
the JAX package's losses exactly; without sklearn it raises ImportError,
as it does on the card's machine.  The tests of tests/test_benchmarks.py
run on the port too.
"""

import sys

import numpy as np
import pytest
import torch

import sgdnet_tpu.benchmarks.convergence as jconv
import sgdnet_tpu.benchmarks.relative as jrel
import sgdnet_tpu_torch.benchmarks as tb
import sgdnet_tpu_torch.benchmarks.convergence as tconv
import sgdnet_tpu_torch.benchmarks.relative as trel
from helpers import random_data
from test_torch_cv import jax_sampling  # noqa: F401

torch.set_num_threads(1)

LOSS_RTOL = 1e-8


def test_exports_match_jax():
    import sgdnet_tpu.benchmarks as jb

    assert tb.__all__ == jb.__all__


@pytest.mark.parametrize("family,alpha,tols", [
    ("gaussian", 1.0, [0.5, 1e-2, 1e-4]),
    ("binomial", 0.0, [0.1, 1e-3]),
    ("multinomial", 1.0, [0.2, 1e-3]),
    ("mgaussian", 0.0, [0.2, 1e-3]),
])
def test_convergence_curve_matches_jax(family, alpha, tols, jax_sampling):
    x, y = random_data(n=200, p=5, family=family, seed=1)
    kw = dict(family=family, alpha=alpha, tolerances=tols, dtype=np.float64)
    ct = tconv.convergence_curve(x, y, device="cpu", **kw)
    cj = jconv.convergence_curve(x, y, **kw)
    np.testing.assert_allclose(ct["losses"], cj["losses"], rtol=LOSS_RTOL)
    assert np.abs(ct["epochs"] - cj["epochs"]).max() <= 1
    np.testing.assert_array_equal(ct["tolerances"], cj["tolerances"])
    assert ct["times"].shape == (len(tols),) and (ct["times"] > 0).all()
    assert [f["device"] for f in ct["fits"]] == ["cpu"] * len(tols)
    # tighter tolerance: no worse loss, no fewer epochs (tests/test_benchmarks.py)
    assert ct["losses"][-1] <= ct["losses"][0] + 1e-12
    assert ct["epochs"][-1] >= ct["epochs"][0]


@pytest.mark.parametrize("family", ["gaussian", "binomial"])
def test_convergence_curve_trace_matches_jax(family, jax_sampling):
    """The trace's losses (the debug fit's epochs, the gaussian rescaled by
    var(y)) equal the JAX package's at the epochs both drew; its tail
    agrees with the sweep's tightest point within 1e-3
    (tests/test_benchmarks.py)."""
    x, y = random_data(n=200, p=5, family=family, seed=1)
    kw = dict(family=family, maxit=400, dtype=np.float64)
    tr = tconv.convergence_curve_trace(x, y, device="cpu", **kw)
    tj = jconv.convergence_curve_trace(x, y, **kw)
    # at thresh 0 the debug fit runs until an epoch changes nothing, which
    # another summation order can reach an epoch apart: the grids end
    # within one epoch, and the losses agree at the epochs both drew
    assert abs(int(tr["epochs"][-1]) - int(tj["epochs"][-1])) <= 1
    common, it, ij = np.intersect1d(tr["epochs"], tj["epochs"], return_indices=True)
    assert len(common) >= len(tj["epochs"]) // 2
    np.testing.assert_allclose(tr["losses"][it], tj["losses"][ij], rtol=LOSS_RTOL)
    assert np.isfinite(tr["losses"]).all()
    assert (np.diff(tr["times"]) > 0).all()
    assert tr["losses"][-1] <= tr["losses"][0] + 1e-12
    sweep = tconv.convergence_curve(x, y, family=family, tolerances=[1e-5], maxit=400, dtype=np.float64,
                                    device="cpu")
    assert abs(tr["losses"][-1] - sweep["losses"][-1]) <= 1e-3 * max(sweep["losses"][-1], 1e-9)


def test_normalize_curves_matches_jax():
    rng = np.random.default_rng(0)
    curves = [{"times": np.sort(rng.uniform(0.01, 2.0, 12)), "losses": np.sort(rng.uniform(0.1, 1.0, 12))[::-1],
               "alpha": a, "family": "gaussian"} for a in (1.0, 0.0)]
    nt, nj = trel.normalize_curves(*curves, bins=8), jrel.normalize_curves(*curves, bins=8)
    assert len(nt) == len(nj) == 2
    for a, b in zip(nt, nj):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["time"], b["time"])
        np.testing.assert_array_equal(a["loss"], b["loss"])


def test_sklearn_curve_matches_jax():
    x, y = random_data(n=150, p=5, seed=2)
    ct = trel.sklearn_curve(x, y, iter_grid=[1, 5, 20])
    cj = jrel.sklearn_curve(x, y, iter_grid=[1, 5, 20])
    np.testing.assert_array_equal(ct["losses"], cj["losses"])
    np.testing.assert_array_equal(ct["iters"], cj["iters"])


def test_relative_without_sklearn_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.linear_model", None)
    x, y = random_data(n=60, p=3, seed=3)
    with pytest.raises(ImportError):
        trel.sklearn_curve(x, y, iter_grid=[1])
    with pytest.raises(ImportError):
        trel.run_relative(datasets={"tiny": ((x, y), "gaussian")}, alphas=(1.0,), maxit=20, dtype=np.float64,
                          device="cpu")


def test_protocol_and_relative_on_small_datasets(jax_sampling):
    """run_reference_protocol and run_relative on two small sets: every
    curve finite, the keys the JAX package's, and the protocol's losses
    the JAX package's."""
    sets = {"g": (random_data(n=120, p=4, seed=4), "gaussian"),
            "b": (random_data(n=120, p=4, family="binomial", seed=5), "binomial")}
    kw = dict(tolerances=[0.5, 1e-3], maxit=300, dtype=np.float64)
    pt = tconv.run_reference_protocol(datasets=sets, device="cpu", **kw)
    pj = jconv.run_reference_protocol(datasets=sets, **kw)
    assert list(pt) == list(pj) == ["g/lasso", "g/ridge", "b/lasso", "b/ridge"]
    for k in pt:
        np.testing.assert_allclose(pt[k]["losses"], pj[k]["losses"], rtol=LOSS_RTOL)
    rt = trel.run_relative(datasets=sets, alphas=(1.0,), maxit=100, dtype=np.float64, device="cpu")
    assert list(rt) == ["g/lasso", "b/lasso"]
    for v in rt.values():
        assert set(v) == {"sgdnet_tpu_torch", "sklearn"}
        assert np.isfinite(v["sgdnet_tpu_torch"]["losses"]).all() and np.isfinite(v["sklearn"]["losses"]).all()
