"""The port's dense fit slice on its own: golden paths, kernel switches,
import isolation and the keywords outside the slice.

  * tests/golden/*.npz (f64 sklearn oracle paths) at the tests/test_golden.py
    tolerance, 2e-3 x scale (5e-3 for the wine intercepts, as there);
  * use_epoch_kernel=True vs False and use_pallas=True vs False on the CPU,
    where each kernel's plain twin runs: same batch orders, so the paths
    agree at reassociation level, 1e-4 x scale, as tests/test_epoch_kernel.py
    and tests/test_pallas.py hold the Pallas kernels;
  * `import sgdnet_tpu_torch` never brings in jax or sgdnet_tpu;
  * keywords outside the dense slice raise NotImplementedError.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sgdnet_tpu_torch as tst
from sgdnet_tpu_torch.solver import epoch_kernel as ek
from sgdnet_tpu_torch.solver import head_kernel as hk

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
COMMON = dict(thresh=1e-6, maxit=5000, dtype=np.float64)


def _check_golden(fit, g, key, skip, a0_tol=2e-3):
    np.testing.assert_allclose(fit.lambda_, g[f"{key}_lambda"], rtol=1e-8)
    beta_g, a0_g = g[f"{key}_beta"], g[f"{key}_a0"]
    beta, a0 = fit.beta[skip:], np.asarray(fit.a0)[skip:]
    if beta_g.ndim == 2:  # single-response: (nl, p)
        beta = beta[:, 0, :]
    np.testing.assert_allclose(beta, beta_g, atol=2e-3 * max(1.0, np.abs(beta_g).max()))
    np.testing.assert_allclose(a0, a0_g, atol=a0_tol * max(1.0, np.abs(a0_g).max()))


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_abalone_golden(alpha):
    g = np.load(os.path.join(GOLDEN, "abalone.npz"))
    x, y = tst.load_abalone()
    # the golden path is batch-size free; 128 rows per step keeps the CPU run short
    fit = tst.fit(x, y, alpha=alpha, nlambda=10, batch_size=128, **COMMON)
    _check_golden(fit, g, f"a{alpha}_s1", skip=1 if alpha == 0.0 else 0)


@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_heart_golden(alpha):
    g = np.load(os.path.join(GOLDEN, "heart.npz"))
    x, y = tst.load_heart()
    fit = tst.fit(x, y, family="binomial", alpha=alpha, nlambda=8, **COMMON)
    _check_golden(fit, g, f"a{alpha}_s1", skip=1 if alpha == 0.0 else 0)


@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_wine_golden(alpha):
    g = np.load(os.path.join(GOLDEN, "wine.npz"))
    x, y = tst.load_wine()
    fit = tst.fit(x, y, family="multinomial", alpha=alpha, nlambda=6, lambda_min_ratio=0.05, **COMMON)
    key = f"a{alpha}_s1"
    _check_golden(fit, g, key, skip=int(g[f"{key}_skip"]), a0_tol=5e-3)


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_student_golden(alpha):
    g = np.load(os.path.join(GOLDEN, "student.npz"))
    x, y = tst.load_student()
    fit = tst.fit(x, y, family="mgaussian", alpha=alpha, nlambda=8, **COMMON)
    _check_golden(fit, g, f"a{alpha}_s1", skip=1)


# ---------------------------------------------------------------------------
# kernel switches (the twins run on the CPU)
# ---------------------------------------------------------------------------


def _assert_close(f_ref, f_ker, tol=1e-4):
    scale = max(1.0, np.abs(f_ref.beta).max())
    assert np.abs(f_ker.beta - f_ref.beta).max() / scale < tol
    assert np.abs(np.asarray(f_ker.a0) - np.asarray(f_ref.a0)).max() < 10 * tol
    assert np.abs(f_ker.dev_ratio - f_ref.dev_ratio).max() < 10 * tol


def _poisson_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 6))
    return x, rng.poisson(np.exp(0.3 + x @ (rng.normal(size=6) * 0.3))).astype(np.float64)


EPOCH_CASES = {
    "heart": ("binomial", tst.load_heart, dict(alpha=0.8)),
    "wine_grouped": ("multinomial", tst.load_wine, dict(alpha=0.9, type_multinomial="grouped")),
    "student": ("mgaussian", tst.load_student, dict(alpha=0.8)),
    "poisson": ("poisson", _poisson_data, dict(alpha=0.5)),
    "abalone_ridge": ("gaussian", tst.load_abalone, dict(alpha=0.0, batch_size=256)),
    "heart_offs_pf": ("binomial", tst.load_heart, dict(alpha=0.5, penalty_factor="pf", offset="offs")),
}


@pytest.mark.parametrize("case", list(EPOCH_CASES))
def test_epoch_kernel_matches_step_path(case):
    family, load, kw = EPOCH_CASES[case]
    x, y = load()
    rng = np.random.default_rng(5)
    if kw.get("offset") == "offs":
        kw = dict(kw, offset=0.2 * rng.normal(size=len(y)))
    if kw.get("penalty_factor") == "pf":
        pf = np.ones(x.shape[1])
        pf[1] = 2.0
        kw = dict(kw, penalty_factor=pf)
    common = dict(family=family, nlambda=8, sampling="block", dtype="float32", seed=3, **kw)
    f_step = tst.fit(x, y, use_epoch_kernel=False, **common)
    f_ker = tst.fit(x, y, use_epoch_kernel=True, **common)
    assert f_step.stats["epoch_kernel"] is False and f_ker.stats["epoch_kernel"] is True
    _assert_close(f_step, f_ker)


def test_epoch_kernel_gate_falls_back_on_options():
    """Box limits are outside the kernel's surface: the step path runs even
    when K1 is asked for, and stats record which ran; on the CPU the kernel
    never engages by default."""
    x, y = tst.load_heart()
    f = tst.fit(x, y, family="binomial", lower_limits=-1.0, upper_limits=1.0, nlambda=4, dtype="float32",
                use_epoch_kernel=True)
    assert f.stats["epoch_kernel"] is False
    f = tst.fit(x, y, family="binomial", nlambda=4, dtype="float32")
    assert f.stats["epoch_kernel"] is False and f.stats["device"] == "cpu"


@pytest.mark.parametrize("family", ["binomial", "multinomial"])
def test_head_kernel_matches_step_path(family):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(256, 16))
    eta = x[:, :4] @ rng.normal(size=4)
    y = (rng.random(256) < 1 / (1 + np.exp(-eta))).astype(float) if family == "binomial" else \
        np.argmax(np.stack([eta, -eta, 0.3 * eta], 1) + rng.gumbel(size=(256, 3)), axis=1)
    common = dict(family=family, nlambda=4, thresh=1e-5, maxit=300, batch_size=64, sampling="block",
                  dtype="float32")
    f_step = tst.fit(x, y, use_pallas=False, **common)
    launches = hk.fused_head_step_at.launches
    f_ker = tst.fit(x, y, use_pallas=True, lambda_path=f_step.lambda_, **common)
    assert f_ker.stats["head_kernel"] is True and f_step.stats["head_kernel"] is False
    assert hk.fused_head_step_at.launches == launches  # the twin ran: no kernel launch on the CPU
    np.testing.assert_allclose(f_ker.beta, f_step.beta, atol=1e-4)


def test_head_kernel_never_serves_poisson():
    x, y = _poisson_data()
    f = tst.fit(x, y, family="poisson", nlambda=3, batch_size=32, sampling="block", use_pallas=True,
                dtype="float32")
    assert f.stats["head_kernel"] is False and np.isfinite(f.beta).all()


def test_epoch_counter_untouched_on_cpu():
    x, y = tst.load_wine()
    before = ek.saga_epoch.launches
    f = tst.fit(x, y, family="multinomial", nlambda=3, dtype="float32", use_epoch_kernel=True)
    assert f.stats["epoch_kernel"] is True and ek.saga_epoch.launches == before


# ---------------------------------------------------------------------------
# isolation and the keywords outside the slice
# ---------------------------------------------------------------------------


def test_import_leaves_jax_out():
    code = (
        "import sys, sgdnet_tpu_torch, sgdnet_tpu_torch.utils.convert, sgdnet_tpu_torch.utils.build\n"
        "import sgdnet_tpu_torch.solver.epoch_kernel, sgdnet_tpu_torch.solver.head_kernel\n"
        "x, y = sgdnet_tpu_torch.load_wine()\n"
        "sgdnet_tpu_torch.fit(x, y, family='multinomial', nlambda=2, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'sgdnet_tpu.'))"
        " or m == 'sgdnet_tpu')\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("kw", [
    dict(mesh=object()),
    dict(screen=True),
    dict(screen="auto"),
    dict(hybrid=True),
    dict(hybrid_head_dtype="int8"),
    dict(hybrid_max_head="auto"),
    dict(sparse_mode="gather"),
    dict(lambda_chunk=4),
])
def test_out_of_slice_keywords_raise(kw):
    x, y = tst.load_heart()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tst.fit(x, y, family="binomial", **kw)


def test_scipy_sparse_input_raises():
    import scipy.sparse as sp

    x, y = tst.load_heart()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tst.fit(sp.csr_matrix(x), y, family="binomial")


def test_fit_validation():
    x, y = tst.load_heart()
    with pytest.raises(ValueError):
        tst.fit(x, y, family="cauchy")
    with pytest.raises(ValueError):
        tst.fit(x, y, family="binomial", alpha=1.5)
    with pytest.raises(ValueError):
        tst.fit(x[:10], y, family="binomial")
    xn = x.copy()
    xn[0, 0] = np.nan
    with pytest.raises(ValueError, match="NA"):
        tst.fit(xn, y, family="binomial")
    with pytest.raises(ValueError):
        tst.fit(x, y, family="binomial", dtype="int32")
