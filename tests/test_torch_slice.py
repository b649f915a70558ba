"""The port's dense fit slice on its own: golden paths, kernel switches,
import isolation and the keywords outside the slice.

  * tests/golden/*.npz (f64 sklearn oracle paths) at the tests/test_golden.py
    tolerance, 2e-3 x scale (5e-3 for the wine intercepts, as there);
  * use_epoch_kernel=True vs False and use_pallas=True vs False on the CPU,
    where each kernel's plain twin runs: same batch orders, so the paths
    agree at reassociation level, 1e-4 x scale, as tests/test_epoch_kernel.py
    and tests/test_pallas.py hold the Pallas kernels;
  * `import sgdnet_tpu_torch` never brings in jax or sgdnet_tpu, and the
    port runs CV and screening with both blocked;
  * `device=None` means the card: without one, fit, the layout constructors
    and the converters raise (every CPU run here asks for device="cpu");
  * the screen and mesh keywords fit and match the same call without
    them.
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
COMMON = dict(thresh=1e-6, maxit=5000, dtype=np.float64, device="cpu")


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
    common = dict(family=family, nlambda=8, sampling="block", dtype="float32", seed=3, device="cpu", **kw)
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
                use_epoch_kernel=True, device="cpu")
    assert f.stats["epoch_kernel"] is False
    f = tst.fit(x, y, family="binomial", nlambda=4, dtype="float32", device="cpu")
    assert f.stats["epoch_kernel"] is False and f.stats["device"] == "cpu"


@pytest.mark.parametrize("family", ["binomial", "multinomial"])
def test_head_kernel_matches_step_path(family):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(256, 16))
    eta = x[:, :4] @ rng.normal(size=4)
    y = (rng.random(256) < 1 / (1 + np.exp(-eta))).astype(float) if family == "binomial" else \
        np.argmax(np.stack([eta, -eta, 0.3 * eta], 1) + rng.gumbel(size=(256, 3)), axis=1)
    common = dict(family=family, nlambda=4, thresh=1e-5, maxit=300, batch_size=64, sampling="block",
                  dtype="float32", device="cpu")
    f_step = tst.fit(x, y, use_pallas=False, **common)
    launches = hk.fused_head_step_at.launches
    f_ker = tst.fit(x, y, use_pallas=True, lambda_path=f_step.lambda_, **common)
    assert f_ker.stats["head_kernel"] is True and f_step.stats["head_kernel"] is False
    assert hk.fused_head_step_at.launches == launches  # the twin ran: no kernel launch on the CPU
    np.testing.assert_allclose(f_ker.beta, f_step.beta, atol=1e-4)


def test_head_kernel_never_serves_poisson():
    x, y = _poisson_data()
    f = tst.fit(x, y, family="poisson", nlambda=3, batch_size=32, sampling="block", use_pallas=True,
                dtype="float32", device="cpu")
    assert f.stats["head_kernel"] is False and np.isfinite(f.beta).all()


def test_epoch_counter_untouched_on_cpu():
    x, y = tst.load_wine()
    before = ek.saga_epochs.launches
    f = tst.fit(x, y, family="multinomial", nlambda=3, dtype="float32", use_epoch_kernel=True, device="cpu")
    assert f.stats["epoch_kernel"] is True and ek.saga_epochs.launches == before
    # the twin ran the chunks: fewer of them than epochs
    assert 0 < f.stats["epoch_chunks"] < f.npasses


# ---------------------------------------------------------------------------
# isolation and the keywords outside the slice
# ---------------------------------------------------------------------------


def test_import_leaves_jax_out():
    code = (
        "import sys, sgdnet_tpu_torch, sgdnet_tpu_torch.utils.convert, sgdnet_tpu_torch.utils.build\n"
        "import sgdnet_tpu_torch.solver.epoch_kernel, sgdnet_tpu_torch.solver.head_kernel\n"
        "import sgdnet_tpu_torch.solver.tail_kernel, sgdnet_tpu_torch.core.sparse, scipy.sparse as sp\n"
        "import sgdnet_tpu_torch.tools.bench_epoch_kernel, sgdnet_tpu_torch.tools.bench_head_dma\n"
        "import sgdnet_tpu_torch.tools.bench_dma_streams, sgdnet_tpu_torch.core.layout\n"
        "import sgdnet_tpu_torch.parallel.dist, sgdnet_tpu_torch.parallel.multihost\n"
        "import sgdnet_tpu_torch.parallel.scaling, sgdnet_tpu_torch.graft_entry\n"
        "x, y = sgdnet_tpu_torch.load_wine()\n"
        "sgdnet_tpu_torch.fit(x, y, family='multinomial', nlambda=2, device='cpu')\n"
        "sgdnet_tpu_torch.fit(sp.csr_matrix(x), y, family='multinomial', nlambda=2, hybrid=True, device='cpu',\n"
        "                     hybrid_max_head='auto')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'sgdnet_tpu.'))"
        " or m == 'sgdnet_tpu')\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_runs_with_jax_blocked():
    """CV, fold-parallel CV and a screened fit with `jax` and `sgdnet_tpu`
    made unimportable (None in sys.modules) in a fresh interpreter, where
    every module of the port imports."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sgdnet_tpu'] = None\n"
        "import numpy as np, sgdnet_tpu_torch as st\n"
        "import sgdnet_tpu_torch.api.cv, sgdnet_tpu_torch.parallel.cv, sgdnet_tpu_torch.solver.screening\n"
        "import sgdnet_tpu_torch.benchmarks, sgdnet_tpu_torch.api.plot, sgdnet_tpu_torch.utils.checkpoint\n"
        "import sgdnet_tpu_torch.utils.native, sgdnet_tpu_torch.utils.profiling\n"
        "x, y = st.load_heart()\n"
        "cv = st.cv_fit(x[:120], y[:120], family='binomial', nfolds=3, nlambda=3, device='cpu')\n"
        "cvp = st.cv_fit(x[:120], y[:120], family='binomial', nfolds=3, nlambda=3, parallel=True, device='cpu')\n"
        "assert np.isfinite(cv.cv_raw[0]).all() and np.isfinite(cvp.cv_raw[0]).all()\n"
        "f = st.fit(x, y, family='binomial', nlambda=3, screen=True, device='cpu')\n"
        "assert f.stats['screening']['kkt_clean'] and np.isfinite(f.beta).all()\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture
def one_rank():
    """A process group of this process alone (gloo on the CPU), torn down
    after the test."""
    import torch.distributed as dist

    from sgdnet_tpu_torch.parallel.multihost import free_port, init_multihost

    init_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kw", [
    ("fit", dict(mesh="data")),
    ("fit", dict(mesh="data", hybrid_max_head="auto")),
    ("fit", dict(mesh="data", use_pallas=True, sampling="block", dtype=np.float32)),
    ("cv_fit", dict(parallel=True, cv_mesh="folds")),
    ("cv_fit", dict(mesh="data")),  # serial CV hands mesh to each fit
    ("parallel_fold_scores", dict(mesh="folds")),
])
def test_mesh_keywords_now_fit(one_rank, kw):
    """The mesh keyword sets that raised before data-parallel fits were
    ported run now, on a mesh of one gloo rank, and match the same call
    without the mesh: a meshed fit (whose orders take its rank) at the
    tolerance of tests/test_parallel.py (fits 2e-3 x scale, serial CV
    scores rtol 0.05 and atol 1e-3), the fold mesh exactly (fold fits take
    no rank)."""
    from sgdnet_tpu_torch.parallel.cv import parallel_fold_scores
    from sgdnet_tpu_torch.parallel.dist import make_mesh

    entry, kwargs = kw
    kwargs = {k: make_mesh(axis=v, device="cpu") if k in ("mesh", "cv_mesh") else v for k, v in kwargs.items()}
    plain_kw = {k: v for k, v in kwargs.items() if k not in ("mesh", "cv_mesh")}
    x, y = tst.load_heart()
    common = dict(family="binomial", nlambda=5, thresh=1e-6, maxit=2000, device="cpu")
    if entry == "fit":
        f = tst.fit(x, y, **common, **kwargs)
        plain = tst.fit(x, y, **{**common, **plain_kw, "nlambda": None, "lambda_path": f.lambda_})
        assert f.stats["mesh"] == {"axis": "data", "size": 1, "rank": 0, "backend": "gloo"}
        assert f.stats["allreduces"]["step"] > 0 and not f.stats["epoch_kernel"]
        assert f.stats["head_kernel"] is bool(kwargs.get("use_pallas"))
        scale = max(1.0, np.abs(plain.beta).max())
        np.testing.assert_allclose(f.beta, plain.beta, atol=2e-3 * scale)
    elif entry == "cv_fit":
        cv_kw = dict(common, thresh=1e-4, nfolds=3)
        cv = tst.cv_fit(x[:150], y[:150], **cv_kw, **kwargs)
        plain = tst.cv_fit(x[:150], y[:150], **cv_kw, **plain_kw)
        if "cv_mesh" in kwargs:
            np.testing.assert_allclose(cv.cv_raw[0], plain.cv_raw[0], rtol=1e-12, atol=0)
        else:
            np.testing.assert_allclose(cv.cv_raw[0], plain.cv_raw[0], rtol=0.05, atol=1e-3)
    else:
        lam = tst.fit(x, y, **common).lambda_
        args = (x, y, np.arange(len(y)) % 3, 3, 1.0, lam)
        scores = parallel_fold_scores(*args, family="binomial", device="cpu", **kwargs)
        np.testing.assert_allclose(scores, parallel_fold_scores(*args, family="binomial", device="cpu"),
                                   rtol=1e-12, atol=0)


def test_screen_true_under_a_mesh_raises(one_rank):
    """As in the JAX package: screen=True needs a single device, and
    screen="auto" runs a meshed fit unscreened."""
    from sgdnet_tpu_torch.parallel.dist import make_mesh

    x, y = tst.load_heart()
    mesh = make_mesh(device="cpu")
    with pytest.raises(ValueError, match="single device"):
        tst.fit(x, y, family="binomial", nlambda=3, device="cpu", mesh=mesh, screen=True)
    f = tst.fit(x, y, family="binomial", nlambda=3, device="cpu", mesh=mesh, screen="auto")
    assert "screening" not in f.stats and f.stats["mesh"]["size"] == 1


@pytest.mark.parametrize("kw", [
    dict(screen=True),
    dict(screen="auto"),
    dict(screen="auto", hybrid=True),
    dict(screen=True, hybrid_max_head="auto", hybrid_head_dtype="int8"),
])
def test_screen_keywords_now_fit(kw):
    """The screen keyword sets that raised before screening was ported: each
    fits now and matches the unscreened fit on the same path at the
    tolerance of tests/test_screening.py (2e-3 x scale)."""
    x, y = tst.load_heart()
    common = dict(family="binomial", nlambda=8, thresh=1e-6, maxit=2000, device="cpu")
    plain = tst.fit(x, y, **{**common, **{k: v for k, v in kw.items() if k != "screen"}})
    f = tst.fit(x, y, **{**common, **kw, "nlambda": None, "lambda_path": plain.lambda_})
    assert f.stats["screening"]["kkt_clean"] is True
    scale = max(1.0, np.abs(plain.beta).max())
    np.testing.assert_allclose(f.beta, plain.beta, atol=2e-3 * scale)


def test_scipy_sparse_input_raises():
    """scipy input is ported (tests/test_torch_sparse.py), the layout
    planner included; what it raises for is a missing value."""
    import scipy.sparse as sp

    x, y = tst.load_heart()
    xn = sp.csr_matrix(x)
    xn.data[0] = np.nan
    with pytest.raises(ValueError, match="NA"):
        tst.fit(xn, y, family="binomial", hybrid_max_head="auto", device="cpu")
    f = tst.fit(sp.csr_matrix(x), y, family="binomial", nlambda=3, hybrid_max_head="auto", device="cpu")
    assert f.stats["layout"]["kind"] == "padded_csr" and np.isfinite(f.beta).all()
    assert f.stats["layout_plan"]["max_head"] == x.shape[1]  # 13 columns: the plan caps at p


def test_fit_without_a_card_raises(monkeypatch):
    """device=None means the card: with no CUDA, fit raises RuntimeError
    naming the missing device instead of running on the CPU, and so do the
    layout builders."""
    import scipy.sparse as sp

    from sgdnet_tpu_torch.core.sparse import PaddedCSR

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = tst.load_heart()
    with pytest.raises(RuntimeError, match="CUDA"):
        tst.fit(x, y, family="binomial", nlambda=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tst.fit(sp.csr_matrix(x), y, family="binomial", nlambda=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        PaddedCSR.from_scipy(sp.csr_matrix(x))


def test_converters_and_cv_without_a_card_raise(monkeypatch):
    """state_from_numpy, layout_from_jax, BlockCOO.from_arrays and the CV
    entry points default to the card too: without one they raise
    RuntimeError, and with device="cpu" they build on the CPU."""
    import scipy.sparse as sp
    from sgdnet_tpu.core.sparse import PaddedCSR as JPaddedCSR

    from sgdnet_tpu_torch.core.sparse import BlockCOO
    from sgdnet_tpu_torch.parallel.cv import parallel_fold_scores
    from sgdnet_tpu_torch.utils.convert import layout_from_jax, state_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = tst.load_heart()
    jcsr = JPaddedCSR.from_scipy(sp.csr_matrix(x[:8]), dtype=np.float64)
    state = {f: np.zeros((8, 1)) for f in ("w", "intercept", "g_mem", "g_sum", "g_sum_intercept")}
    packed = (np.zeros((1, 4), np.int32), np.zeros((1, 4), np.int32), np.zeros((1, 4)), 4, 3)
    for call in (lambda **d: layout_from_jax(jcsr, **d), lambda **d: state_from_numpy(state, **d),
                 lambda **d: BlockCOO.from_arrays(*packed, **d),
                 lambda **d: tst.cv_fit(x, y, family="binomial", nfolds=3, nlambda=2, **d),
                 lambda **d: parallel_fold_scores(x, y, np.arange(len(y)) % 3, 3, 1.0, [0.1], family="binomial",
                                                  **d)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert layout_from_jax(jcsr, device="cpu").values.device.type == "cpu"
    assert state_from_numpy(state, device="cpu").w.device.type == "cpu"
    assert BlockCOO.from_arrays(*packed, device="cpu").vals.device.type == "cpu"


def test_fit_validation():
    x, y = tst.load_heart()
    with pytest.raises(ValueError):
        tst.fit(x, y, family="cauchy", device="cpu")
    with pytest.raises(ValueError):
        tst.fit(x, y, family="binomial", alpha=1.5, device="cpu")
    with pytest.raises(ValueError):
        tst.fit(x[:10], y, family="binomial", device="cpu")
    xn = x.copy()
    xn[0, 0] = np.nan
    with pytest.raises(ValueError, match="NA"):
        tst.fit(xn, y, family="binomial", device="cpu")
    with pytest.raises(ValueError):
        tst.fit(x, y, family="binomial", dtype="int32", device="cpu")
