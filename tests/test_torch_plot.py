"""The port's plots (api/plot.py) against the JAX package's.

For every family the port's `SgdnetFit.plot` and the JAX package's draw the
same figure: the same axes, labels and titles, and each line's
`get_data()` equal.  The port's fit and the JAX fit walk one trajectory
(the `jax_sampling` fixture of test_torch_cv.py), so their lines agree
within 1e-6 x scale; the port's `plot_path` on the JAX fit's arrays
draws the JAX figure's lines exactly.  `CvFit.plot` likewise, a panel an
alpha; a bad `xvar` raises.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import sgdnet_tpu as jst  # noqa: E402
import sgdnet_tpu_torch as tst  # noqa: E402
from helpers import random_data  # noqa: E402
from sgdnet_tpu_torch.api.plot import plot_cv, plot_path  # noqa: E402
from test_torch_cv import jax_sampling  # noqa: F401, E402

torch.set_num_threads(1)

LOCKSTEP = 1e-6


def _data(family):
    if family == "poisson":
        rng = np.random.default_rng(1)
        x = rng.normal(size=(100, 4))
        return x, rng.poisson(np.exp(0.3 + x @ (rng.normal(size=4) * 0.3))).astype(np.float64)
    return random_data(n=100, p=4, family=family, seed=1)


def _lines(fig):
    """[(axis title, xlabel, ylabel, [(xdata, ydata), ...])] of the visible
    axes."""
    return [(a.get_title(), a.get_xlabel(), a.get_ylabel(), [ln.get_data() for ln in a.get_lines()])
            for a in fig.axes if a.get_visible()]


def _same_figure(ft, fj, atol):
    lt, lj = _lines(ft), _lines(fj)
    assert len(ft.axes) == len(fj.axes) and len(lt) == len(lj)
    for (tt, xt, yt, dt), (tj, xj, yj, dj) in zip(lt, lj):
        assert (tt, xt, yt) == (tj, xj, yj)
        assert len(dt) == len(dj)
        for (x1, y1), (x2, y2) in zip(dt, dj):
            np.testing.assert_allclose(np.asarray(x1, float), np.asarray(x2, float), rtol=0, atol=atol)
            np.testing.assert_allclose(np.asarray(y1, float), np.asarray(y2, float), rtol=0, atol=atol)


@pytest.mark.parametrize("family", ["gaussian", "binomial", "poisson", "multinomial", "mgaussian"])
def test_plot_path_matches_jax(family, jax_sampling):
    x, y = _data(family)
    kw = dict(family=family, nlambda=6, dtype=np.float64)
    ft, fj = tst.fit(x, y, device="cpu", **kw), jst.fit(x, y, **kw)
    scale = max(1.0, np.abs(fj.beta).max(), np.abs(np.log(fj.lambda_)).max())
    for xvar in ("norm", "lambda", "dev"):
        fig_t, fig_j = ft.plot(xvar=xvar), fj.plot(xvar=xvar)
        assert len(fig_t.axes) >= ft.beta.shape[1]
        _same_figure(fig_t, fig_j, LOCKSTEP * scale)
        # the JAX fit's arrays drawn by the port: the JAX figure exactly
        fig_x = plot_path(fj, xvar=xvar)
        _same_figure(fig_x, fig_j, 0.0)
        for f in (fig_t, fig_j, fig_x):
            plt.close(f)


def test_plot_path_on_a_given_axis():
    x, y = _data("gaussian")
    ft = tst.fit(x, y, nlambda=4, dtype=np.float64, device="cpu")
    fig, ax = plt.subplots()
    assert ft.plot(ax=ax) is fig and len(ax.get_lines()) == x.shape[1]
    plt.close(fig)
    fm = tst.fit(*_data("multinomial"), family="multinomial", nlambda=3, dtype=np.float64, device="cpu")
    fig, ax = plt.subplots()
    with pytest.raises(ValueError, match="single-response"):
        fm.plot(ax=ax)
    plt.close(fig)


def test_plot_bad_xvar():
    x, y = random_data(n=60, p=3, seed=2)
    fit = tst.fit(x, y, nlambda=4, dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="xvar"):
        fit.plot(xvar="bogus")


def test_plot_cv_matches_jax(jax_sampling):
    """tests/test_plotting.py's CV plot: a panel an alpha, and its lines
    (the mean curve, the lambda_min and lambda_1se verticals) the JAX
    package's within 1e-6 x scale."""
    x, y = random_data(n=120, p=4, seed=3)
    kw = dict(alpha=[0.2, 1.0], nfolds=4, nlambda=5, dtype=np.float64)
    ct, cj = tst.cv_fit(x, y, device="cpu", **kw), jst.cv_fit(x, y, **kw)
    fig_t, fig_j = ct.plot(), cj.plot()
    assert len(fig_t.axes) == 2
    summ = cj.cv_summary
    scale = max(1.0, float(np.max(np.abs(summ["mean"]))), float(np.max(np.abs(np.log(summ["lambda"])))))
    _same_figure(fig_t, fig_j, LOCKSTEP * scale)
    fig_x = plot_cv(cj)
    _same_figure(fig_x, fig_j, 0.0)
    for f in (fig_t, fig_j, fig_x):
        plt.close(f)
