"""The port's `fit(lambda_chunk=)` against the JAX package's.

The path runs in warm-started chunks, each with its own batch orders (the
salt lo + 1000 * try, the JAX package's fold_in(key, lo + 1000 * try)) and
the sticky step backoff of a suspicious chunk.  With the `jax_sampling`
fixture of test_torch_cv.py the port replays the JAX package's orders for
every chunk and retry, so the two walk the same trajectories: coefficients
within 1e-6 x scale (f64; measured ~3e-16), the same return codes, the same
chunks refit.  The cases are tests/test_lambda_path.py's (the chunked path
against the single call, the backoff mechanics at maxit 1, a converging
chunked fit), and screening's `full_tail_chunk`, which fit passes its
`lambda_chunk` as: screen="auto" runs the full-layout tail in chunks.
"""

import numpy as np
import pytest
import torch

import sgdnet_tpu as jst
import sgdnet_tpu_torch as tst
from helpers import random_data
from test_torch_cv import jax_sampling  # noqa: F401
from test_torch_screening import _lockstep, _twin

torch.set_num_threads(1)

LOCKSTEP = 1e-6


def _chunked_lockstep(x, y, **kw):
    """The port's chunked fit and the JAX package's, held in lockstep:
    (port fit, JAX fit)."""
    ft = tst.fit(x, y, dtype=np.float64, device="cpu", **kw)
    fj = jst.fit(x, y, dtype=np.float64, **kw)
    scale = max(1.0, np.abs(fj.beta).max())
    np.testing.assert_allclose(ft.beta, fj.beta, rtol=0, atol=LOCKSTEP * scale)
    np.testing.assert_allclose(ft.a0, np.asarray(fj.a0), rtol=0, atol=LOCKSTEP * max(1.0, np.abs(fj.a0).max()))
    np.testing.assert_allclose(ft.dev_ratio, fj.dev_ratio, rtol=0, atol=LOCKSTEP)
    np.testing.assert_allclose(ft.lambda_, fj.lambda_, rtol=1e-12)  # lambda_max's last bits differ
    assert (ft.return_codes == np.asarray(fj.return_codes)).all()
    # a lambda whose last epoch's change sits at thresh can stop an epoch
    # apart under another summation order
    assert abs(ft.npasses - fj.npasses) <= max(2, 0.01 * fj.npasses)
    return ft, fj


def test_lambda_chunked_path_matches_single_call(jax_sampling):
    """tests/test_lambda_path.py's chunked path: in lockstep with the JAX
    package's, and within its bounds of the one-call path."""
    x, y = random_data(n=200, p=12, seed=8)
    kw = dict(nlambda=9, thresh=1e-7, maxit=3000, seed=1)
    ft, _ = _chunked_lockstep(x, y, lambda_chunk=4, **kw)
    one = tst.fit(x, y, dtype=np.float64, device="cpu", **kw)
    assert ft.npasses > 0
    scale = max(1.0, np.abs(one.beta).max())
    np.testing.assert_allclose(ft.beta, one.beta, atol=2e-3 * scale)
    np.testing.assert_allclose(ft.dev_ratio, one.dev_ratio, atol=1e-3)
    np.testing.assert_array_equal(ft.lambda_, one.lambda_)
    assert ft.stats["lambda_chunk"] == {"chunks": 3, "refits": [], "backoff": 0}
    assert "lambda_chunk" not in one.stats


def test_lambda_chunk_backoff_mechanics(jax_sampling):
    """maxit 1: every lambda ends at code 1 with a large final change, so
    each chunk is refit at half the step; every attempt counts in npasses,
    and the codes stay an honest 1."""
    x, y = random_data(n=64, p=6, seed=3)
    ft, _ = _chunked_lockstep(x, y, nlambda=4, maxit=1, lambda_chunk=2, thresh=1e-12)
    assert 8 <= ft.npasses <= 36
    assert (ft.return_codes == 1).all()
    assert ft.stats["lambda_chunk"]["chunks"] == 2
    assert set(ft.stats["lambda_chunk"]["refits"]) == {0, 2}


def test_lambda_chunk_converges(jax_sampling):
    """A converging chunked fit reports code 0 at every lambda."""
    x, y = random_data(n=200, p=8, seed=4)
    ft, _ = _chunked_lockstep(x, y, nlambda=6, lambda_chunk=3, thresh=1e-5, maxit=2000)
    assert (ft.return_codes == 0).all()


def test_lambda_chunk_binomial_chunks_of_one(jax_sampling):
    """A link family, chunks of 1 and a chunk size over the path's length
    (one call, as without chunking)."""
    x, y = random_data(n=120, p=5, family="binomial", seed=6)
    ft, _ = _chunked_lockstep(x, y, family="binomial", nlambda=5, lambda_chunk=1, thresh=1e-6, maxit=2000)
    assert ft.stats["lambda_chunk"]["chunks"] == 5
    whole = tst.fit(x, y, family="binomial", nlambda=5, lambda_chunk=9, thresh=1e-6, maxit=2000,
                    dtype=np.float64, device="cpu")
    assert "lambda_chunk" not in whole.stats


def test_lambda_chunk_rejects_nonpositive():
    x, y = random_data(n=40, p=3, seed=7)
    with pytest.raises(ValueError, match="lambda_chunk"):
        tst.fit(x, y, lambda_chunk=0, device="cpu")


def test_screen_auto_full_tail_chunked(jax_sampling):
    """screen="auto" with lambda_chunk on a path that densifies: the tail
    past the switch runs in full-layout chunks of 2 lambdas (each a
    fallback group), in lockstep with the JAX package's screened fit and
    within 2e-3 x scale of its unscreened chunked fit."""
    rng = np.random.default_rng(22)
    n, p = 300, 60
    x = rng.normal(size=(n, p))
    y = x @ rng.normal(size=p) + 0.2 * rng.normal(size=n)
    auto, _ = _twin(x, y, lambda_min_ratio=1e-4, screen="auto", lambda_chunk=2, thresh=1e-6, maxit=2000,
                    dtype=np.float64)
    scr = auto.stats["screening"]
    assert scr["full_tail_from"] is not None
    tail = 6 - scr["full_tail_from"]  # _twin fits the 7-lambda path past lambda_max
    assert scr["full_fallback_groups"] == -(-tail // 2) > 1


def test_screen_true_ignores_full_tail_chunk(jax_sampling):
    """screen=True never switches to a full-layout tail: lambda_chunk
    changes nothing there (lockstep with the JAX package's)."""
    x, y = random_data(n=150, p=120, seed=9)
    lams = jst.fit(x, y, nlambda=7, lambda_min_ratio=0.3, dtype=np.float64).lambda_[1:]
    kw = dict(lambda_path=lams, screen=True, thresh=1e-6, maxit=2000, dtype=np.float64)
    scr = tst.fit(x, y, lambda_chunk=2, device="cpu", **kw)
    _lockstep(scr, x, y, lambda_chunk=2, **kw)
    plain = tst.fit(x, y, device="cpu", **kw)
    np.testing.assert_array_equal(scr.beta, plain.beta)
