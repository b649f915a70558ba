"""The port's checkpoints (utils/checkpoint.py) against the JAX package's.

One file format for both packages: a state written by either loads in the
other with every field bit for bit (JAX save_state -> port load_state, and
port save_state -> JAX load_state), and the metadata as written.  The
warm-resume test of tests/test_checkpoint.py runs on the port: the head of
a path, checkpointed, reloaded and resumed on the rest, against the whole
path within 2e-3 x scale.
"""

import numpy as np
import pytest
import torch

import sgdnet_tpu as jst
import sgdnet_tpu_torch as tst
from helpers import random_data
from sgdnet_tpu.utils import checkpoint as jck
from sgdnet_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)

FIELDS = ("w", "intercept", "g_mem", "g_sum", "g_sum_intercept")


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("family", ["gaussian", "multinomial"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, family):
    x, y = random_data(n=90, p=5, family=family, seed=1)
    fj = jst.fit(x, y, family=family, nlambda=5, dtype=np.float64)
    meta = {"lambda": list(map(float, fj.lambda_)), "family": family}
    path = str(tmp_path / "jax.npz")
    jck.save_state(path, fj.final_state, meta=meta)
    state, got = tck.load_state(path, device="cpu")
    for f in FIELDS:
        _same_bits(getattr(state, f).numpy(), getattr(fj.final_state, f))
    assert got == meta


@pytest.mark.parametrize("family", ["binomial", "mgaussian"])
def test_port_checkpoint_loads_in_jax(tmp_path, family):
    x, y = random_data(n=90, p=5, family=family, seed=2)
    ft = tst.fit(x, y, family=family, nlambda=5, dtype=np.float64, device="cpu")
    path = str(tmp_path / "port.npz")
    tck.save_state(path, ft.final_state, meta={"nobs": ft.nobs})
    state, meta = jck.load_state(path)
    for f in FIELDS:
        _same_bits(np.asarray(getattr(state, f)), getattr(ft.final_state, f).numpy())
    assert meta == {"nobs": 90}


def test_save_load_roundtrip_and_dtype(tmp_path):
    """tests/test_checkpoint.py's round trip on the port, then a load that
    converts every field to float32."""
    x, y = random_data(n=100, p=5, seed=1)
    fit = tst.fit(x, y, nlambda=5, dtype=np.float64, device="cpu")
    path = str(tmp_path / "state.npz")
    tck.save_state(path, fit.final_state, meta={"lambda": list(map(float, fit.lambda_))})
    state, meta = tck.load_state(path, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(state, f), getattr(fit.final_state, f))
    assert meta["lambda"][0] == fit.lambda_[0]
    s32, _ = tck.load_state(path, dtype=np.float32, device="cpu")
    assert all(getattr(s32, f).dtype == torch.float32 for f in FIELDS)
    torch.testing.assert_close(s32.w, fit.final_state.w.float(), rtol=0, atol=0)


def test_load_state_without_a_card_raises(tmp_path):
    x, y = random_data(n=40, p=3, seed=3)
    fit = tst.fit(x, y, nlambda=2, dtype=np.float64, device="cpu")
    path = str(tmp_path / "s.npz")
    tck.save_state(path, fit.final_state)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: device=None loads onto it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tck.load_state(path)


def test_warm_resume_extends_path(tmp_path):
    """tests/test_checkpoint.py's warm resume on the port: the first 5
    lambdas, checkpointed and resumed on the other 5, against the
    uninterrupted path; and the JAX package resuming from the port's file
    agrees with the port resuming from it."""
    x, y = random_data(n=120, p=5, seed=2)
    kw = dict(thresh=1e-6, dtype=np.float64)
    full = tst.fit(x, y, nlambda=10, device="cpu", **kw)
    head = tst.fit(x, y, lambda_path=full.lambda_[:5], device="cpu", **kw)
    path = str(tmp_path / "ck.npz")
    tck.save_state(path, head.final_state)
    state, _ = tck.load_state(path, device="cpu")
    tail = tst.fit(x, y, lambda_path=full.lambda_[5:], warm_state=state, device="cpu", **kw)
    scale = max(1.0, np.abs(full.beta).max())
    np.testing.assert_allclose(tail.beta, full.beta[5:], atol=2e-3 * scale)
    jstate, _ = jck.load_state(path)
    jtail = jst.fit(x, y, lambda_path=full.lambda_[5:], warm_state=jstate, **kw)
    np.testing.assert_allclose(tail.beta, jtail.beta, atol=2e-3 * scale)
