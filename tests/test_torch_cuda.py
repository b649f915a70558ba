"""The hand-written CUDA kernels against their torch twins, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips without one.  The
file imports neither jax nor the JAX package, so it runs on a CUDA
machine that has only torch (tests/conftest.py needs jax, hence
--noconftest):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Bounds: K2 as tests/test_pallas.py (f32: g atol 1e-5, corr atol 2e-3;
bf16: g 3e-2, corr 2e-2 x max|corr|); K1 one epoch at 1e-5 x scale; fits
through a kernel vs the plain step path on the card at 1e-4 x scale.
"""

import numpy as np
import pytest
import torch

import sgdnet_tpu_torch as st
from sgdnet_tpu_torch.families import get_family
from sgdnet_tpu_torch.penalties import select_penalty
from sgdnet_tpu_torch.solver import epoch_kernel as ek
from sgdnet_tpu_torch.solver import head_kernel as hk
from sgdnet_tpu_torch.solver.saga import SagaState

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family,k", [("gaussian", 1), ("binomial", 1), ("multinomial", 10), ("mgaussian", 3)])
def test_head_kernel_matches_twin(dev, family, k, dtype):
    rng = np.random.default_rng(k)
    n_pad, B, D = 8192, 1024, 784
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    head = t(rng.normal(size=(n_pad, D))).to(dtype)
    w = t(rng.normal(size=(k, D)) / np.sqrt(D))
    lpe = t(0.1 * rng.normal(size=(B, k)))
    if family == "binomial":
        y = t(rng.random((B, k)) < 0.5)
    elif family == "multinomial":
        y = t(np.eye(k)[rng.integers(0, k, B)])
    else:
        y = t(rng.normal(size=(B, k)))
    gm, wb = t(0.1 * rng.normal(size=(B, k))), t(rng.random(B) < 0.9)
    args = (head, 2048, w, lpe, y, gm, wb, family)
    before = hk.fused_head_step_at.launches
    g, corr = hk.fused_head_step_at(*args)
    assert hk.fused_head_step_at.launches == before + 1
    g_ref, corr_ref = hk.fused_head_step_reference(*args)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(g, g_ref, atol=1e-5, rtol=0)
        torch.testing.assert_close(corr, corr_ref, atol=2e-3, rtol=0)
    else:
        torch.testing.assert_close(g, g_ref, atol=3e-2, rtol=0)
        torch.testing.assert_close(corr, corr_ref, atol=2e-2 * max(float(corr_ref.abs().max()), 1.0), rtol=0)


def test_head_kernel_rejects_what_it_does_not_take(dev):
    head = torch.zeros((256, 64), device=dev)
    args = (torch.zeros(64, device=dev), torch.zeros((64, 1), device=dev), torch.zeros((64, 1), device=dev),
            torch.zeros((64, 1), device=dev), torch.ones(64, device=dev))
    w = torch.zeros((1, 64), device=dev)
    with pytest.raises(ValueError):
        hk.fused_head_step_at(head, 0, w, args[1], args[2], args[3], args[4], "poisson")
    with pytest.raises(ValueError):
        hk.fused_head_step_at(head, 224, w, args[1], args[2], args[3], args[4], "gaussian")  # past the end
    with pytest.raises(ValueError):
        hk.fused_head_step_at(head.double(), 0, w, args[1], args[2], args[3], args[4], "gaussian")


@pytest.mark.parametrize("family,alpha,grouped", [
    ("gaussian", 0.8, False), ("binomial", 0.0, False), ("poisson", 0.5, False),
    ("multinomial", 0.9, True), ("mgaussian", 0.5, False),
])
def test_epoch_kernel_matches_twin(dev, family, alpha, grouped):
    rng = np.random.default_rng(3)
    n, p, B = 500, 11, 32
    x = rng.normal(size=(n, p))
    k = {"multinomial": 3, "mgaussian": 2}.get(family, 1)
    y = {"binomial": lambda: (rng.random((n, 1)) < 0.4).astype(float),
         "poisson": lambda: rng.poisson(1.5, (n, 1)).astype(float),
         "multinomial": lambda: np.eye(3)[rng.integers(0, 3, n)]}.get(family, lambda: rng.normal(size=(n, k)))()
    n_pad = -(-n // B) * B
    pad = lambda a: torch.tensor(  # noqa: E731
        np.concatenate([a, np.zeros((n_pad - n,) + a.shape[1:])]), dtype=torch.float32, device=dev)
    fam = get_family(family, n_classes=k, smoothness=8.0)
    fam.n_classes = k
    pen = select_penalty(alpha, family, "grouped" if grouped else "ungrouped")
    data = ek.pad_data(pad(x), pad(y), pad(np.ones(n)), pad(0.2 * rng.normal(size=(n, k))),
                       torch.tensor(rng.uniform(0, 2, p), dtype=torch.float32, device=dev))
    st0 = SagaState(*(torch.tensor(0.1 * rng.normal(size=s), dtype=torch.float32, device=dev)
                      for s in [(k, p), (k,), (n_pad, k), (k, p), (k,)]))
    ps = ek.pad_state(st0, p)
    starts = torch.tensor(rng.permutation(n_pad // B) * B, dtype=torch.int32, device=dev)
    run = (data, ps, starts, B, fam, pen, 0.01, 0.02, 0.03, float(n))
    for refresh in (True, False):
        out = ek.saga_epoch(*run, refresh=refresh)
        ref = ek.epoch_reference(*run, refresh=refresh)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, float(b.abs().max())), rtol=0)
        assert float(out.w[:, p:].abs().max()) == 0.0 and float(out.w[k:].abs().max()) == 0.0


@pytest.mark.parametrize("name,family", [("heart", "binomial"), ("wine", "multinomial")])
def test_fit_through_kernels_matches_plain_path(dev, name, family):
    x, y = st.load_dataset(name)["x"], st.load_dataset(name)["y"]
    common = dict(family=family, nlambda=8, sampling="block", seed=3, device=dev, batch_size=32)
    f_plain = st.fit(x, y, use_epoch_kernel=False, **common)
    f_k1 = st.fit(x, y, **common)  # K1 is the default on CUDA
    f_k2 = st.fit(x, y, use_epoch_kernel=False, use_pallas=True, lambda_path=f_plain.lambda_,
                  **{k: v for k, v in common.items() if k != "nlambda"})
    assert f_k1.stats["epoch_kernel"] is True and f_k2.stats["head_kernel"] is True
    scale = max(1.0, np.abs(f_plain.beta).max())
    for f in (f_k1, f_k2):
        assert np.abs(f.beta - f_plain.beta).max() / scale < 1e-4
