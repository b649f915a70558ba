"""The port's data-parallel fit (parallel/dist.py, SolverConfig.mesh)
against the JAX package's sharded fit.

Two gloo ranks on the CPU (spawned once for the module, every case run in
that one group by tests/torch_dist_cases.py) fit the same seeded data as
`sgdnet_tpu.fit(..., mesh=make_mesh(2))` on two of conftest's eight
virtual devices, float64.  The ranks replay the JAX fit's per-shard batch
orders and its power iteration's start vector, so both walk the same
trajectory: coefficients agree per lambda within 1e-6 x scale for a dense
gaussian and binomial, a PaddedCSR and a HybridCSR with a BlockCOO tail
under block sampling.  Without the replay a 2-rank fit meets the
single-device fit at the matched global batch within 2e-3 x scale (the
contract of tests/test_parallel.py).  A step makes exactly one
all-reduce, a refresh one, and every rank ends with the same bits of w.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sgdnet_tpu as jst
import sgdnet_tpu_torch as tst
import torch_dist_cases
from helpers import random_data
from sgdnet_tpu.parallel.dist import make_mesh as jax_mesh
from sgdnet_tpu_torch.parallel.multihost import run_ranks

torch.set_num_threads(1)

LOCKSTEP_TOL = 1e-6


def _lockstep_cases() -> dict:
    common = dict(nlambda=3, thresh=1e-3, maxit=60, dtype=np.float64, batch_size=8)
    out = {}
    for name, family, kind, p, density, extra in (
        ("dense_gaussian", "gaussian", "dense", 12, 1.0, {}),
        ("dense_binomial", "binomial", "dense", 12, 1.0, {}),
        ("csr_binomial", "binomial", "csr", 12, 0.4, {}),
        ("hybrid_blockcoo_binomial", "binomial", "hybrid", 24, 0.4,
         dict(hybrid=True, hybrid_max_head=8, sampling="block")),
    ):
        x, y = random_data(n=64, p=p, family=family, density=density, seed=1)
        out[name] = {"x": x, "y": y, "kind": kind, "kw": dict(common, family=family, **extra)}
    return out


LOCKSTEP = _lockstep_cases()

#: matched global batch, no replay: 4 rows a rank on 2 ranks against 8 on one
MATCHED = {f"matched_{family}": {"x": random_data(n=96, p=6, family=family, seed=3)[0],
                                 "y": random_data(n=96, p=6, family=family, seed=3)[1], "kind": "dense",
                                 "kw": dict(family=family, nlambda=5, thresh=1e-6, maxit=3000, dtype=np.float64,
                                            batch_size=4)}
           for family in ("gaussian", "binomial")}

#: fixed epochs: thresh 0 runs maxit epochs a lambda, no backoff retries
COUNTED = {"counted": {"x": random_data(n=64, p=6, family="binomial", seed=4)[0],
                       "y": random_data(n=64, p=6, family="binomial", seed=4)[1], "kind": "dense",
                       "kw": dict(family="binomial", nlambda=2, thresh=0.0, maxit=5, step_backoff=False,
                                  dtype=np.float64, batch_size=8)}}


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results: the lockstep cases (JAX orders replayed) in one
    group, the matched-batch and counted cases in another."""
    lock = run_ranks(torch_dist_cases.run_cases, 2, args=(LOCKSTEP, True), timeout=300.0)
    own = run_ranks(torch_dist_cases.run_cases, 2, args=({**MATCHED, **COUNTED},), timeout=300.0)
    return [{**a, **b} for a, b in zip(lock, own)]


def _jax_fit(case):
    x = case["x"] if case["kind"] == "dense" else sp.csr_matrix(case["x"])
    return jst.fit(x, case["y"], mesh=jax_mesh(2), **case["kw"])


@pytest.mark.parametrize("name", list(LOCKSTEP))
def test_two_ranks_match_jax_sharded_fit(ranks, name):
    jf = _jax_fit(LOCKSTEP[name])
    r = ranks[0][name]
    np.testing.assert_allclose(r["lambda"], jf.lambda_, rtol=1e-10)
    scale = max(1.0, float(np.abs(jf.beta).max()))
    np.testing.assert_allclose(r["beta"], jf.beta, atol=LOCKSTEP_TOL * scale, rtol=0)
    np.testing.assert_allclose(r["a0"], jf.a0, atol=LOCKSTEP_TOL * scale, rtol=0)
    assert r["npasses"] == jf.npasses
    np.testing.assert_array_equal(r["return_codes"], jf.return_codes)
    layout = r["stats"]["layout"]["kind"]
    assert layout == {"dense_gaussian": "dense", "dense_binomial": "dense", "csr_binomial": "padded_csr",
                      "hybrid_blockcoo_binomial": "hybrid"}[name]
    if layout == "hybrid":
        assert r["stats"]["layout"]["blk_tail"] and r["stats"]["tail_kernel"]


@pytest.mark.parametrize("name", list(LOCKSTEP) + list(MATCHED))
def test_every_rank_ends_with_the_same_bits(ranks, name):
    a, b = ranks[0][name], ranks[1][name]
    np.testing.assert_array_equal(a["w"], b["w"])
    np.testing.assert_array_equal(a["beta"], b["beta"])
    assert a["npasses"] == b["npasses"]
    assert a["stats"]["mesh"] == {"axis": "data", "size": 2, "rank": 0, "backend": "gloo"}
    assert b["stats"]["mesh"]["rank"] == 1


@pytest.mark.parametrize("family", ["gaussian", "binomial"])
def test_sharded_matches_single_device(ranks, family):
    c = MATCHED[f"matched_{family}"]
    r = ranks[0][f"matched_{family}"]
    single = tst.fit(c["x"], c["y"], device="cpu", lambda_path=r["lambda"], **dict(c["kw"], batch_size=8))
    scale = max(1.0, float(np.abs(single.beta).max()))
    np.testing.assert_allclose(r["beta"], single.beta, atol=2e-3 * scale)
    np.testing.assert_allclose(r["a0"], single.a0, atol=5e-3 * scale)
    np.testing.assert_allclose(r["dev_ratio"], single.dev_ratio, atol=1e-3)
    assert (r["return_codes"] == 0).all()


def test_one_allreduce_a_step_and_a_refresh(ranks):
    """2 lambdas x 5 epochs of 4 blocks a rank: 40 steps, 10 refreshes, a
    dataset loss a lambda and the total weight once; torch.distributed
    sees exactly those calls."""
    for r in ranks:
        c = r["counted"]
        assert c["npasses"] == 10 and c["g_mem_rows"] == 32
        assert c["stats"]["allreduces"] == {"setup": 1, "step": 40, "refresh": 10, "loss": 2, "total": 53}
        assert c["all_reduce_calls"] == 53


def test_mesh_keeps_k1_and_k2_off_by_default(ranks):
    """Neither K1 nor, without use_pallas=True, K2 runs under a mesh (as in
    the JAX package); the rank's g_mem holds its rows only."""
    for name in LOCKSTEP:
        st = ranks[0][name]["stats"]
        assert st["epoch_kernel"] is False and st["head_kernel"] is False
    assert ranks[0]["dense_gaussian"]["g_mem_rows"] == 32
