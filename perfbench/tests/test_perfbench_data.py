"""The benchmark's copy of the generator against the port's tools, bit for bit."""

import numpy as np
import pytest

from perfbench.data import zipf_sparse


@pytest.mark.parametrize("seed", [0, 7, 3_000_000_017])
def test_design_matches_the_ports_bench(seed):
    from sgdnet_tpu_torch.tools import bench

    x, y = zipf_sparse.padded_design(3000, 1200, 76, seed)
    xb, yb = bench.make_sparse_binomial(3000, 1200, 76, seed)
    for key in ("indices", "values", "nnz"):
        assert np.array_equal(x[key], xb[key])
    assert (x["n"], x["p"]) == (xb["n"], xb["p"])
    assert np.array_equal(y, yb)
    a, b = zipf_sparse.to_csr(x), bench._to_scipy(xb)
    b.sum_duplicates()
    assert (a != b).nnz == 0 and a.has_canonical_format


def test_softmax_labels_match_slice_m():
    from sgdnet_tpu_torch.tools import profile_sparse_slices as pss

    x = zipf_sparse.to_csr(zipf_sparse.padded_design(4000, 900, 20, 5)[0])
    got = zipf_sparse.softmax_labels(x, 7, 30, 128, 5)
    assert np.array_equal(got, pss.make_sparse_multiclass_labels(x, 7, 30, 128, 5))


def test_make_returns_the_configured_response():
    conf = {"n": 2000, "p": 700, "nnz_per_row": 20, "zipf_exponent": 1.15, "true_share": 0.05,
            "labels": {"kind": "softmax", "classes": 5, "per_class": 20, "head": 128}}
    x, y, k = zipf_sparse.make(conf, 3)
    assert x.shape == (2000, 700) and k == 5 and y.shape == (2000,) and set(np.unique(y)) <= set(range(5))
    x2, y2, k2 = zipf_sparse.make(dict(conf, labels={"kind": "binomial"}), 3)
    assert k2 == 1 and set(np.unique(y2)) == {0.0, 1.0} and (x2 != x).nnz == 0
