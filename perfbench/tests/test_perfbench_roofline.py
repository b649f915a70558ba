"""The roofline counts reproduce the kernel bounds PERF.md's kernel table
gives at slice C's and slice M's shapes."""

import numpy as np
import pytest

from perfbench import roofline
from perfbench.data import zipf_sparse
from perfbench.reference import saga as ref


def test_k2_bounds():
    assert round(1e3 * roofline.head_step(8192, 16384, 1, 2), 4) == 0.0802  # resident, slice C
    assert round(1e3 * roofline.head_step(8192, 16384, 53, 2), 4) == 0.0843  # streamed, slice M


@pytest.fixture(scope="module")
def slice_c_largest_block():
    """Slice C's tail as fit() packs it: bench.py's design (n 100000, p 47000,
    seed 0), split at D 16384, rows shuffled by the fit's seed 0, blocks of
    8192; the block with the most entries: (entries, distinct columns)."""
    x = zipf_sparse.to_csr(zipf_sparse.padded_design(100_000, 47_000, 76, 0)[0])
    perm, D = ref.split_columns(x, 0.98, 16384)
    assert D == 16384
    new_col = np.empty(x.shape[1], np.int64)
    new_col[perm] = np.arange(x.shape[1])
    rows = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr))
    inv = np.empty(x.shape[0], np.int64)
    inv[np.random.default_rng(0 + 0x5EED).permutation(x.shape[0])] = np.arange(x.shape[0])
    cols = new_col[x.indices]
    tail = cols >= D
    blk = inv[rows[tail]] // 8192
    b = int(np.argmax(np.bincount(blk)))
    return int((blk == b).sum()), len(np.unique(cols[tail][blk == b]))


def test_k3_k4_bounds(slice_c_largest_block):
    c, u = slice_c_largest_block
    assert round(1e3 * roofline.tail_forward(c, u, 8192, 1), 5) == 0.00018
    assert round(1e3 * roofline.tail_outer(c, 8192, 47_000, 1), 5) == 0.00021


def test_bound_takes_the_larger_side():
    nbytes, flops = 3.35e9, 989e12 * 2e-3
    assert roofline.bound_s(nbytes, flops, roofline.PEAK["bf16_flops"]) == pytest.approx(2e-3)
    assert roofline.bound_s(nbytes, 0.0, roofline.PEAK["bf16_flops"]) == pytest.approx(1e-3)
