"""The rcv1-scale sparse design: fixed nonzeros a row, Zipf column use.

A configuration whose `data_kind` is "zipf_sparse" is made here from the
run's seed.  The design is bench.py's `make_sparse_binomial`
(bench.py:142-165, the repo's north-star workload), copied bit for bit:
n rows of `nnz_per_row` draws each, columns from the Zipf weights
(rank + 10)^-zipf_exponent, values N(0, 1), and a binomial response from
a sparse true model (`true_share` of the columns, N(0, 3^2)).  Labels of
kind "softmax" replace that response by a k-class one drawn from a
seeded softmax model over the same design (rcv1.multiclass's 53 classes).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def padded_design(n, p, nnz_per_row, seed, zipf_exponent=1.15, true_share=0.05):
    """bench.py's generator: a padded-CSR dict (indices, values (n, L), nnz,
    n, p; L the row width rounded up to 8) and y (n, 1), float32."""
    rng = np.random.default_rng(seed)
    weights = (np.arange(p) + 10.0) ** -zipf_exponent
    cdf = np.cumsum(weights) / weights.sum()
    cols = np.searchsorted(cdf, rng.random((n, nnz_per_row))).astype(np.int32).clip(0, p - 1)
    vals = rng.normal(size=(n, nnz_per_row)).astype(np.float32)
    w_true = rng.normal(size=p) * (rng.random(p) < true_share) * 3.0
    lp = (vals * w_true[cols]).sum(axis=1)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-lp))).astype(np.float32)

    L = ((nnz_per_row + 7) // 8) * 8
    indices = np.zeros((n, L), np.int32)
    values = np.zeros((n, L), np.float32)
    indices[:, :nnz_per_row] = cols
    values[:, :nnz_per_row] = vals
    x = dict(indices=indices, values=values, nnz=np.full((n,), nnz_per_row, np.int32), n=n, p=p)
    return x, y.reshape(-1, 1)


def to_csr(x) -> sp.csr_matrix:
    """The padded dict as a canonical scipy CSR: a row's repeated columns
    summed, explicit zeros dropped (bench.py's `_to_scipy`)."""
    n, p = x["n"], x["p"]
    ind = x["indices"].reshape(-1)
    val = x["values"].reshape(-1)
    rows = np.repeat(np.arange(n), x["indices"].shape[1])
    keep = val != 0
    m = sp.csr_matrix((val[keep], (rows[keep], ind[keep])), shape=(n, p))
    m.sum_duplicates()
    return m


def softmax_labels(x, k, per_class, head, seed):
    """k-class labels on the design x (scipy CSR): each class has `per_class`
    true coefficients N(0, 3^2), half among the `head` most used columns
    and half among the rest; y (n,) is drawn from softmax(x W) by the
    Gumbel trick.  Raises if a class draws no row (profile_sparse_slices.py's
    `make_sparse_multiclass_labels`, copied)."""
    rng = np.random.default_rng(seed)
    n, p = x.shape
    order = np.argsort(-np.bincount(x.indices, minlength=p), kind="stable")
    w = np.zeros((p, k))
    for c in range(k):
        cols = np.concatenate([rng.choice(order[:head], per_class // 2, replace=False),
                               rng.choice(order[head:], per_class - per_class // 2, replace=False)])
        w[cols, c] = 3.0 * rng.normal(size=per_class)
    y = np.argmax(np.asarray(x @ w) + rng.gumbel(size=(n, k)), axis=1)
    counts = np.bincount(y, minlength=k)
    if counts.min() == 0:
        raise RuntimeError(f"softmax labels: class {int(np.argmin(counts))} drew no row")
    return y


def make(config: dict, seed: int):
    """(x, y, k) of a configuration: the design as a canonical scipy CSR
    (float32), the response ((n,) 0/1 float32 for binomial labels, (n,)
    class ids for softmax ones) and the number of classes the fit sees
    (1 for binomial)."""
    xd, y = padded_design(config["n"], config["p"], config["nnz_per_row"], seed, config["zipf_exponent"],
                          config["true_share"])
    x = to_csr(xd)
    labels = config["labels"]
    if labels["kind"] == "binomial":
        return x, y.ravel(), 1
    if labels["kind"] == "softmax":
        return x, softmax_labels(x, labels["classes"], labels["per_class"], labels["head"], seed), labels["classes"]
    raise ValueError(f"unknown labels kind {labels['kind']!r}")
