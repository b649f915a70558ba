"""Example datasets: the JAX package's bundled .npz files, read by path.

  abalone  (4177, 9)  gaussian
  heart    (270, 18)  binomial
  wine     (178, 13)  multinomial
  student  (382, 21)  mgaussian

The files live in `sgdnet_tpu/data/` beside this package; they are read
with numpy, so nothing of the JAX package is imported.
"""

from __future__ import annotations

import os

import numpy as np

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "sgdnet_tpu", "data"
)


def load_dataset(name: str):
    """Load a bundled dataset; returns a dict with x, y and metadata."""
    path = os.path.join(DATA_DIR, f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no bundled dataset '{name}' (looked for {path})")
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_abalone():
    d = load_dataset("abalone")
    return d["x"], d["y"]


def load_heart(sparse: bool = False):
    """heart's x (a scipy CSR matrix when `sparse`) and y."""
    d = load_dataset("heart")
    x = d["x"]
    if sparse:
        import scipy.sparse as sp

        x = sp.csr_matrix(x)
    return x, d["y"]


def load_wine():
    d = load_dataset("wine")
    return d["x"], d["y"]


def load_student():
    d = load_dataset("student")
    return d["x"], d["y"]
