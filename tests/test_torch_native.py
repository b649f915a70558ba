"""The port's native data layer (utils/native.py) against the JAX package's.

Both bind the same source, native/sgdnet_native.cpp: the port builds its
own library under sgdnet_tpu_torch/_build/ and never writes the JAX
package's native/_sgdnet_native.so.  On the same bytes and CSR the two
give equal results: `load_libsvm` (indptr, indices, values, labels and
shape equal), `pack_padded` and `csr_column_stats` (equal), and both equal
the port's numpy versions; a malformed line raises in both; a fit from a
parsed libsvm buffer agrees with the JAX package's fit of the same buffer
within 1e-3 x scale.
"""

import io
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sgdnet_tpu as jst
import sgdnet_tpu_torch as tst
from sgdnet_tpu.utils import native as jnat
from sgdnet_tpu_torch.utils import native as tnat
from test_torch_cv import jax_sampling  # noqa: F401

torch.set_num_threads(1)

LIBSVM_SAMPLE = b"""1 1:0.5 3:-1.25 7:2
0 2:1.0
# comment line
1 1:3.5 2:0.25 4:1e-3
0 7:-4
"""


def _dump(x, y) -> bytes:
    from sklearn.datasets import dump_svmlight_file

    buf = io.BytesIO()
    dump_svmlight_file(x, y, buf)
    return buf.getvalue()


def _same_csr(a, b):
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype, f


def test_library_builds_under_its_build_dir(tmp_path, monkeypatch):
    """A fresh build lands in the port's build directory (here redirected to
    a temporary one) and writes nothing beside the source: native/ keeps
    its files.  (chip_smoke.py checks on the card, where no other process
    builds, that the JAX package's library keeps its bytes and mtime.)"""
    native_dir = os.path.dirname(tnat.SRC)
    before = sorted(os.listdir(native_dir))
    assert os.path.dirname(tnat.SO) == os.path.join(os.path.dirname(os.path.dirname(tnat.__file__)), "_build")
    monkeypatch.setattr(tnat, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(tnat, "SO", str(tmp_path / "_build" / "libsgdnet_native.so"))
    monkeypatch.setattr(tnat, "_LIB", None)
    lib = tnat.get_lib()
    assert lib._name == tnat.SO and os.path.exists(tnat.SO)
    assert os.listdir(tmp_path / "_build") == ["libsgdnet_native.so"]
    assert sorted(os.listdir(native_dir)) == before
    x, y = tnat.load_libsvm(LIBSVM_SAMPLE)
    assert x.shape == (4, 7)


def test_build_failure_raises_with_the_compilers_error(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnat, "SRC", str(bad))
    monkeypatch.setattr(tnat, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(tnat, "SO", str(tmp_path / "_build" / "libsgdnet_native.so"))
    monkeypatch.setattr(tnat, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnat.get_lib()
    assert os.listdir(tmp_path / "_build") == []


@pytest.mark.parametrize("n_threads", [0, 1, 3])
def test_parse_libsvm_matches_jax(n_threads):
    x, y = tnat.load_libsvm(LIBSVM_SAMPLE, n_threads=n_threads)
    xj, yj = jnat.load_libsvm(LIBSVM_SAMPLE, n_threads=n_threads)
    _same_csr(x, xj)
    np.testing.assert_array_equal(y, yj)
    assert x.shape == (4, 7)
    np.testing.assert_array_equal(x.toarray()[2], [3.5, 0.25, 0, 1e-3, 0, 0, 0])


def test_parse_dumped_file_matches_jax_and_data(tmp_path):
    """A sklearn dump (0-based indices) read from a path: equal to the JAX
    package's parse and to the data written."""
    rng = np.random.default_rng(0)
    x = sp.random(50, 20, density=0.2, random_state=0, format="csr")
    y = rng.normal(size=50)
    path = tmp_path / "d.svm"
    path.write_bytes(_dump(x, y))
    x2, y2 = tnat.load_libsvm(str(path))
    xj, yj = jnat.load_libsvm(str(path))
    _same_csr(x2, xj)
    np.testing.assert_array_equal(y2, yj)
    np.testing.assert_allclose(y2, y, rtol=1e-15)
    np.testing.assert_allclose(x2.toarray(), x.toarray()[:, : x2.shape[1]], rtol=1e-15)


@pytest.mark.parametrize("buf", [b"1 bogus\n", b"1 3:x\n", b"0 1:1.0\n1 2 3\n"])
def test_parse_error_raises_in_both(buf):
    with pytest.raises(ValueError, match="parse error"):
        tnat.load_libsvm(buf)
    with pytest.raises(ValueError, match="parse error"):
        jnat.load_libsvm(buf)


@pytest.mark.parametrize("width", [None, 3])
def test_pack_padded_matches_jax_and_numpy(width):
    x = sp.random(40, 15, density=0.3, random_state=1, format="csr")
    L = width or int(np.diff(x.indptr).max())
    out = tnat.pack_padded(x, L)
    for ref in (jnat.pack_padded(x, L), tnat.pack_padded_reference(x, L)):
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_csr_column_stats_matches_jax_and_numpy():
    x = sp.random(60, 9, density=0.4, random_state=2, format="csr")
    x = sp.csr_matrix(x.toarray() * (np.arange(9) != 4))  # a column of zeros: SD 1
    mean, sd = tnat.csr_column_stats(x)
    jm, js = jnat.csr_column_stats(x)
    np.testing.assert_array_equal(mean, jm)
    np.testing.assert_array_equal(sd, js)
    rm, rs = tnat.csr_column_stats_reference(x)
    np.testing.assert_allclose(mean, rm, rtol=0, atol=1e-15)
    np.testing.assert_allclose(sd, rs, rtol=1e-13)
    assert sd[4] == 1.0


def test_end_to_end_fit_from_libsvm(jax_sampling):
    """tests/test_native.py's fit on a parsed libsvm buffer (binomial, 5
    lambdas, the default thresh): converged, and within 1e-3 x scale of
    the JAX package's fit of its own parse of the same bytes (the JAX
    batch orders replayed, so the two walk one trajectory)."""
    rng = np.random.default_rng(3)
    x = sp.random(120, 10, density=0.4, random_state=3, format="csr")
    beta = rng.normal(size=10)
    y = (np.asarray(x @ beta).ravel() > 0).astype(float)
    buf = _dump(x, y)
    kw = dict(family="binomial", nlambda=5, dtype=np.float64)
    ft = tst.fit(*tnat.load_libsvm(buf), device="cpu", **kw)
    fj = jst.fit(*jnat.load_libsvm(buf), **kw)
    assert (ft.return_codes == 0).all() and (np.asarray(fj.return_codes) == 0).all()
    scale = max(1.0, np.abs(fj.beta).max())
    np.testing.assert_allclose(ft.beta, fj.beta, atol=1e-3 * scale)
    np.testing.assert_allclose(ft.dev_ratio, fj.dev_ratio, atol=1e-3)
