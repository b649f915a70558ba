"""ctypes bindings of the native C++ data layer (twin of
sgdnet_tpu/utils/native.py): the libsvm parser, the padded-row packer and
the sparse column statistics of native/sgdnet_native.cpp.

The source is the JAX package's own file, read in place, not copied.  It
is built with g++ at first use into `sgdnet_tpu_torch/_build/` (rebuilt
when the source is newer than the library); the JAX package's library
beside the source is never written.  A failed build raises with g++'s
error: there is no fallback, as the machines the port runs on need not
have sklearn.  `pack_padded_reference` and `csr_column_stats_reference`
are the plain numpy versions the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC = os.path.join(_ROOT, "native", "sgdnet_native.cpp")
BUILD_DIR = os.path.join(_ROOT, "sgdnet_tpu_torch", "_build")
SO = os.path.join(BUILD_DIR, "libsgdnet_native.so")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIB = None


class _ParseResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_cols", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("indptr", ctypes.POINTER(ctypes.c_int64)),
        ("indices", ctypes.POINTER(ctypes.c_int32)),
        ("values", ctypes.POINTER(ctypes.c_double)),
        ("labels", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char_p),
    ]


def _build() -> None:
    """Compile the source unless the library is at least as new; the
    library is written under another name and renamed into place, so a
    process that loads it never sees half a file."""
    if os.path.exists(SO) and os.path.getmtime(SO) >= os.path.getmtime(SRC):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {out.returncode}) building {SRC}:\n{out.stderr}{out.stdout}")
        os.replace(tmp, SO)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the native data layer needs a C++ compiler ({e})") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> ctypes.CDLL:
    """The native library, built at first use; raises RuntimeError with
    g++'s error when the build fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        _build()
        lib = ctypes.CDLL(SO)
        lib.sgdnet_parse_libsvm.restype = ctypes.POINTER(_ParseResult)
        lib.sgdnet_parse_libsvm.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32]
        lib.sgdnet_free_parse_result.restype = None
        lib.sgdnet_free_parse_result.argtypes = [ctypes.POINTER(_ParseResult)]
        i64, i32, f64 = (np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS") for t in (np.int64, np.int32, np.float64))
        lib.sgdnet_pack_padded.restype = None
        lib.sgdnet_pack_padded.argtypes = [
            i64, i32, f64, ctypes.c_int64, ctypes.c_int64,
            i32, np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"), i32, ctypes.c_int32,
        ]
        lib.sgdnet_csr_column_stats.restype = None
        lib.sgdnet_csr_column_stats.argtypes = [i64, i32, f64, ctypes.c_int64, ctypes.c_int64, f64, f64]
        _LIB = lib
        return _LIB


def _csr_arrays(x_csr):
    """The CSR's indptr, indices and values in the library's types."""
    return (np.ascontiguousarray(x_csr.indptr, dtype=np.int64),
            np.ascontiguousarray(x_csr.indices, dtype=np.int32),
            np.ascontiguousarray(x_csr.data, dtype=np.float64))


def load_libsvm(path_or_bytes, n_threads: int = 0):
    """Parse a libsvm / svmlight file (a path, or its bytes) into (scipy CSR
    (f64 values, int32 indices), labels (f64)) with the multithreaded
    native parser (`n_threads` 0: one a hardware thread).  1-based indices
    are shifted to 0-based; a malformed line raises ValueError."""
    import scipy.sparse as sp

    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    else:
        buf = bytes(path_or_bytes)

    lib = get_lib()
    res = lib.sgdnet_parse_libsvm(buf, len(buf), int(n_threads))
    try:
        r = res.contents
        if r.error:
            raise ValueError(f"libsvm parse error: {r.error.decode()}")
        n, p, nnz = r.n_rows, r.n_cols, r.nnz
        indptr = np.ctypeslib.as_array(r.indptr, (n + 1,)).copy()
        indices = np.ctypeslib.as_array(r.indices, (max(nnz, 1),))[:nnz].copy()
        values = np.ctypeslib.as_array(r.values, (max(nnz, 1),))[:nnz].copy()
        labels = np.ctypeslib.as_array(r.labels, (max(n, 1),))[:n].copy()
        return sp.csr_matrix((values, indices, indptr), shape=(n, p)), labels
    finally:
        lib.sgdnet_free_parse_result(res)


def pack_padded(x_csr, row_width: int, n_threads: int = 0):
    """CSR -> (indices (n, L) int32, values (n, L) f32, nnz (n,) int32): the
    first L entries of each row, zero-padded."""
    n = x_csr.shape[0]
    indptr, indices, values = _csr_arrays(x_csr)
    out_i = np.zeros((n, row_width), np.int32)
    out_v = np.zeros((n, row_width), np.float32)
    out_n = np.zeros((n,), np.int32)
    get_lib().sgdnet_pack_padded(indptr, indices, values, n, row_width, out_i, out_v, out_n, int(n_threads))
    return out_i, out_v, out_n


def csr_column_stats(x_csr):
    """Per-column (mean, population SD counting the zeros; SD 0 -> 1)."""
    n, p = x_csr.shape
    indptr, indices, values = _csr_arrays(x_csr)
    mean, sd = np.zeros(p), np.zeros(p)
    get_lib().sgdnet_csr_column_stats(indptr, indices, values, n, p, mean, sd)
    return mean, sd


def pack_padded_reference(x_csr, row_width: int):
    """`pack_padded` in numpy (the tests' plain version)."""
    n = x_csr.shape[0]
    indptr, indices, values = _csr_arrays(x_csr)
    out_i = np.zeros((n, row_width), np.int32)
    out_v = np.zeros((n, row_width), np.float32)
    nnz = np.diff(indptr)
    rows = np.repeat(np.arange(n), nnz)
    pos = np.arange(len(values)) - np.repeat(indptr[:-1], nnz)
    keep = pos < row_width
    out_i[rows[keep], pos[keep]] = indices[keep]
    out_v[rows[keep], pos[keep]] = values[keep]
    return out_i, out_v, np.minimum(nnz, row_width).astype(np.int32)


def csr_column_stats_reference(x_csr):
    """`csr_column_stats` in numpy (the tests' plain version)."""
    n = x_csr.shape[0]
    mean = np.asarray(x_csr.sum(axis=0)).ravel() / n
    sq = np.asarray(x_csr.multiply(x_csr).sum(axis=0)).ravel() / n
    var = np.maximum(sq - mean ** 2, 0.0)
    return mean, np.where(var == 0.0, 1.0, np.sqrt(var))
