"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The kernels are compiled at first use with `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface, which is
loaded with ctypes: the build needs nothing but nvcc (no ninja, no
PyTorch headers).  The library lands in `sgdnet_tpu_torch/_build/`,
keyed by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads at once.  Nothing here runs at import time.

A failed build raises with nvcc's stderr; a failed launch raises with
the CUDA error string (see `check`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("epoch_kernel.cu", "head_step.cu")
HEADERS = ("common.h",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "sgd_epoch": (
        [_P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I, _P],
        ctypes.c_int,
    ),
    "sgd_head_step": (
        [_P, _I, _LL, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P],
        ctypes.c_int,
    ),
    "sgd_error_string": ([_I], ctypes.c_char_p),
}

#: the loaded library and its build record, filled by `load_library`
_STATE: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")


def _source_hash(nvcc: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    if "lib" in _STATE:
        return _STATE["lib"]
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libsgdnet_kernels_{_source_hash(nvcc)}.so")
    t0 = time.perf_counter()
    built = False
    if not os.path.exists(out):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(os.path.join(CSRC, s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, out)
        built = True
    lib = ctypes.CDLL(out)
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _STATE.update(lib=lib, path=out, built=built, seconds=time.perf_counter() - t0)
    return lib


def build_info() -> dict:
    """Path of the loaded library, whether this process compiled it, and
    the seconds that took (empty before `load_library`)."""
    return {k: v for k, v in _STATE.items() if k != "lib"}


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = load_library().sgd_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
