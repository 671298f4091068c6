"""Builds ``csrc/four_step.cu`` with ``nvcc`` at first use and loads it
with ``ctypes``.

The library has a plain C interface (no PyTorch headers), so a build
takes seconds. It lands in ``distributedfft_tpu_torch/_build/`` (listed in
``.gitignore``), named by the source's hash, so an edited source is built
anew and an unchanged one is loaded as it is. Nothing runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "four_step.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "distributedfft_tpu_torch are built from csrc/ at first use")
    return path


def _declare(lib: ctypes.CDLL) -> None:
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.dfft_fft_rows.argtypes = [p, p, p, ll, i, i, i, p, p, p, f, p]
    lib.dfft_fft_strided.argtypes = [p, p, p, ll, ll, i, i, i, p, p, p, f, p]
    lib.dfft_fft_plane.argtypes = ([p, p, p, ll] + [i] * 8 + [p] * 6
                                   + [f, p])
    for fn in (lib.dfft_fft_rows, lib.dfft_fft_strided, lib.dfft_fft_plane):
        fn.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(SOURCE, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"libdfft_four_step_{digest}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)  # atomic: concurrent builds agree
        lib = ctypes.CDLL(so)
        _declare(lib)
        _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` a launcher returned."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
