"""Builds the CUDA sources under ``csrc/`` with ``nvcc`` at first use and
loads them with ``ctypes``.

Every ``.cu`` file is compiled to an object by its own ``nvcc`` process,
all started together, and the objects are linked into one shared library.
The library has a plain C interface (no PyTorch headers), so a build
takes seconds. It lands in ``distributedfft_tpu_torch/_build/`` (listed in
``.gitignore``), named by the hash of every source and header together,
so an edited source is built anew and an unchanged one is loaded as it
is. Nothing runs at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lib = None
_lock = threading.Lock()


def sources() -> list[str]:
    """The ``.cu`` files the library is built from, sorted."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


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


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of any that
    fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)} -> {proc.returncode}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in sources()]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                  for src, obj in zip(sources(), objs)])
        tmp = f"{so}.{tag}.tmp"
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, so)  # atomic: concurrent builds agree
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


def _declare(lib: ctypes.CDLL) -> None:
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.dfft_fft_rows.argtypes = [p, p, ll, i, i, ip, i, p, f, p]
    lib.dfft_fft_rows_direct.argtypes = [p, p, p, ll, i, i, i, p, p, p, f, p]
    two_pass = [i, i, ip, i, i, ip, i, p, p, p, f, p]
    lib.dfft_fft_rows_2p.argtypes = [p, p, p, ll] + two_pass
    lib.dfft_fft_strided_2p.argtypes = [p, p, p, ll, ll] + two_pass
    lib.dfft_fft_strided.argtypes = [p, p, ll, ll, i, i, ip, i, p, f, p]
    lib.dfft_fft_strided_direct.argtypes = [p, p, p, ll, ll, i, i, i, p, p,
                                            p, f, p]
    lib.dfft_fft_plane.argtypes = [p, p, ll, i, i, ip, i, i, ip, i, p, p, ll,
                                   f, p]
    lib.dfft_fft_plane_direct.argtypes = ([p, p, p, ll] + [i] * 8 + [p] * 6
                                          + [f, p])
    lib.dfft_fft_encode.argtypes = [p, p, p, p, p, ll, ll, i, i, ip, i, i,
                                    f, i, p, f, p]
    lib.dfft_fft_encode_direct.argtypes = ([p] * 6 + [ll, ll] + [i] * 5
                                           + [f, p, p, p, f, p])
    lib.dfft_decode_fft.argtypes = [p, p, p, ll, ll, i, i, ip, i, i, i, p,
                                    f, p]
    lib.dfft_decode_fft_direct.argtypes = ([p] * 4 + [ll, ll] + [i] * 5
                                           + [p, p, p, f, p])
    for fn in (lib.dfft_fft_rows, lib.dfft_fft_rows_direct,
               lib.dfft_fft_rows_2p, lib.dfft_fft_strided,
               lib.dfft_fft_strided_direct, lib.dfft_fft_strided_2p,
               lib.dfft_fft_plane, lib.dfft_fft_plane_direct,
               lib.dfft_fft_encode, lib.dfft_fft_encode_direct,
               lib.dfft_decode_fft,
               lib.dfft_decode_fft_direct):
        fn.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = os.path.join(BUILD_DIR, f"libdfft_kernels_{_digest()}.so")
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        _declare(lib)
        _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` a launcher returned."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
