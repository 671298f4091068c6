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
import re
import shutil
import subprocess
import tempfile
import threading
import time

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


#: Wall seconds of each command of the last build, by source file name
#: (each nvcc from the start of all of them to its own end).
BUILD_SECONDS: dict[str, float] = {}


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel and return their outputs; raise with
    the output of any that fails. Each command's wall seconds go into
    :data:`BUILD_SECONDS` under the name of its last argument."""
    BUILD_SECONDS.clear()
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"{i}.log"), "w+")
                for i in range(len(cmds))]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, stdout=log, stderr=subprocess.STDOUT,
                                  text=True) for c, log in zip(cmds, logs)]
        pending = set(range(len(cmds)))
        while pending:
            for i in list(pending):
                if procs[i].poll() is not None:
                    BUILD_SECONDS[os.path.basename(cmds[i][-1])] = round(
                        time.perf_counter() - t0, 1)
                    pending.discard(i)
            time.sleep(0.05)
        outs, errors = [], []
        for cmd, proc, log in zip(cmds, procs, logs):
            log.seek(0)
            out = log.read()
            log.close()
            outs.append(out)
            if proc.returncode != 0:
                errors.append(f"{' '.join(cmd)} -> {proc.returncode}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return outs


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in sources()]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                  for src, obj in zip(sources(), objs)])
        units = dict(BUILD_SECONDS)
        tmp = f"{so}.{tag}.tmp"
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        BUILD_SECONDS.clear()
        BUILD_SECONDS.update(units)
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
    two_pass = [i, i, ip, i, i, ip, i, p, p, p, f, p]
    lib.dfft_fft_rows_2p.argtypes = [p, p, p, ll] + two_pass
    lib.dfft_fft_strided_2p.argtypes = [p, p, p, ll, ll] + two_pass
    lib.dfft_fft_strided.argtypes = [p, p, ll, ll, i, i, ip, i, p, f, p]
    lib.dfft_fft_plane.argtypes = [p, p, ll, i, i, ip, i, i, ip, i, p, p, ll,
                                   f, p]
    lib.dfft_fft_encode.argtypes = [p, p, p, p, p, ll, ll, i, i, ip, i, i,
                                    f, i, p, f, p]
    lib.dfft_fft_encode_2p.argtypes = [p] * 6 + [ll, ll, i, i, f] + two_pass
    lib.dfft_decode_fft.argtypes = [p, p, p, ll, ll, i, i, ip, i, i, i, p,
                                    f, p]
    lib.dfft_decode_fft_2p.argtypes = [p] * 4 + [ll, ll, i, i] + two_pass
    pp = ctypes.POINTER(ctypes.c_void_p)
    lib.dfft_fft_two_level.argtypes = [p, p, p, ll, i, ip, ip, ip, i, pp, pp,
                                       pp, ip, f, p]
    lib.dfft_r2c_rows.argtypes = [p, p, ll, i, i, ip, p, p, p]
    lib.dfft_c2r_rows.argtypes = [p, p, ll, i, i, ip, p, p, f, p]
    for fn in (lib.dfft_fft_rows, lib.dfft_fft_rows_2p, lib.dfft_fft_strided,
               lib.dfft_fft_strided_2p, lib.dfft_fft_plane,
               lib.dfft_fft_encode, lib.dfft_fft_encode_2p,
               lib.dfft_decode_fft, lib.dfft_decode_fft_2p,
               lib.dfft_fft_two_level, lib.dfft_r2c_rows,
               lib.dfft_c2r_rows):
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


def ptxas_usage(csrc: str = CSRC) -> dict[str, tuple[int, int, int]]:
    """(registers, spill-store bytes, spill-load bytes) of every kernel
    compiled from the ``.cu`` files under ``csrc``, as ``nvcc -Xptxas -v``
    reports them (one nvcc per source, all together), keyed by the
    demangled name with the anonymous namespace and ``fuse::`` dropped,
    so that a kernel keeps its key when it moves between translation
    units or namespaces. Needs ``nvcc``."""
    srcs = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    with tempfile.TemporaryDirectory() as tmp:
        outs = _run_all([[_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                          os.path.join(tmp, f"{i}.o"), src]
                         for i, src in enumerate(srcs)])
    usage, name = {}, None
    for line in "\n".join(outs).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            usage[name] = [0, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name in usage:
            usage[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in usage:
            usage[name][0] = int(m.group(1))
    names = list(usage)
    filt = shutil.which("cu++filt") or os.path.join(
        os.path.dirname(_nvcc()), "cu++filt")
    plain = subprocess.run([filt], input="\n".join(names), text=True,
                           capture_output=True, check=True).stdout.split("\n")
    drop = re.compile(r"\(anonymous namespace\)::|<unnamed>::|fuse::")
    return {drop.sub("", d.strip()): tuple(usage[n])
            for n, d in zip(names, plain)}


if __name__ == "__main__":
    # python -m distributedfft_tpu_torch.ops._build [OTHER_CSRC]: each
    # kernel's registers and spills, beside those of the same kernel
    # built from OTHER_CSRC (another tree's csrc/) when one is given.
    import sys

    mine = ptxas_usage()
    print(f"seconds per unit, all together: {BUILD_SECONDS}")
    other = {}
    if len(sys.argv) > 1:
        other = ptxas_usage(sys.argv[1])
        print(f"seconds per unit there: {BUILD_SECONDS}")
    same = 0
    for k in sorted(mine):
        theirs = other.get(k)
        same += theirs == mine[k]
        print(f"{mine[k]} {'' if theirs is None else theirs} {k}")
    if other:
        print(f"ptxas: {len(mine)} kernels here, {len(other)} there; "
              f"{same} with equal registers and spills; only there: "
              f"{sorted(set(other) - set(mine))}")
