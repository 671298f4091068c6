"""The host runtime library: ctypes bindings over ``csrc/dfft_native.cpp``.

The port's own copy of the JAX package's native side
(``distributedfft_tpu/native.py`` over ``native/dfft_native.cpp``): the
plan-time axis scheduler, the processor-grid searches, the uneven-slab
exchange tables, the C trace recorder, and the transform-time C ABI that
:mod:`.capi` installs its bridge into. The C++ source keeps the JAX
library's ABI (names, signatures, kind and op codes, version 3), so a C
or Fortran driver written against one links against the other.

The library is built at first use, never at import: ``g++ -O3
-std=c++17 -fPIC -shared -Wl,-Bsymbolic`` into
``distributedfft_tpu_torch/_build/`` (listed in ``.gitignore``), named by
the hash of the source, as :mod:`.ops._build` names the CUDA library. It
is the port's own: its callback slots and trace table are process-global
per loaded library, so a process that also loads the JAX package's
library keeps the two bridges apart, and ``-Bsymbolic`` keeps the
library's internal calls (``dfft_c_selftest`` -> ``dfft_plan_c2c_3d``)
inside it. A failed build makes :func:`is_available` false (the reason
in :func:`build_error`) and every function below falls back to its
pure-Python mirror, kept in lockstep (``tests/test_torch_native.py``).

The kernels' planning (``ops/cuda_fft.py``, ``ops/ddfft.py``,
``ops/dft_matmul.py``) calls :func:`balanced_split`, which is the Python
rule and loads nothing: no compiler is needed on the kernel path.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
SOURCE = os.path.join(CSRC, "dfft_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wl,-Bsymbolic")
FORTRAN_SOURCES = (os.path.join(CSRC, "dfft_fortran.f90"),
                   os.path.join(CSRC, "dfft_fortran_smoke.f90"))
FORTRAN_FLAGS = ("-O2", "-fPIC", "-shared")
#: The ABI version both libraries report (``dfft_abi_version``).
ABI_VERSION = 3

_lib = None
_tried = False
_error: str | None = None
_lock = threading.Lock()


def _digest(paths) -> str:
    h = hashlib.sha256()
    for path in paths:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    """Where the library of the current source is (or will be) built."""
    return os.path.join(BUILD_DIR, f"libdfft_native_{_digest([SOURCE])}.so")


def _compile(cmd: list[str], out: str) -> None:
    """Run one compiler command that writes ``out`` through a temporary
    name (atomic: concurrent builds agree); raise with its output."""
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run(cmd + ["-o", tmp], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} -> {proc.returncode}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build() -> str:
    """Build the library from ``csrc/dfft_native.cpp`` unless the build of
    this source exists; return its path. Raises when ``g++`` is missing
    or fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: distributedfft_tpu_torch builds "
                           "its host library from csrc/dfft_native.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    _compile([cxx, *CXX_FLAGS, f"-Wl,-soname,{os.path.basename(so)}",
              SOURCE], so)
    return so


def _declare(lib: ctypes.CDLL) -> None:
    ll = ctypes.c_longlong
    lp = ctypes.POINTER(ll)
    lib.dfft_abi_version.restype = ctypes.c_int
    lib.dfft_schedule_axis.restype = ctypes.c_int
    lib.dfft_schedule_axis.argtypes = [ll, ll, ctypes.c_int, lp]
    lib.dfft_procgrid2.argtypes = [ll, lp, lp]
    lib.dfft_min_surface_grid.argtypes = [ll, ll, ll, ll, lp]
    lib.dfft_pencil_grid.argtypes = [ll, ll, ll, ll, lp]
    lib.dfft_balanced_split.restype = ctypes.c_int
    lib.dfft_balanced_split.argtypes = [ll, ll, lp]
    lib.dfft_exchange_table.argtypes = [ll] * 5 + [lp] * 4
    lib.dfft_trace_begin.restype = ll
    lib.dfft_trace_begin.argtypes = [ctypes.c_char_p]
    lib.dfft_trace_end.argtypes = [ll]
    lib.dfft_trace_count.restype = ll
    lib.dfft_trace_dump.restype = ctypes.c_int
    lib.dfft_trace_dump.argtypes = [ctypes.c_char_p, ll, ll]
    lib.dfft_c_api_ready.restype = ctypes.c_int
    lib.dfft_c_api_typed_ready.restype = ctypes.c_int


def _load():
    """The loaded library, built on the first call; None when it cannot
    be built or loaded (:func:`build_error` says why)."""
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build())
            _declare(lib)
            version = lib.dfft_abi_version()
        except (OSError, RuntimeError, AttributeError,
                subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        if version != ABI_VERSION:
            _error = f"ABI version {version}, expected {ABI_VERSION}"
            return None
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the library is unavailable (None when it loaded or was not
    tried)."""
    return _error


# ------------------------------------------------------------- scheduler

def schedule_axis(
    n: int, max_factor: int = 256, max_passes: int = 4
) -> list[int] | None:
    """Split ``n`` into <= ``max_passes`` balanced factors each <=
    ``max_factor`` (descending), or None when impossible (a prime factor
    over the bound, or too many passes): the FFTScheduler decision
    (``templateFFT.cpp:3941-4100``)."""
    lib = _load()
    if lib is not None:
        out = (ctypes.c_longlong * max_passes)()
        r = lib.dfft_schedule_axis(n, max_factor, max_passes, out)
        return [int(v) for v in out[:r]] if r > 0 else None
    return _schedule_axis_py(n, max_factor, max_passes)


def _prime_factors(n: int) -> list[int]:
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    if n > 1:
        out.append(n)
    return out


def _schedule_axis_py(n: int, max_factor: int,
                      max_passes: int) -> list[int] | None:
    """Pure-Python mirror of ``dfft_schedule_axis``."""
    if n < 1 or max_factor < 2 or max_passes < 1:
        return None
    if n == 1:
        return [1]
    primes = _prime_factors(n)
    if max(primes) > max_factor:
        return None
    for passes in range(1, max_passes + 1):
        bins = [1] * passes
        ok = True
        for p in sorted(primes, reverse=True):
            fits = [b for b in range(passes) if bins[b] * p <= max_factor]
            if not fits:
                ok = False
                break
            bins[max(fits, key=lambda b: bins[b])] *= p
        if not ok:
            continue
        for _ in range(64):
            bins.sort(reverse=True)
            if bins[-1] == 1 and len(bins) > 1:
                bins.pop()
                continue
            moved = False
            for p in sorted(_prime_factors(bins[0])):
                big, small = bins[0] // p, bins[-1] * p
                if small <= max_factor and max(big, small) < bins[0]:
                    bins[0], bins[-1] = big, small
                    moved = True
                    break
            if not moved:
                break
        return sorted(bins, reverse=True)
    return None


# -------------------------------------------------------------- geometry

def procgrid2(p: int) -> tuple[int, int]:
    """The most-square 2D grid of ``p`` (``make_procgrid``)."""
    lib = _load()
    if lib is not None:
        a, b = ctypes.c_longlong(), ctypes.c_longlong()
        lib.dfft_procgrid2(p, ctypes.byref(a), ctypes.byref(b))
        return int(a.value), int(b.value)
    from .geometry import make_procgrid

    return make_procgrid(p)


def min_surface_grid(shape, p: int) -> tuple[int, int, int]:
    """The 3D grid of ``p`` minimising the boxes' surface
    (``proc_setup_min_surface``)."""
    lib = _load()
    if lib is not None:
        out = (ctypes.c_longlong * 3)()
        lib.dfft_min_surface_grid(shape[0], shape[1], shape[2], p, out)
        return int(out[0]), int(out[1]), int(out[2])
    from .geometry import proc_setup_min_surface, world_box

    return proc_setup_min_surface(world_box(tuple(shape)), p)


def pencil_grid(shape, p: int) -> tuple[int, int]:
    """Min-surface 2D pencil grid (rows over axis 0, cols over axis 1):
    the planner's default grid for pencils (the
    ``proc_setup_min_surface`` role, ``heffte_geometry.h:589-626``)."""
    lib = _load()
    if lib is not None:
        out = (ctypes.c_longlong * 2)()
        lib.dfft_pencil_grid(shape[0], shape[1], shape[2], p, out)
        return int(out[0]), int(out[1])
    from .geometry import pencil_grid_min_surface

    return pencil_grid_min_surface(shape, p)


def balanced_split(n: int, max_factor: int) -> tuple[int, int] | None:
    """Balanced divisor pair (n1, n2), n1 <= n2 <= max_factor, n1 maximal,
    or None when there is none: the split rule of the four-step kernels
    and the matmul recursion. The Python rule, which loads nothing; the
    library's ``dfft_balanced_split`` is :func:`balanced_split_native`."""
    return _balanced_split_py(n, max_factor)


def balanced_split_native(n: int, max_factor: int) -> tuple[int, int] | None:
    """:func:`balanced_split` through ``dfft_balanced_split`` (the mirror
    when the library is unavailable)."""
    lib = _load()
    if lib is not None:
        out = (ctypes.c_longlong * 2)()
        r = lib.dfft_balanced_split(n, max_factor, out)
        return (int(out[0]), int(out[1])) if r == 0 else None
    return _balanced_split_py(n, max_factor)


def _balanced_split_py(n: int, max_factor: int) -> tuple[int, int] | None:
    """Pure-Python mirror of ``dfft_balanced_split``."""
    for d in range(math.isqrt(n), 1, -1):
        if n % d == 0:
            n1, n2 = d, n // d
            return (n1, n2) if n2 <= max_factor else None
    return None


# -------------------------------------------------------- exchange tables

def exchange_table(n0: int, n1: int, n2: int, p: int, rank: int):
    """Per-peer (send_counts, send_offsets, recv_counts, recv_offsets) of
    the uneven X-slab -> Y-slab redistribution (``fft_mpi_3d_api.cpp:
    84-133`` TransInfo semantics; element counts, not bytes)."""
    lib = _load()
    if lib is not None:
        arrs = [(ctypes.c_longlong * p)() for _ in range(4)]
        lib.dfft_exchange_table(n0, n1, n2, p, rank, *arrs)
        return tuple([int(v) for v in a] for a in arrs)
    return _exchange_table_py(n0, n1, n2, p, rank)


def _exchange_table_py(n0: int, n1: int, n2: int, p: int, rank: int):
    """Pure-Python mirror of ``dfft_exchange_table``."""
    c0, c1 = -(-n0 // p), -(-n1 // p)

    def owned(n, c, r):
        return max(0, min(n, (r + 1) * c) - min(n, r * c))

    my_rows, my_cols = owned(n0, c0, rank), owned(n1, c1, rank)
    sc = [my_rows * owned(n1, c1, j) * n2 for j in range(p)]
    rc = [owned(n0, c0, j) * my_cols * n2 for j in range(p)]

    def off(cs):
        return [sum(cs[:j]) for j in range(p)]

    return sc, off(sc), rc, off(rc)


# ----------------------------------------------------------------- trace

class NativeTrace:
    """The C trace recorder (``dfft_trace_*``); every call is a no-op
    when the library is unavailable, so callers use it unconditionally."""

    def __init__(self) -> None:
        self._lib = _load()

    @property
    def available(self) -> bool:
        return self._lib is not None

    def init(self) -> None:
        if self._lib is not None:
            self._lib.dfft_trace_init()

    def begin(self, name: str) -> int:
        if self._lib is None:
            return -1
        return int(self._lib.dfft_trace_begin(name.encode()))

    def end(self, event_id: int) -> None:
        if self._lib is not None:
            self._lib.dfft_trace_end(event_id)

    def count(self) -> int:
        return 0 if self._lib is None else int(self._lib.dfft_trace_count())

    def dump(self, path: str, process: int = 0, nprocs: int = 1) -> bool:
        if self._lib is None:
            return False
        return self._lib.dfft_trace_dump(path.encode(), process, nprocs) == 0


# --------------------------------------------------------------- Fortran

def fortran_library_path() -> str:
    """Where :func:`build_fortran` puts the Fortran binding and smoke."""
    return os.path.join(BUILD_DIR, "libdfft_fortran_"
                        f"{_digest([SOURCE, *FORTRAN_SOURCES])}.so")


def build_fortran() -> str:
    """Compile ``csrc/dfft_fortran.f90`` and ``dfft_fortran_smoke.f90``
    into a shared library linked against this package's host library
    (built first), found beside it at run time; return its path. Raises
    when ``gfortran`` is missing or fails."""
    fc = shutil.which("gfortran")
    if fc is None:
        raise RuntimeError("gfortran not found: the Fortran binding "
                           "compiles only where a Fortran compiler is")
    so = fortran_library_path()
    if os.path.exists(so):
        return so
    native = build()
    mod_dir = os.path.join(BUILD_DIR, f"fmod_{os.getpid()}")
    os.makedirs(mod_dir, exist_ok=True)
    try:
        _compile([fc, *FORTRAN_FLAGS, f"-J{mod_dir}", *FORTRAN_SOURCES,
                  f"-L{BUILD_DIR}", f"-l:{os.path.basename(native)}",
                  "-Wl,-rpath,$ORIGIN"], so)
    finally:
        shutil.rmtree(mod_dir, ignore_errors=True)
    return so
