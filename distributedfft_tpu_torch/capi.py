"""Transform-time C API bridge: the ``heffte_c`` surface for C callers.

heFFTe exposes its C++ transforms to C (and through it, Fortran) by
opaque plan handles and typed execute calls (``heffte_c.h:52-179``). The
port's transforms are PyTorch plans on the card, so the bridge runs the
other way round: :func:`install_c_api` registers ctypes trampolines into
the function-pointer table of the port's host library
(``csrc/dfft_native.cpp``, built by :mod:`.native`), after which any
C/C++/Fortran code in a Python-hosted process can call the plain C ABI

.. code-block:: c

    long long dfft_plan_c2c_3d(long long nx, ny, nz, int direction);
    int       dfft_execute_c2c(long long plan, const float* in, float* out);
    void      dfft_destroy_plan_c(long long plan);

with interleaved complex64 buffers (C-order, the whole world per call),
and the typed surface (``dfft_c_api_install_typed``):

.. code-block:: c

    long long dfft_plan_r2c_3d(nx, ny, nz, direction, r2c_axis);
    int       dfft_execute_r2c / dfft_execute_c2r(plan, float*, float*);
    long long dfft_plan_z2z_3d(nx, ny, nz, direction);       /* double */
    int       dfft_execute_z2z(plan, double*, double*);
    long long dfft_plan_d2z_3d(nx, ny, nz, direction, axis); /* double r2c */
    int       dfft_execute_d2z / dfft_execute_z2d(plan, double*, double*);
    int       dfft_upload(plan, const void*);   /* plan-resident buffers */
    int       dfft_execute_resident(plan);
    int       dfft_download(plan, void*);

The ABI, its kind and op codes and its return codes are the JAX
package's (``distributedfft_tpu/capi.py``): -1 for bad arguments or a
failed plan, 1 when no bridge is installed, 2 for an unknown plan, 3 when
the Python side raised, 4 for a run before an upload, 5 for a download
before a run, 6 for an unknown op.

The device work is the port's. The float plans run the ``cuda`` executor,
so C callers launch the hand-written kernels. An input buffer is taken as
a numpy view of the caller's pointer and copied once to the plan's
device (``torch.from_numpy(view).to(device)``); an output is copied from
the device straight into the caller's buffer
(``torch.from_numpy(view).copy_(y)``). Double buffers go through the dd
tier (:func:`.ops.ddfft.dd_from_host` / :func:`~.ops.ddfft.dd_to_host`
and the ``plan_dd_*`` planners). The resident ops keep the input and
output on the device between calls, so a C driver can repeat a
transform without moving the world each way per call
(``fftSpeed3d_c2c.cpp:94-98``); ``dfft_execute_resident`` returns once
the plan's last launch has finished, so a C timer around it measures the
device's work. Destroying a plan drops its entry, its resident tensors
and its place in the plan cache (:func:`.api.destroy_plan`).

Single-process scope: the C caller holds the whole world, so the plans
run on one device or a loopback world; a process-group world is refused
(the JAX bridge is single-controller too).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import native as _native

__all__ = ["install_c_api", "c_api_installed", "c_selftest",
           "c_selftest_r2c", "c_selftest_z2z", "c_selftest_resident"]

_lock = threading.Lock()
_installed = False
# The CFUNCTYPE objects must outlive every C call: a ctypes callback is
# freed with its Python wrapper, and a dangling pointer in the library's
# table would crash the next C caller.
_keepalive: list = []
# plan id -> _Entry, shared by the v1 (c2c) and typed surfaces, so one
# destroy entry point serves every plan kind.
_plans: dict[int, "_Entry"] = {}
_next_id = 0

_PLAN_FN = ctypes.CFUNCTYPE(
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int)
_EXEC_FN = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_float),
    ctypes.POINTER(ctypes.c_float))
_DESTROY_FN = ctypes.CFUNCTYPE(None, ctypes.c_longlong)
# Typed surface: plan2(kind, nx, ny, nz, direction, axis) and
# exec2(plan, op, in, out); the codes are the library's dispatch table's.
_PLAN2_FN = ctypes.CFUNCTYPE(
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int)
_EXEC2_FN = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p)

_KIND_C2C_F, _KIND_R2C_F, _KIND_C2C_D, _KIND_R2C_D = 0, 1, 2, 3
_OP_EXEC, _OP_UPLOAD, _OP_RUN, _OP_DOWNLOAD = 0, 1, 2, 3
_DD_KINDS = (_KIND_C2C_D, _KIND_R2C_D)


class _Entry:
    """One C-created plan: the plan, its host buffers' geometry, and the
    resident device buffers once used."""

    __slots__ = ("plan", "kind", "in_shape", "out_shape", "in_np",
                 "out_np", "resident_in", "resident_out")

    def __init__(self, plan, kind, in_shape, out_shape, in_np, out_np):
        self.plan = plan
        self.kind = kind
        self.in_shape = in_shape    # host logical shape of the input
        self.out_shape = out_shape  # host logical shape of the output
        self.in_np = in_np          # host numpy dtype of the input
        self.out_np = out_np        # host numpy dtype of the output
        self.resident_in = None
        self.resident_out = None


def _host_view(ptr, shape, np_dtype) -> np.ndarray:
    """A C buffer as the numpy array its side declares (interleaved re/im
    floats or doubles for complex), without a copy."""
    n = int(np.prod(shape))
    complex_ = np.issubdtype(np_dtype, np.complexfloating)
    base = (ctypes.c_float if np_dtype in (np.complex64, np.float32)
            else ctypes.c_double)
    buf = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(base)),
                                shape=(2 * n if complex_ else n,))
    return (buf.view(np_dtype) if complex_ else buf).reshape(shape)


def _half(shape, axis):
    s = list(shape)
    s[axis] = s[axis] // 2 + 1
    return tuple(s)


def install_c_api(world=None, device=None) -> bool:
    """Install the transform bridge into the port's host library.

    ``world`` is what every C-created plan runs on: None for one device,
    an int or a ``(rows, cols)`` tuple for a loopback world, or a
    loopback :class:`~.parallel.mesh.World`; a process-group world
    raises ``ValueError``. ``device`` goes through
    :func:`.api.resolve_device`: the card unless the caller names
    another (``device="cpu"``); without a card it raises. Returns False
    when the library is unavailable (no ``g++``), True once C callers
    can use the ABI. Idempotent; a second call re-points the plans'
    world and device. The library's callback slots are atomics, so a
    reinstall is never seen torn, but a C thread inside
    ``dfft_execute_*`` during a reinstall may run the old bridge once
    more: quiesce C-side executes before switching."""
    global _installed
    from . import api as _api
    from .ops import ddfft as _dd
    from .parallel.mesh import World
    from .utils.timing import sync

    if isinstance(world, World) and not world.loopback:
        raise ValueError(
            "install_c_api: a C caller holds the whole world in one "
            "process; a process-group world is not supported (use a "
            "loopback World, an int or a (rows, cols) tuple)")
    dev = _api.resolve_device(device)
    lib = _native._load()
    if lib is None:
        return False

    def _make_entry(kind, shape, direction, axis):
        """The plan and host geometry of one C plan request."""
        fwd = direction == _api.FORWARD
        if kind == _KIND_C2C_F:
            p = _api.plan_dft_c2c_3d(shape, world, direction=direction,
                                     device=dev)
            return _Entry(p, kind, shape, shape, np.complex64, np.complex64)
        if kind == _KIND_R2C_F:
            h = _half(shape, axis)
            if fwd:
                p = _api.plan_dft_r2c_3d(shape, world, r2c_axis=axis,
                                         device=dev)
                return _Entry(p, kind, shape, h, np.float32, np.complex64)
            p = _api.plan_dft_c2r_3d(shape, world, r2c_axis=axis, device=dev)
            return _Entry(p, kind, h, shape, np.complex64, np.float32)
        if kind == _KIND_C2C_D:
            p = _api.plan_dd_dft_c2c_3d(shape, world, direction=direction,
                                        device=dev)
            return _Entry(p, kind, shape, shape, np.complex128,
                          np.complex128)
        h = _half(shape, axis)
        if fwd:
            p = _api.plan_dd_dft_r2c_3d(shape, world, r2c_axis=axis,
                                        device=dev)
            return _Entry(p, kind, shape, h, np.float64, np.complex128)
        p = _api.plan_dd_dft_c2r_3d(shape, world, r2c_axis=axis, device=dev)
        return _Entry(p, kind, h, shape, np.complex128, np.float64)

    def _register(kind, nx, ny, nz, direction, axis):
        global _next_id
        if (min(nx, ny, nz) < 1 or direction not in (-1, 1)
                or axis not in (0, 1, 2) or not 0 <= kind <= 3):
            return -1
        try:
            entry = _make_entry(kind, (int(nx), int(ny), int(nz)),
                                int(direction), int(axis))
        except Exception:  # noqa: BLE001 -- a failed plan is rc -1 in C
            return -1
        with _lock:
            pid = _next_id
            _next_id += 1
            _plans[pid] = entry
        return pid

    def _to_device(entry, x):
        """Host array -> the plan's input on ``dev``: one copy, also
        where ``dev`` is the host (the plan never holds the caller's
        buffer)."""
        if entry.kind in _DD_KINDS:
            return _dd.dd_from_host(x, device=dev)
        return torch.from_numpy(x).to(dev, copy=True)

    def _run(entry, dev_in):
        if entry.kind in _DD_KINDS:
            return entry.plan(*dev_in)
        return entry.plan(dev_in)

    def _to_host(entry, y, out_ptr):
        view = _host_view(out_ptr, entry.out_shape, entry.out_np)
        if entry.kind in _DD_KINDS:
            view[...] = _dd.dd_to_host(*y)
        else:
            torch.from_numpy(view).copy_(y)

    @_PLAN_FN
    def _plan(nx, ny, nz, direction):
        return _register(_KIND_C2C_F, nx, ny, nz, direction, 2)

    @_EXEC_FN
    def _exec(pid, in_ptr, out_ptr):
        return _exec2(pid, _OP_EXEC, ctypes.cast(in_ptr, ctypes.c_void_p),
                      ctypes.cast(out_ptr, ctypes.c_void_p))

    @_PLAN2_FN
    def _plan2(kind, nx, ny, nz, direction, axis):
        return _register(kind, nx, ny, nz, direction, axis)

    @_EXEC2_FN
    def _exec2(pid, op, in_ptr, out_ptr):
        with _lock:
            entry = _plans.get(int(pid))
        if entry is None:
            return 2
        try:
            if op == _OP_EXEC:
                x = _host_view(in_ptr, entry.in_shape, entry.in_np)
                _to_host(entry, _run(entry, _to_device(entry, x)),
                         out_ptr)
            elif op == _OP_UPLOAD:
                x = _host_view(in_ptr, entry.in_shape, entry.in_np)
                entry.resident_in = _to_device(entry, x)
                # A new upload invalidates the previous run's output: a
                # download before the next run is rc 5, never stale data.
                entry.resident_out = None
            elif op == _OP_RUN:
                if entry.resident_in is None:
                    return 4
                entry.resident_out = _run(entry, entry.resident_in)
                sync(entry.resident_out)
            elif op == _OP_DOWNLOAD:
                if entry.resident_out is None:
                    return 5
                _to_host(entry, entry.resident_out, out_ptr)
            else:
                return 6
        except Exception:  # noqa: BLE001 -- the Python side raised: rc 3
            return 3
        return 0

    @_DESTROY_FN
    def _destroy(pid):
        with _lock:
            entry = _plans.pop(int(pid), None)
        if entry is not None:
            _api.destroy_plan(entry.plan)

    lib.dfft_c_api_install.argtypes = [_PLAN_FN, _EXEC_FN, _DESTROY_FN]
    lib.dfft_c_api_install_typed.argtypes = [_PLAN2_FN, _EXEC2_FN]
    with _lock:
        # Append, never replace, under the lock: a reinstall must not
        # drop the trampolines an in-flight C call may still be using.
        _keepalive.extend([_plan, _exec, _destroy, _plan2, _exec2])
        lib.dfft_c_api_install(_plan, _exec, _destroy)
        lib.dfft_c_api_install_typed(_plan2, _exec2)
        _installed = True
    return True


def c_api_installed() -> bool:
    lib = _native._load()
    if lib is None or not _installed:
        return False
    return bool(lib.dfft_c_api_ready())


def c_selftest(shape=(8, 6, 5)) -> float:
    """The library's C-driven round trip (plan, execute and destroy all
    issued from compiled C, ``dfft_c_selftest``). Returns the relative
    max error (negative: a failure)."""
    lib = _native._load()
    if lib is None:
        return -1.0
    lib.dfft_c_selftest.restype = ctypes.c_double
    lib.dfft_c_selftest.argtypes = [ctypes.c_longlong] * 3
    return float(lib.dfft_c_selftest(*map(int, shape)))


def c_selftest_r2c(shape=(8, 6, 5), r2c_axis: int = 2) -> float:
    """C-driven r2c/c2r round trip through the typed ABI
    (``dfft_c_selftest_r2c``); negative: a failure."""
    lib = _native._load()
    if lib is None:
        return -1.0
    lib.dfft_c_selftest_r2c.restype = ctypes.c_double
    lib.dfft_c_selftest_r2c.argtypes = [ctypes.c_longlong] * 3 + [
        ctypes.c_int]
    return float(lib.dfft_c_selftest_r2c(*map(int, shape), int(r2c_axis)))


def c_selftest_z2z(shape=(8, 6, 5)) -> float:
    """C-driven double round trip (the dd tier) through the typed ABI
    (``dfft_c_selftest_z2z``); the 1e-11 tier from compiled C."""
    lib = _native._load()
    if lib is None:
        return -1.0
    lib.dfft_c_selftest_z2z.restype = ctypes.c_double
    lib.dfft_c_selftest_z2z.argtypes = [ctypes.c_longlong] * 3
    return float(lib.dfft_c_selftest_z2z(*map(int, shape)))


def c_selftest_resident(shape=(8, 6, 5), repeats: int = 3) -> float:
    """C-driven resident lifecycle: upload once, run ``repeats`` times on
    the device, download once, then the inverse likewise; the round
    trip's error (``dfft_c_selftest_resident``); negative: a failure."""
    lib = _native._load()
    if lib is None:
        return -1.0
    lib.dfft_c_selftest_resident.restype = ctypes.c_double
    lib.dfft_c_selftest_resident.argtypes = [ctypes.c_longlong] * 3 + [
        ctypes.c_int]
    return float(lib.dfft_c_selftest_resident(*map(int, shape),
                                              int(repeats)))
