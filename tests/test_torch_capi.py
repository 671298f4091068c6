"""The port's C ABI (``distributedfft_tpu_torch/capi.py`` over its own
host library) against the JAX package's bridge (``distributedfft_tpu/
capi.py`` over ``native/libdfft_native.so``), both installed in this
process and driven through ctypes as a C caller would.

- every plan kind, direction and ``r2c_axis`` (c2c, r2c/c2r, z2z,
  d2z/z2d) on one device at (8, 6, 5) and (7, 10, 6): complex64 within
  5e-4, the dd tier within 1e-11, each also against numpy (the loopback
  worlds: ``tests/test_torch_capi_worlds.py``);
- every return code equal to JAX's; the four selftests from compiled C;
- the two bridges stay apart in one process;
- ``install_c_api()`` without a card raises, a process-group world is
  refused.
"""

import ctypes
import gc
import weakref

import numpy as np
import pytest
import torch

import distributedfft_tpu as jdfft
from distributedfft_tpu import capi as jcapi
from distributedfft_tpu import native as jnative
from distributedfft_tpu_torch import api as tapi
from distributedfft_tpu_torch import capi as tcapi
from distributedfft_tpu_torch import native as tnative
from distributedfft_tpu_torch.parallel.mesh import World, make_world

pytestmark = pytest.mark.skipif(
    not (tnative.is_available() and jnative.is_available()),
    reason="a host library did not build (g++ missing)")

TOL, TOL_DD = 5e-4, 1e-11
LL, VP = ctypes.c_longlong, ctypes.c_void_p
SHAPES = [(8, 6, 5), (7, 10, 6)]
#: (kind, direction, r2c_axis)
CASES = ([("c2c", d, 2) for d in (-1, 1)]
         + [("r2c", d, a) for d in (-1, 1) for a in (0, 1, 2)]
         + [("z2z", d, 2) for d in (-1, 1)]
         + [("d2z", d, a) for d in (-1, 1) for a in (0, 1, 2)])


def _fn(lib, name, restype, argtypes):
    """A fresh function object (``lib[name]``), so these bindings never
    touch the ones the packages' own code and tests set."""
    fn = lib[name]
    fn.restype, fn.argtypes = restype, argtypes
    return fn


class _C:
    """The C entry points of one library, as a C caller sees them."""

    def __init__(self, lib):
        i = ctypes.c_int
        self.plan = {
            "c2c": _fn(lib, "dfft_plan_c2c_3d", LL, [LL] * 3 + [i]),
            "r2c": _fn(lib, "dfft_plan_r2c_3d", LL, [LL] * 3 + [i, i]),
            "z2z": _fn(lib, "dfft_plan_z2z_3d", LL, [LL] * 3 + [i]),
            "d2z": _fn(lib, "dfft_plan_d2z_3d", LL, [LL] * 3 + [i, i]),
        }
        ex = {n: _fn(lib, f"dfft_execute_{n}", i, [LL, VP, VP])
              for n in ("c2c", "r2c", "c2r", "z2z", "d2z", "z2d")}
        self.execute = {("c2c", -1): ex["c2c"], ("c2c", 1): ex["c2c"],
                        ("r2c", -1): ex["r2c"], ("r2c", 1): ex["c2r"],
                        ("z2z", -1): ex["z2z"], ("z2z", 1): ex["z2z"],
                        ("d2z", -1): ex["d2z"], ("d2z", 1): ex["z2d"]}
        self.upload = _fn(lib, "dfft_upload", i, [LL, VP])
        self.run = _fn(lib, "dfft_execute_resident", i, [LL])
        self.download = _fn(lib, "dfft_download", i, [LL, VP])
        self.destroy = _fn(lib, "dfft_destroy_plan_c", None, [LL])
        self.ready = _fn(lib, "dfft_c_api_ready", i, [])
        self.install = _fn(lib, "dfft_c_api_install", None, [VP] * 3)
        self.install_typed = _fn(lib, "dfft_c_api_install_typed", None,
                                 [VP] * 2)

    def make_plan(self, kind, shape, direction, axis):
        args = (*shape, direction) + ((axis,) if kind in ("r2c", "d2z")
                                      else ())
        return self.plan[kind](*args)


PORT = _C(tnative._load()) if tnative.is_available() else None
JAX = _C(jnative._load()) if jnative.is_available() else None


def _half(shape, axis):
    s = list(shape)
    s[axis] = s[axis] // 2 + 1
    return tuple(s)


def _io(kind, shape, direction, axis, seed=4242):
    """(input, empty output, numpy reference) of one case: seeded
    standard-normal data; an inverse real case takes a true half
    spectrum (the rfftn of a seeded real field)."""
    rng = np.random.default_rng(seed)
    double = kind in ("z2z", "d2z")
    cdt, rdt = ((np.complex128, np.float64) if double
                else (np.complex64, np.float32))
    axes = [a for a in range(3) if a != axis] + [axis]
    if kind in ("c2c", "z2z"):
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(cdt)
        ref = np.fft.fftn(x) if direction == -1 else np.fft.ifftn(x)
        return x, np.zeros(shape, cdt), ref
    real = rng.standard_normal(shape)
    if direction == -1:
        x = real.astype(rdt)
        return x, np.zeros(_half(shape, axis), cdt), np.fft.rfftn(
            x.astype(np.float64), axes=axes)
    x = np.fft.rfftn(real, axes=axes).astype(cdt)
    return x, np.zeros(shape, rdt), np.fft.irfftn(
        x.astype(np.complex128), s=[shape[a] for a in axes], axes=axes)


def _drive(c, kind, shape, direction, axis, x, out):
    """Plan, execute and destroy through one library; the rc pair."""
    pid = c.make_plan(kind, shape, direction, axis)
    if pid < 0:
        return pid, None
    rc = c.execute[(kind, direction)](pid, x.ctypes.data, out.ctypes.data)
    c.destroy(pid)
    return pid, rc


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _install(world):
    jmesh = (None if world is None else jdfft.make_mesh(world))
    assert jcapi.install_c_api(mesh=jmesh)
    assert tcapi.install_c_api(world, device="cpu")


@pytest.fixture(autouse=True)
def _single_bridges():
    """Both bridges on one device around every test."""
    _install(None)
    yield
    _install(None)


def _check_case(kind, shape, direction, axis, world):
    _install(world)
    x, out_t, ref = _io(kind, shape, direction, axis)
    out_j = np.zeros_like(out_t)
    pid, rc = _drive(PORT, kind, shape, direction, axis, x, out_t)
    assert pid >= 0 and rc == 0, (pid, rc)
    pid, rc = _drive(JAX, kind, shape, direction, axis, x, out_j)
    assert pid >= 0 and rc == 0, (pid, rc)
    tol = TOL_DD if kind in ("z2z", "d2z") else TOL
    assert _rel(out_t, out_j) <= tol
    assert _rel(out_t, ref) <= tol
    assert _rel(out_j, ref) <= tol


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind,direction,axis", CASES)
def test_execute_matches_jax_single(kind, direction, axis, shape):
    _check_case(kind, shape, direction, axis, None)


@pytest.mark.parametrize("world", [None, 4, (2, 2), make_world(4)])
def test_resident_matches_jax(world):
    """upload / execute_resident / download of a c2c and a z2z plan: the
    output of a direct execute, and JAX's."""
    _install(world if not isinstance(world, World) else 4)
    tcapi.install_c_api(world, device="cpu")
    for kind in ("c2c", "z2z"):
        shape = (8, 6, 5)
        x, _, ref = _io(kind, shape, -1, 2, seed=7)
        outs = []
        for c in (PORT, JAX):
            out = np.zeros_like(x)
            pid = c.make_plan(kind, shape, -1, 2)
            assert c.upload(pid, x.ctypes.data) == 0
            for _ in range(3):
                assert c.run(pid) == 0
            assert c.download(pid, out.ctypes.data) == 0
            c.destroy(pid)
            outs.append(out)
        tol = TOL_DD if kind == "z2z" else TOL
        assert _rel(outs[0], outs[1]) <= tol and _rel(outs[0], ref) <= tol


def _codes(c, capi_mod):
    """Every return code of the ABI, in one fixed script."""
    x = np.arange(2 * 64, dtype=np.float32)
    out = np.zeros_like(x)
    got = {}
    got["plan zero extent"] = c.make_plan("c2c", (0, 4, 4), -1, 2)
    got["plan bad direction"] = c.make_plan("c2c", (4, 4, 4), 0, 2)
    got["plan bad axis"] = c.make_plan("r2c", (4, 4, 4), -1, 3)
    got["plan d2z bad axis"] = c.make_plan("d2z", (4, 4, 4), 1, -1)
    got["execute unknown plan"] = c.execute[("c2c", -1)](
        10 ** 9, x.ctypes.data, out.ctypes.data)
    pid = c.make_plan("c2c", (4, 4, 4), -1, 2)
    got["plan"] = int(pid >= 0)
    got["download before any run"] = c.download(pid, out.ctypes.data)
    got["run before upload"] = c.run(pid)
    got["upload"] = c.upload(pid, x.ctypes.data)
    got["download before the run"] = c.download(pid, out.ctypes.data)
    got["run"] = c.run(pid)
    got["download"] = c.download(pid, out.ctypes.data)
    got["upload again"] = c.upload(pid, x.ctypes.data)
    got["download after the new upload"] = c.download(pid, out.ctypes.data)
    got["execute with a NULL input"] = c.execute[("c2c", -1)](
        pid, None, out.ctypes.data)
    got["unknown op"] = capi_mod._keepalive[-1](pid, 9, None, None)
    c.destroy(pid)
    got["execute a destroyed plan"] = c.execute[("c2c", -1)](
        pid, x.ctypes.data, out.ctypes.data)
    got["run a destroyed plan"] = c.run(pid)
    c.destroy(pid)                  # twice: a no-op
    c.install(None, None, None)
    c.install_typed(None, None)
    got["ready uninstalled"] = c.ready()
    got["plan uninstalled"] = c.make_plan("c2c", (4, 4, 4), -1, 2)
    got["typed plan uninstalled"] = c.make_plan("z2z", (4, 4, 4), -1, 2)
    got["execute uninstalled"] = c.execute[("c2c", -1)](
        0, x.ctypes.data, out.ctypes.data)
    got["run uninstalled"] = c.run(0)
    return got


def test_return_codes_match_jax():
    port = _codes(PORT, tcapi)
    assert tcapi.c_selftest() == -1.0 and not tcapi.c_api_installed()
    jax_ = _codes(JAX, jcapi)
    _install(None)
    assert port == jax_
    assert port["plan"] == 1 and port["run"] == port["download"] == 0
    assert {port[k] for k in ("plan zero extent", "plan bad direction",
                              "plan bad axis", "plan uninstalled")} == {-1}
    assert (port["execute unknown plan"], port["execute a destroyed plan"],
            port["execute with a NULL input"], port["run before upload"],
            port["download before the run"], port["unknown op"],
            port["execute uninstalled"]) == (2, 2, 3, 4, 5, 6, 1)


@pytest.mark.parametrize("world,shape", [(None, (8, 6, 5)),
                                         (4, (16, 8, 8)),
                                         ((2, 2), (16, 8, 8)),
                                         (None, (7, 10, 6))])
def test_selftests_from_compiled_c(world, shape):
    tcapi.install_c_api(world, device="cpu")
    assert tcapi.c_api_installed()
    assert 0 <= tcapi.c_selftest(shape) < TOL
    for axis in (0, 1, 2):
        assert 0 <= tcapi.c_selftest_r2c(shape, r2c_axis=axis) < TOL
    assert 0 <= tcapi.c_selftest_z2z(shape) < TOL_DD
    assert 0 <= tcapi.c_selftest_resident(shape, repeats=4) < TOL


def test_bridges_stay_apart():
    """Each library's plan calls reach only its own package's registry,
    its selftests included (-Bsymbolic and one library each)."""
    t0, j0 = dict(tcapi._plans), dict(jcapi._plans)
    tid, jid = tcapi._next_id, jcapi._next_id
    pid = PORT.make_plan("c2c", (4, 4, 4), -1, 2)
    assert set(tcapi._plans) - set(t0) == {pid}
    assert jcapi._plans == j0 and jcapi._next_id == jid
    assert isinstance(tcapi._plans[pid].plan, tapi.Plan3D)
    assert tcapi._plans[pid].plan.executor == "cuda"
    qid = JAX.make_plan("c2c", (4, 4, 4), -1, 2)
    assert set(jcapi._plans) - set(j0) == {qid}
    assert set(tcapi._plans) - set(t0) == {pid}
    PORT.destroy(qid if qid != pid else -5)
    assert qid in jcapi._plans
    PORT.destroy(pid)
    JAX.destroy(qid)
    assert tcapi._plans == t0 and jcapi._plans == j0
    jnext = jcapi._next_id
    assert 0 <= tcapi.c_selftest((4, 4, 4)) < TOL
    assert tcapi._next_id == tid + 3 and jcapi._next_id == jnext
    assert 0 <= jcapi.c_selftest((4, 4, 4)) < TOL
    assert tcapi._next_id == tid + 3 and jcapi._next_id == jnext + 2


def test_resident_input_is_a_copy_and_destroy_drops_everything():
    shape = (4, 6, 5)
    x, _, ref = _io("c2c", shape, -1, 2, seed=3)
    keep = x.copy()
    out = np.zeros_like(x)
    pid = PORT.make_plan("c2c", shape, -1, 2)
    entry = tcapi._plans[pid]
    assert PORT.upload(pid, x.ctypes.data) == 0
    x[...] = 0                      # the caller reuses its buffer
    assert PORT.run(pid) == 0
    assert PORT.download(pid, out.ctypes.data) == 0
    assert _rel(out, np.fft.fftn(keep)) <= TOL
    plan = weakref.ref(entry.plan)
    resident = weakref.ref(entry.resident_out)
    assert any(v is entry.plan for v in tapi._PLAN_CACHE.values())
    del entry
    PORT.destroy(pid)
    gc.collect()
    assert pid not in tcapi._plans
    assert plan() is None and resident() is None


def test_dd_entries_run_the_dd_planners():
    pid = PORT.make_plan("d2z", (8, 6, 5), -1, 1)
    entry = tcapi._plans[pid]
    assert isinstance(entry.plan, tapi.DDPlan3D)
    assert (entry.in_shape, entry.out_shape) == ((8, 6, 5), (8, 4, 5))
    assert (entry.in_np, entry.out_np) == (np.float64, np.complex128)
    PORT.destroy(pid)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_install_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcapi.install_c_api()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcapi.install_c_api(4, device="cuda")


def test_process_group_world_is_refused():
    with pytest.raises(ValueError, match="process-group world"):
        tcapi.install_c_api(World(2, rank=0), device="cpu")
    with pytest.raises(ValueError, match="process-group world"):
        tcapi.install_c_api(World(4, rank=1, grid=(2, 2)), device="cpu")


def test_install_is_idempotent_and_keeps_its_trampolines():
    n = len(tcapi._keepalive)
    assert tcapi.install_c_api(4, device="cpu")
    assert tcapi.install_c_api(4, device="cpu")
    assert len(tcapi._keepalive) == n + 10
    assert tcapi.c_api_installed()
    pid = PORT.make_plan("c2c", (8, 4, 4), -1, 2)
    assert tcapi._plans[pid].plan.decomposition == "slab"
    PORT.destroy(pid)


def test_unavailable_library_installs_nothing(monkeypatch):
    monkeypatch.setattr(tnative, "_load", lambda: None)
    assert tcapi.install_c_api(device="cpu") is False
    assert tcapi.c_selftest() == -1.0
    assert tcapi.c_selftest_r2c() == tcapi.c_selftest_z2z() == -1.0
    assert tcapi.c_selftest_resident() == -1.0
    assert not tcapi.c_api_installed()


def _edge_values(kind):
    rng = np.random.default_rng(11)
    if kind == "real":
        return np.concatenate([
            rng.standard_normal(64) * 10.0 ** rng.integers(-300, 300, 64),
            [1e-320, 3.4e38, 3.5e38, -np.inf, np.nan, 1.0 + 2 ** -30]])
    z = ((rng.standard_normal(32) + 1j * rng.standard_normal(32))
         * 10.0 ** rng.integers(-40, 40, 32))
    return np.concatenate([z, [complex(np.inf, 1.0),
                               complex(3.5e38, np.nan),
                               complex(-1e-320, 3.4e38)]])


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_dd_host_conversions_keep_the_host_split(kind):
    """The bridge's double buffers go through ``dd_from_host`` (split on
    the plan's device) and ``dd_to_host`` (summed there): the bits of
    JAX's host split and sum, NaN and infinity included."""
    from distributedfft_tpu.ops import ddfft as jdd
    from distributedfft_tpu_torch.ops import ddfft as tdd

    x = _edge_values(kind)
    with np.errstate(all="ignore"):
        jh, jl = (np.asarray(a) for a in jdd.dd_from_host(x))
        want = jdd.dd_to_host(jh, jl)
    th, tl = tdd.dd_from_host(x, device="cpu")
    assert th.numpy().tobytes() == jh.tobytes()
    assert tl.numpy().tobytes() == jl.tobytes()
    assert tdd.dd_to_host(th, tl).tobytes() == want.tobytes()
