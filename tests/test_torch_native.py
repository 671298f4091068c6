"""The port's host library (``distributedfft_tpu_torch/native.py`` over
``csrc/dfft_native.cpp``) against the JAX package's ``native.py``.

- every planning function of the library, its Python mirror and the JAX
  package's function agree on ``tests/test_native.py``'s inputs;
- the library is the port's own: built from ``csrc/`` into ``_build/``,
  named by the source's hash, never ``native/libdfft_native.so``; its
  exports are the JAX library's; ``ops/_build.py`` does not take it up;
- the kernels' ``balanced_split`` loads nothing; a failed build leaves
  the mirrors and ``is_available() == False``;
- the C trace recorder; ``capi``, ``native`` and ``utils.trace`` import
  no JAX.
"""

import os
import subprocess
import sys

import pytest

from distributedfft_tpu import native as jnative
from distributedfft_tpu_torch import geometry as tgeo
from distributedfft_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

requires_native = pytest.mark.skipif(
    not native.is_available(),
    reason=f"the port's host library did not build: {native.build_error()}")

SCHEDULE_NS = [1, 2, 12, 128, 512, 4096, 48828125, 2 ** 22, 3 ** 8,
               5 * 7 * 11 * 13, 8191, 2 ** 40, 65536]
PROCS = [1, 2, 3, 4, 6, 8, 12, 16, 30]
SURFACES = [((512, 512, 512), 8), ((1536, 1024, 768), 16),
            ((100, 200, 300), 12), ((8, 8, 8), 1), ((7, 10, 6), 6)]
SPLITS = [2, 4, 12, 97, 256, 510, 512, 4096, 8192, 9728, 65536, 2 ** 20,
          3 ** 10, 5 ** 11]
TABLES = [(512, 512, 4, 0), (100, 70, 8, 7), (7, 5, 4, 2), (16, 16, 16, 3),
          (9, 10, 3, 1)]


@requires_native
@pytest.mark.parametrize("n", SCHEDULE_NS)
def test_schedule_axis_matches_jax(n):
    for max_factor, max_passes in [(256, 4), (128, 2), (16, 4)]:
        got = native.schedule_axis(n, max_factor, max_passes)
        assert got == native._schedule_axis_py(n, max_factor, max_passes)
        assert got == jnative.schedule_axis(n, max_factor, max_passes)
        assert got == jnative._schedule_axis_py(n, max_factor, max_passes)
        if got is not None:
            prod = 1
            for f in got:
                assert f <= max_factor
                prod *= f
            assert prod == n


@requires_native
@pytest.mark.parametrize("p", PROCS)
def test_procgrid2_matches_jax(p):
    got = native.procgrid2(p)
    assert got == tgeo.make_procgrid(p) == jnative.procgrid2(p)


@requires_native
@pytest.mark.parametrize("shape,p", SURFACES)
def test_min_surface_grid_matches_jax(shape, p):
    got = native.min_surface_grid(shape, p)
    assert got == tgeo.proc_setup_min_surface(tgeo.world_box(shape), p)
    assert got == tuple(jnative.min_surface_grid(shape, p))


@requires_native
@pytest.mark.parametrize("shape,p", SURFACES)
def test_pencil_grid_matches_jax(shape, p):
    got = native.pencil_grid(shape, p)
    assert got == tgeo.pencil_grid_min_surface(shape, p)
    assert got == tuple(jnative.pencil_grid(shape, p))


@requires_native
@pytest.mark.parametrize("n", SPLITS)
def test_balanced_split_matches_jax(n):
    for bound in (16, 128, 256, 2048):
        got = native.balanced_split(n, bound)
        assert got == native.balanced_split_native(n, bound)
        assert got == native._balanced_split_py(n, bound)
        assert got == jnative.balanced_split(n, bound)


@requires_native
@pytest.mark.parametrize("n0,n1,p,rank", TABLES)
def test_exchange_table_matches_jax(n0, n1, p, rank):
    got = native.exchange_table(n0, n1, 3, p, rank)
    assert got == native._exchange_table_py(n0, n1, 3, p, rank)
    assert got == tuple(jnative.exchange_table(n0, n1, 3, p, rank))


@pytest.mark.parametrize("n0,n1,p", [(512, 512, 4), (100, 70, 8), (7, 5, 4),
                                     (16, 16, 16)])
def test_exchange_table_conserves(n0, n1, p):
    """Every owned element is sent, and what r sends j is what j
    receives from r (the reference's count tables)."""
    tables = [native.exchange_table(n0, n1, 3, p, r) for r in range(p)]
    for r in range(p):
        for j in range(p):
            assert tables[r][0][j] == tables[j][2][r]
    assert sum(sum(t[0]) for t in tables) == n0 * n1 * 3


def test_mirrors_without_the_library(monkeypatch):
    """A library that cannot be built: every function answers from its
    mirror, as JAX's falls back."""
    monkeypatch.setattr(native, "_load", lambda: None)
    assert native.schedule_axis(512) == [32, 16]
    assert native.procgrid2(12) == (3, 4)
    assert native.min_surface_grid((100, 200, 300), 12) == \
        tgeo.proc_setup_min_surface(tgeo.world_box((100, 200, 300)), 12)
    assert native.pencil_grid((512, 512, 512), 8) == (4, 2)
    assert native.balanced_split_native(512, 256) == (16, 32)
    assert native.exchange_table(7, 5, 3, 4, 2) == \
        native._exchange_table_py(7, 5, 3, 4, 2)
    tr = native.NativeTrace()
    assert not tr.available and tr.begin("x") == -1 and tr.count() == 0
    assert tr.dump("/nonexistent/x.log") is False


def test_failed_build_is_unavailable(monkeypatch):
    """A build that fails (no g++, a compile error) leaves the library
    unavailable with its reason, and loads nothing."""
    def broken():
        raise RuntimeError("g++ not found: test")

    monkeypatch.setattr(native, "build", broken)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.is_available() is False
    assert "g++ not found" in native.build_error()
    assert native.schedule_axis(4096, 256, 4) == [64, 64]


def test_balanced_split_loads_nothing(monkeypatch):
    """The kernels' split rule is the Python one: no compiler on the
    kernel path."""
    def refuse():
        raise AssertionError("balanced_split loaded the library")

    monkeypatch.setattr(native, "_load", refuse)
    assert native.balanced_split(512, 256) == (16, 32)
    from distributedfft_tpu_torch.ops import cuda_fft

    assert cuda_fft.split_for(512) == native._balanced_split_py(
        512, cuda_fft.MAX_FACTOR)


@requires_native
def test_library_is_the_ports_own():
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR == os.path.join(REPO, "distributedfft_tpu_torch",
                                            "_build")
    assert os.path.basename(path).startswith("libdfft_native_")
    assert native.SOURCE == os.path.join(REPO, "distributedfft_tpu_torch",
                                         "csrc", "dfft_native.cpp")
    assert os.path.exists(path)
    lib = native._load()
    assert lib._name == path
    assert lib._name != jnative._SO_PATH
    assert lib.dfft_abi_version() == native.ABI_VERSION == 3
    assert "-Wl,-Bsymbolic" in native.CXX_FLAGS
    from distributedfft_tpu_torch.ops import _build

    import glob

    assert all(not p.endswith((".cpp", ".f90")) for p in _build.sources())
    hashed = glob.glob(os.path.join(_build.CSRC, "*.cu*"))
    assert hashed and all(p.endswith((".cu", ".cuh")) for p in hashed)


def _exports(text):
    import re

    return set(re.findall(
        r"^(?:long long|int|double|void)\s+(dfft_\w+)\s*\(", text, re.M))


@requires_native
def test_exports_are_the_jax_librarys():
    """The same extern "C" names, each resolvable in both libraries."""
    port = open(native.SOURCE).read()
    jax_src = open(os.path.join(REPO, "native", "dfft_native.cpp")).read()
    names = _exports(port)
    assert names == _exports(jax_src) and len(names) >= 30
    lib = native._load()
    for name in names:
        getattr(lib, name)
    if jnative.is_available():
        jlib = jnative._load()
        for name in names:
            getattr(jlib, name)


@requires_native
def test_native_trace_roundtrip(tmp_path):
    tr = native.NativeTrace()
    tr.init()
    i = tr.begin("stage_a")
    tr.end(i)
    j = tr.begin("stage_b")
    tr.end(j)
    assert tr.count() == 2
    path = str(tmp_path / "trace_0.log")
    assert tr.dump(path, process=0, nprocs=1)
    lines = open(path).read().splitlines()
    assert lines[0] == "process 0 of 1"
    assert [ln.split()[-1] for ln in lines[1:]] == ["stage_a", "stage_b"]
    assert tr.dump(str(tmp_path / "no" / "such" / "dir.log")) is False


@requires_native
def test_trace_tables_are_per_library(tmp_path):
    """The port's and JAX's recorders keep separate tables in one
    process."""
    if not jnative.is_available():
        pytest.skip("the JAX package's library did not build")
    ours, theirs = native.NativeTrace(), jnative.NativeTrace()
    ours.init()
    theirs.init()
    ours.end(ours.begin("port_only"))
    assert ours.count() == 1 and theirs.count() == 0
    assert theirs.dump(str(tmp_path / "j.log"))
    assert ours.dump(str(tmp_path / "t.log"))
    assert "port_only" in open(tmp_path / "t.log").read()
    assert "port_only" not in open(tmp_path / "j.log").read()


@pytest.mark.parametrize("module", ["capi", "native", "utils.trace",
                                    "fortran_check"])
def test_modules_import_no_jax(module):
    code = (f"import sys, distributedfft_tpu_torch.{module}\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                    'distributedfft_tpu'))\n"
            "print(bad)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
