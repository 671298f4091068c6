"""The port's Fortran binding: ``csrc/dfft_fortran.f90`` against the
port's own ``csrc/dfft_native.cpp``.

- everywhere: the port's interface checker
  (``distributedfft_tpu_torch/fortran_check.py``) passes on the port's
  sources, agrees with the JAX package's checker on them, rejects a
  drifted interface, and the module covers the whole typed surface;
- where ``gfortran`` exists: ``native.build_fortran()`` compiles the
  module and the smoke against the port's library, and a transform
  driven from Fortran runs in this process.
"""

import ctypes
import shutil
import sys
from pathlib import Path

import pytest

from distributedfft_tpu_torch import fortran_check as tfc
from distributedfft_tpu_torch import native

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "distributedfft_tpu_torch" / "csrc"
F90 = CSRC / "dfft_fortran.f90"
CPP = CSRC / "dfft_native.cpp"

REQUIRED = {
    "dfft_plan_c2c_3d", "dfft_execute_c2c", "dfft_destroy_plan_c",
    "dfft_plan_r2c_3d", "dfft_execute_r2c", "dfft_execute_c2r",
    "dfft_plan_z2z_3d", "dfft_execute_z2z",
    "dfft_plan_d2z_3d", "dfft_execute_d2z", "dfft_execute_z2d",
    "dfft_upload", "dfft_execute_resident", "dfft_download",
    "dfft_c_api_ready", "dfft_c_selftest", "dfft_c_selftest_r2c",
    "dfft_c_selftest_z2z", "dfft_c_selftest_resident",
}


def _jax_checker():
    sys.path.insert(0, str(REPO / "native"))
    try:
        import fortran_check
    finally:
        sys.path.pop(0)
    return fortran_check


def test_fortran_interfaces_match_the_ports_c_abi():
    problems = tfc.check(F90, CPP)
    assert not problems, "\n".join(problems)


def test_module_covers_the_typed_surface():
    sigs = tfc.parse_fortran_interfaces(F90)
    assert REQUIRED <= set(sigs), sorted(REQUIRED - set(sigs))


@pytest.mark.parametrize("which", ["interfaces", "exports"])
def test_checkers_agree_with_jax(which):
    """The port's checker and sources against the JAX package's: the same
    parsed interfaces, and the same C signatures for them."""
    jfc = _jax_checker()
    jf90 = REPO / "native" / "dfft_fortran.f90"
    jcpp = REPO / "native" / "dfft_native.cpp"
    sigs = tfc.parse_fortran_interfaces(F90)
    if which == "interfaces":
        assert sigs == jfc.parse_fortran_interfaces(jf90)
        assert sigs == jfc.parse_fortran_interfaces(F90)
    else:
        assert tfc.parse_c_exports(CPP, sigs) == \
            jfc.parse_c_exports(jcpp, sigs)
        assert not jfc.check(F90, CPP)


@pytest.mark.parametrize("drift", [
    ("function dfft_execute_resident(plan) bind(c) result(rc)",
     "function dfft_execute_resident(plan, extra) bind(c) result(rc)"),
    ("integer(c_int), value :: direction, r2c_axis",
     "integer(c_long_long), value :: direction, r2c_axis"),
])
def test_checker_rejects_drift(tmp_path, drift):
    """The checker is load-bearing: an undeclared dummy is a parse error
    (a compiler's), a retyped one a mismatch (a linker's)."""
    bad = tmp_path / "bad.f90"
    src = F90.read_text()
    assert drift[0] in src
    bad.write_text(src.replace(drift[0], drift[1], 1))
    try:
        problems = tfc.check(bad, CPP)
    except ValueError:
        return
    assert problems


def test_checker_rejects_a_c_side_drift(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text(CPP.read_text().replace(
        "int dfft_execute_resident(long long plan) {",
        "int dfft_execute_resident(long long plan, int extra) {"))
    assert any("dfft_execute_resident" in p for p in tfc.check(F90, bad))


@pytest.mark.skipif(shutil.which("gfortran") is None,
                    reason="no Fortran compiler here (gfortran)")
def test_fortran_smoke_runs():
    """Compile the binding against the port's library and run a
    transform driven from Fortran."""
    from distributedfft_tpu_torch import capi

    if not native.is_available():
        pytest.skip(f"the port's host library did not build: "
                    f"{native.build_error()}")
    assert capi.install_c_api(device="cpu")
    lib = ctypes.CDLL(native.build_fortran())
    lib.dfft_fortran_smoke.restype = ctypes.c_double
    lib.dfft_fortran_smoke.argtypes = [ctypes.c_longlong] * 3
    err = float(lib.dfft_fortran_smoke(8, 6, 5))
    assert 0 <= err < 5e-4, err
    lib.dfft_fortran_smoke_z2z.restype = ctypes.c_double
    lib.dfft_fortran_smoke_z2z.argtypes = [ctypes.c_longlong] * 3
    derr = float(lib.dfft_fortran_smoke_z2z(8, 6, 5))
    assert 0 <= derr < 1e-11, derr


def test_build_fortran_without_a_compiler(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="gfortran not found"):
        native.build_fortran()
