"""The port's C ABI on loopback worlds against the JAX package's bridge
on the 8-device CPU mesh: a ``World(4)`` slab and a ``(2, 2)`` pencil
against JAX's 4-device and 2x2 meshes, at (8, 6, 5) and (7, 10, 6),
through the same ctypes calls as ``tests/test_torch_capi.py`` (whose
helpers this file uses); complex64 within 5e-4, the dd tier within
1e-11, each also against numpy."""

import pytest

from test_torch_capi import (SHAPES, _check_case, _install,  # noqa: F401
                             pytestmark)

#: The cases on the loopback worlds (each JAX mesh plan compiles anew).
WORLD_CASES = [("c2c", -1, 2), ("c2c", 1, 2), ("r2c", -1, 0),
               ("r2c", 1, 1), ("r2c", 1, 2), ("z2z", -1, 2),
               ("z2z", 1, 2), ("d2z", -1, 1), ("d2z", 1, 0)]


@pytest.fixture(autouse=True)
def _single_bridges():
    _install(None)
    yield
    _install(None)


@pytest.mark.parametrize("world", [4, (2, 2)])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind,direction,axis", WORLD_CASES)
def test_execute_matches_jax_on_worlds(kind, direction, axis, shape,
                                       world):
    _check_case(kind, shape, direction, axis, world)
