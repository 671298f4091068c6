"""Tolerance tiers and seeded world data, as the JAX package defines them
(``distributedfft_tpu/testing.py``): the same seed gives bit-identical data
in both packages, so a port result can be held against the reference on
the same input.
"""

from __future__ import annotations

import numpy as np

# Tolerance tiers of the reference's tests (float 5e-4, double 1e-11).
TOLERANCE = {
    np.dtype(np.complex64): 5e-4,
    np.dtype(np.complex128): 1e-11,
    np.dtype(np.float32): 5e-4,
    np.dtype(np.float64): 1e-11,
}


def tolerance(dtype) -> float:
    return TOLERANCE[np.dtype(dtype)]


def make_world_data(shape, dtype=np.complex128, seed: int = 4242) -> np.ndarray:
    """Deterministic full-world input data, values in [0, 1)."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "c":
        real_dt = np.float64 if dtype == np.complex128 else np.float32
        re = rng.random(shape, dtype=np.float64).astype(real_dt)
        im = rng.random(shape, dtype=np.float64).astype(real_dt)
        return (re + 1j * im).astype(dtype)
    return rng.random(shape, dtype=np.float64).astype(dtype)


def rel_error(result, reference) -> float:
    """Max absolute error over the reference's max magnitude."""
    result = np.asarray(result)
    reference = np.asarray(reference)
    denom = float(np.max(np.abs(reference))) or 1.0
    return float(np.max(np.abs(result - reference))) / denom
