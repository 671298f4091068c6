"""Tolerance tiers and seeded world data, as the JAX package defines them
(``distributedfft_tpu/testing.py``): the same seed gives bit-identical data
in both packages, so a port result can be held against the reference on
the same input.
"""

from __future__ import annotations

import math

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


#: Prefixes of the spans the port opens inside a stage, none of them a
#: stage (the JAX package opens none of them): one kernel pass
#: (``fft_plane``, ``fft_axis[<route>]``), a real transform's untangle
#: (``r2c_untangle``, ``c2r_untangle``), the process-group all-to-all's
#: copies (``a2a_pack``, ``a2a_unpack``) and a step that blocks the host
#: on the card (``host_wait[<site>]``).
PASS_SPANS = ("fft_plane", "fft_axis[", "r2c_untangle", "c2r_untangle",
              "a2a_pack", "a2a_unpack", "host_wait[")


def pass_span(name: str) -> bool:
    """True for a span name of :data:`PASS_SPANS`."""
    return name.startswith(PASS_SPANS)


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


def tree_mismatch(got, want, rel: float = 1e-12, path: str = "") -> str | None:
    """Where two nested records (dicts, lists, tuples, scalars) differ,
    or None: the same keys and lengths, numbers within ``rel`` relative
    (a bool is no number), everything else equal."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return f"{path}: {got!r} against {want!r}"
        subs = [(got[k], want[k], f"{path}.{k}") for k in want]
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return f"{path}: {got!r} against {want!r}"
        subs = [(g, w, f"{path}[{i}]") for i, (g, w) in
                enumerate(zip(got, want))]
    else:
        if isinstance(got, bool) != isinstance(want, bool):
            ok = False
        elif isinstance(want, (int, float)) and not isinstance(want, bool):
            ok = isinstance(got, (int, float)) and (
                got == want or abs(got - want) <= rel * abs(want)
                or (math.isnan(got) and math.isnan(want)))
        else:
            ok = got == want
        return None if ok else f"{path}: {got!r} against {want!r}"
    for g, w, p in subs:
        bad = tree_mismatch(g, w, rel, p)
        if bad:
            return bad
    return None
