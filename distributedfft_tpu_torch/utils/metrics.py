"""Metrics registry: process-global counters, gauges and histograms.

The port's own copy of ``distributedfft_tpu/utils/metrics.py``: named
series with labels, snapshot as one JSON-serializable document, with the
JAX package's series names, :data:`METRICS_SCHEMA`, snapshot shape and
reservoir seed.

Series wired in the port:

- ``plan_builds`` (counter; kind/decomposition/executor): plan
  constructions, each cache miss and each bypass of the plan cache.
- ``plan_cache_hits`` / ``plan_cache_misses`` (counter; kind): the plan
  cache's outcome of every cached planner call.
- ``plan_build_seconds`` (histogram; kind): the host time of each build.
- ``executes`` (counter; kind/decomposition/executor): one per
  ``execute()`` of a plan, an operator plan's included, and one per call
  of a dd plan (executor ``dd``).
- ``exchange_true_bytes`` / ``exchange_wire_bytes`` (counter): per
  execute, the information a plan moves between ranks and the bytes its
  transport ships (:func:`..plan_logic.exchange_payloads`, plus the brick
  edges).
- ``pallas_fallback`` (counter; axis/reason): each local transform the
  ``cuda`` executor sends away from its kernels (the port's
  ``cuda_fft.FALLBACKS``, under the JAX package's series name).
- ``fusion_fallback`` (counter; site/reason): each fusion site that runs
  unfused (``cuda_fuse.FUSION_FALLBACKS``).

- ``compile_seconds`` (histogram; decomposition/executor): each
  ``Plan3D.compile()``.
- ``fault_injected`` (counter; point/kind): each fault
  :mod:`..faults` fires.
- ``numerics_shadow_sampled`` / ``numerics_shadow_audits`` (counter) and
  ``numerics_nonfinite`` (counter; site/kind): :mod:`..numerics`.
- ``serving_*`` (:mod:`..serving`, JAX's names and labels): submits,
  flushes, transforms, flush reasons, batch size, queue depth, wait,
  retries, degraded rebuilds, isolated failures, expiries, rejections,
  the tenant series, the concurrent and wave series, the warm pool's.

The tuner's series are JAX's too (:mod:`..tuner`); the monitor's wait
for its port. :data:`RESERVOIR_SERIES` keep a bounded sample (Algorithm
R, seeded) so their snapshots carry p50/p99.

Off by default: every hook is one flag check and a return until
:func:`enable_metrics`. Unlike the JAX package, the port reads no
``DFFT_METRICS`` environment variable.
"""

from __future__ import annotations

import random
import threading
import time

__all__ = [
    "METRICS_SCHEMA",
    "enable_metrics",
    "metrics_enabled",
    "inc",
    "set_gauge",
    "observe",
    "counter_total",
    "metrics_snapshot",
    "metrics_reset",
]

#: Snapshot document format version, stamped into every snapshot.
METRICS_SCHEMA = 1

_enabled = False
_lock = threading.Lock()
# Keyed (name, ((label, value), ...)) with label values stringified.
_counters: dict[tuple, float] = {}
_gauges: dict[tuple, float] = {}
_histograms: dict[tuple, list] = {}  # [count, total, min, max]

#: Histogram series that keep a bounded sampling reservoir for snapshot
#: quantiles.
RESERVOIR_SERIES = frozenset(
    {"serving_wait_seconds", "serving_tenant_wait_seconds"})
#: Reservoir capacity per labeled series.
RESERVOIR_SIZE = 2048
_reservoirs: dict[tuple, list] = {}
_res_rng = random.Random(0x0FF7)  # deterministic per process


def metrics_enabled() -> bool:
    return _enabled


def enable_metrics(on: bool = True) -> None:
    """Turn the registry on (or off with ``on=False``)."""
    global _enabled
    _enabled = bool(on)


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def inc(name: str, value: float = 1.0, **labels) -> None:
    """Add ``value`` to the counter series ``name`` at ``labels``."""
    if not _enabled:
        return
    k = _key(name, labels)
    with _lock:
        _counters[k] = _counters.get(k, 0.0) + value


def set_gauge(name: str, value: float, **labels) -> None:
    """Set the gauge series ``name`` at ``labels`` to ``value``."""
    if not _enabled:
        return
    k = _key(name, labels)
    with _lock:
        _gauges[k] = float(value)


def observe(name: str, value: float, **labels) -> None:
    """Record one observation into the histogram series ``name``, kept
    as count/total/min/max (and a reservoir for
    :data:`RESERVOIR_SERIES`)."""
    if not _enabled:
        return
    k = _key(name, labels)
    value = float(value)
    with _lock:
        h = _histograms.get(k)
        if h is None:
            h = _histograms[k] = [1, value, value, value]
        else:
            h[0] += 1
            h[1] += value
            h[2] = min(h[2], value)
            h[3] = max(h[3], value)
        if name in RESERVOIR_SERIES:
            r = _reservoirs.get(k)
            if r is None:
                r = _reservoirs[k] = []
            if len(r) < RESERVOIR_SIZE:
                r.append(value)
            else:
                # Algorithm R: each of the h[0] observations so far ends
                # up in the sample with probability RESERVOIR_SIZE/h[0].
                j = _res_rng.randrange(h[0])
                if j < RESERVOIR_SIZE:
                    r[j] = value


def counter_total(name: str) -> float:
    """Sum of the counter ``name`` across every label combination."""
    with _lock:
        return sum(v for (n, _), v in _counters.items() if n == name)


def _label_str(labels: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in labels)


def _quantile(sorted_vals: list, q: float) -> float:
    """Linear-interpolated quantile of an already-sorted sample."""
    if not sorted_vals:
        return 0.0
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)


def metrics_snapshot() -> dict:
    """One JSON-serializable document of every recorded series:
    ``{"schema", "captured_at_monotonic", "enabled", "counters": {name:
    {"label=value,...": total}}, "gauges": {...}, "histograms": {name:
    {labels: {count, total, mean, min, max[, p50, p99, exact]}}}}`` (the
    empty string keys a label-less series). ``captured_at_monotonic`` is
    ``time.monotonic()`` at capture, an ordering stamp within one
    process."""
    with _lock:
        counters: dict = {}
        for (name, labels), v in sorted(_counters.items()):
            counters.setdefault(name, {})[_label_str(labels)] = v
        gauges: dict = {}
        for (name, labels), v in sorted(_gauges.items()):
            gauges.setdefault(name, {})[_label_str(labels)] = v
        hists: dict = {}
        for (name, labels), (cnt, total, lo, hi) in sorted(
                _histograms.items()):
            entry = {
                "count": cnt,
                "total": total,
                "mean": total / cnt,
                "min": lo,
                "max": hi,
            }
            r = _reservoirs.get((name, labels))
            if r is not None:
                s = sorted(r)
                entry["p50"] = _quantile(s, 0.50)
                entry["p99"] = _quantile(s, 0.99)
                entry["exact"] = cnt <= RESERVOIR_SIZE
            hists.setdefault(name, {})[_label_str(labels)] = entry
    return {
        "schema": METRICS_SCHEMA,
        "captured_at_monotonic": time.monotonic(),
        "enabled": _enabled,
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
    }


def metrics_reset() -> None:
    """Drop every recorded series (the enabled flag is left as is)."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _histograms.clear()
        _reservoirs.clear()
