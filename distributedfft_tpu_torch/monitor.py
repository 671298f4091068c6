"""Measured overlap attribution: the dispatch-span joins of the monitor.

The port of the overlap block of ``distributedfft_tpu/monitor.py``
(``dispatch_spans``, ``realized_overlap``, ``overlap_from_events``,
``update_overlap_correction``), the part :mod:`.explain` calls. The
monitor itself (sampling, health, Prometheus) is still to be ported.

:func:`dispatch_spans` runs a fresh :func:`..stagegraph._build_concurrent`
program once on zeros of each plan's input, under
:func:`..utils.trace.capture_events`, and synchronises: the JAX package
evaluates the program abstractly instead, which the port's CUDA kernels
have no counterpart of. The spans are the host's dispatch order either
way, since launches on the card are asynchronous.
"""

from __future__ import annotations

import re

from .utils.trace import capture_events

__all__ = ["dispatch_spans", "realized_overlap", "overlap_from_events",
           "update_overlap_correction"]

_CC_PREFIX = re.compile(r"^cc(\d+):")
_CHUNK_SUFFIX = re.compile(r"\[(\d+)\]$")


def dispatch_spans(plans) -> list[tuple[str, float, float]]:
    """The dispatch-order spans ``(name, start, stop)`` of the merged
    schedule of ``plans`` (stage-graph plans on one world): an uncached
    :func:`..stagegraph._build_concurrent` program run once on zeros of
    each plan's input under :func:`..utils.trace.capture_events`, every
    ``cc<j>:`` span and per-chunk ``[k]`` span included. Raises
    ``ValueError`` for a plan below the stage-graph tier."""
    from .api import alloc_local
    from .stagegraph import _build_concurrent
    from .utils.timing import sync

    plans = tuple(plans)
    cp = _build_concurrent(plans)
    xs = [alloc_local(p) for p in plans]
    with capture_events() as buf:
        out = cp.fn(*xs)
    sync(out)
    return list(buf)


def realized_overlap(events, group_of) -> dict | None:
    """Realized overlap of a span timeline: the spans grouped by
    ``group_of(name)`` (None: ignored), then ``hide_ratio = 1 - wall /
    sum(per-group extents)``, each group's extent from its first start
    to its last stop and ``wall`` the whole cohort's. Groups dispatched
    back to back give 0; a perfect n-way interleave approaches
    ``1 - 1/n``. None without two groups."""
    groups: dict = {}
    for name, start, stop in events:
        g = group_of(name)
        if g is None:
            continue
        cur = groups.get(g)
        if cur is None:
            groups[g] = [start, stop]
        else:
            cur[0] = min(cur[0], start)
            cur[1] = max(cur[1], stop)
    if len(groups) < 2:
        return None
    extents = sum(hi - lo for lo, hi in groups.values())
    wall = (max(hi for _, hi in groups.values())
            - min(lo for lo, _ in groups.values()))
    if extents <= 0.0:
        return None
    return {
        "groups": len(groups),
        "wall_seconds": wall,
        "extent_seconds": extents,
        "hide_ratio": max(0.0, 1.0 - wall / extents),
    }


def overlap_from_events(events) -> dict:
    """Both joins of one dispatch timeline: ``"concurrent"`` groups by
    the ``cc<j>:`` transform prefix (None for one transform), ``"legs"``
    by the per-chunk ``[k]`` suffix (None at K <= 1)."""
    def cc_of(name: str):
        m = _CC_PREFIX.match(name)
        return int(m.group(1)) if m else None

    def chunk_of(name: str):
        m = _CHUNK_SUFFIX.search(_CC_PREFIX.sub("", name))
        return int(m.group(1)) if m else None

    return {
        "concurrent": realized_overlap(events, cc_of),
        "legs": realized_overlap(events, chunk_of),
    }


def update_overlap_correction(
    overlap: dict | None, path: str | None = None,
) -> dict | None:
    """Persist an explain record's measured / model overlap ratio into
    the calibration profile (:func:`..calibrate.update_model_correction`)
    under ``"concurrent_hide"`` or ``"leg_hide"``, the keys the model's
    ``hide_correction`` reads back. None (nothing written) without a
    measured ratio, a positive model ratio, a known kind or an armed
    profile store."""
    if not isinstance(overlap, dict):
        return None
    measured = overlap.get("measured_hide_ratio")
    model = overlap.get("model_hide_ratio")
    kind = overlap.get("kind")
    key = {"concurrent": "concurrent_hide",
           "overlap_k": "leg_hide"}.get(kind)
    if (key is None
            or not isinstance(measured, (int, float))
            or not isinstance(model, (int, float)) or model <= 0.0):
        return None
    from .calibrate import update_model_correction

    return update_model_correction({key: measured / model}, path)
