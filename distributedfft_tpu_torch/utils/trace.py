"""Event tracing: named spans around every stage, exchange and leg.

The port of ``distributedfft_tpu/utils/trace.py``. :func:`add_trace` is
a context manager that enters ``torch.profiler.record_function(name)``
while a profiler records, so each span lands in a ``torch.profiler``
timeline (and the device work launched inside it is attributed to it
there), and records a host wall-clock pair while a session is open
(:func:`init_tracing`, or the environment: ``DFFT_TRACE=1``,
``DFFT_TRACE_ROOT``, ``DFFT_TRACE_FORMAT``); besides the stages, the
port opens spans inside them around each kernel pass, untangle,
all-to-all copy and host wait. :func:`finalize_tracing` writes one file
per rank, ``<root>_<rank>.log`` (the per-rank text log) or ``.json`` (a
Chrome trace), the rank being that of ``torch.distributed`` when it is
initialized, else 0. The in-memory recorder is a ring of
``DFFT_TRACE_MAX_EVENTS`` events (0: unbounded) that evicts the oldest.

A ``"log"`` session records through the C recorder of the port's host
library (``dfft_trace_*`` in ``csrc/dfft_native.cpp``, :mod:`..native`)
when the library builds, as the JAX package's does; ``DFFT_TRACE_NATIVE=0``
forces the Python recorder, and ``"chrome"`` sessions always use it. The C
recorder stores spans in the order they begin and has no ring;
:func:`record_span` returns False under it (its begin/end API takes no
explicit times), and :func:`capture_events` tees under either recorder.
"""

from __future__ import annotations

import json
import math
import os
import socket
import time
from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.distributed as dist

TRACE_FORMATS = ("log", "chrome")

#: Default ring capacity of the recorder (``DFFT_TRACE_MAX_EVENTS``).
DEFAULT_TRACE_MAX_EVENTS = 1 << 20

_events: list[tuple[str, float, float]] | None = None
_trace_root: str | None = None
_native_rec = None  # native.NativeTrace while the C recorder is in use
_session = 0  # bumped by init/finalize: stale in-flight spans are dropped
_format = "log"
# perf_counter pairs plus _epoch land on the time.time() axis, so the
# files of several ranks share one timeline.
_epoch = 0.0
_capture: list[tuple[str, float, float]] | None = None
_max_events = DEFAULT_TRACE_MAX_EVENTS
_dropped = 0


def dropped_events() -> int:
    """Events evicted by the ring in the current session."""
    return _dropped


def _push(ev: list, name: str, start: float, stop: float) -> None:
    """Append one event, evicting the oldest past the ring's capacity (a
    capacity/16 slice at a time, so the shift cost amortizes)."""
    global _dropped
    if _max_events and len(ev) >= _max_events:
        cut = max(1, len(ev) - _max_events + max(1, _max_events // 16))
        del ev[:cut]
        _dropped += cut
    ev.append((name, start, stop))


def tracing_enabled() -> bool:
    return _events is not None or _native_rec is not None


def _rank() -> tuple[int, int]:
    """(rank, world size) of ``torch.distributed`` when initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _try_native():
    """The C recorder of the port's host library, initialised, or None
    when ``DFFT_TRACE_NATIVE=0`` or the library is unavailable."""
    if os.environ.get("DFFT_TRACE_NATIVE", "1") == "0":
        return None
    from .. import native

    rec = native.NativeTrace()
    if not rec.available:
        return None
    rec.init()
    return rec


def init_tracing(root: str = "", format: str | None = None) -> None:
    """Start collecting events. ``root`` prefixes the file
    :func:`finalize_tracing` writes; ``format`` (default
    ``DFFT_TRACE_FORMAT``, else ``"log"``) is ``"log"`` or ``"chrome"``.
    A ``"log"`` session takes the C recorder unless
    ``DFFT_TRACE_NATIVE=0`` (module docstring). An open session is
    finalized (written) first."""
    global _events, _trace_root, _format, _epoch, _max_events, _dropped
    global _native_rec, _session
    if tracing_enabled():
        finalize_tracing()
    fmt = format or os.environ.get("DFFT_TRACE_FORMAT", "") or "log"
    if fmt not in TRACE_FORMATS:
        raise ValueError(
            f"unknown trace format {fmt!r}; use one of {TRACE_FORMATS}")
    _trace_root = root or "dfft_trace"
    _format = fmt
    _epoch = time.time() - time.perf_counter()
    try:
        _max_events = int(os.environ.get("DFFT_TRACE_MAX_EVENTS", "")
                          or DEFAULT_TRACE_MAX_EVENTS)
    except ValueError:
        _max_events = DEFAULT_TRACE_MAX_EVENTS
    _dropped = 0
    _session += 1
    _native_rec = _try_native() if fmt == "log" else None
    _events = None if _native_rec is not None else []


def _write_chrome(path: str, events, proc: int, nprocs: int) -> None:
    """One ``B``/``E`` pair per event, ``pid`` the rank, ``ts`` in
    wall-clock microseconds."""
    trace_events = []
    for name, start, stop in events:
        b = {"name": name, "cat": "dfft", "ph": "B", "pid": proc, "tid": 0,
             "ts": (start + _epoch) * 1e6}
        trace_events.extend((b, dict(b, ph="E", ts=(stop + _epoch) * 1e6)))
    # Events are recorded at their end (inner before outer); a stable
    # sort on ts, B before E at ties, restores the nesting.
    trace_events.sort(key=lambda ev: (ev["ts"], ev["ph"] != "B"))
    meta = {"process": proc, "process_count": nprocs,
            "host": socket.gethostname(), "os_pid": os.getpid()}
    if _dropped:
        meta["dropped_events"] = _dropped
    with open(path, "w") as f:
        json.dump({"displayTimeUnit": "ms", "metadata": meta,
                   "traceEvents": trace_events}, f)


def finalize_tracing() -> str | None:
    """Write ``<root>_<rank>.log`` (or ``.json``) and stop tracing.
    Returns the path, or None when no session was open. Raises
    ``OSError`` when the C recorder's dump fails."""
    global _events, _trace_root, _dropped, _native_rec, _session
    if not tracing_enabled():
        return None
    proc, nprocs = _rank()
    _session += 1
    if _native_rec is not None:
        # A failed dump keeps the session, and the C table its spans.
        path = f"{_trace_root}_{proc}.log"
        if not _native_rec.dump(path, proc, nprocs):
            raise OSError(f"the C trace recorder's dump to {path!r} failed")
        _native_rec, _trace_root = None, None
        return path
    events, root = _events, _trace_root
    _events, _trace_root = None, None
    if _format == "chrome":
        path = f"{root}_{proc}.json"
        _write_chrome(path, events, proc, nprocs)
    else:
        path = f"{root}_{proc}.log"
        t0 = events[0][1] if events else 0.0
        with open(path, "w") as f:
            f.write(f"process {proc} of {nprocs}\n")
            if _dropped:
                f.write(f"dropped_events {_dropped}\n")
            for name, start, stop in events:
                f.write(f"{start - t0:14.6f}  {stop - start:12.6f}  {name}\n")
    _dropped = 0
    return path


if os.environ.get("DFFT_TRACE", "") not in ("", "0"):
    init_tracing(os.environ.get("DFFT_TRACE_ROOT", "dfft_trace"))


@contextmanager
def add_trace(name: str):
    """One named span: a ``torch.profiler`` range while a profiler is
    recording (entering one costs ~10 us of host time even when none
    is, so it is skipped then); a host wall-clock pair when a session
    (or :func:`capture_events`) is open. The pair brackets the host's
    launch of the work, not the device's run of it; the profiler's
    timeline has the device side."""
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(name):
            yield from _host_pair(name)
    else:
        yield from _host_pair(name)


def _host_pair(name: str):
    """The session's and capture's part of :func:`add_trace`: a
    generator that yields once, around the span's body."""
    rec, cap, sess = _native_rec, _capture, _session
    if rec is not None:
        # The C table is process-global: a finalize or re-init inside
        # the block would let a stale id land in the next session's
        # table, so the session count drops such an end.
        eid = rec.begin(name)
        start = time.perf_counter() if cap is not None else 0.0
        try:
            yield
        finally:
            if cap is not None:
                cap.append((name, start, time.perf_counter()))
            if _session == sess:
                rec.end(eid)
        return
    ev = _events
    if ev is None and cap is None:
        yield
        return
    start = time.perf_counter()
    try:
        yield
    finally:
        stop = time.perf_counter()
        if ev is not None:
            _push(ev, name, start, stop)
        if cap is not None:
            cap.append((name, start, stop))


def record_span(name: str, start: float, stop: float) -> bool:
    """Record an already-completed span with ``time.perf_counter()``
    endpoints. True when a session took it: never under the C recorder,
    whose begin/end API takes no explicit times."""
    ev = _events
    if ev is None:
        return False
    _push(ev, name, float(start), float(stop))
    return True


@contextmanager
def capture_events():
    """While the block runs, every :func:`add_trace` span is also
    appended to the yielded ``(name, start, stop)`` list, with or
    without a session and without using the session's ring. Captures
    nest (the inner one takes the spans)."""
    global _capture
    prev = _capture
    buf: list[tuple[str, float, float]] = []
    _capture = buf
    try:
        yield buf
    finally:
        _capture = prev


@contextmanager
def timed_span(name: str):
    """:func:`add_trace` that also yields a dict whose ``"seconds"`` is
    the span's host wall time, filled on exit."""
    out = {"seconds": 0.0}
    with add_trace(name):
        start = time.perf_counter()
        try:
            yield out
        finally:
            out["seconds"] = time.perf_counter() - start


#: Stage keys of the reference's per-execute breakdown.
STAGE_KEYS = ("t0", "t1", "t2", "t3")
#: Stage keys of a spectral-operator chain (with its ``t_mid``).
OP_STAGE_KEYS = ("t0", "t1", "t2", "t_mid", "t3")


def stage_key(name: str) -> str | None:
    """The ``t0..t3`` / ``t_mid`` key of a span or stage name, or None:
    ``t0_fft_yz`` -> t0, ``t2a_exchange_ici[1]`` and ``t2b_exchange_dcn``
    -> t2, ``t3_fft_x[4]`` -> t3, ``t_mid[k]`` -> t_mid,
    ``t_mid_pointwise`` -> None; a ``cc<j>:`` prefix (transform j of a
    concurrent schedule) is dropped first."""
    if name.startswith("cc"):
        head, sep, rest = name.partition(":")
        if sep and head[2:].isdigit():
            name = rest
    if name.startswith("t_mid"):
        rest = name[5:]
        return "t_mid" if (not rest or rest[0] == "[") else None
    if len(name) >= 2 and name[0] == "t" and name[1] in "0123":
        rest = name[2:]
        if not rest or rest[0] in "_[" or rest[:1] in ("a", "b"):
            return name[:2]
    return None


def traced_stage(name: str, fn):
    """``fn`` with every call under the span ``name``; the bare callable
    stays reachable as ``__wrapped__``."""

    def run(x):
        with add_trace(name):
            return fn(x)

    run.__wrapped__ = fn
    return run


def trace_stages(stages):
    """:func:`traced_stage` over a ``[(name, fn), ...]`` stage list."""
    return [(name, traced_stage(name, fn)) for name, fn in stages]


@dataclass
class CsvRecorder:
    """Appends benchmark rows to a CSV file, refusing a file whose header
    differs from ``header``."""

    path: str
    header: tuple[str, ...]

    def __post_init__(self) -> None:
        if not os.path.exists(self.path) or os.path.getsize(self.path) == 0:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "w") as f:
                f.write(",".join(self.header) + "\n")
            return
        with open(self.path) as f:
            existing = f.readline().rstrip("\n")
        want = ",".join(self.header)
        if existing != want:
            raise ValueError(
                f"CSV {self.path!r} has header {existing!r}, recorder "
                f"expects {want!r}; refusing to append misaligned rows "
                f"(use a fresh path or matching header)")

    def record(self, *row) -> None:
        if len(row) != len(self.header):
            raise ValueError(
                f"expected {len(self.header)} fields, got {len(row)}")
        with open(self.path, "a") as f:
            f.write(",".join(str(v) for v in row) + "\n")


_MB = 1.0 / (1024 * 1024)


def plan_info(plan) -> str:
    """A plan's routing, world and boxes as text (the reference's
    ``outputPlanInfo``), one string for every rank. A dd plan (no
    ``executor``) names the complex128 engine its pairs run on."""
    if not hasattr(plan, "executor"):
        return _dd_plan_info(plan)
    real = plan.kind == "r2c"
    d = plan.describe()
    lines = [
        f"plan: {plan.in_shape} -> {plan.out_shape} "
        f"({'forward' if plan.forward else 'backward'}"
        f"{', r2c' if real and plan.forward else ''}"
        f"{', c2r' if real and not plan.forward else ''})",
        f"decomposition: {plan.decomposition}",
        f"executor: {plan.executor}",
        f"algorithm: {d['algorithm']}",
        f"dtype: {plan.in_dtype} -> {plan.out_dtype}",
    ]
    if d["overlap_chunks"] not in (None, 1):
        lines.append(
            f"overlap: {d['overlap_chunks']} chunks (pipelined t2/t3 "
            f"exchange-compute interleave along the bystander axis)")
    if plan.wire_dtype is not None:
        lines.append(f"wire: {plan.wire_dtype}")
    if plan.batch is not None:
        lines.append(f"batch: {plan.batch} coalesced transforms (one "
                     f"shared exchange per t2 stage)")
    op = getattr(plan, "op", "")
    if op:
        lines.append(
            f"operator: fused {op} (FFT -> pointwise -> iFFT in one plan; "
            f"multiplier applied at the transposed t_mid midpoint, "
            f"skipping the cancelling transpose pair)")
    if plan.r2c_axis != 2:
        lines.append(f"r2c axis: {plan.r2c_axis} (the chain runs on the "
                     f"view with axes {plan.r2c_axis} and 2 swapped)")
    for label in ("in_spec", "out_spec"):
        spec = getattr(plan, label)
        if spec is not None:
            absorbed = getattr(plan.logic, label.replace("spec", "absorbed"))
            lines.append(f"{label}: {spec} ("
                         f"{'absorbed by the chain' if absorbed else 'edge reshape'})")
    if plan.brick_edges is not None:
        # The overlap-map accounting of the brick edges: true payload
        # against what the transport ships (the send_size/recv_size tables
        # of heffte_reshape3d's overlap maps).
        itemsize = torch.empty((), dtype=plan.dtype).element_size()
        for label, bs in zip(("in->chain", "chain->out"), plan.brick_edges):
            t = bs.payload_elems * itemsize
            wb = bs.wire_elems * itemsize
            ov = f"ratio {bs.wire_ratio:.2f}x" if t else "ratio n/a"
            how = (f"{len(bs.steps)} ring steps" if bs.algorithm == "ring"
                   else "a2av exact counts")
            tbl = ("" if bs.a2av_table_bytes is None else
                   f" | index tables {bs.a2av_table_bytes / 1024:.1f} "
                   f"KB/device (RLE)")
            lines.append(f"brick edge {label}: {how}, payload "
                         f"{t * _MB:.2f} MB | wire {wb * _MB:.2f} MB ({ov})"
                         + tbl)
    world = plan.world
    lines += _world_lines(world)
    itemsize = torch.empty((), dtype=plan.dtype).element_size()
    nranks = 1 if world is None else world.size
    in_b = math.prod(plan.in_shape) * torch.empty(
        (), dtype=plan.in_dtype).element_size()
    out_b = math.prod(plan.out_shape) * torch.empty(
        (), dtype=plan.out_dtype).element_size()
    work = max(in_b, out_b, math.prod(plan.complex_shape) * itemsize
               * (plan.batch or 1))
    lines.append(
        f"memory/rank (est): in {in_b / nranks * _MB:.1f} MB + out "
        f"{out_b / nranks * _MB:.1f} MB + work {work / nranks * _MB:.1f} MB")
    return "\n".join(lines + _box_lines(plan))


def _world_lines(world) -> list[str]:
    if world is None:
        return []
    axes = world.axis_names if world.grid is not None else world.axis_names[:1]
    sizes = world.grid if world.grid is not None else (world.size,)
    return ["world: " + " x ".join(f"{a}={s}" for a, s in zip(axes, sizes))
            + f" ({world.size} ranks, {world.backend})"]


def _box_lines(plan) -> list[str]:
    lines = [] if plan.spec is None else [f"padded extents: {plan.spec}"]
    for label, boxes in (("in", plan.in_boxes), ("out", plan.out_boxes)):
        for i, b in enumerate(boxes):
            order = ("" if tuple(b.order) == (0, 1, 2)
                     else f" order={tuple(b.order)}")
            lines.append(f"{label} box[{i}]: low={b.low} high={b.high} "
                         f"shape={b.shape}{order}")
    return lines


def _dd_plan_info(plan) -> str:
    """The dd tier's branch of :func:`plan_info`."""
    real = plan.kind == "r2c"
    lines = [
        f"plan: {plan.in_shape} -> {plan.out_shape} "
        f"({'forward' if plan.forward else 'backward'}"
        f"{', r2c' if real and plan.forward else ''}"
        f"{', c2r' if real and not plan.forward else ''}, dd tier)",
        f"decomposition: {plan.decomposition}",
        "executor: dd ((hi, lo) pairs joined into complex128 on the torch "
        "engine: torch.fft, cuFFT Z2Z on the card)",
        f"dtype: {plan.in_dtype} -> {plan.out_dtype} pairs",
    ]
    if plan.world is not None:
        lines.append(f"algorithm: {plan.algorithm}")
    if plan.overlap_chunks not in (None, 1):
        lines.append(f"overlap: {plan.overlap_chunks} chunks")
    if plan.batch is not None:
        lines.append(f"batch: {plan.batch} coalesced transforms (one "
                     f"shared exchange per t2 stage)")
    if plan.r2c_axis != 2:
        lines.append(f"r2c axis: {plan.r2c_axis} (the chain runs on the "
                     f"view with axes {plan.r2c_axis} and 2 swapped)")
    return "\n".join(lines + _world_lines(plan.world) + _box_lines(plan))
