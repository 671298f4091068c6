"""Deterministic fault injection: reproducible chaos for the serving tier.

The port of ``distributedfft_tpu/faults.py``. The serving tier's
recovery machinery (retry, batch isolation, degraded-mode fallback,
:mod:`.serving`) is tested with faults that fire on demand and
reproducibly: count-based and seeded, never by hoping the hardware
flakes.

Injection points (where the hosting code calls :func:`check`):

- ``plan``: plan construction (:func:`.api._timed_build`, every public
  planner's cache-miss build).
- ``compile``: a plan's first execution and :meth:`.api.Plan3D.compile`.
- ``execute``: every :func:`.api.execute`.
- ``exchange``: the t2 exchange, raised on the host at the execution of
  any plan that owns one (``plan.world is not None``).

Spec grammar (env ``DFFT_FAULT_INJECT``; clauses separated by ``;``)::

    clause    = point ":" directive ("," directive)*
    directive = "once"                 fire on the 1st check only
              | "every=N"             fire on every Nth check (N, 2N, ...)
              | "at=N[+N...]"         fire on exactly these check numbers
              | "p=P"                 fire with probability P (seeded)
              | "seed=S"              RNG seed for p (default 0)
              | "times=N"             cap total fires at N
              | "kind=transient"      (default) retryable fault
              | "kind=deterministic"  never-retryable fault
              | "match=SUBSTR"        only fire when the check site's
                                      label contains SUBSTR (e.g. the
                                      plan's executor name)

Examples: ``"execute:every=3"``, ``"plan:once"``,
``"exchange:seed=7,p=0.25"``,
``"execute:at=1+3,kind=deterministic,match=cuda"``. ``p=`` draws from
``random.Random(seed)`` exactly as the JAX package does, so one spec
fires on the same check numbers in both.

:func:`inject` arms one point programmatically (the grammar's knobs),
:func:`clear` disarms everything programmatic, and :func:`injected`
scopes an injection to a block. The env spec is parsed again (counters
reset) whenever the variable's value changes.

Every fired fault bumps the ``fault_injected`` metric (labels: point,
kind), lands a ``fault_injected[point:kind]`` marker span, then raises
:class:`InjectedFault`, whose ``transient`` flag drives :func:`classify`.

Disarmed, :func:`check` is one env-dict lookup and a return.
"""

from __future__ import annotations

import os
import random
from contextlib import contextmanager

import torch

from .utils import metrics as _metrics
from .utils.trace import add_trace, tracing_enabled

__all__ = [
    "POINTS",
    "InjectedFault",
    "check",
    "classify",
    "clear",
    "inject",
    "injected",
    "kernel_fault",
    "parse_spec",
    "reset",
]

#: The valid injection points.
POINTS = ("plan", "compile", "execute", "exchange")


class InjectedFault(RuntimeError):
    """A fault raised by :func:`check`. ``point`` names the injection
    point; ``transient`` says whether the retry policy may treat it as
    recoverable (``kind=transient``) or must not (``deterministic``)."""

    def __init__(self, point: str, kind: str, call: int):
        super().__init__(
            f"injected {kind} fault at point {point!r} (check #{call})")
        self.point = point
        self.transient = kind == "transient"


class _FaultPoint:
    """Armed state of one clause: counts checks, decides fires."""

    __slots__ = ("point", "kind", "mode", "n", "at", "p", "times",
                 "match", "_rng", "calls", "fires")

    def __init__(self, point: str, *, once: bool = False,
                 every: int | None = None, at: tuple[int, ...] = (),
                 p: float | None = None, seed: int = 0,
                 times: int | None = None, kind: str = "transient",
                 match: str = ""):
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; expected one of {POINTS}")
        if kind not in ("transient", "deterministic"):
            raise ValueError(
                f"fault kind must be transient|deterministic, got {kind!r}")
        modes = sum((bool(once), every is not None, bool(at),
                     p is not None))
        if modes != 1:
            raise ValueError(
                f"fault point {point!r} needs exactly one of "
                f"once|every=N|at=...|p=P")
        if every is not None and every < 1:
            raise ValueError(f"every={every} must be >= 1")
        if p is not None and not (0.0 <= p <= 1.0):
            raise ValueError(f"p={p} must be in [0, 1]")
        self.point = point
        self.kind = kind
        self.mode = ("once" if once else "every" if every is not None
                     else "at" if at else "p")
        self.n = every
        self.at = frozenset(at)
        self.p = p
        self.times = 1 if once else times
        self.match = match
        self._rng = random.Random(seed)
        self.calls = 0
        self.fires = 0

    def should_fire(self, label: str) -> bool:
        if self.match and self.match not in label:
            return False
        self.calls += 1
        if self.times is not None and self.fires >= self.times:
            return False
        if self.mode == "once":
            fire = self.calls == 1
        elif self.mode == "every":
            fire = self.calls % self.n == 0
        elif self.mode == "at":
            fire = self.calls in self.at
        else:
            fire = self._rng.random() < self.p
        if fire:
            self.fires += 1
        return fire


def parse_spec(raw: str) -> list[_FaultPoint]:
    """Parse one ``DFFT_FAULT_INJECT`` spec string into armed points.
    Raises ``ValueError`` on a malformed clause: a chaos spec that arms
    nothing would make every chaos test pass vacuously."""
    points: list[_FaultPoint] = []
    for clause in raw.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if ":" not in clause:
            raise ValueError(
                f"fault clause {clause!r} lacks a ':' (point:directives)")
        point, _, body = clause.partition(":")
        kw: dict = {"point": point.strip()}
        for directive in body.split(","):
            directive = directive.strip()
            if not directive:
                continue
            name, _, value = directive.partition("=")
            name = name.strip()
            value = value.strip()
            try:
                if name == "once" and not value:
                    kw["once"] = True
                elif name == "every":
                    kw["every"] = int(value)
                elif name == "at":
                    kw["at"] = tuple(int(v) for v in value.split("+"))
                elif name == "p":
                    kw["p"] = float(value)
                elif name == "seed":
                    kw["seed"] = int(value)
                elif name == "times":
                    kw["times"] = int(value)
                elif name == "kind":
                    kw["kind"] = value
                elif name == "match":
                    kw["match"] = value
                else:
                    raise ValueError(f"unknown directive {name!r}")
            except ValueError as e:
                raise ValueError(
                    f"fault clause {clause!r}: {e}") from None
        points.append(_FaultPoint(**kw))
    return points


# Armed state: the env layer (parsed again whenever the variable's value
# changes, counters reset with it) and the programmatic layer.
_env_raw: str | None = None
_env_points: list[_FaultPoint] = []
_prog_points: list[_FaultPoint] = []


def inject(point: str, *, once: bool = False, every: int | None = None,
           at: tuple[int, ...] = (), p: float | None = None, seed: int = 0,
           times: int | None = None, kind: str = "transient",
           match: str = "") -> _FaultPoint:
    """Arm one injection point programmatically (the grammar's knobs).
    Returns the armed point; disarm with :func:`clear` (everything) or
    :func:`injected` (scoped)."""
    fp = _FaultPoint(point, once=once, every=every, at=at, p=p, seed=seed,
                     times=times, kind=kind, match=match)
    _prog_points.append(fp)
    return fp


def clear() -> None:
    """Disarm every programmatic injection (the env layer follows the
    env variable)."""
    del _prog_points[:]


def reset() -> None:
    """Disarm everything and make the env layer parse again, with fresh
    counters, on the next :func:`check` (test setup and teardown)."""
    global _env_raw
    clear()
    _env_raw = None
    del _env_points[:]


@contextmanager
def injected(point: str, **kw):
    """Scope one programmatic injection to a block (armed on entry,
    disarmed on exit, also on failure)."""
    fp = inject(point, **kw)
    try:
        yield fp
    finally:
        try:
            _prog_points.remove(fp)
        except ValueError:
            pass  # a reset()/clear() inside the block already removed it


def _fire(fp: _FaultPoint) -> None:
    if _metrics._enabled:
        _metrics.inc("fault_injected", point=fp.point, kind=fp.kind)
    if tracing_enabled():
        # zero-length marker span: the fault's place on the timeline
        with add_trace(f"fault_injected[{fp.point}:{fp.kind}]"):
            pass
    raise InjectedFault(fp.point, fp.kind, fp.calls)


def check(point: str, label: str = "") -> None:
    """The injection hook, called by the hosting code at each point.
    Raises :class:`InjectedFault` when an armed clause fires, else
    returns. ``label`` is the site's context that ``match=`` filters on
    (the plan's executor, or its transport at ``exchange``)."""
    global _env_raw
    raw = os.environ.get("DFFT_FAULT_INJECT")
    if raw != _env_raw:
        _env_raw = raw
        _env_points[:] = parse_spec(raw) if raw else []
    if not _env_points and not _prog_points:
        return
    for fp in _env_points:
        if fp.point == point and fp.should_fire(label):
            _fire(fp)
    for fp in _prog_points:
        if fp.point == point and fp.should_fire(label):
            _fire(fp)


# --------------------------------------------------------- classification

#: Substrings of runtime-error messages that mark infrastructure blips
#: (the status families a sick transport surfaces): worth one bounded
#: retry, unlike a deterministic shape or launch error.
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
    "connection reset", "temporarily unavailable",
)

#: Substrings of a CUDA error raised by torch or by a kernel launcher
#: (``ops/_build.py:check``). Such an error is sticky: it poisons
#: the CUDA context, so a retry on the same context cannot succeed.
_CUDA_FAULT_MARKERS = (
    "CUDA error", "illegal memory access", "illegal address",
    "unspecified launch failure", "device-side assert",
)


#: Substrings of the error a failed kernel build raises
#: (``ops/_build.py``): the card's kernels are missing, so no retry or
#: fallback executor may stand in for them.
_BUILD_MARKERS = ("nvcc failed", "nvcc not found")


def kernel_fault(err: BaseException) -> bool:
    """True for a kernel that failed to build (``nvcc``) or to launch,
    and for any other CUDA fault (``torch.AcceleratorError`` or a
    message with a CUDA error marker). Such an error is neither retried
    nor served on a fallback executor: the kernels are missing, or the
    context is poisoned. An injected fault is never one."""
    if isinstance(err, InjectedFault):
        return False
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(err, accel):
        return True
    msg = str(err)
    return any(m in msg for m in _CUDA_FAULT_MARKERS + _BUILD_MARKERS)


def classify(err: BaseException) -> str:
    """``"transient"`` (a bounded retry may recover it) or
    ``"deterministic"`` (retrying reproduces it: isolate or degrade
    instead). Injected faults carry their own flag; the caching
    allocator's out-of-memory error, timeouts, connection errors and
    status-marked runtime errors are transient; a CUDA launch or
    illegal-address error and a failed kernel build are deterministic
    (:func:`kernel_fault`: never retried), as is everything else: shape
    errors reproduce on the same program and input."""
    if isinstance(err, InjectedFault):
        return "transient" if err.transient else "deterministic"
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return "transient"
    if isinstance(err, (TimeoutError, ConnectionError, InterruptedError)):
        return "transient"
    if kernel_fault(err):
        return "deterministic"
    if any(m in str(err) for m in _TRANSIENT_MARKERS):
        return "transient"
    return "deterministic"
