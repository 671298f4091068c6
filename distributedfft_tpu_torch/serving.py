"""Batched multi-request serving tier: async submit/await and coalescing.

The port of ``distributedfft_tpu/serving.py``. Everything below the plan
layer executes one transform at a time; a serving tier for heavy traffic
coalesces many independent same-shape FFTs into one batched plan call.
Five pieces:

1. :func:`submit` / :class:`Handle`: execute and await. CUDA launches
   are asynchronous, so ``submit(plan, x)`` returns once the work is
   launched; ``handle.result()`` waits on a CUDA event recorded after
   the last launch that produced the output.
2. :class:`CoalescingQueue`: groups pending requests by ``(shape,
   dtype, direction)`` (the tuple the wisdom store keys) and executes
   each group through one batched plan (``plan(batch=B)``): B transforms,
   one exchange per t2 stage. Plans come from the plan cache, so a
   steady queue never plans again.
3. :func:`warm_pool`: preplans the newest (shape, dtype, direction[,
   batch]) tuples of the wisdom store at startup (``tune="wisdom"``
   replays each stored winner with no timing execution).
4. **Fault tolerance**: with ``retry_max=`` / ``DFFT_RETRY_MAX`` a failed
   flush is classified (:func:`.faults.classify`) and recovered instead
   of failing every co-batched request: transient errors retry with
   bounded exponential backoff (``DFFT_RETRY_BACKOFF_S``), persistent
   failures rebuild the group on the degraded executor
   (``DFFT_FALLBACK_EXECUTOR``, default ``matmul``: :mod:`.ops.dft_matmul`
   shares no code with the CUDA kernels), and a batched flush that still
   fails *bisects*: each request runs again alone (with its own degraded
   fallback), so one poisoned buffer fails alone while its cohort
   completes. A kernel that fails to build or launch, or any other
   CUDA fault (:func:`.faults.kernel_fault`; a CUDA fault poisons the
   context), is neither retried nor rebuilt on the degraded executor:
   it fails every request of its group. Retries recover host-side and
   allocator faults. ``submit(..., deadline_s=T)`` cancels a request
   that waits past T with :class:`DeadlineExceeded`;
   ``max_pending`` / ``admission`` bound the queue's depth
   (:class:`QueueFull`).
5. **Multi-tenant QoS** (:mod:`.qos`): with a :class:`.qos.QosPolicy`
   (``policy=`` / ``DFFT_QOS``) every request belongs to a tenant
   (``submit(..., tenant=)``; groups then key per tenant) and the policy
   decides admission (token-bucket quotas), drain order (strict class,
   weighted-fair within a class, a starvation clock) and
   concurrent-wave placement. Without a policy the drain order is FIFO:
   oldest formed group first.

Throughput: every flush observes ``serving_batch_size`` and bumps
``serving_transforms``. Spans (with tracing on): ``serve_submit[<id>]``,
``serve_wait[<id>]`` (enqueue -> flush, recorded afterwards through
:func:`.utils.trace.record_span`), ``serve_flush[<kind>:b<B>:<reason>]``
around each group's ``serve_plan`` / ``serve_execute``,
``serve_result[<id>]``, and on recovery ``serve_retry[<tag>:a<N>]``,
``serve_degraded[<tag>:<executor>]``, ``serve_expire[<id>]``. Metrics:
``serving_queue_depth`` (gauge), ``serving_wait_seconds`` (histogram),
``serving_flush_reasons`` (``full`` | ``manual`` | ``result`` |
``deadline`` | ``stream``), ``serving_retries``,
``serving_isolated_failures``, ``serving_degraded``,
``serving_expired``, ``serving_rejected``.

Streams and threads: a flush launches on the flushing thread's current
stream; the streaming drain loop (:meth:`CoalescingQueue.serve`) runs on
its own thread, whose current stream is the default stream. A caller
that made a request's input on a side stream synchronises that stream
before ``submit``. The queue holds the caller's tensor (no copy) until
its group flushes: write it only after ``result()``. The queue serves a
loopback world (or one device); a world over a process group is
refused, since ranks that flush different groups would deadlock the
collective.
"""

from __future__ import annotations

import itertools
import os
import queue as _queuelib
import sys
import threading
import time
from contextlib import nullcontext
from typing import Any

import torch

from . import faults as _faults
from . import numerics as _numerics
from .api import FORWARD
from .ops.executors import Scale
from .parallel.mesh import World
from .qos import QosPolicy, QuotaExceeded
from .stagegraph import _ready_events
from .utils import metrics as _metrics
from .utils.trace import add_trace, record_span, tracing_enabled

__all__ = ["Handle", "submit", "CoalescingQueue", "warm_pool",
           "DeadlineExceeded", "QueueFull", "QuotaExceeded"]

#: Process-global request ids: the key of one request's submit, wait and
#: result spans across threads.
_REQ_IDS = itertools.count(1)

#: Default backoff base of the transient-retry loop (seconds; doubled
#: per attempt). ``DFFT_RETRY_BACKOFF_S`` / ``retry_backoff_s`` override.
DEFAULT_RETRY_BACKOFF_S = 0.05

#: Group keys carry the dtype by name, as the JAX package's do.
_DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


class DeadlineExceeded(TimeoutError):
    """A request's ``deadline_s`` elapsed before it executed. Carries
    the queue-wait breakdown: ``waited_s``, ``deadline_s`` and ``stage``
    (``"queued"``: expired while coalescing; ``"admission"``: never
    admitted past the bounded depth). The request never executed."""

    def __init__(self, *, waited_s: float, deadline_s: float,
                 stage: str = "queued"):
        super().__init__(
            f"request deadline of {deadline_s:g}s exceeded after "
            f"{waited_s:.3f}s in the {stage} stage (never executed)")
        self.waited_s = waited_s
        self.deadline_s = deadline_s
        self.stage = stage


class QueueFull(RuntimeError):
    """Admission rejected: the queue is at ``max_pending`` and was made
    with ``admission="raise"``."""


def _span(name: str, on: bool):
    """A live trace span when the recorder is on, else a no-op context."""
    return add_trace(name) if on else nullcontext()


def _wait_events(events) -> None:
    for ev in events:
        ev.synchronize()


class Handle:
    """Awaitable result of one submitted transform.

    A direct :func:`submit` handle is born resolved; a
    :class:`CoalescingQueue` handle stays pending until its group
    flushes (``result()`` flushes it when the caller outruns the
    coalescer). A resolved handle holds its output and the CUDA events
    recorded after the launches that produce it (none for a CPU output);
    ``result()`` synchronises on them. ``degraded`` is True when the
    result came from the executor-fallback chain."""

    __slots__ = ("_value", "_error", "_event", "_ready", "_queue",
                 "_req_id", "_enqueued", "_key", "degraded")

    def __init__(self, queue: "CoalescingQueue | None" = None):
        self._value: Any = None
        self._error: BaseException | None = None
        self._event = threading.Event()
        self._ready: tuple = ()
        self._queue = queue
        # the handle's own group key, so result() can flush just its
        # group (None for direct submits)
        self._key: tuple | None = None
        self.degraded = False
        # the request id of this handle's spans and its enqueue stamp
        # (perf_counter): None when nothing needed them at submit
        self._req_id: int | None = None
        self._enqueued: float | None = None

    @classmethod
    def _resolved(cls, value, ready=()) -> "Handle":
        h = cls()
        h._set(value, ready)
        return h

    def _set(self, value, ready=()) -> None:
        self._value = value
        self._ready = tuple(ready)
        self._queue = None
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._queue = None
        self._event.set()

    def done(self) -> bool:
        """True when the result (or failure) is attached and the card
        has finished producing it: ``result()`` will not block."""
        if not self._event.is_set():
            return False
        return self._error is not None or all(
            ev.query() for ev in self._ready)

    def result(self, timeout: float | None = None):
        """The transform's output, once the card has produced it.

        A pending queue handle first flushes its own group (the caller
        demanding a result is the coalescing deadline); ``timeout`` then
        bounds the wait for the flush, not the device. Raises the
        request's failure (retry-exhausted error,
        :class:`DeadlineExceeded`, ...) when the queue failed it."""
        rid = self._req_id
        with _span(f"serve_result[{rid}]",
                   rid is not None and tracing_enabled()):
            q = self._queue
            if not self._event.is_set() and q is not None:
                q.flush(self._key, reason="result")
                if not self._event.is_set() and self._queue is not None:
                    # Raced a concurrent submit/flush: another thread may
                    # hold this group popped mid-execution. Drain all.
                    q.flush(reason="result")
            if not self._event.wait(timeout):
                raise TimeoutError("submitted transform still pending")
            if self._error is not None:
                raise self._error
            _wait_events(self._ready)
            return self._value


def submit(plan, x, *, scale: Scale = Scale.NONE) -> Handle:
    """Execute ``plan`` on ``x`` asynchronously -> :class:`Handle`.

    Returns once the plan's work is launched (its host side done);
    ``handle.result()`` waits for the card. ``plan`` is any
    :class:`.api.Plan3D`; batched plans take the stacked ``[B, ...]``
    input."""
    from .api import execute

    if _metrics._enabled:
        _metrics.inc("serving_submits", kind="direct")
    tracing = tracing_enabled()
    rid = next(_REQ_IDS) if tracing else None
    with _span(f"serve_submit[{rid}]", tracing):
        y = execute(plan, x, scale=scale)
        h = Handle._resolved(y, _ready_events([y]))
    h._req_id = rid
    return h


class _Req:
    """One pending request of a coalescing group: the coerced tensor,
    its handle, the scale to apply, the owning tenant (QoS queues only)
    and, for deadline requests, the absolute expiry stamp
    (perf_counter)."""

    __slots__ = ("x", "handle", "scale", "expires", "deadline_s",
                 "tenant")

    def __init__(self, x, handle: Handle, scale: Scale,
                 expires: float | None = None,
                 deadline_s: float | None = None,
                 tenant: str | None = None):
        self.x = x
        self.handle = handle
        self.scale = scale
        self.expires = expires
        self.deadline_s = deadline_s
        self.tenant = tenant


def _quantile(sorted_vals: list, q: float) -> float | None:
    """Nearest-rank quantile over an already sorted sample list."""
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return float(sorted_vals[i])


class _WaveStats:
    """Wave-level occupancy accounting: dispatched waves and their
    widths, per-class admit-to-dispatch latency, the host's idle and
    busy seconds between waves, and preemptions. One wave is one
    dispatch cohort: a streaming loop iteration's admitted set, or one
    ``flush()``'s drained set.

    Armed by the streaming loop (:meth:`CoalescingQueue.serve`) and on a
    monitored queue; a queue without either carries None and takes no
    hook.

    Drain stamps come from a daemon *stamper* thread that synchronises
    each wave's CUDA events (recorded after the wave's last launch) in
    dispatch order; the dispatch path never blocks on the card. Idle is
    the gap between one wave's drain and the next wave's dispatch while
    nothing else was in flight."""

    _RESERVOIR = 2048

    def __init__(self, kind: str = "c2c"):
        self.kind = kind
        self._lock = threading.Lock()
        self.waves = 0
        self.preemptions = 0       # preemption events (waves that bumped)
        self.bumped_groups = 0
        self.bumped_transforms = 0
        self.idle_s = 0.0
        self.busy_s = 0.0
        self._widths: list[float] = []
        self._durations: list[float] = []    # dispatch -> drain, seconds
        self._periods: list[float] = []      # dispatch -> next dispatch
        self._admit: dict[str, list[float]] = {}  # class -> waits
        self._last_dispatch: float | None = None
        self._q: _queuelib.Queue = _queuelib.Queue()
        self._thread: threading.Thread | None = None

    def _push(self, vals: list, v: float) -> None:
        # Caller holds the lock. Bounded: drop the oldest half when full.
        if len(vals) >= self._RESERVOIR:
            del vals[:self._RESERVOIR // 2]
        vals.append(float(v))

    def note_wave(self, *, width: int, t_dispatch: float, outputs,
                  waits=()) -> None:
        """Record one dispatched wave. ``outputs`` are the wave's output
        tensors (an event is recorded after their launches for the
        stamper); ``waits`` is ``[(class, admit_to_dispatch_s), ...]``,
        one entry per request the wave admitted."""
        events = _ready_events(outputs)
        with self._lock:
            self.waves += 1
            self._push(self._widths, float(width))
            if self._last_dispatch is not None:
                self._push(self._periods,
                           max(0.0, t_dispatch - self._last_dispatch))
            self._last_dispatch = t_dispatch
            for klass, w in waits:
                self._push(self._admit.setdefault(klass or "none", []), w)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._stamper, name="dfft-wave-stamper",
                    daemon=True)
                self._thread.start()
        if _metrics._enabled:
            _metrics.inc("serving_waves", kind=self.kind)
            _metrics.observe("serving_wave_width", float(width),
                             kind=self.kind)
            for klass, w in waits:
                _metrics.observe("serving_wave_admit_seconds", w,
                                 kind=self.kind,
                                 tenant_class=klass or "none")
        self._q.put((t_dispatch, events))

    def note_preemption(self, groups: int, transforms: int) -> None:
        """Record one preemption event: ``groups`` bumped groups of
        ``transforms`` transforms in all."""
        with self._lock:
            self.preemptions += 1
            self.bumped_groups += int(groups)
            self.bumped_transforms += int(transforms)
        if _metrics._enabled:
            _metrics.inc("serving_wave_preemptions", kind=self.kind)
            _metrics.inc("serving_wave_bumped", float(transforms),
                         kind=self.kind)

    def _stamper(self) -> None:
        last_drain: float | None = None
        while True:
            item = self._q.get()
            if item is None:
                return
            t_dispatch, events = item
            try:
                _wait_events(events)
            except Exception:  # noqa: BLE001 -- a failed wave still
                pass           # closes its accounting interval
            t_drain = time.perf_counter()
            idle = busy = 0.0
            if last_drain is None or t_dispatch > last_drain:
                if last_drain is not None:
                    idle = t_dispatch - last_drain
                busy = max(0.0, t_drain - t_dispatch)
            else:
                busy = max(0.0, t_drain - last_drain)
            last_drain = max(t_drain, last_drain or t_drain)
            with self._lock:
                self.idle_s += idle
                self.busy_s += busy
                self._push(self._durations, max(0.0, t_drain - t_dispatch))
            if _metrics._enabled:
                if idle > 0:
                    _metrics.inc("serving_wave_idle_seconds", idle,
                                 kind=self.kind)
                if busy > 0:
                    _metrics.inc("serving_wave_busy_seconds", busy,
                                 kind=self.kind)

    def stop(self, timeout: float = 5.0) -> None:
        """Let the stamper thread exit once its queue drains, and wait
        up to ``timeout`` s for it (a later :meth:`note_wave` starts it
        again). Joined, it is not left inside a CUDA event wait when the
        interpreter exits: a daemon thread that returns from such a call
        during finalization aborts the process."""
        t = self._thread
        if t is None or not t.is_alive():
            return
        self._q.put(None)
        if t is not threading.current_thread():
            t.join(timeout)

    def snapshot(self) -> dict:
        """One JSON-ready occupancy document (a monitor sample's
        ``waves`` block)."""
        with self._lock:
            widths = sorted(self._widths)
            durs = sorted(self._durations)
            periods = sorted(self._periods)
            total = self.idle_s + self.busy_s
            admit = {}
            for klass, vals in self._admit.items():
                s = sorted(vals)
                admit[klass] = {
                    "n": len(s),
                    "p50_s": _quantile(s, 0.50),
                    "p99_s": _quantile(s, 0.99),
                    "max_s": s[-1] if s else None,
                }
            return {
                "waves": self.waves,
                "preemptions": self.preemptions,
                "bumped_groups": self.bumped_groups,
                "bumped_transforms": self.bumped_transforms,
                "width_mean": (sum(widths) / len(widths)
                               if widths else None),
                "width_max": widths[-1] if widths else None,
                "wave_duration_p50_s": _quantile(durs, 0.50),
                "wave_duration_max_s": durs[-1] if durs else None,
                "wave_period_p50_s": _quantile(periods, 0.50),
                "idle_s": self.idle_s,
                "busy_s": self.busy_s,
                "idle_fraction": (self.idle_s / total
                                  if total > 0 else None),
                "admit_wait": admit,
            }


def _env_int(name: str) -> int | None:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None


def _env_float(name: str) -> float | None:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None


class CoalescingQueue:
    """Request-coalescing front of the serving tier.

    ``submit(x)`` enqueues one transform of ``x``'s shape and returns a
    :class:`Handle`; pending requests with the same ``(shape, dtype,
    direction)`` are grouped and executed as one batched plan call when
    the group reaches ``max_batch`` (auto-flush), on ``flush()``, or when
    a handle's ``result()`` is awaited. Batched plans come from the plan
    cache, so each (tuple, B) pair is built once; :func:`warm_pool` (or
    ``queue.warm(...)``) preplans the hot tuples at startup.

    ``world`` is the planners' (None: one device; an int or a
    :class:`~.parallel.mesh.World` of a loopback world). A world over a
    process group raises ``ValueError``. ``plan_kw`` goes to every plan
    (``device="cpu"`` off the card; ``executor``, ``wire_dtype``, ...).

    ``kind``: ``"c2c"`` (default) or ``"r2c"`` (forward real input,
    ``r2c_axis=2``). ``donate`` lets batched flushes use the queue-owned
    stacked buffer as workspace (singletons never donate: the caller's
    tensor must survive). Thread-safe: submits and flushes serialize on
    one lock.

    ``max_wait_s`` is the coalescing deadline: a pending group whose
    oldest request ages past it is flushed at whatever size it reached
    (reason ``"deadline"``), by a daemon timer armed when the group
    forms. None (the default): groups wait for ``max_batch``, a
    ``flush()`` or a ``result()``.

    ``concurrent_groups`` (env ``DFFT_CONCURRENT_GROUPS``) arms the
    multi-group flush: a flush draining more than one group schedules up
    to this many groups on one world as one interleaved program
    (:func:`.stagegraph.schedule_concurrent`), equal to per-group flushes
    bit for bit. Groups whose plans have no stage graph (single device)
    or that fail to schedule take the per-group path, which owns the
    fault-tolerance chain. ``"auto"`` picks the width per flush from the
    measured width tournament when armed (``DFFT_WIDTH_TOURNAMENT``),
    else from :func:`.plan_logic.model_concurrent_seconds` over widths
    1..4, each plan priced with its executor's fused stages.

    ``policy`` (default: parsed from ``DFFT_QOS``; ``"off"`` forces the
    policy-free queue) arms the QoS tier (:mod:`.qos`).
    ``flush(limit=N)`` bounds one call to N transforms (the last group
    splits at the boundary).

    Robustness knobs (all off by default):

    - ``retry_max`` (env ``DFFT_RETRY_MAX``) arms the fault-tolerant
      dispatch: transient errors retry up to this many times with
      exponential backoff from ``retry_backoff_s`` (env
      ``DFFT_RETRY_BACKOFF_S``, default 0.05 s); persistent failures go
      through the degraded-executor rebuild and, for batched groups,
      per-request bisection; failures then surface only through the
      failed requests' handles. ``retry_max=0`` isolates and degrades
      with no retry.
    - ``fallback_executor`` (env ``DFFT_FALLBACK_EXECUTOR``, default
      ``"matmul"``; ``""``/``"0"``/``"none"`` disables) names the
      degraded executor; handles it resolved set ``handle.degraded``.
    - ``max_pending`` bounds the queued depth; ``admission`` picks the
      overload policy: ``"block"`` (default) parks ``submit`` until a
      flush frees space, ``"raise"`` sheds with :class:`QueueFull`.
    - ``submit(..., deadline_s=T)`` cancels the request with
      :class:`DeadlineExceeded` if it has not executed within T seconds.

    ``DFFT_SHADOW_RATE`` arms the numerics plane (:mod:`.numerics`),
    ``streaming=True`` / ``DFFT_SERVE_STREAMING=1`` the drain loop
    (:meth:`serve`), ``DFFT_MONITOR=interval[,path]`` /
    ``DFFT_MONITOR_DIR=dir`` a live sampler (:class:`.monitor.Monitor`),
    which :meth:`close` stops.
    """

    def __init__(
        self,
        world=None,
        *,
        kind: str = "c2c",
        max_batch: int = 8,
        donate: bool = False,
        max_wait_s: float | None = None,
        max_pending: int | None = None,
        admission: str = "block",
        retry_max: int | None = None,
        retry_backoff_s: float | None = None,
        fallback_executor: str | None = None,
        concurrent_groups: int | str | None = None,
        policy: "QosPolicy | str | None" = None,
        streaming: bool | None = None,
        **plan_kw,
    ):
        if kind not in ("c2c", "r2c"):
            raise ValueError(f"kind must be c2c|r2c, got {kind!r}")
        if isinstance(world, World) and not world.loopback:
            raise ValueError(
                "CoalescingQueue serves a loopback world or one device: on "
                "a world over a process group each rank would flush its "
                "own groups, and ranks flushing different groups deadlock "
                "the collective")
        if streaming is None:
            streaming = os.environ.get(
                "DFFT_SERVE_STREAMING", "").strip() not in ("", "0")
        if concurrent_groups is None:
            raw = os.environ.get("DFFT_CONCURRENT_GROUPS", "").strip()
            concurrent_groups = ("auto" if raw == "auto"
                                 else _env_int("DFFT_CONCURRENT_GROUPS"))
        if concurrent_groups is not None and concurrent_groups != "auto" \
                and (isinstance(concurrent_groups, bool)
                     or not isinstance(concurrent_groups, int)
                     or concurrent_groups < 1):
            raise ValueError(f"concurrent_groups must be an int >= 1, "
                             f"'auto', or None, got {concurrent_groups!r}")
        if policy is None:
            policy = QosPolicy.from_env()
        elif policy == "off" or policy is False:
            policy = None
        elif not isinstance(policy, QosPolicy):
            raise ValueError(f"policy must be a QosPolicy, 'off', or "
                             f"None, got {policy!r}")
        if not isinstance(max_batch, int) or max_batch < 1:
            raise ValueError(f"max_batch must be an int >= 1, "
                             f"got {max_batch!r}")
        if max_wait_s is not None and (
                isinstance(max_wait_s, bool)
                or not isinstance(max_wait_s, (int, float))
                or not max_wait_s > 0):
            raise ValueError(f"max_wait_s must be a positive number or "
                             f"None, got {max_wait_s!r}")
        if max_pending is not None and (
                isinstance(max_pending, bool)
                or not isinstance(max_pending, int) or max_pending < 1):
            raise ValueError(f"max_pending must be an int >= 1 or None, "
                             f"got {max_pending!r}")
        if admission not in ("block", "raise"):
            raise ValueError(f"admission must be block|raise, "
                             f"got {admission!r}")
        if retry_max is None:
            retry_max = _env_int("DFFT_RETRY_MAX")
        if retry_max is not None and (
                isinstance(retry_max, bool)
                or not isinstance(retry_max, int) or retry_max < 0):
            raise ValueError(f"retry_max must be an int >= 0 or None, "
                             f"got {retry_max!r}")
        if retry_backoff_s is None:
            retry_backoff_s = _env_float("DFFT_RETRY_BACKOFF_S")
        if retry_backoff_s is None:
            retry_backoff_s = DEFAULT_RETRY_BACKOFF_S
        if (isinstance(retry_backoff_s, bool)
                or not isinstance(retry_backoff_s, (int, float))
                or retry_backoff_s < 0):
            raise ValueError(f"retry_backoff_s must be a number >= 0, "
                             f"got {retry_backoff_s!r}")
        if fallback_executor is None:
            fallback_executor = os.environ.get(
                "DFFT_FALLBACK_EXECUTOR", "matmul")
        fallback_executor = fallback_executor.strip()
        if fallback_executor in ("", "0", "none"):
            fallback_executor = ""
        for bad in ("batch", "donate", "in_spec", "out_spec"):
            if bad in plan_kw:
                raise ValueError(f"{bad!r} is owned by the queue; do not "
                                 f"pass it in plan_kw")
        self.world = world
        self.kind = kind
        self.max_batch = max_batch
        self.donate = bool(donate)
        self.max_wait_s = None if max_wait_s is None else float(max_wait_s)
        self.max_pending = max_pending
        self.admission = admission
        self._retry_max = retry_max          # None = one try, no recovery
        self._retry_backoff = float(retry_backoff_s)
        self._fallback_executor = fallback_executor
        self.concurrent_groups = concurrent_groups
        self.policy = policy
        self.plan_kw = dict(plan_kw)
        self._lock = threading.RLock()
        # admission waiters park here; notified whenever a flush or an
        # expiry frees depth
        self._space = threading.Condition(self._lock)
        # (shape, dtype name, direction[, tenant]) -> list of _Req (the
        # tenant element only on QoS queues)
        self._pending: dict[tuple, list[_Req]] = {}
        # group-formation stamps: key -> (sequence, perf_counter). The
        # sequence is the policy-free FIFO drain order; the stamp feeds
        # the QoS starvation clock. Popped with the group.
        self._order = itertools.count()
        self._formed: dict[tuple, tuple[int, float]] = {}
        # concurrent_groups="auto": the width per plan tuple
        self._auto_widths: dict[tuple, int] = {}
        # flush-progress sequence, bumped whenever a flush pops groups
        # (a live monitor's stall watchdog compares it across samples)
        self._flush_seq = 0
        # DFFT_MONITOR=interval[,path] or DFFT_MONITOR_DIR=dir arms a
        # live sampler (:mod:`.monitor`; the directory names its series
        # monitor-<host>-<pid>.jsonl). Both unset: no monitor, no hook.
        self._monitor = None
        # DFFT_SHADOW_RATE=p[,seed]: shadow audits against a memoized
        # exact reference plan and non-finite sentinels; unset, None,
        # and the serving path takes no numerics branch
        self._numerics = _numerics.NumericsPlane.from_env()
        # plan-tuple key[:3] -> exact reference plan (None when it cannot
        # build: that tuple's audits count as failures)
        self._shadow_plans: dict[tuple, Any] = {}
        # streaming drain-loop state: serve()/stop() manage the loop;
        # _arrival wakes it (set by submit only while streaming);
        # _wave_stats carries the occupancy accounting (also armed, in
        # flush mode, on a monitored queue, so the idle-fraction
        # baseline exists)
        self._streaming = False
        self._serve_thread: threading.Thread | None = None
        self._serve_stop = threading.Event()
        self._drain_on_stop = True
        self._arrival = threading.Event()
        self._wave_stats: _WaveStats | None = None
        if (os.environ.get("DFFT_MONITOR", "").strip() not in ("", "0")
                or os.environ.get("DFFT_MONITOR_DIR", "").strip()):
            from .monitor import Monitor

            self._monitor = Monitor.from_env(self)
            if self._monitor is not None:
                self._monitor.start()
        if self._monitor is not None:
            self._wave_stats = _WaveStats(self.kind)
        if streaming:
            self.serve()

    # ------------------------------------------------------------ intake

    def _planner(self):
        from . import api

        return (api.plan_dft_r2c_3d if self.kind == "r2c"
                else api.plan_dft_c2c_3d)

    def _plan(self, key: tuple, batch: int | None, donate: bool,
              executor: str | None = None):
        # QoS keys carry the tenant as a 4th element; the plan is the
        # first three's (tenancy never changes what a plan computes)
        shape, dtype, direction = key[:3]
        kw = dict(self.plan_kw, direction=direction, batch=batch,
                  donate=donate)
        if executor is not None:
            kw["executor"] = executor  # the degraded-mode rebuild
        if dtype is not None:
            kw["dtype"] = _DTYPES.get(dtype, dtype)
        return self._planner()(shape, self.world, **kw)

    def _admit(self, deadline_s: float | None) -> None:
        """Bounded-depth admission gate (caller holds the queue lock;
        ``Condition.wait`` releases it while parked). ``"raise"`` sheds
        at once; ``"block"`` parks until a flush or expiry frees depth,
        bounded by the request's ``deadline_s``."""
        if self.max_pending is None:
            return
        start = time.perf_counter()
        while (sum(len(g) for g in self._pending.values())
               >= self.max_pending):
            if self.admission == "raise":
                if _metrics._enabled:
                    _metrics.inc("serving_rejected", kind=self.kind)
                raise QueueFull(
                    f"queue depth is at max_pending={self.max_pending} "
                    f"(admission='raise'); shed or await pending results")
            timeout = None
            if deadline_s is not None:
                timeout = deadline_s - (time.perf_counter() - start)
                if timeout <= 0:
                    if _metrics._enabled:
                        _metrics.inc("serving_rejected", kind=self.kind)
                    raise DeadlineExceeded(
                        waited_s=time.perf_counter() - start,
                        deadline_s=deadline_s, stage="admission")
            self._space.wait(timeout)

    def _quota_admit(self, tenant: str, deadline_s: float | None) -> None:
        """Token-bucket admission of one QoS submit (outside the queue
        lock: a quota park must not block peers). ``"raise"`` sheds with
        :class:`.qos.QuotaExceeded`; ``"block"`` parks until the bucket
        covers it, bounded by the request's deadline (overrun:
        :class:`DeadlineExceeded`, ``stage="admission"``, the tenant's
        deadline miss)."""
        pol = self.policy
        start = time.perf_counter()
        while True:
            wait = pol.admit(tenant)
            if wait <= 0:
                return
            if self.admission == "raise":
                if _metrics._enabled:
                    _metrics.inc("serving_rejected", kind=self.kind)
                    _metrics.inc("serving_tenant_quota_shed",
                                 kind=self.kind, tenant=tenant)
                pol.note_shed(tenant)
                raise QuotaExceeded(tenant, wait)
            if deadline_s is not None:
                waited = time.perf_counter() - start
                if waited + wait > deadline_s:
                    if _metrics._enabled:
                        _metrics.inc("serving_rejected", kind=self.kind)
                        _metrics.inc("serving_tenant_deadline_misses",
                                     kind=self.kind, tenant=tenant)
                    pol.note_miss(tenant)
                    raise DeadlineExceeded(
                        waited_s=waited, deadline_s=deadline_s,
                        stage="admission")
            time.sleep(wait)

    def submit(self, x, *, direction: int = FORWARD,
               scale: Scale = Scale.NONE,
               deadline_s: float | None = None,
               tenant: str | None = None) -> Handle:
        """Enqueue one transform of ``x`` (the plan's unbatched input: the
        3D world for c2c and forward r2c). Returns at once; the group
        executes at ``max_batch``, on :meth:`flush`, or on ``result()``.
        ``x`` becomes a tensor of the plan's input dtype on its device.

        ``deadline_s`` bounds this request's queue time: a request that
        has not begun executing within it is cancelled (its handle
        raises :class:`DeadlineExceeded`) while its group's survivors
        stay queued.

        ``tenant`` names the request's owner. With a
        :class:`.qos.QosPolicy` it must be registered (None is the
        implicit ``default`` tenant); without one it is an accounting
        label only."""
        if deadline_s is not None and (
                isinstance(deadline_s, bool)
                or not isinstance(deadline_s, (int, float))
                or not deadline_s > 0):
            raise ValueError(f"deadline_s must be a positive number or "
                             f"None, got {deadline_s!r}")
        if tenant is not None and not isinstance(tenant, str):
            raise ValueError(f"tenant must be a string or None, "
                             f"got {tenant!r}")
        pol = self.policy
        tname = tenant
        if pol is not None:
            tname = pol.resolve(tenant).name
            pol.note_submit(tname)
        tracing = tracing_enabled()
        recording = tracing or _metrics._enabled
        rid = next(_REQ_IDS) if recording else None
        ttag = f":tenant={tname}" if tname is not None else ""
        with _span(f"serve_submit[{rid}{ttag}]", tracing):
            shape, dtype, x = self._coerce(x, direction)
            key = (shape, dtype, direction)
            if pol is not None:
                key = key + (tname,)
                self._quota_admit(tname, deadline_s)
            handle = Handle(queue=self)
            handle._key = key
            if recording:
                handle._req_id = rid
                handle._enqueued = time.perf_counter()
            if _metrics._enabled:
                _metrics.inc("serving_submits", kind=self.kind)
                if tname is not None:
                    _metrics.inc("serving_tenant_submits",
                                 kind=self.kind, tenant=tname)
            with self._lock:
                self._admit(deadline_s)
                group = self._pending.setdefault(key, [])
                first = not group
                if first:
                    self._formed[key] = (next(self._order),
                                         time.perf_counter())
                req = _Req(x, handle, scale, tenant=tname)
                if handle._enqueued is None and (
                        self._streaming or pol is not None
                        or deadline_s is not None
                        or self.max_wait_s is not None):
                    # the wave, QoS, deadline and coalescing clocks need
                    # the enqueue stamp with the recorder off
                    handle._enqueued = time.perf_counter()
                if deadline_s is not None:
                    req.deadline_s = float(deadline_s)
                    req.expires = handle._enqueued + req.deadline_s
                    t = threading.Timer(req.deadline_s, self._expire,
                                        (key,))
                    t.daemon = True
                    t.start()
                group.append(req)
                full = len(group) >= self.max_batch
                if self._streaming:
                    # the drain loop owns all dispatch while streaming:
                    # wake it instead of flushing from the submit thread
                    full = False
                    self._arrival.set()
                if self.max_wait_s is not None and first and not full:
                    t = threading.Timer(self.max_wait_s,
                                        self._deadline_flush, (key,))
                    t.daemon = True
                    t.start()
                if _metrics._enabled:
                    _metrics.set_gauge(
                        "serving_queue_depth",
                        float(sum(len(g) for g in self._pending.values())),
                        kind=self.kind)
        if full:
            self.flush(key, reason="full")
        return handle

    def _deadline_flush(self, key: tuple) -> None:
        """Timer callback of ``max_wait_s``: flush ``key``'s group iff its
        oldest request has aged past the deadline (a group that already
        flushed and formed again armed its own timer)."""
        with self._lock:
            group = self._pending.get(key)
            if not group:
                return
            oldest = group[0].handle._enqueued
            if oldest is None or (time.perf_counter() - oldest
                                  < self.max_wait_s * 0.999):
                return
        self.flush(key, reason="deadline")

    def _fail_expired(self, req: _Req, now: float) -> None:
        """Cancel one expired request: :class:`DeadlineExceeded` onto its
        handle, a ``serve_expire`` span, the ``serving_expired``
        counter."""
        waited = (now - req.handle._enqueued
                  if req.handle._enqueued is not None else 0.0)
        if _metrics._enabled:
            _metrics.inc("serving_expired", kind=self.kind)
            if req.tenant is not None:
                _metrics.inc("serving_tenant_deadline_misses",
                             kind=self.kind, tenant=req.tenant)
        if self.policy is not None and req.tenant is not None:
            self.policy.note_miss(req.tenant)
        if (tracing_enabled() and req.handle._req_id is not None
                and req.handle._enqueued is not None):
            record_span(f"serve_expire[{req.handle._req_id}]",
                        req.handle._enqueued, now)
        req.handle._fail(DeadlineExceeded(
            waited_s=waited, deadline_s=req.deadline_s or 0.0,
            stage="queued"))

    def _expire(self, key: tuple) -> None:
        """Deadline timer callback: cancel every expired request of
        ``key``'s group; survivors stay queued."""
        now = time.perf_counter()
        with self._lock:
            group = self._pending.get(key)
            if not group:
                return
            live = [r for r in group
                    if r.expires is None or r.expires > now]
            if len(live) == len(group):
                return
            expired = [r for r in group if r not in live]
            if live:
                self._pending[key] = live
            else:
                self._pending.pop(key, None)
                self._formed.pop(key, None)
            for r in expired:
                self._fail_expired(r, now)
            if _metrics._enabled:
                _metrics.set_gauge(
                    "serving_queue_depth",
                    float(sum(len(g) for g in self._pending.values())),
                    kind=self.kind)
            self._space.notify_all()

    def _coerce(self, x, direction: int):
        """Validate and convert one request against the plan family's
        unbatched input; returns (world shape, dtype name, tensor)."""
        shape = tuple(x.shape) if hasattr(x, "shape") else tuple(
            torch.as_tensor(x).shape)
        plan0 = self._plan_for_probe(shape, direction)
        x = torch.as_tensor(x).to(device=plan0.device, dtype=plan0.in_dtype)
        if tuple(x.shape) != tuple(plan0.in_shape):
            raise ValueError(
                f"queue expects the unbatched plan input shape "
                f"{plan0.in_shape}, got {tuple(x.shape)}")
        return plan0.shape, _dtype_name(plan0.dtype), x

    def _plan_for_probe(self, in_shape, direction: int):
        """The unbatched plan for a request of ``in_shape`` (from the
        plan cache)."""
        if len(in_shape) != 3:
            raise ValueError(
                f"submit takes one unbatched 3D input, got {in_shape}")
        shape = tuple(int(s) for s in in_shape)
        if self.kind == "r2c" and direction != FORWARD:
            # a half-spectrum input [n0, n1, n2h] leaves n2 ambiguous
            # (2*(n2h-1) or 2*n2h-1)
            raise ValueError(
                "backward r2c coalescing needs the real-space world "
                "shape; use CoalescingQueue(kind='r2c') for forward "
                "only, or submit(plan, x) with an explicit c2r plan")
        return self._plan((shape, self.plan_kw.get("dtype"), direction),
                          None, False)

    # ------------------------------------------------------------- flush

    def pending(self) -> int:
        """Number of requests waiting to be coalesced."""
        with self._lock:
            return sum(len(g) for g in self._pending.values())

    def _tenant_of(self, key: tuple) -> str | None:
        """The owning tenant of a group key; None without a policy."""
        return key[3] if len(key) > 3 else None

    def _drain_order(self, now: float) -> list[tuple]:
        """Pending group keys in drain order (caller holds the lock):
        FIFO by formation without a policy; with one, strict class >
        weighted-fair within a class > starvation promotion
        (:meth:`.qos.QosPolicy.order_groups`)."""
        keys = [k for k, g in self._pending.items() if g]
        if self.policy is None:
            return sorted(keys,
                          key=lambda k: self._formed.get(k, (0, 0.0))[0])
        infos = []
        for k in keys:
            g = self._pending[k]
            _, t0 = self._formed.get(k, (0, now))
            oldest = min((r.handle._enqueued for r in g
                          if r.handle._enqueued is not None), default=t0)
            infos.append({"key": k, "tenant": self._tenant_of(k),
                          "n": len(g), "age_s": max(0.0, now - oldest)})
        ordered = self.policy.order_groups(infos,
                                           max_wait_s=self.max_wait_s)
        return [i["key"] for i in ordered]

    def _concurrent_chunks(self, groups: list, ncc: int) -> list:
        """Partition drained groups into the cohorts one concurrent
        dispatch merges: runs of ``ncc`` without a policy; with one,
        class-compatible runs (:meth:`.qos.QosPolicy.concurrent_chunks`)."""
        if self.policy is None:
            return [groups[i:i + ncc]
                    for i in range(0, len(groups), ncc)]
        by_key = {k: g for k, g in groups}
        infos = [{"key": k, "tenant": self._tenant_of(k), "n": len(g)}
                 for k, g in groups]
        return [[(i["key"], by_key[i["key"]]) for i in chunk]
                for chunk in self.policy.concurrent_chunks(infos, ncc)]

    def flush(self, key: tuple | None = None, *,
              reason: str = "manual", limit: int | None = None) -> int:
        """Execute pending groups (or just ``key``'s) as batched plan
        calls; returns the number of transforms dispatched. ``reason``
        tags the spans and metrics: ``full``, ``manual``, ``result`` or
        ``deadline``. ``limit`` bounds this call to that many transforms
        (groups in drain order, the last one split at the boundary, its
        remainder queued under its formation stamp). With the retry
        machinery armed, errors surface only through the failed
        requests' handles; without it a failed group fails every handle
        and raises."""
        if limit is not None and (
                isinstance(limit, bool) or not isinstance(limit, int)
                or limit < 1):
            raise ValueError(f"limit must be an int >= 1 or None, "
                             f"got {limit!r}")
        done = 0
        recording = tracing_enabled() or _metrics._enabled
        flushed_at = (time.perf_counter()
                      if recording or self.policy is not None
                      or self._wave_stats is not None else 0.0)
        with self._lock:
            keys = ([key] if key is not None
                    else self._drain_order(flushed_at))
            groups = []
            budget = limit
            for k in keys:
                g = self._pending.get(k)
                if not g:
                    continue
                if budget is not None and len(g) > budget:
                    self._pending[k] = g[budget:]
                    groups.append((k, g[:budget]))
                    budget = 0
                    break
                self._pending.pop(k)
                self._formed.pop(k, None)
                groups.append((k, g))
                if budget is not None:
                    budget -= len(g)
                    if budget <= 0:
                        break
            if groups:
                self._flush_seq += 1  # stall-watchdog progress marker
                self._space.notify_all()  # admission waiters: depth fell
            ncc = self._concurrent_width(groups)
            if ncc > 1 and len(groups) > 1:
                for chunk in self._concurrent_chunks(groups, ncc):
                    done += self._execute_concurrent(
                        chunk, reason=reason, flushed_at=flushed_at)
            else:
                for k, group in groups:
                    done += self._execute_group(k, group, reason=reason,
                                                flushed_at=flushed_at)
            ws = self._wave_stats
            if ws is not None and groups:
                # one flush cohort is one wave
                outs = [r.handle._value for _, g in groups for r in g
                        if r.handle._event.is_set()
                        and r.handle._error is None]
                ws.note_wave(width=len(groups), t_dispatch=flushed_at,
                             outputs=outs,
                             waits=self._admit_waits(groups, flushed_at))
            if recording and _metrics._enabled and groups:
                _metrics.set_gauge(
                    "serving_queue_depth",
                    float(sum(len(g) for g in self._pending.values())),
                    kind=self.kind)
        return done

    def _concurrent_width(self, groups: list) -> int:
        """The concurrent-flush width: the configured int, or under
        ``"auto"`` the width in 1..4 with the highest transforms/s, from
        the measured width tournament when it is armed, else priced by
        :func:`.plan_logic.model_concurrent_seconds` with each plan's
        executor. Plans without a stage graph or logic skeleton, and any
        failure of the model, give 1; widths are memoized per plan
        tuple."""
        ncc = self.concurrent_groups
        if ncc is None:
            return 1
        if ncc != "auto":
            return ncc
        if len(groups) < 2:
            return 1
        try:
            plans, counts = [], []
            for k, g in groups[:4]:
                p = self._plan(k, len(g) if len(g) > 1 else None, False)
                if p.graph is None or p.logic is None:
                    return 1
                plans.append(p)
                counts.append(len(g))
            memo_key = tuple(id(p) for p in plans)
            hit = self._auto_widths.get(memo_key)
            if hit is not None:
                return hit
            from .tuner import tune_concurrent_width

            measured = tune_concurrent_width(plans, counts)
            if measured is not None:
                if len(self._auto_widths) >= 64:
                    self._auto_widths.pop(next(iter(self._auto_widths)))
                self._auto_widths[memo_key] = measured
                return measured
            from .calibrate import model_correction
            from .explain import _model_shape_itemsize, device_profile
            from .plan_logic import model_concurrent_seconds

            hw = device_profile()
            transforms = []
            for p in plans:
                shape, itemsize = _model_shape_itemsize(p)
                transforms.append((p.logic, shape, itemsize, p.executor))
            hide_corr = model_correction("concurrent_hide")
            best_w, best_rate = 1, -1.0
            for w in range(1, len(plans) + 1):
                m = model_concurrent_seconds(
                    transforms[:w], hbm_gbps=hw["hbm_gbps"],
                    wire_gbps=hw["wire_gbps"],
                    launch_seconds=hw["launch_seconds"],
                    dcn_gbps=hw.get("dcn_gbps"),
                    hide_correction=hide_corr)
                secs = m["concurrent_seconds"]
                rate = sum(counts[:w]) / secs if secs > 0 else 0.0
                if rate > best_rate:
                    best_w, best_rate = w, rate
            if len(self._auto_widths) >= 64:
                self._auto_widths.pop(next(iter(self._auto_widths)))
            self._auto_widths[memo_key] = best_w
            return best_w
        except Exception:  # noqa: BLE001 -- the model must never block
            return 1       # a drain; sequential is always correct

    def _live(self, group: list) -> list:
        """Fail every request of a popped group whose deadline passed
        while it waited; return the survivors."""
        now = time.perf_counter()
        live = []
        for r in group:
            if r.expires is not None and r.expires <= now:
                self._fail_expired(r, now)
            else:
                live.append(r)
        return live

    def _note_waits(self, group: list, flushed_at: float,
                    tracing: bool) -> None:
        """Close every request's queue-wait interval (enqueue -> flush):
        the ``serve_wait`` span, the wait histograms and the policy's
        SLO ledger."""
        pol = self.policy
        for r in group:
            if r.handle._enqueued is None:
                continue
            wait = max(0.0, flushed_at - r.handle._enqueued)
            if tracing and r.handle._req_id is not None:
                record_span(f"serve_wait[{r.handle._req_id}]",
                            r.handle._enqueued, flushed_at)
            if _metrics._enabled:
                _metrics.observe("serving_wait_seconds", wait,
                                 kind=self.kind)
                if r.tenant is not None:
                    _metrics.observe("serving_tenant_wait_seconds", wait,
                                     kind=self.kind, tenant=r.tenant)
            if pol is not None and r.tenant is not None:
                pol.note_wait(r.tenant, wait)

    def _admit_waits(self, groups: list, now: float) -> list:
        """Per-request admit-to-dispatch intervals of one wave as
        ``[(tenant class, seconds), ...]``; requests without an enqueue
        stamp give nothing."""
        pol = self.policy
        waits = []
        for k, g in groups:
            klass = None
            if pol is not None:
                try:
                    klass = pol.resolve(self._tenant_of(k)).klass
                except Exception:  # noqa: BLE001 -- unregistered tenant
                    klass = None
            for r in g:
                if r.handle._enqueued is not None:
                    waits.append((klass,
                                  max(0.0, now - r.handle._enqueued)))
        return waits

    def _execute_concurrent(self, chunk: list, *, reason: str,
                            flushed_at: float) -> int:
        """Execute popped groups as one interleaved program
        (:func:`.stagegraph.schedule_concurrent`), each group through its
        (batched) plan. Falls back to per-group execution, which owns
        the fault-tolerance chain, whenever the chunk cannot be scheduled
        or its execution fails (no handle is touched before success).
        Concurrent dispatch never donates. A loopback plan takes the
        global stack, so no input is placed by layout."""
        live_groups = [(k, self._live(g)) for k, g in chunk]
        live_groups = [(k, g) for k, g in live_groups if g]

        def sequential() -> int:
            return sum(self._execute_group(k, g, reason=reason,
                                           flushed_at=flushed_at)
                       for k, g in live_groups)

        if len(live_groups) < 2:
            return sequential()
        tracing = tracing_enabled()
        try:
            from .stagegraph import schedule_concurrent

            plans = [self._plan(k, len(g) if len(g) > 1 else None, False)
                     for k, g in live_groups]
            if any(p.graph is None for p in plans):
                return sequential()
            cp = schedule_concurrent(plans)
        except Exception:  # noqa: BLE001 -- per-group path owns failures
            return sequential()
        for _, g in live_groups:
            self._note_waits(g, flushed_at, tracing)
        inputs = [g[0].x if len(g) == 1 else torch.stack([r.x for r in g])
                  for _, g in live_groups]
        b_total = sum(len(g) for _, g in live_groups)
        tnames = [self._tenant_of(k) for k, _ in live_groups]
        ttag = ("" if all(t is None for t in tnames) else
                ":tenants=" + "+".join(t or "-" for t in tnames))
        tag = f"{self.kind}:g{len(live_groups)}:b{b_total}:{reason}{ttag}"
        try:
            with _span(f"serve_flush[concurrent:{tag}]", tracing):
                ys = cp(*inputs)
        except Exception:  # noqa: BLE001 -- no handle touched yet: the
            return sequential()  # per-group path runs with its own chain
        from .ops.executors import apply_scale

        g_outs = []
        for plan, y, (_, g) in zip(plans, ys, live_groups):
            outs = []
            for i, r in enumerate(g):
                out = y if len(g) == 1 else y[i]
                if r.scale != Scale.NONE:
                    out = apply_scale(out, r.scale, plan.world_size)
                outs.append(out)
            g_outs.append(outs)
        if self._numerics is not None:
            # sentinel sweep before any handle resolves; the per-group
            # fallback owns the quarantine chain
            try:
                for (_, g), outs in zip(live_groups, g_outs):
                    self._guard_nonfinite(g, outs, tag, tracing)
            except _numerics.NonFiniteResult:
                return sequential()
        ready = _ready_events([o for outs in g_outs for o in outs])
        for plan, (k, g), outs in zip(plans, live_groups, g_outs):
            gt = self._tenant_of(k)
            for r, out in zip(g, outs):
                r.handle._set(out, ready)
            if _metrics._enabled:
                _metrics.inc("serving_flushes", kind=self.kind)
                _metrics.inc("serving_flush_reasons", kind=self.kind,
                             reason=reason)
                _metrics.inc("serving_transforms", float(len(g)),
                             kind=self.kind)
                _metrics.observe("serving_batch_size", float(len(g)),
                                 kind=self.kind)
                if gt is not None:
                    _metrics.inc("serving_tenant_transforms",
                                 float(len(g)), kind=self.kind,
                                 tenant=gt)
            if self.policy is not None and gt is not None:
                self.policy.account_drain(gt, len(g))
        if _metrics._enabled:
            _metrics.inc("serving_concurrent_dispatches", kind=self.kind)
            _metrics.inc("serving_concurrent_transforms", float(b_total),
                         kind=self.kind)
            _metrics.observe("serving_concurrent_groups",
                             float(len(live_groups)), kind=self.kind)
        if self._numerics is not None:
            for plan, (k, g), outs in zip(plans, live_groups, g_outs):
                self._shadow_audit(k, plan, g, outs, tag, tracing)
        return b_total

    def _execute_group(self, key: tuple, group: list, *,
                       reason: str = "manual",
                       flushed_at: float = 0.0) -> int:
        group = self._live(group)
        if not group:
            return 0
        b = len(group)
        tname = self._tenant_of(key)
        tracing = tracing_enabled()
        tag = (f"{self.kind}:b{b}:{reason}"
               + (f":tenant={tname}" if tname is not None else ""))
        if tracing or _metrics._enabled or self.policy is not None:
            self._note_waits(group, flushed_at, tracing)
        if self._retry_max is None:
            # one try: a failure fails every co-batched handle and
            # raises (no classification, no recovery)
            try:
                with _span(f"serve_flush[{tag}]", tracing):
                    self._run_group(key, group, tag, tracing)
            except Exception as e:  # noqa: BLE001 -- fail the handles
                for r in group:
                    r.handle._fail(e)
                raise
        else:
            with _span(f"serve_flush[{tag}]", tracing):
                self._dispatch_ft(key, group, tag, tracing)
        if _metrics._enabled:
            _metrics.inc("serving_flushes", kind=self.kind)
            _metrics.inc("serving_flush_reasons", kind=self.kind,
                         reason=reason)
            _metrics.inc("serving_transforms", float(b), kind=self.kind)
            _metrics.observe("serving_batch_size", float(b), kind=self.kind)
            if tname is not None:
                _metrics.inc("serving_tenant_transforms", float(b),
                             kind=self.kind, tenant=tname)
        if self.policy is not None and tname is not None:
            self.policy.account_drain(tname, b)
        return b

    def _run_group(self, key: tuple, group: list, tag: str, tracing: bool,
                   *, executor: str | None = None):
        """One execution attempt of ``group`` (a singleton directly, more
        through a ``batch=B`` plan). Resolves every handle on success,
        each with a CUDA event recorded after the group's last launch,
        and returns the plan used; on failure raises with no handle
        touched. ``executor`` overrides the queue's (the degraded
        rebuild)."""
        from .api import execute
        from .ops.executors import apply_scale

        if len(group) == 1:
            r = group[0]
            with _span(f"serve_plan[{tag}]", tracing):
                plan = self._plan(key, None, False, executor=executor)
            with _span(f"serve_execute[{tag}]", tracing):
                out = execute(plan, r.x, scale=r.scale)
                if self._numerics is not None:
                    self._guard_nonfinite(group, [out], tag, tracing)
                if executor is not None:
                    r.handle.degraded = True
                r.handle._set(out, _ready_events([out]))
            if self._numerics is not None and executor is None:
                self._shadow_audit(key, plan, group, [out], tag,
                                   tracing)
            return plan
        with _span(f"serve_plan[{tag}]", tracing):
            plan = self._plan(key, len(group), self.donate,
                              executor=executor)
        stacked = torch.stack([r.x for r in group])
        with _span(f"serve_execute[{tag}]", tracing):
            y = plan(stacked)
            outs = []
            for i, r in enumerate(group):
                out = y[i]
                if r.scale != Scale.NONE:
                    out = apply_scale(out, r.scale, plan.world_size)
                outs.append(out)
            if self._numerics is not None:
                self._guard_nonfinite(group, outs, tag, tracing)
            ready = _ready_events(outs)
            for r, out in zip(group, outs):
                if executor is not None:
                    r.handle.degraded = True
                r.handle._set(out, ready)
        if self._numerics is not None and executor is None:
            self._shadow_audit(key, plan, group, outs, tag, tracing)
        return plan

    # --------------------------------------------------- numerics plane

    def _guard_nonfinite(self, group: list, outs: list, tag: str,
                         tracing: bool) -> None:
        """Non-finite sentinel at the output boundary (armed queues
        only). The input is checked first: a non-finite input is counted
        (``numerics_nonfinite{site=input}``) and its output delivered as
        it is, never retried. A non-finite output from a finite input
        raises :class:`.numerics.NonFiniteResult` before any handle
        resolves, so the fault chain quarantines that request while its
        finite cohort completes."""
        for r, out in zip(group, outs):
            ikind = _numerics.nonfinite_kind(r.x)
            if ikind is not None:
                with _span("numerics_nonfinite[input]", tracing):
                    _numerics.record_nonfinite("input", ikind)
                continue
            okind = _numerics.nonfinite_kind(out)
            if okind is not None:
                with _span("numerics_nonfinite[output]", tracing):
                    _numerics.record_nonfinite("output", okind)
                raise _numerics.NonFiniteResult(
                    f"non-finite ({okind}) output from a finite input "
                    f"[{tag}]", site="output", kind=okind)

    def _shadow_plan(self, key: tuple):
        """The memoized exact reference plan of ``key``'s tuple: same
        geometry and direction, exact wire (``wire_dtype="none"``), the
        exact tier of the executor's base, fusion and tuner off. A
        reference that cannot build memoizes None."""
        pk = key[:3]
        if pk in self._shadow_plans:
            return self._shadow_plans[pk]
        shape, dtype, direction = pk
        kw = dict(self.plan_kw, direction=direction, batch=None,
                  donate=False, wire_dtype="none", fuse=False,
                  tune="off")
        for tiered in ("mm_precision", "mm_complex",
                       "max_roundtrip_err"):
            kw.pop(tiered, None)
        if dtype is not None:
            kw["dtype"] = _DTYPES.get(dtype, dtype)
        ex = kw.pop("executor", None)
        if ex:
            from .ops.executors import (MM_EXECUTOR_BASES,
                                        split_executor, split_fuse,
                                        tiered_name)

            base, _tier, _cmode = split_executor(split_fuse(ex)[0])
            kw["executor"] = (tiered_name(base, "highest")
                              if base in MM_EXECUTOR_BASES else base)
        try:
            plan = self._planner()(shape, self.world, **kw)
        except Exception:  # noqa: BLE001 -- no reference, no audit
            plan = None
        self._shadow_plans[pk] = plan
        return plan

    def _plan_label(self, key: tuple, plan) -> str:
        """The ledger bucket label of a plan tuple: readable and stable
        across processes."""
        from .plan_logic import resolve_wire_dtype

        sh = "x".join(str(n) for n in key[0])
        try:
            # a plan without a world never exchanges: no codec runs
            if getattr(plan, "world", None) is None:
                wd = "exact"
            else:
                wd = resolve_wire_dtype(plan.options.wire_dtype) or "exact"
        except Exception:  # noqa: BLE001
            wd = "exact"
        d = "fwd" if getattr(plan, "forward", True) else "inv"
        return (f"{self.kind}:{sh}:{_dtype_name(plan.dtype)}:{d}:"
                f"{plan.executor}:{wd}")

    def _admitted_err(self, plan) -> float:
        """The plan's admitted error budget: the seeded plan-time wire
        and executor-tier round-trip figures the tuner admits plans
        against. The drift verdict compares realized error with it."""
        from .ops.executors import executor_roundtrip_error
        from .parallel.exchange import wire_roundtrip_error
        from .plan_logic import resolve_wire_dtype

        err = 0.0
        try:
            wd = (None if getattr(plan, "world", None) is None
                  else resolve_wire_dtype(plan.options.wire_dtype))
            if wd:
                err += wire_roundtrip_error(plan.dtype, wd)
        except Exception:  # noqa: BLE001 -- unknown codec: no budget
            pass
        try:
            err += executor_roundtrip_error(plan.executor, plan.dtype)
        except Exception:  # noqa: BLE001 -- bare label: no tier budget
            pass
        return err

    def _shadow_audit(self, key: tuple, plan, group: list, outs: list,
                      tag: str, tracing: bool) -> None:
        """Shadow-sampled accuracy audit: picked requests run again
        through the memoized exact reference plan after their primary
        execution resolved; the realized L2-relative error lands in the
        ledger against the plan's admitted budget. The owning tenant's
        bucket pays for the extra execution; audit failures are counted,
        never raised."""
        ns = self._numerics
        picked = [(r, out) for r, out in zip(group, outs)
                  if ns.pick()]
        if not picked:
            return
        from .api import execute

        label = self._plan_label(key, plan)
        tenant = self._tenant_of(key)
        for r, out in picked:
            _numerics.record_sampled()
            try:
                ref = self._shadow_plan(key)
                if ref is None:
                    _numerics.record_audit_failure()
                    continue
                with _span(f"shadow_audit[{tag}]", tracing):
                    yref = execute(ref, r.x, scale=r.scale)
                    realized = _numerics.realized_error(out, yref)
                _numerics.record_audit(
                    label, tenant, realized, self._admitted_err(plan),
                    _numerics.drift_floor(
                        getattr(yref, "dtype", plan.dtype)))
            except Exception:  # noqa: BLE001 -- telemetry never fails
                _numerics.record_audit_failure()
                continue
            if self.policy is not None and r.tenant:
                self.policy.charge(r.tenant, 1)

    # ------------------------------------------------- fault tolerance

    def _dispatch_ft(self, key: tuple, group: list, tag: str,
                     tracing: bool) -> None:
        """The fault-tolerant dispatch chain:

        1. the group, with transient retries (:meth:`_attempt`);
        2. the whole group rebuilt on the degraded executor;
        3. batched groups only: per-request bisection, each request run
           alone (retries and its own degraded fallback), so one
           poisoned request fails alone while its cohort completes.

        A kernel fault (:func:`.faults.kernel_fault`: a kernel that
        failed to build or launch, or a CUDA fault, which poisons the
        context) ends the chain at once: every handle not yet resolved
        fails with it, with no degraded rebuild and no further run.

        Failures surface only through the failed requests' handles;
        this method never raises."""
        try:
            self._attempt(key, group, tag, tracing)
            return
        except Exception as err:  # noqa: BLE001 -- classified upstream
            last = err
        if _faults.kernel_fault(last):
            for r in group:
                r.handle._fail(last)
            return
        if self._try_degraded(key, group, tag, tracing):
            return
        if len(group) > 1:
            for i, r in enumerate(group):
                sub = [r]
                subtag = f"{tag}:iso{i}"
                try:
                    self._attempt(key, sub, subtag, tracing)
                    continue
                except Exception as e:  # noqa: BLE001
                    iso_err = e
                if _faults.kernel_fault(iso_err):
                    for rest in group[i:]:
                        rest.handle._fail(iso_err)
                    return
                if self._try_degraded(key, sub, subtag, tracing):
                    continue
                if _metrics._enabled:
                    _metrics.inc("serving_isolated_failures",
                                 kind=self.kind)
                r.handle._fail(iso_err)
            return
        group[0].handle._fail(last)

    def _attempt(self, key: tuple, group: list, tag: str, tracing: bool,
                 *, executor: str | None = None):
        """One logical execution with the bounded transient-retry loop: a
        failure :func:`.faults.classify` calls transient retries up to
        ``retry_max`` times under exponential backoff
        (``serve_retry[<tag>:a<N>]`` spans, ``serving_retries``);
        deterministic failures raise at once."""
        delay = self._retry_backoff
        attempt = 0
        while True:
            try:
                if attempt == 0:
                    return self._run_group(key, group, tag, tracing,
                                           executor=executor)
                with _span(f"serve_retry[{tag}:a{attempt}]", tracing):
                    return self._run_group(key, group, tag, tracing,
                                           executor=executor)
            except Exception as e:  # noqa: BLE001 -- classified below
                if (attempt >= self._retry_max
                        or _faults.classify(e) != "transient"):
                    raise
            attempt += 1
            if _metrics._enabled:
                _metrics.inc("serving_retries", kind=self.kind)
            if self.policy is not None and group and group[0].tenant:
                # recovery work is traffic: the owning tenant pays
                self.policy.charge(group[0].tenant, len(group))
            if delay > 0:
                time.sleep(delay)
            delay *= 2

    def _try_degraded(self, key: tuple, group: list, tag: str,
                      tracing: bool) -> bool:
        """Degraded-mode fallback: rebuild the group's plan on
        ``fallback_executor`` and execute. Resolved handles are stamped
        ``degraded``; the fallback is recorded under its own wisdom
        annotation. True on success; False (never raises) when disabled,
        pointless (the queue already runs the fallback executor) or
        failing itself."""
        fb = self._fallback_executor
        if not fb or self.plan_kw.get("executor") == fb:
            return False
        try:
            with _span(f"serve_degraded[{tag}:{fb}]", tracing):
                plan = self._run_group(key, group, tag, tracing,
                                       executor=fb)
        except Exception:  # noqa: BLE001 -- the chain's last resort failed
            return False
        if _metrics._enabled:
            _metrics.inc("serving_degraded", float(len(group)),
                         kind=self.kind, executor=fb)
        if self.policy is not None and group and group[0].tenant:
            self.policy.charge(group[0].tenant, len(group))
        self._annotate_degraded(key, plan, len(group))
        return True

    def _annotate_degraded(self, key: tuple, plan, b: int) -> None:
        """Append the fallback to the wisdom store under a key marked
        ``{"annotation": "degraded"}``: durable and inspectable, but no
        wisdom lookup or :func:`warm_pool` matches it, so the degraded
        winner never replays by accident. Telemetry, never fatal."""
        try:
            from . import tuner

            shape, dtype, direction = key[:3]
            ndev = tuner._mesh_context(self.world)[0]
            wkey = tuner.wisdom_key(
                kind=self.kind, shape=shape,
                dtype=dtype if dtype is not None else plan.dtype,
                direction=direction, ndev=ndev,
                batch=None if b == 1 else b)
            wkey["annotation"] = "degraded"
            tuner.record_wisdom(
                wkey,
                tuner.Candidate(
                    decomposition=plan.decomposition,
                    algorithm=plan.algorithm,
                    executor=plan.executor,
                    overlap_chunks=int(plan.overlap_chunks or 1)),
                0.0)
        except Exception:  # noqa: BLE001 -- annotation is telemetry
            pass

    # ------------------------------------------------- streaming waves

    def serve(self, *, poll_s: float = 0.05) -> "CoalescingQueue":
        """Start the streaming drain loop: a daemon thread that keeps
        waves in flight. Each iteration assembles the next wave (up to
        the concurrent width's groups, in QoS drain order, with realtime
        wave preemption), launches it, and only then waits for the
        *previous* wave's CUDA events, so groups formed meanwhile join
        the next wave of a running schedule. While streaming, a full
        group wakes the loop instead of flushing from the submit thread;
        ``flush()`` and ``result()`` still work. Idempotent; also armed
        by ``streaming=True`` or ``DFFT_SERVE_STREAMING=1``. ``poll_s``
        bounds the idle wakeup (arrivals wake the loop at once). The
        loop launches on its own thread's current stream, the default
        stream."""
        with self._lock:
            if self._serve_thread is not None \
                    and self._serve_thread.is_alive():
                return self
            if self._wave_stats is None:
                self._wave_stats = _WaveStats(self.kind)
            self._serve_stop = threading.Event()
            self._drain_on_stop = True
            self._streaming = True
            t = threading.Thread(target=self._serve_loop,
                                 args=(float(poll_s),),
                                 name="dfft-serve", daemon=True)
            self._serve_thread = t
            t.start()
        return self

    def stop(self, *, drain: bool = True,
             timeout: float | None = 30.0) -> None:
        """Stop the streaming loop. ``drain=True`` (default) lets it
        dispatch every pending group and retire its waves first;
        ``drain=False`` exits after the wave in flight (pending groups
        stay queued for flush mode). Idempotent; ``serve()`` may arm it
        again."""
        with self._lock:
            t = self._serve_thread
            self._streaming = False  # new submits stop waking the loop
            if t is None:
                return
            self._drain_on_stop = bool(drain)
            self._serve_stop.set()
        self._arrival.set()  # wake a loop parked on an empty queue
        if t.is_alive():
            t.join(timeout)
        with self._lock:
            if self._serve_thread is t:
                self._serve_thread = None

    def _serve_loop(self, poll_s: float) -> None:
        """The drain loop body. ``prev`` holds the previous wave's CUDA
        events: wave k+1 is launched before the loop waits on wave k, so
        at most two waves are in flight and the wait (where arrivals
        coalesce into the next wave) runs under the younger wave's
        device time."""
        stop = self._serve_stop
        prev: list = []
        while True:
            stopping = stop.is_set()
            if stopping and not self._drain_on_stop:
                break
            wave = self._next_wave()
            if wave is None:
                if stopping:
                    break  # drained: nothing pending, nothing admitted
                self._arrival.clear()
                # check again under the cleared event, so an arrival
                # racing the clear is never lost
                if self.pending() == 0:
                    self._arrival.wait(poll_s)
                continue
            groups, waits = wave
            t_dispatch = time.perf_counter()
            outs = self._execute_wave(groups, flushed_at=t_dispatch)
            ws = self._wave_stats
            if ws is not None:
                ws.note_wave(width=len(groups), t_dispatch=t_dispatch,
                             outputs=outs, waits=waits)
            events = _ready_events(outs)
            # admission point: retire the previous wave while this one
            # runs; every arrival meanwhile lands in the next wave
            try:
                _wait_events(prev)
            except Exception:  # noqa: BLE001 -- failed handles already
                pass           # carry their errors
            prev = events
        try:
            _wait_events(prev)
        except Exception:  # noqa: BLE001
            pass

    def _next_wave(self):
        """Assemble the next wave under the lock (streaming loop only):
        up to the concurrent width's groups in drain order, with wave
        preemption (a realtime group is guaranteed a slot in this wave,
        bumping later-class members when the width is full; bumped
        groups stay queued with their formation stamps, and the
        preempting tenant is charged, :meth:`.qos.QosPolicy
        .preempt_wave`). Groups larger than ``max_batch`` split at the
        boundary. Returns ``(groups, waits)`` or None when nothing is
        pending."""
        now = time.perf_counter()
        with self._lock:
            keys = self._drain_order(now)
            if not keys:
                return None
            probe = [(k, self._pending[k]) for k in keys
                     if self._pending.get(k)]
            if not probe:
                return None
            width = max(1, self._concurrent_width(probe[:4]))
            take = [k for k, _ in probe[:width]]
            if self.policy is not None and len(probe) > width:
                infos = [{"key": k, "tenant": self._tenant_of(k),
                          "n": len(g)} for k, g in probe]
                admit, bumped, _charges = self.policy.preempt_wave(
                    infos, width)
                take = [i["key"] for i in admit]
                if bumped:
                    ws = self._wave_stats
                    if ws is not None:
                        ws.note_preemption(
                            len(bumped), sum(i["n"] for i in bumped))
            groups = []
            for k in take:
                g = self._pending.get(k)
                if not g:
                    continue
                if len(g) > self.max_batch:
                    self._pending[k] = g[self.max_batch:]
                    g = g[:self.max_batch]
                else:
                    self._pending.pop(k)
                    self._formed.pop(k, None)
                groups.append((k, g))
            if not groups:
                return None
            self._flush_seq += 1  # stall-watchdog progress marker
            self._space.notify_all()  # admission waiters: depth fell
            waits = self._admit_waits(groups, now)
            if _metrics._enabled:
                _metrics.set_gauge(
                    "serving_queue_depth",
                    float(sum(len(g) for g in self._pending.values())),
                    kind=self.kind)
        return groups, waits

    def _execute_wave(self, groups: list, *, flushed_at: float) -> list:
        """Dispatch one assembled wave outside the queue lock:
        multi-group waves interleave through :meth:`_execute_concurrent`
        (which owns the sequential fallback), singletons take
        :meth:`_execute_group` and its recovery chain. Returns the wave's
        resolved outputs. A fault mid-wave never wedges the loop: the
        error is absorbed, any handle it left unresolved fails with it,
        and the wave's other chunks go on."""
        if len(groups) > 1:
            chunks = self._concurrent_chunks(groups, len(groups))
        else:
            chunks = [groups]
        for chunk in chunks:
            try:
                if len(chunk) > 1:
                    self._execute_concurrent(chunk, reason="stream",
                                             flushed_at=flushed_at)
                else:
                    k, g = chunk[0]
                    self._execute_group(k, g, reason="stream",
                                        flushed_at=flushed_at)
            except Exception as e:  # noqa: BLE001 -- see docstring
                for k, g in chunk:
                    for r in g:
                        if not r.handle._event.is_set():
                            r.handle._fail(e)
        outs = []
        for _, g in groups:
            for r in g:
                h = r.handle
                if h._event.is_set() and h._error is None \
                        and h._value is not None:
                    outs.append(h._value)
        return outs

    # -------------------------------------------------------------- warm

    def warm(self, shapes, *, batches=(None,),
             direction: int = FORWARD) -> int:
        """Preplan (into the plan cache) the given world shapes at the
        given batch sizes, each plan compiled (:meth:`.api.Plan3D
        .compile`: one throwaway execution). Returns plans built."""
        n = 0
        for shape in shapes:
            for b in batches:
                self._plan((tuple(int(s) for s in shape),
                            self.plan_kw.get("dtype"), direction), b,
                           False).compile()
                n += 1
        return n

    def close(self) -> None:
        """Drain the queue (stopping the streaming loop with a full
        drain, then a final flush) and let the wave stamper exit.
        Idempotent; the queue stays usable afterwards."""
        self.stop(drain=True)
        self.flush(reason="manual")
        m = self._monitor
        if m is not None:
            m.stop()
        ws = self._wave_stats
        if ws is not None:
            ws.stop()


def warm_pool(world=None, top_n: int = 4, *, path: str | None = None,
              max_batch: int | None = None, device=None) -> list:
    """Preplan the top-N problem tuples of the wisdom store.

    The wisdom store keys measured winners by the serving tuple (kind,
    shape, dtype, direction[, batch], world, hardware), so its newest
    entries are the shapes a fresh serving process sees first. This
    reads the store (``DFFT_WISDOM`` / the compile-cache default), keeps
    the entries of this platform, torch and CUDA version and world size
    (``world``: an int rank count, a :class:`~.parallel.mesh.World`, or
    None for one device; annotated entries, the degraded-fallback
    records, are never replayed), newest first, and builds the top
    ``top_n`` through ``tune="wisdom"`` into the plan cache.
    ``max_batch`` also preplans each tuple at that batch size.
    ``device`` goes to the planners. Returns the built plans.

    A stale tuple (a winner the current build can no longer plan) is
    skipped, counted into ``serving_warm_pool_skipped`` and one stderr
    summary line; ``KeyboardInterrupt`` / ``SystemExit`` propagate."""
    from . import api, tuner
    from .calibrate import _current_identity

    entries = tuner._read_wisdom(path if path is not None
                                 else tuner.default_wisdom_path())
    ndev = tuner._mesh_context(world)[0]
    platform = _current_identity()[1]

    def eligible(entry) -> bool:
        k = entry.get("key", {})
        return (k.get("kind") in ("c2c", "r2c")
                and k.get("ndev") == ndev
                and k.get("platform") == platform
                and k.get("torch") == torch.__version__
                and k.get("cuda") == torch.version.cuda
                and k.get("layouts") is None
                and not k.get("annotation"))  # degraded records: never

    ranked = sorted((e for e in entries.values() if eligible(e)),
                    key=lambda e: str(e.get("recorded_at", "")),
                    reverse=True)[:max(0, int(top_n))]
    plans = []
    skipped = 0
    on = tracing_enabled()
    for entry in ranked:
        k = entry["key"]
        plan_fn = (api.plan_dft_r2c_3d if k["kind"] == "r2c"
                   else api.plan_dft_c2c_3d)
        batches = {k.get("batch")}
        if max_batch is not None:
            batches.add(int(max_batch))
        for b in sorted(batches, key=lambda v: (v is not None, v)):
            name = (f"warm_plan[{k['kind']}:"
                    f"{'x'.join(str(s) for s in k['shape'])}"
                    + (f":b{b}" if b else "") + "]") if on else ""
            try:
                with _span(name, on):
                    plans.append(plan_fn(
                        tuple(k["shape"]), world, direction=k["direction"],
                        dtype=_DTYPES[k["dtype"]], tune="wisdom", batch=b,
                        device=device))
            except (KeyboardInterrupt, SystemExit):
                raise  # interrupts must stop the process
            except Exception:  # noqa: BLE001 -- a stale tuple never
                skipped += 1   # blocks the rest of the pool
                continue
    if skipped:
        print(f"serving: warm_pool skipped {skipped} stale wisdom "
              f"tuple(s) of {len(ranked)} eligible", file=sys.stderr)
        if _metrics._enabled:
            _metrics.inc("serving_warm_pool_skipped", float(skipped))
    if _metrics._enabled:
        _metrics.set_gauge("serving_warm_pool_plans", float(len(plans)))
    return plans
