"""Timing: per-stage t0..t3 breakdowns and kernel times on the card.

The port of ``distributedfft_tpu/utils/timing.py``. On a CUDA device
the stage and kernel times come from CUDA events (``torch.cuda.Event``),
which measure the device's work rather than the host's enqueue; the
tuner's :func:`time_fn_amortized` reads the host clock around
``iters`` calls and one synchronisation, as the JAX package's does.
GFlop/s follows the reference's 5 N log2 N / t model.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable

import torch


def _last_tensor(x):
    """The last tensor of ``x`` (a tensor, or nested lists and tuples of
    them), or None."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (list, tuple)):
        for v in reversed(x):
            t = _last_tensor(v)
            if t is not None:
                return t
    return None


def sync(x) -> None:
    """Wait for the work that produces ``x``: on a CUDA tensor its
    device's current stream is synchronised; on the CPU the work is
    done when the call returns."""
    t = _last_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def time_fn_amortized(fn: Callable, *args, iters: int = 10,
                      repeats: int = 3) -> tuple[float, object]:
    """Per-call seconds with the synchronisation's latency amortised
    out: one warm call, then ``repeats`` batches of ``iters`` calls
    dispatched back to back and synchronised once (:func:`sync`); the
    best batch's seconds over ``iters``. The reference times ``nt``
    executes inside one ``MPI_Wtime`` pair (``fftSpeed3d_c2c.cpp:94-98``)
    for the same reason. Returns (seconds, the last output)."""
    out = fn(*args)
    sync(out)
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        sync(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best, out


def gflops(shape, seconds: float) -> float:
    n = math.prod(shape)
    return 5.0 * n * math.log2(n) / seconds / 1e9


class StageTimer:
    """Sums the time of each named stage (t0..t3) over the runs it sees.

    On a CUDA device each stage is bracketed by two CUDA events; the sums
    are read in :meth:`times`, after one synchronize. On the CPU it reads
    the host clock, and :attr:`clock` says so."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.clock = "cuda_events" if self.device.type == "cuda" else "host"
        self._spans: list[tuple[str, object, object]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.clock == "cuda_events":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
        else:
            start = time.perf_counter()
            yield
            end = time.perf_counter()
        self._spans.append((name, start, end))

    def times(self) -> dict[str, float]:
        """Seconds per stage, summed over every span recorded."""
        if self.clock == "cuda_events":
            torch.cuda.synchronize(self.device)
        out: dict[str, float] = {}
        for name, start, end in self._spans:
            dt = (start.elapsed_time(end) / 1e3 if self.clock == "cuda_events"
                  else end - start)
            out[name] = out.get(name, 0.0) + dt
        return out


def cuda_time_ms(fn: Callable[[], object], *, iters: int = 10,
                 warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds over ``iters``
    runs after ``warmup`` ones. Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@dataclass
class StageTimes:
    """Seconds per stage of a staged pipeline, in stage order."""

    times: dict[str, float] = field(default_factory=dict)

    @property
    def total(self) -> float:
        return sum(self.times.values())

    def report(self) -> str:
        return "\n".join(f"  {k}: {v:.6f} s" for k, v in self.times.items())


def _device_of(v):
    """The device of a stage value (a tensor or a list of blocks)."""
    t = v[0] if isinstance(v, (list, tuple)) else v
    return t.device


def time_staged(stages, x, iters: int = 3) -> tuple[StageTimes, object]:
    """Time a ``[(name, fn), ...]`` pipeline, each stage's output feeding
    the next: the best of ``iters`` passes after one warm pass, per
    stage. On a CUDA device each stage is bracketed by two CUDA events
    (the device's time for the stage's work, the stream idle in between
    only while the host launches); on the CPU by the host clock. Returns
    the times and the last pass's output."""
    cuda = _device_of(x).type == "cuda"
    best: dict[str, float] = {}
    out = None
    for it in range(iters + 1):
        cur = x
        for name, fn in stages:
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                cur = fn(cur)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                cur = fn(cur)
                dt = time.perf_counter() - t0
            if it > 0:
                best[name] = min(best.get(name, math.inf), dt)
        out = cur
    return StageTimes(best), out
