"""Timing: per-stage t0..t3 breakdowns and kernel times on the card.

The port of ``distributedfft_tpu/utils/timing.py``. On a CUDA device
every time comes from CUDA events (``torch.cuda.Event``), which measure
the device's work rather than the host's enqueue; GFlop/s follows the
reference's 5 N log2 N / t model.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import time
from typing import Callable

import torch


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
