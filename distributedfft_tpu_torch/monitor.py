"""Live serving monitor: streaming export, health engine, overlap
attribution. The port of ``distributedfft_tpu/monitor.py``.

It watches a *running* serving tier, in three pillars:

1. **Streaming export.** :class:`Monitor` runs a daemon sampler
   (``Monitor(queue, interval_s=...)``, or ``DFFT_MONITOR=interval[,path]``
   / ``DFFT_MONITOR_DIR=dir``, which every
   :class:`..serving.CoalescingQueue` arms at construction) that
   periodically joins :func:`..utils.metrics.metrics_snapshot`, the
   queue's depth and pending age, the QoS policy's
   :meth:`..qos.QosPolicy.slo_report` and the numerics ledger into one
   sample document, appended as a JSONL time series with the
   :func:`..utils.atomicio.append_line` discipline (line-atomic under
   concurrent writers: N serving processes can share one series).
   :func:`prometheus_from_sample` / :meth:`Monitor.prometheus_text`
   render a sample in the Prometheus text exposition format.

2. **Health engine.** :func:`health_from_samples` turns a sample series
   into verdicts: windowed per-tenant SLO burn rate over the ledger
   counters (fast and slow windows; lifetime counters are diffed across
   samples, never read as rates), quota-pressure and degraded /
   isolated-failure deltas from the fault counters, accuracy drift and
   non-finite outputs from the numerics block, and the queue-stall
   watchdog (a pending group older than ``stall_factor x max_wait_s``
   with no flush progress between samples fires ``serving_stalls`` and
   a retroactive ``serve_stall`` span).

3. **Measured overlap attribution.** :func:`dispatch_spans` runs a
   cohort's merged :func:`..stagegraph.schedule_concurrent` program once
   under :func:`..utils.trace.capture_events` and
   :func:`overlap_from_events` joins the ``cc<j>:`` / per-chunk ``[k]``
   span intervals into realized-overlap ratios, ``1 - wall / sum(per-group
   extents)``: 0 for a back-to-back schedule, approaching ``1 - 1/n``
   for a perfect n-way interleave. :mod:`.explain` stamps the ratio into
   its records and :func:`update_overlap_correction` persists the
   measured / model ratio into the calibration profile. The spans are
   the host's dispatch order (launches on the card are asynchronous),
   the quantity the model's hide budgets assume.

The sampler runs on its own thread and never touches the card: every
block it reads is host-side (the wave stats' drain stamps come from
their own stamper thread), so it cannot serialise the serving stream.
It reads the metrics registry as it is: the port reads no
``DFFT_METRICS``, so a monitor of a process that never called
:func:`..utils.metrics.enable_metrics` samples an empty registry.

Disarmed discipline: a queue without ``DFFT_MONITOR`` /
``DFFT_MONITOR_DIR`` (and without an explicit Monitor) takes no hook on
any hot path (the sampler reads queue state from its own thread under
the queue lock), and its serving is unchanged with the monitor off.
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
import time
from collections import deque

from .utils import metrics as _metrics
from .utils.atomicio import append_line
from .utils.trace import capture_events, record_span

__all__ = [
    "MONITOR_SCHEMA",
    "HEALTH_SCHEMA",
    "Monitor",
    "load_series",
    "health_from_samples",
    "health_snapshot",
    "prometheus_from_sample",
    "dispatch_spans",
    "overlap_from_events",
    "realized_overlap",
    "update_overlap_correction",
]

#: Sample-document format version (stamped into every JSONL sample),
#: the JAX package's: v2 added the fleet identity fields (``host`` /
#: ``process_index``), the monotonic stamp ``mono`` (the fleet
#: aggregator's clock-offset anchor) and the per-tenant wait-reservoir
#: tail inside the qos block (:meth:`..qos.QosPolicy.slo_report`
#: ``include_waits``); v3 the ``waves`` block inside the queue reading
#: (``CoalescingQueue._wave_stats.snapshot()``: wave count and width,
#: admit-to-dispatch latency per class, the host's idle fraction between
#: waves, preemptions), present on streaming or monitored queues; v4 the
#: ``numerics`` block (:mod:`..numerics`: sampled and audited counts,
#: per-(plan, tenant) realized-error tails against the admitted budget
#: with the drift verdict, the non-finite counters), present once the
#: plane is armed (``DFFT_SHADOW_RATE``) or a sentinel fired. Older
#: samples still load and merge (the added fields are absent).
MONITOR_SCHEMA = 4
#: Health-verdict format version (stamped into every health block).
HEALTH_SCHEMA = 1

#: This process's hostname, stamped into every sample — half of the
#: fleet stream identity (``host``/``pid``); the other half of the
#: shared-directory naming convention (``fleet.series_path``).
_HOST = socket.gethostname()

#: Sampling interval when only ``DFFT_MONITOR_DIR`` is set (no
#: ``DFFT_MONITOR`` interval to say otherwise).
DEFAULT_DIR_INTERVAL_S = 1.0


def _process_index() -> int | None:
    """This process's rank in the default ``torch.distributed`` group
    when one is initialised; None otherwise. Never initialises a group
    and never touches CUDA."""
    import torch.distributed as dist

    try:
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 -- a group torn down meanwhile
        pass
    return None


#: A pending group is judged stalled past ``stall_factor x max_wait_s``
#: (or ``x stall_grace_s`` on queues without a deadline) with no flush
#: progress between two consecutive samples.
DEFAULT_STALL_FACTOR = 4.0
DEFAULT_STALL_GRACE_S = 1.0
#: SLO burn windows — the classic fast/slow pair: fast catches an
#: active incident, slow catches a smolder the fast window forgives.
DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 600.0
#: Fraction of a tenant's windowed submits that may miss (deadline
#: misses + quota sheds) before ``slo_burn`` fires.
DEFAULT_BURN_THRESHOLD = 0.1


# ------------------------------------------------------------- sampling


class Monitor:
    """Live sampler over one process's serving state.

    ``queue`` (a :class:`..serving.CoalescingQueue`, or None for a
    metrics-only monitor) is sampled under its own lock; ``interval_s``
    arms the daemon sampler thread (None leaves the monitor manual —
    :meth:`sample` / :meth:`prometheus_text` / :meth:`health` still
    work); ``path`` streams every sample as one JSONL line
    (line-atomic, multi-process safe). The queue's :meth:`..serving
    .CoalescingQueue.close` stops an attached monitor's thread.

    ``DFFT_MONITOR=interval[,path]`` arms one per queue at construction
    (:meth:`from_env`); unset, queues carry no monitor and no hook.
    """

    def __init__(
        self,
        queue=None,
        *,
        interval_s: float | None = None,
        path: str | None = None,
        stall_factor: float = DEFAULT_STALL_FACTOR,
        stall_grace_s: float = DEFAULT_STALL_GRACE_S,
        fast_window_s: float = DEFAULT_FAST_WINDOW_S,
        slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
        burn_threshold: float = DEFAULT_BURN_THRESHOLD,
        history: int = 512,
    ):
        if interval_s is not None and (
                isinstance(interval_s, bool)
                or not isinstance(interval_s, (int, float))
                or not interval_s > 0):
            raise ValueError(f"interval_s must be a positive number or "
                             f"None, got {interval_s!r}")
        self.queue = queue
        self.interval_s = None if interval_s is None else float(interval_s)
        self.path = path
        self.stall_factor = float(stall_factor)
        self.stall_grace_s = float(stall_grace_s)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self._samples: deque = deque(maxlen=max(2, int(history)))
        self._seq = 0
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # Stall-watchdog state: flush progress at the previous sample,
        # and the keys already counted this stall episode (one
        # ``serving_stalls`` bump per group per episode, re-armed when
        # a flush makes progress).
        self._last_flush_seq: int | None = None
        self._stalled_keys: set = set()
        self._stall_count = 0
        # samples the daemon thread failed to take (swallowed: a failing
        # sampler shows as a short series and this count)
        self.errors = 0

    # ------------------------------------------------------- lifecycle

    @classmethod
    def from_env(cls, queue=None) -> "Monitor | None":
        """A monitor armed from ``DFFT_MONITOR=interval[,path]`` and/or
        the fleet directory convention ``DFFT_MONITOR_DIR=dir`` (one
        JSONL series per process: ``monitor-<host>-<pid>.jsonl``). None
        when both are unset (the zero-overhead default). An explicit
        ``DFFT_MONITOR=0`` disarms even with the directory set; an
        explicit path in ``DFFT_MONITOR`` wins over the derived one;
        the directory alone samples at ``DEFAULT_DIR_INTERVAL_S``."""
        spec = os.environ.get("DFFT_MONITOR", "").strip()
        mdir = os.environ.get("DFFT_MONITOR_DIR", "").strip()
        if spec in ("", "0") and not mdir:
            return None
        if spec == "0":
            return None
        interval, tail = DEFAULT_DIR_INTERVAL_S, ""
        if spec:
            head, _, tail = spec.partition(",")
            try:
                interval = float(head)
            except ValueError:
                raise ValueError(
                    f"DFFT_MONITOR must be 'interval[,path]' (seconds), "
                    f"got {spec!r}") from None
            if interval <= 0:
                return None
        path = tail.strip() or None
        if path is None and mdir:
            from .fleet import series_path

            path = series_path(mdir)
        return cls(queue, interval_s=interval, path=path)

    def start(self) -> "Monitor":
        """Arm the daemon sampler thread (no-op without ``interval_s``,
        idempotent while running)."""
        with self._lock:
            if self.interval_s is None:
                return self
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop = threading.Event()
            t = threading.Thread(target=self._run, name="dfft-monitor",
                                 daemon=True)
            self._thread = t
            t.start()
        return self

    def stop(self) -> None:
        """Tear the sampler thread down (idempotent; joins the thread
        so no sample lands after stop returns). Stopping a started
        sampler takes one final sample first, so a run shorter than
        ``interval_s`` still leaves its terminal state in the series."""
        with self._lock:
            t, self._thread = self._thread, None
            self._stop.set()
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        if t is not None:
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass

    def __enter__(self) -> "Monitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        stop = self._stop
        while not stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — the sampler must never
                self.errors += 1  # take the serving process down

    # -------------------------------------------------------- sampling

    def _watch_queue(self, now: float) -> dict | None:
        """One reading of the attached queue (under its lock): depth,
        pending age, and the stall watchdog's verdict. A stall =
        a pending group older than ``stall_factor x max_wait_s`` (or
        ``x stall_grace_s`` without a deadline) while the queue's flush
        sequence has not advanced since the previous sample — counted
        once per group per episode into ``serving_stalls`` with a
        retroactive ``serve_stall`` span over the un-flushed wait."""
        q = self.queue
        if q is None:
            return None
        with q._lock:
            depth = sum(len(g) for g in q._pending.values())
            fseq = q._flush_seq
            infos = []
            for k, g in q._pending.items():
                if not g:
                    continue
                _, t0 = q._formed.get(k, (0, now))
                oldest = min((r.handle._enqueued for r in g
                              if r.handle._enqueued is not None),
                             default=t0)
                infos.append((k, max(0.0, now - oldest), oldest))
        ref = self.stall_factor * (q.max_wait_s if q.max_wait_s is not None
                                   else self.stall_grace_s)
        stalled = []
        if self._last_flush_seq is not None and fseq != self._last_flush_seq:
            # Progress: the episode ends, every group re-arms.
            self._stalled_keys.clear()
        no_progress = (self._last_flush_seq is not None
                       and fseq == self._last_flush_seq)
        for k, age, oldest in infos:
            if not (no_progress and age > ref):
                continue
            if k in self._stalled_keys:
                continue
            self._stalled_keys.add(k)
            self._stall_count += 1
            _metrics.inc("serving_stalls", kind=q.kind)
            record_span(f"serve_stall[{q.kind}]", oldest, now)
            stalled.append({
                "age_s": age,
                "tenant": k[3] if len(k) > 3 else None,
            })
        self._last_flush_seq = fseq
        self._stalled_keys &= {k for k, _, _ in infos}
        out = {
            "kind": q.kind,
            "depth": depth,
            "groups": len(infos),
            "oldest_pending_age_s": max((a for _, a, _ in infos),
                                        default=0.0),
            "flush_seq": fseq,
            "stalls_total": self._stall_count,
        }
        if stalled:
            out["stalled"] = stalled
        ws = getattr(q, "_wave_stats", None)
        if ws is not None:
            # Scheduler occupancy (schema v3): the wave-level document
            # the fleet view merges (idle fraction, admit latency). A
            # host-side snapshot: the stamper thread took its stamps.
            out["waves"] = ws.snapshot()
        out["streaming"] = bool(getattr(q, "_streaming", False))
        return out

    def sample(self) -> dict:
        """Take one sample document: metrics snapshot + queue reading
        (stall watchdog included) + QoS ledger. Appends to the
        in-memory ring and — with ``path`` set — to the JSONL series."""
        now = time.perf_counter()
        doc = {
            "schema": MONITOR_SCHEMA,
            "ts": time.time(),
            # The monotonic stamp next to the wall stamp is the fleet
            # aggregator's clock-offset anchor: within one host every
            # process shares the monotonic epoch, so ts - mono deltas
            # across streams ARE wall-clock skew (fleet.estimate_offsets).
            "mono": time.monotonic(),
            "host": _HOST,
            "pid": os.getpid(),
            "process_index": _process_index(),
            "seq": self._seq,
            "metrics": _metrics.metrics_snapshot(),
            "queue": self._watch_queue(now),
        }
        self._seq += 1
        q = self.queue
        pol = getattr(q, "policy", None) if q is not None else None
        # include_waits: the reservoir tail rides in the sample so the
        # fleet aggregator can quantile-merge waits across processes.
        doc["qos"] = (pol.slo_report(include_waits=True)
                      if pol is not None else None)
        # Numerics plane (schema v4): the process-global shadow-audit /
        # non-finite ledger. None (block absent) while the plane is
        # dark — older consumers and disarmed processes are unaffected.
        from .numerics import numerics_snapshot

        nsnap = numerics_snapshot()
        if nsnap is not None:
            doc["numerics"] = nsnap
        self._samples.append(doc)
        if self.path:
            append_line(self.path, json.dumps(doc, sort_keys=True))
        return doc

    @property
    def samples(self) -> list[dict]:
        """The in-memory sample ring, oldest first."""
        return list(self._samples)

    # ------------------------------------------------------------ views

    def prometheus_text(self, sample: dict | None = None) -> str:
        """Prometheus text-exposition rendering of ``sample`` (default:
        a fresh one)."""
        return prometheus_from_sample(sample or self.sample())

    def health(self, samples: list[dict] | None = None) -> dict:
        """Health verdicts over the in-memory series (or ``samples``);
        takes a fresh sample first when the ring is empty."""
        if samples is None:
            if not self._samples:
                self.sample()
            samples = list(self._samples)
        return health_from_samples(
            samples, fast_window_s=self.fast_window_s,
            slow_window_s=self.slow_window_s,
            burn_threshold=self.burn_threshold)


def load_series(path: str) -> list[dict]:
    """Load a monitor JSONL series, lenient to torn/foreign lines (the
    history/wisdom loader discipline) and ordered oldest-first by
    timestamp — concurrent writers interleave whole lines in arbitrary
    order."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue
                if isinstance(doc, dict) and "ts" in doc:
                    out.append(doc)
    except OSError:
        return []
    out.sort(key=lambda d: d.get("ts") or 0.0)
    return out


# ------------------------------------------------------- health engine


def _counter_sum(snap: dict | None, name: str) -> float:
    """Sum of one metrics counter across every label row of a
    snapshot."""
    rows = ((snap or {}).get("counters") or {}).get(name) or {}
    return float(sum(v for v in rows.values()
                     if isinstance(v, (int, float))))


def _baseline(samples: list[dict], window_s: float) -> dict | None:
    """The newest sample OLDER than the window (the delta baseline).
    None when the series does not reach back that far — then the series
    start is the baseline, or, for a single-sample series, zero (the
    single-shot semantics: lifetime totals ARE the window)."""
    end = samples[-1].get("ts") or 0.0
    base = None
    for s in samples:
        if (s.get("ts") or 0.0) < end - window_s:
            base = s
        else:
            break
    if base is None and len(samples) > 1:
        base = samples[0]
    return base


def _delta(samples: list[dict], window_s: float, get) -> float:
    """Windowed counter increase: newest minus the baseline sample
    (0-baselined for a single-sample series). Clamped at 0 so a
    counter reset can never read as negative burn."""
    base = _baseline(samples, window_s)
    return max(0.0, get(samples[-1]) - (get(base) if base else 0.0))


def _tenant_counter(sample: dict, tenant: str, field: str) -> float:
    t = (((sample.get("qos") or {}).get("tenants") or {}).get(tenant)
         or {})
    v = t.get(field)
    return float(v) if isinstance(v, (int, float)) else 0.0


def health_from_samples(
    samples: list[dict],
    *,
    fast_window_s: float = DEFAULT_FAST_WINDOW_S,
    slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
    burn_threshold: float = DEFAULT_BURN_THRESHOLD,
) -> dict:
    """Health verdicts over a monitor sample series (oldest first).

    Alert severities: ``"alert"`` fires the gate (the status turns
    ``"alert"``), ``"warn"`` is surfaced but never gates.

    - ``stall`` (alert) — the queue-stall watchdog counted a stalled
      group within the fast window.
    - ``slo_burn`` (alert) — a tenant WITH a declared SLO burned more
      than ``burn_threshold`` of its windowed submits on deadline
      misses + quota sheds (fast window), or the newest ledger already
      judges its lifetime p99/misses out of SLO.
    - ``slo_burn_slow`` (warn) — same burn over the slow window only
      (a smolder the fast window forgives).
    - ``quota_pressure`` (warn) — quota sheds within the fast window.
    - ``degraded`` (warn) — degraded executions or isolated failures
      within the fast window (the recovery chain's fault counters).
    - ``accuracy_drift`` (alert) — a shadow-audited plan bucket's
      realized p99 error exceeds its admitted budget x slack
      (:mod:`..numerics`).
    - ``nonfinite`` (alert) — non-finite outputs from finite inputs
      within the fast window (quarantined serving damage);
      ``nonfinite_input`` (warn) is the caller-side counterpart.
    """
    if not samples:
        return {"schema": HEALTH_SCHEMA, "status": "unknown",
                "alerts": [], "samples": 0,
                "windows": {"fast_s": fast_window_s,
                            "slow_s": slow_window_s}}
    newest = samples[-1]
    alerts: list[dict] = []

    def stalls_of(s: dict) -> float:
        qb = s.get("queue") or {}
        v = qb.get("stalls_total")
        if isinstance(v, (int, float)):
            return float(v)
        return _counter_sum(s.get("metrics"), "serving_stalls")

    stall_d = _delta(samples, fast_window_s, stalls_of)
    if stall_d > 0:
        alerts.append({
            "name": "stall", "severity": "alert",
            "detail": f"{stall_d:g} stalled group(s) in the fast "
                      f"window with no flush progress"})

    tenants = ((newest.get("qos") or {}).get("tenants") or {})
    for tname, t in sorted(tenants.items()):
        declared = isinstance(t.get("slo_wait_s"), (int, float))

        def bad(s, _t=tname):
            return (_tenant_counter(s, _t, "deadline_misses")
                    + _tenant_counter(s, _t, "quota_shed"))

        def submits(s, _t=tname):
            return _tenant_counter(s, _t, "submits")

        shed_d = _delta(samples, fast_window_s,
                        lambda s, _t=tname: _tenant_counter(
                            s, _t, "quota_shed"))
        if shed_d > 0:
            alerts.append({
                "name": "quota_pressure", "severity": "warn",
                "tenant": tname,
                "detail": f"{shed_d:g} over-quota shed(s) in the fast "
                          f"window"})
        if not declared:
            continue
        bad_fast = _delta(samples, fast_window_s, bad)
        sub_fast = _delta(samples, fast_window_s, submits)
        burn_fast = bad_fast / max(1.0, sub_fast)
        bad_slow = _delta(samples, slow_window_s, bad)
        sub_slow = _delta(samples, slow_window_s, submits)
        burn_slow = bad_slow / max(1.0, sub_slow)
        out_of_slo = t.get("slo_ok") is False
        if (bad_fast > 0 and burn_fast > burn_threshold) or out_of_slo:
            alerts.append({
                "name": "slo_burn", "severity": "alert",
                "tenant": tname,
                "burn_fast": burn_fast, "burn_slow": burn_slow,
                "detail": (f"burn {burn_fast:.0%} of submits in the "
                           f"fast window"
                           + (" and the lifetime ledger is out of SLO"
                              if out_of_slo else ""))})
        elif bad_slow > 0 and burn_slow > burn_threshold:
            alerts.append({
                "name": "slo_burn_slow", "severity": "warn",
                "tenant": tname,
                "burn_fast": burn_fast, "burn_slow": burn_slow,
                "detail": f"burn {burn_slow:.0%} of submits over the "
                          f"slow window"})

    def faults_of(s: dict) -> float:
        snap = s.get("metrics")
        return (_counter_sum(snap, "serving_degraded")
                + _counter_sum(snap, "serving_isolated_failures"))

    fault_d = _delta(samples, fast_window_s, faults_of)
    if fault_d > 0:
        alerts.append({
            "name": "degraded", "severity": "warn",
            "detail": f"{fault_d:g} degraded execution(s)/isolated "
                      f"failure(s) in the fast window"})

    # Numerics plane (schema v4): accuracy drift judges the newest ledger (the reservoirs
    # are cumulative — a drifting plan stays drifting until its p99
    # recovers); the non-finite sentinels are windowed counter deltas
    # like every other counter verdict. Output-site non-finites are
    # serving damage (alert); input-site ones are the caller's (warn).
    numerics = newest.get("numerics") or {}
    drifting = [b for b in (numerics.get("plans") or {}).values()
                if b.get("drifting")]
    if drifting:
        worst = max(drifting, key=lambda b: b.get("drift_ratio", 0.0))
        alerts.append({
            "name": "accuracy_drift", "severity": "alert",
            "plan": worst.get("plan"), "tenant": worst.get("tenant"),
            "drift_ratio": worst.get("drift_ratio"),
            "detail": (f"{len(drifting)} plan bucket(s) drifting; "
                       f"worst {worst.get('plan')}: realized p99 "
                       f"{worst.get('realized_p99', 0.0):.3g} is "
                       f"{worst.get('drift_ratio', 0.0):.3g}x the "
                       f"admitted budget "
                       f"{worst.get('admitted_err', 0.0):.3g}")})

    def nonfinite_of(site):
        def get(s):
            nf = (s.get("numerics") or {}).get("nonfinite") or {}
            return float(sum(v for k, v in nf.items()
                             if k.startswith(site + ":")))
        return get

    nf_out_d = _delta(samples, fast_window_s, nonfinite_of("output"))
    if nf_out_d > 0:
        alerts.append({
            "name": "nonfinite", "severity": "alert",
            "detail": f"{nf_out_d:g} non-finite output(s) from finite "
                      f"input(s) in the fast window (quarantined)"})
    nf_in_d = _delta(samples, fast_window_s, nonfinite_of("input"))
    if nf_in_d > 0:
        alerts.append({
            "name": "nonfinite_input", "severity": "warn",
            "detail": f"{nf_in_d:g} non-finite caller input(s) in the "
                      f"fast window (delivered as-is, never retried)"})

    firing = [a for a in alerts if a["severity"] == "alert"]
    fast_n = len(samples) - len(
        samples[:samples.index(_baseline(samples, fast_window_s))]
    ) if _baseline(samples, fast_window_s) in samples else len(samples)
    return {
        "schema": HEALTH_SCHEMA,
        "status": ("alert" if firing
                   else "warn" if alerts else "ok"),
        "alerts": alerts,
        "samples": len(samples),
        "windows": {"fast_s": fast_window_s, "slow_s": slow_window_s,
                    "fast_samples": fast_n},
        "totals": {
            "stalls": stalls_of(newest),
            "deadline_misses": sum(
                _tenant_counter(newest, t, "deadline_misses")
                for t in tenants),
            "quota_shed": sum(
                _tenant_counter(newest, t, "quota_shed")
                for t in tenants),
            "degraded": _counter_sum(newest.get("metrics"),
                                     "serving_degraded"),
            "isolated_failures": _counter_sum(
                newest.get("metrics"), "serving_isolated_failures"),
            "expired": _counter_sum(newest.get("metrics"),
                                    "serving_expired"),
            "shadow_sampled": float(numerics.get("sampled", 0)),
            "shadow_audited": float(numerics.get("audited", 0)),
            "nonfinite": float(sum(
                (numerics.get("nonfinite") or {}).values())),
        },
    }


def health_snapshot(queue=None) -> dict:
    """Single-shot health verdict from the process's current state (one
    fresh sample; lifetime totals play the window): the block a run
    record carries."""
    m = Monitor(queue)
    return health_from_samples([m.sample()])


# -------------------------------------------------- Prometheus rendering

# Metrics-snapshot label strings are "k=v,k2=v2" with stringified
# values; values may themselves contain commas ("(64, 64, 64)" shapes),
# so split only at commas that start a new key.
_LABEL_SPLIT = re.compile(r",(?=[A-Za-z_][A-Za-z0-9_]*=)")


def _esc(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _plabels(label_str: str, extra: dict | None = None) -> str:
    pairs = []
    if label_str:
        for part in _LABEL_SPLIT.split(label_str):
            k, _, v = part.partition("=")
            pairs.append((k, v))
    for k, v in (extra or {}).items():
        pairs.append((k, v))
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in pairs) + "}"


def _prom_rows(sample: dict, extra: dict | None = None) -> list[tuple]:
    """One monitor sample as ``(family, type, line)`` Prometheus rows.
    ``extra`` labels (the fleet renderer's ``proc``/``host``) are
    appended to every row's label set. :func:`_render_prom` joins rows
    into the text exposition format, emitting each family's ``# TYPE``
    exactly once — the property that lets the fleet view concatenate N
    processes' rows into one valid scrape document."""
    rows: list[tuple] = []
    extra = extra or {}

    def lab(label_str: str, more: dict | None = None) -> str:
        merged = dict(more or {})
        merged.update(extra)
        return _plabels(label_str, merged)

    snap = sample.get("metrics") or {}
    for name, fam in sorted((snap.get("counters") or {}).items()):
        pname = f"dfft_{name}_total"
        for lbl, v in sorted(fam.items()):
            rows.append((pname, "counter", f"{pname}{lab(lbl)} {v:g}"))
    for name, fam in sorted((snap.get("gauges") or {}).items()):
        pname = f"dfft_{name}"
        for lbl, v in sorted(fam.items()):
            rows.append((pname, "gauge", f"{pname}{lab(lbl)} {v:g}"))
    for name, fam in sorted((snap.get("histograms") or {}).items()):
        pname = f"dfft_{name}"
        for lbl, h in sorted(fam.items()):
            rows.append((pname, "summary",
                         f"{pname}_count{lab(lbl)} {h.get('count', 0):g}"))
            rows.append((pname, "summary",
                         f"{pname}_sum{lab(lbl)} {h.get('total', 0.0):g}"))
            for q, fld in (("0.5", "p50"), ("0.99", "p99")):
                if fld in h:
                    rows.append((pname, "summary",
                                 f"{pname}{lab(lbl, {'quantile': q})} "
                                 f"{h[fld]:g}"))

    qb = sample.get("queue") or None
    if qb:
        kind = {"kind": qb.get("kind", "")}
        for pname, ptype, fld, dflt in (
                ("dfft_queue_depth", "gauge", "depth", 0),
                ("dfft_queue_pending_groups", "gauge", "groups", 0),
                ("dfft_queue_oldest_pending_age_seconds", "gauge",
                 "oldest_pending_age_s", 0.0),
                ("dfft_queue_stalls_total", "counter",
                 "stalls_total", 0)):
            rows.append((pname, ptype,
                         f"{pname}{lab('', kind)} {qb.get(fld, dflt):g}"))

    waves = (qb or {}).get("waves")
    if waves:
        kind = {"kind": (qb or {}).get("kind", "")}
        for pname, ptype, fld in (
                ("dfft_waves_total", "counter", "waves"),
                ("dfft_wave_preemptions_total", "counter", "preemptions"),
                ("dfft_wave_bumped_transforms_total", "counter",
                 "bumped_transforms"),
                ("dfft_wave_idle_seconds_total", "counter", "idle_s"),
                ("dfft_wave_busy_seconds_total", "counter", "busy_s"),
                ("dfft_wave_idle_fraction", "gauge", "idle_fraction"),
                ("dfft_wave_width_mean", "gauge", "width_mean"),
                ("dfft_wave_duration_seconds_max", "gauge",
                 "wave_duration_max_s")):
            v = waves.get(fld)
            if isinstance(v, (int, float)):
                rows.append((pname, ptype,
                             f"{pname}{lab('', kind)} {v:g}"))
        for klass, a in sorted((waves.get("admit_wait") or {}).items()):
            for q, fld in (("0.5", "p50_s"), ("0.99", "p99_s")):
                v = a.get(fld)
                if isinstance(v, (int, float)):
                    rows.append((
                        "dfft_wave_admit_seconds", "summary",
                        f"dfft_wave_admit_seconds"
                        f"{lab('', {'class': klass, 'quantile': q})}"
                        f" {v:g}"))

    tenants = ((sample.get("qos") or {}).get("tenants") or {})
    if tenants:
        fams = (("submits", "dfft_tenant_submits_total", "counter"),
                ("transforms", "dfft_tenant_transforms_total", "counter"),
                ("quota_shed", "dfft_tenant_quota_shed_total", "counter"),
                ("deadline_misses", "dfft_tenant_slo_misses_total",
                 "counter"))
        for fld, pname, ptype in fams:
            for tname, t in sorted(tenants.items()):
                v = t.get(fld)
                if isinstance(v, (int, float)):
                    rows.append((pname, ptype,
                                 f"{pname}{lab('', {'tenant': tname})} "
                                 f"{v:g}"))
        for tname, t in sorted(tenants.items()):
            for q, fld in (("0.5", "wait_p50_s"), ("0.99", "wait_p99_s")):
                v = t.get(fld)
                if isinstance(v, (int, float)):
                    rows.append((
                        "dfft_tenant_wait_seconds", "summary",
                        f"dfft_tenant_wait_seconds"
                        f"{lab('', {'tenant': tname, 'quantile': q})}"
                        f" {v:g}"))
        for tname, t in sorted(tenants.items()):
            if "slo_ok" in t:
                rows.append((
                    "dfft_tenant_slo_ok", "gauge",
                    f"dfft_tenant_slo_ok{lab('', {'tenant': tname})} "
                    f"{1 if t['slo_ok'] else 0}"))

    numerics = sample.get("numerics") or None
    if numerics:
        for pname, fld in (
                ("dfft_numerics_shadow_sampled_total", "sampled"),
                ("dfft_numerics_shadow_audited_total", "audited"),
                ("dfft_numerics_audit_failures_total",
                 "audit_failures")):
            v = numerics.get(fld)
            if isinstance(v, (int, float)):
                rows.append((pname, "counter",
                             f"{pname}{lab('')} {v:g}"))
        for sk, v in sorted((numerics.get("nonfinite") or {}).items()):
            site, _, nfkind = sk.partition(":")
            rows.append((
                "dfft_numerics_nonfinite_total", "counter",
                f"dfft_numerics_nonfinite_total"
                f"{lab('', {'site': site, 'kind': nfkind})} {v:g}"))
        for _, b in sorted((numerics.get("plans") or {}).items()):
            pl = {"plan": b.get("plan", ""),
                  "tenant": b.get("tenant") or ""}
            for pname, fld in (
                    ("dfft_numerics_admitted_err", "admitted_err"),
                    ("dfft_numerics_drift_ratio", "drift_ratio")):
                v = b.get(fld)
                if isinstance(v, (int, float)):
                    rows.append((pname, "gauge",
                                 f"{pname}{lab('', pl)} {v:g}"))
            for q, fld in (("0.5", "realized_p50"),
                           ("0.99", "realized_p99")):
                v = b.get(fld)
                if isinstance(v, (int, float)):
                    rows.append((
                        "dfft_numerics_realized_err", "summary",
                        f"dfft_numerics_realized_err"
                        f"{lab('', dict(pl, quantile=q))} {v:g}"))

    ts_line = f"dfft_monitor_sample_timestamp_seconds{lab('')}" \
        if extra else "dfft_monitor_sample_timestamp_seconds"
    rows.append(("dfft_monitor_sample_timestamp_seconds", "gauge",
                 f"{ts_line} {sample.get('ts', 0.0):.6f}"))
    return rows


def _render_prom(rows: list[tuple]) -> str:
    """Join ``(family, type, line)`` rows into the Prometheus text
    exposition format. Each family's ``# TYPE`` header is emitted once,
    at the family's first appearance; later rows of the same family
    (another process's, in the fleet view) group under it."""
    by_family: dict[str, tuple[str, list[str]]] = {}
    order: list[str] = []
    for family, ptype, line in rows:
        if family not in by_family:
            by_family[family] = (ptype, [])
            order.append(family)
        by_family[family][1].append(line)
    lines: list[str] = []
    for family in order:
        ptype, fam_lines = by_family[family]
        lines.append(f"# TYPE {family} {ptype}")
        lines.extend(fam_lines)
    return "\n".join(lines) + "\n"


def prometheus_from_sample(sample: dict) -> str:
    """One monitor sample in Prometheus text exposition format. Series
    are prefixed ``dfft_``; counters get ``_total``, histograms emit
    ``_count``/``_sum`` plus ``quantile`` rows where the registry keeps
    a reservoir; the queue/QoS blocks surface depth, pending age, stall
    count, and per-tenant SLO standing for scraping. The fleet view
    (:func:`..fleet.prometheus_from_fleet`) renders the same rows once
    per process with ``proc``/``host`` labels."""
    return _render_prom(_prom_rows(sample))


# ------------------------------------------- measured overlap attribution

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
