"""Fleet observability plane: multi-process monitor aggregation. The
port of ``distributedfft_tpu/fleet.py``.

One process's monitor sees one process; a fleet of serving processes
shares tenant quotas, and a stall or burn on one member is a fleet
incident even when the others look healthy. This module is the
cross-process half:

1. **Shared-directory convention.** ``DFFT_MONITOR_DIR=dir`` makes every
   :class:`..monitor.Monitor` armed from the environment stream its
   JSONL series to ``dir/monitor-<host>-<pid>.jsonl``
   (:func:`series_path`; :func:`..utils.atomicio.append_line` keeps each
   file free of torn lines even if its writer dies mid-run).
   :func:`load_fleet` reads every series in the directory, lenient to
   empty files, foreign files and torn last lines.

2. **Clock-offset estimation.** Every sample carries a wall stamp
   (``ts``) and a monotonic stamp (``mono``). Within one host all
   processes share the monotonic epoch, so the per-stream anchor
   ``median(ts - mono)`` differs between two same-host streams exactly
   by their wall-clock disagreement. :func:`estimate_offsets` computes
   per-stream offsets relative to the per-host median anchor; streams on
   different hosts get no cross-host correction (monotonic epochs are
   unrelated boot times there), and samples without ``mono`` get 0.

3. **Merge.** :func:`merge_streams` re-buckets every stream onto one
   corrected timeline and emits *fleet samples* shaped like monitor
   samples (summed queue depth, stalls and flush progress, summed
   metrics counters, per-tenant ledgers merged with a true quantile
   merge over the exported wait reservoirs, pooled numerics buckets),
   so :func:`..monitor.health_from_samples` runs on the fleet series
   unchanged. Each fleet sample also carries a ``per_proc`` block: each
   member's share of submits, sheds and stalls.

4. **Fleet health.** :func:`fleet_health` adds cross-stream verdicts:
   per-stream health, the merged-series health, ``fleet_stall`` (a
   member stalled or went quiet while peers progressed),
   ``straggler_skew`` (one member's wait p99 or burn rate diverging from
   the fleet median) and ``quota_imbalance`` (one process carrying
   nearly all of a shared tenant's traffic). The load generator
   (:mod:`..loadgen`) drives sustained mixed traffic through it and
   turns its verdict into an exit code.

Prometheus: :func:`prometheus_from_fleet` renders every stream's newest
sample with ``proc`` / ``host`` labels plus fleet-level aggregates, one
``# TYPE`` per family across the whole document.

Nothing here touches a tensor: the aggregator reads files and runs
anywhere the series can be copied to.
"""

from __future__ import annotations

import os
import statistics

from .monitor import (
    DEFAULT_BURN_THRESHOLD,
    DEFAULT_FAST_WINDOW_S,
    DEFAULT_SLOW_WINDOW_S,
    _delta,
    _prom_rows,
    _render_prom,
    _tenant_counter,
    health_from_samples,
    load_series,
)

__all__ = [
    "FLEET_SCHEMA",
    "series_path",
    "monitor_dir_from_env",
    "load_fleet",
    "estimate_offsets",
    "merge_streams",
    "fleet_health",
    "prometheus_from_fleet",
    "format_fleet",
]

#: Fleet-verdict format version (stamped into every fleet health doc).
FLEET_SCHEMA = 1

#: A member's newest sample may lag the fleet's newest by this many
#: sampling intervals before the member counts as "gone quiet" (its
#: writer wedged or died) for the ``fleet_stall`` verdict.
DEFAULT_LAG_FACTOR = 3.0

#: A member whose wait p99 exceeds ``skew_factor x`` the fleet median
#: (or whose fast-window burn rate does, against burning peers' median)
#: is flagged ``straggler_skew``.
DEFAULT_SKEW_FACTOR = 4.0

#: Ignore wait-skew verdicts below this absolute p99 (seconds) — at
#: micro waits, scheduler noise dwarfs any real divergence.
DEFAULT_MIN_SKEW_S = 1e-3

#: One process carrying more than this share of a shared tenant's
#: windowed submits (with at least ``_IMBALANCE_MIN_SUBMITS`` of them)
#: fires ``quota_imbalance``.
DEFAULT_IMBALANCE_SHARE = 0.9
_IMBALANCE_MIN_SUBMITS = 8.0


# ------------------------------------------------------------ directory


def monitor_dir_from_env() -> str | None:
    """The fleet series directory (``DFFT_MONITOR_DIR``), or None."""
    d = os.environ.get("DFFT_MONITOR_DIR", "").strip()
    return d or None


def series_path(dir_: str, host: str | None = None,
                pid: int | None = None) -> str:
    """This (or the named) process's series file under the shared fleet
    directory: ``monitor-<host>-<pid>.jsonl``."""
    from .monitor import _HOST

    return os.path.join(
        dir_, f"monitor-{host or _HOST}-{pid or os.getpid()}.jsonl")


def _stream_id(samples: list[dict], fallback: str) -> str:
    """Stream identity from the newest sample's stamps (``host:pid``,
    ``#<process_index>`` appended when the writer had a rank), or the
    filename stem for pre-identity (v1) series."""
    newest = samples[-1]
    host, pid = newest.get("host"), newest.get("pid")
    if not host or pid is None:
        return fallback
    sid = f"{host}:{pid}"
    pi = newest.get("process_index")
    if isinstance(pi, int):
        sid += f"#{pi}"
    return sid


def load_fleet(dir_: str) -> dict[str, list[dict]]:
    """Every per-process monitor series under ``dir_``:
    ``{stream_id: samples (oldest first)}``. Lenient by construction —
    :func:`..monitor.load_series` drops torn/foreign lines, empty or
    unreadable series are skipped (a worker that died before its first
    sample must not sink the fleet view), and non-series files in the
    directory are ignored."""
    streams: dict[str, list[dict]] = {}
    try:
        names = sorted(os.listdir(dir_))
    except OSError:
        return {}
    for name in names:
        if not (name.startswith("monitor-") and name.endswith(".jsonl")):
            continue
        samples = load_series(os.path.join(dir_, name))
        if not samples:
            continue
        sid = _stream_id(samples, name[len("monitor-"):-len(".jsonl")])
        # Two files claiming one identity (a restarted pid): keep both,
        # disambiguated by filename.
        while sid in streams:
            sid += "'"
        streams[sid] = samples
    return streams


# --------------------------------------------------------- clock offsets


def _host_of(samples: list[dict]) -> str:
    return str(samples[-1].get("host") or "")


def estimate_offsets(streams: dict[str, list[dict]]) -> dict[str, float]:
    """Per-stream wall-clock offsets (seconds a stream's wall clock
    runs AHEAD of its host group's median): within each host, the
    anchor ``median(ts - mono)`` is shared-epoch, so anchor deltas are
    wall-clock skew. Corrected time = ``ts - offset``. Streams without
    monotonic stamps (v1 samples) and single-stream hosts get 0; no
    correction is attempted across hosts (monotonic epochs are
    unrelated boot times there)."""
    anchors: dict[str, float] = {}
    for sid, samples in streams.items():
        vals = [s["ts"] - s["mono"] for s in samples
                if isinstance(s.get("ts"), (int, float))
                and isinstance(s.get("mono"), (int, float))]
        if vals:
            anchors[sid] = statistics.median(vals)
    by_host: dict[str, list[str]] = {}
    for sid in anchors:
        by_host.setdefault(_host_of(streams[sid]), []).append(sid)
    offsets = {sid: 0.0 for sid in streams}
    for _, sids in by_host.items():
        if len(sids) < 2:
            continue
        ref = statistics.median(anchors[s] for s in sids)
        for sid in sids:
            offsets[sid] = anchors[sid] - ref
    return offsets


# ---------------------------------------------------------------- merge


def _median_interval(streams: dict[str, list[dict]]) -> float:
    """The fleet's sampling cadence: median inter-sample spacing across
    every stream (floor 1 ms; 1 s when no stream has two samples)."""
    gaps: list[float] = []
    for samples in streams.values():
        ts = [s.get("ts") for s in samples
              if isinstance(s.get("ts"), (int, float))]
        gaps.extend(b - a for a, b in zip(ts, ts[1:]) if b > a)
    if not gaps:
        return 1.0
    return max(1e-3, statistics.median(gaps))


def _merge_counters(snaps: list[dict | None]) -> dict:
    """Sum metrics counters across processes, per (name, label row)."""
    out: dict[str, dict[str, float]] = {}
    for snap in snaps:
        for name, rows in ((snap or {}).get("counters") or {}).items():
            dst = out.setdefault(name, {})
            for lbl, v in rows.items():
                if isinstance(v, (int, float)):
                    dst[lbl] = dst.get(lbl, 0.0) + float(v)
    return {"counters": out}


def _quantile(sorted_vals: list[float], q: float) -> float | None:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def _merge_tenants(docs: list[dict | None]) -> dict | None:
    """Merge per-process SLO ledgers into one fleet ledger: counters
    sum; waits are a true quantile merge — the exported reservoir tails
    are concatenated and the fleet p50/p99 read off the union, never
    averaged from per-process quantiles (quantiles do not average).
    ``slo_ok`` is re-judged from the merged evidence."""
    tenants: dict[str, dict] = {}
    waits: dict[str, list[float]] = {}
    any_doc = False
    for doc in docs:
        for tname, t in ((doc or {}).get("tenants") or {}).items():
            any_doc = True
            row = tenants.setdefault(tname, {
                "class": t.get("class"), "weight": t.get("weight"),
                "rate": t.get("rate"), "submits": 0, "transforms": 0,
                "quota_shed": 0, "deadline_misses": 0,
                "slo_wait_s": None,
            })
            for fld in ("submits", "transforms", "quota_shed",
                        "deadline_misses"):
                v = t.get(fld)
                if isinstance(v, (int, float)):
                    row[fld] += v
            if isinstance(t.get("slo_wait_s"), (int, float)):
                row["slo_wait_s"] = t["slo_wait_s"]
            w = t.get("waits")
            if isinstance(w, list):
                waits.setdefault(tname, []).extend(
                    float(x) for x in w if isinstance(x, (int, float)))
    if not any_doc:
        return None
    for tname, row in tenants.items():
        pool = sorted(waits.get(tname, ()))
        row["wait_p50_s"] = _quantile(pool, 0.50)
        row["wait_p99_s"] = _quantile(pool, 0.99)
        if row["slo_wait_s"] is not None:
            p99 = row["wait_p99_s"]
            row["slo_ok"] = (row["deadline_misses"] == 0
                             and (p99 is None or p99 <= row["slo_wait_s"]))
    return {"schema": 1, "tenants": tenants}


def _merge_waves(docs: list[dict]) -> dict:
    """Sum per-process wave-scheduler occupancy blocks (the queue
    block's ``waves`` snapshot, schema 3) into one fleet block. The
    counters and busy/idle second pools sum; ``idle_fraction`` is
    re-derived from the POOLED seconds (fractions do not average — a
    process that ran one wave must not weigh as much as one that ran a
    thousand), and ``width_mean`` is re-weighted by each member's wave
    count for the same reason."""
    out: dict = {"waves": 0, "preemptions": 0, "bumped_groups": 0,
                 "bumped_transforms": 0, "idle_s": 0.0, "busy_s": 0.0}
    wsum = 0.0
    dur_max = None
    for d in docs:
        for fld in ("waves", "preemptions", "bumped_groups",
                    "bumped_transforms"):
            v = d.get(fld)
            if isinstance(v, (int, float)):
                out[fld] += v
        for fld in ("idle_s", "busy_s"):
            v = d.get(fld)
            if isinstance(v, (int, float)):
                out[fld] += float(v)
        wm, n = d.get("width_mean"), d.get("waves")
        if isinstance(wm, (int, float)) and isinstance(n, (int, float)):
            wsum += wm * n
        dm = d.get("wave_duration_max_s")
        if isinstance(dm, (int, float)):
            dur_max = dm if dur_max is None else max(dur_max, dm)
    total = out["idle_s"] + out["busy_s"]
    out["idle_fraction"] = (out["idle_s"] / total) if total > 0 else None
    out["width_mean"] = (wsum / out["waves"]) if out["waves"] else None
    out["wave_duration_max_s"] = dur_max
    return out


def _proc_share(sample: dict) -> dict:
    """One process's contribution row for a fleet sample's ``per_proc``
    block."""
    qb = sample.get("queue") or {}
    tenants = ((sample.get("qos") or {}).get("tenants") or {})
    return {
        "ts": sample.get("ts"),
        "seq": sample.get("seq"),
        "depth": qb.get("depth", 0),
        "flush_seq": qb.get("flush_seq", 0),
        "stalls_total": qb.get("stalls_total", 0),
        "submits": sum(
            t.get("submits", 0) for t in tenants.values()
            if isinstance(t.get("submits"), (int, float))),
        "quota_shed": sum(
            t.get("quota_shed", 0) for t in tenants.values()
            if isinstance(t.get("quota_shed"), (int, float))),
        "deadline_misses": sum(
            t.get("deadline_misses", 0) for t in tenants.values()
            if isinstance(t.get("deadline_misses"), (int, float))),
    }


def _merge_numerics(blocks: list[dict | None]) -> dict | None:
    """Pool per-process numerics ledgers (monitor schema v4) into one
    fleet block, the wait-reservoir discipline applied to accuracy:
    counters sum, the exported realized-error tails concatenate per
    (plan, tenant) bucket, and the fleet p50/p99/drift verdict is re-ranked over the
    union (never averaged percentiles — quantiles do not average).
    Mixed-schema fleets (a rolling restart with pre-v4 members still
    streaming schema 2/3) treat absent blocks as empty: None when no
    member carries one."""
    from .numerics import DEFAULT_SLACK, judge_bucket

    blocks = [b for b in blocks if isinstance(b, dict)]
    if not blocks:
        return None
    slack = max((b["slack"] for b in blocks
                 if isinstance(b.get("slack"), (int, float))),
                default=DEFAULT_SLACK)
    out: dict = {"schema": 1, "sampled": 0, "audited": 0,
                 "audit_failures": 0, "slack": slack,
                 "nonfinite": {}, "plans": {}}
    pooled: dict[str, dict] = {}
    for b in blocks:
        for fld in ("sampled", "audited", "audit_failures"):
            v = b.get(fld)
            if isinstance(v, (int, float)):
                out[fld] += int(v)
        for k, v in (b.get("nonfinite") or {}).items():
            if isinstance(v, (int, float)):
                out["nonfinite"][k] = out["nonfinite"].get(k, 0) + int(v)
        for key, bucket in (b.get("plans") or {}).items():
            dst = pooled.setdefault(key, {
                "plan": bucket.get("plan"), "tenant": bucket.get("tenant"),
                "n": 0, "admitted_err": 0.0, "floor": 0.0, "errors": []})
            if isinstance(bucket.get("n"), (int, float)):
                dst["n"] += int(bucket["n"])
            for fld in ("admitted_err", "floor"):
                if isinstance(bucket.get(fld), (int, float)):
                    dst[fld] = max(dst[fld], float(bucket[fld]))
            errs = bucket.get("errors")
            if isinstance(errs, list):
                dst["errors"].extend(float(e) for e in errs
                                     if isinstance(e, (int, float)))
    for key, dst in sorted(pooled.items()):
        doc = judge_bucket(dst["errors"], dst["n"], dst["admitted_err"],
                           dst["floor"], slack)
        doc["plan"] = dst["plan"]
        doc["tenant"] = dst["tenant"]
        doc["errors"] = sorted(dst["errors"])[-64:]
        out["plans"][key] = doc
    return out


def merge_streams(
    streams: dict[str, list[dict]],
    *,
    offsets: dict[str, float] | None = None,
    bucket_s: float | None = None,
) -> list[dict]:
    """Merge N per-process series into one fleet sample series (oldest
    first), shaped like monitor samples so
    :func:`..monitor.health_from_samples` consumes it unchanged.

    Streams are clock-corrected (``ts - offset``), bucketed at the
    fleet's sampling cadence, and each stream contributes its newest
    sample at-or-before each bucket (carry-forward — lifetime counters
    are monotone, so a slow sampler's last reading stays correct until
    its next one). Per fleet sample: queue depth/groups/stalls/flush
    progress sum across members, metrics counters sum per label row,
    tenant ledgers merge with counter sums + reservoir quantile merge,
    and ``per_proc`` carries each member's share for the imbalance and
    straggler checks."""
    if not streams:
        return []
    if offsets is None:
        offsets = estimate_offsets(streams)
    width = bucket_s if bucket_s and bucket_s > 0 \
        else _median_interval(streams)

    # Per stream: bucket index -> newest sample in that bucket
    # (corrected time).
    per_stream: dict[str, dict[int, dict]] = {}
    lo, hi = None, None
    for sid, samples in streams.items():
        off = offsets.get(sid, 0.0)
        buckets: dict[int, dict] = {}
        for s in samples:
            ts = s.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            b = int((ts - off) / width)
            buckets[b] = s
            lo = b if lo is None else min(lo, b)
            hi = b if hi is None else max(hi, b)
        if buckets:
            per_stream[sid] = buckets
    if not per_stream:
        return []

    out: list[dict] = []
    last_seen: dict[str, dict] = {}
    for b in range(lo, hi + 1):
        advanced = False
        for sid, buckets in per_stream.items():
            if b in buckets:
                last_seen[sid] = buckets[b]
                advanced = True
        if not advanced or not last_seen:
            continue
        members = dict(last_seen)
        queues = [m.get("queue") for m in members.values()
                  if m.get("queue")]
        kind = next((q.get("kind") for q in queues if q.get("kind")), "")
        fleet_queue = None
        if queues:
            fleet_queue = {
                "kind": kind,
                "depth": sum(q.get("depth", 0) for q in queues),
                "groups": sum(q.get("groups", 0) for q in queues),
                "oldest_pending_age_s": max(
                    (q.get("oldest_pending_age_s", 0.0) for q in queues),
                    default=0.0),
                "flush_seq": sum(q.get("flush_seq", 0) for q in queues),
                "stalls_total": sum(q.get("stalls_total", 0)
                                    for q in queues),
            }
            wave_docs = [q["waves"] for q in queues
                         if isinstance(q.get("waves"), dict)]
            if wave_docs:
                fleet_queue["waves"] = _merge_waves(wave_docs)
                fleet_queue["streaming"] = any(
                    q.get("streaming") for q in queues)
        doc = {
            "schema": 2,
            "fleet": True,
            "ts": (b + 1) * width,
            "seq": b,
            "procs": len(members),
            "metrics": _merge_counters(
                [m.get("metrics") for m in members.values()]),
            "queue": fleet_queue,
            "qos": _merge_tenants([m.get("qos")
                                   for m in members.values()]),
            "per_proc": {sid: _proc_share(m)
                         for sid, m in sorted(members.items())},
        }
        # Schema tolerance (rolling restarts): members may mix monitor
        # schemas 2/3/4 in one directory — blocks a member does not
        # carry (waves, numerics) are treated as empty, and the merged
        # numerics block appears only when at least one member has one.
        nmerged = _merge_numerics([m.get("numerics")
                                   for m in members.values()])
        if nmerged is not None:
            doc["numerics"] = nmerged
        out.append(doc)
    return out


# --------------------------------------------------------- fleet health


def _stream_progressed(samples: list[dict], window_s: float) -> bool:
    """Did this member make serving progress in the window — flushes
    advanced or new submits arrived?"""
    def flush_of(s: dict) -> float:
        return float((s.get("queue") or {}).get("flush_seq") or 0)

    def submits_of(s: dict) -> float:
        tenants = ((s.get("qos") or {}).get("tenants") or {})
        return float(sum(t.get("submits", 0) for t in tenants.values()
                         if isinstance(t.get("submits"), (int, float))))

    return (_delta(samples, window_s, flush_of) > 0
            or _delta(samples, window_s, submits_of) > 0)


def _stream_stall_delta(samples: list[dict], window_s: float) -> float:
    def stalls_of(s: dict) -> float:
        return float((s.get("queue") or {}).get("stalls_total") or 0)

    return _delta(samples, window_s, stalls_of)


def _stream_burn(samples: list[dict], window_s: float) -> float:
    """Windowed bad-submit fraction across every tenant of one
    stream."""
    tenants = ((samples[-1].get("qos") or {}).get("tenants") or {})

    def bad(s: dict) -> float:
        return sum(_tenant_counter(s, t, "deadline_misses")
                   + _tenant_counter(s, t, "quota_shed") for t in tenants)

    def submits(s: dict) -> float:
        return sum(_tenant_counter(s, t, "submits") for t in tenants)

    return (_delta(samples, window_s, bad)
            / max(1.0, _delta(samples, window_s, submits)))


def _stream_wait_p99(samples: list[dict]) -> float | None:
    """The newest sample's worst per-tenant wait p99 (seconds)."""
    tenants = ((samples[-1].get("qos") or {}).get("tenants") or {})
    vals = [t.get("wait_p99_s") for t in tenants.values()
            if isinstance(t.get("wait_p99_s"), (int, float))]
    return max(vals) if vals else None


def fleet_health(
    streams: dict[str, list[dict]],
    *,
    fast_window_s: float = DEFAULT_FAST_WINDOW_S,
    slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
    burn_threshold: float = DEFAULT_BURN_THRESHOLD,
    skew_factor: float = DEFAULT_SKEW_FACTOR,
    min_skew_s: float = DEFAULT_MIN_SKEW_S,
    imbalance_share: float = DEFAULT_IMBALANCE_SHARE,
    lag_factor: float = DEFAULT_LAG_FACTOR,
    offsets: dict[str, float] | None = None,
    bucket_s: float | None = None,
) -> dict:
    """Fleet health verdicts: the health engine over the merged series,
    per-member verdicts over each stream, and the cross-stream checks
    no single member can see. The combined ``alerts`` list carries a
    ``scope`` per alert (``"fleet"`` for merged-series verdicts,
    ``"cross"`` for the fleet-only ones); ``status`` is ``"alert"``
    when any severity-alert fires anywhere — the gate's exit
    verdict.

    Cross-stream verdicts:

    - ``fleet_stall`` (alert) — a member stalled (its watchdog counted
      a stall in the fast window) or went quiet (its newest corrected
      sample lags the fleet's newest by more than ``lag_factor``
      sampling intervals) while at least one peer progressed.
    - ``straggler_skew`` (alert) — a member's worst tenant wait p99
      exceeds ``skew_factor x`` the fleet median (above ``min_skew_s``),
      or its fast-window burn rate exceeds ``burn_threshold`` while the
      fleet median burn stays under half the threshold.
    - ``quota_imbalance`` (warn) — one process carries more than
      ``imbalance_share`` of a shared tenant's windowed submits (the
      shared quota is not being shared).
    """
    if not streams:
        return {"schema": FLEET_SCHEMA, "status": "unknown",
                "procs": {}, "fleet": None, "alerts": [],
                "offsets": {}, "samples": 0}
    if offsets is None:
        offsets = estimate_offsets(streams)
    width = bucket_s if bucket_s and bucket_s > 0 \
        else _median_interval(streams)
    merged = merge_streams(streams, offsets=offsets, bucket_s=width)
    hkw = dict(fast_window_s=fast_window_s, slow_window_s=slow_window_s,
               burn_threshold=burn_threshold)
    fleet_verdict = health_from_samples(merged, **hkw)
    alerts: list[dict] = [dict(a, scope="fleet")
                          for a in fleet_verdict.get("alerts") or []]

    procs: dict[str, dict] = {}
    corrected_newest: dict[str, float] = {}
    for sid, samples in sorted(streams.items()):
        v = health_from_samples(samples, **hkw)
        ts = samples[-1].get("ts")
        corr = (ts - offsets.get(sid, 0.0)
                if isinstance(ts, (int, float)) else None)
        corrected_newest[sid] = corr if corr is not None else 0.0
        procs[sid] = {
            "status": v.get("status"),
            "samples": len(samples),
            "host": _host_of(samples),
            "newest_ts": ts,
            "clock_offset_s": offsets.get(sid, 0.0),
            "depth": ((samples[-1].get("queue") or {}).get("depth")
                      or 0),
            "stalls": _stream_stall_delta(samples, fast_window_s),
            "burn_fast": _stream_burn(samples, fast_window_s),
            "wait_p99_s": _stream_wait_p99(samples),
            "wave_idle_fraction": (
                ((samples[-1].get("queue") or {}).get("waves") or {})
                .get("idle_fraction")),
            "progressed": _stream_progressed(samples, fast_window_s),
            "alerts": v.get("alerts") or [],
        }

    # fleet_stall: stalled-or-quiet member + progressing peer. A member
    # whose series merely ends earlier than its peers' but drained to
    # depth 0 finished cleanly — "quiet" means it went dark with work
    # still queued (or without any recent progress), the dead-writer
    # shape.
    fleet_newest = max(corrected_newest.values(), default=0.0)
    for sid, p in procs.items():
        quiet = (fleet_newest - corrected_newest[sid]
                 > lag_factor * width
                 and (p["depth"] > 0 or not p["progressed"]))
        stalled = p["stalls"] > 0
        if not (stalled or quiet):
            continue
        peers_progress = any(q["progressed"] for osid, q in procs.items()
                             if osid != sid)
        if not peers_progress:
            continue
        how = ("stalled" if stalled else
               f"quiet for {fleet_newest - corrected_newest[sid]:.3g}s")
        alerts.append({
            "name": "fleet_stall", "severity": "alert", "scope": "cross",
            "proc": sid,
            "detail": f"member {sid} {how} while peers progress"})

    # straggler_skew: wait-p99 or burn-rate divergence vs fleet median.
    p99s = {sid: p["wait_p99_s"] for sid, p in procs.items()
            if isinstance(p["wait_p99_s"], (int, float))}
    if len(p99s) >= 2:
        med = statistics.median(p99s.values())
        for sid, v in sorted(p99s.items()):
            if v > max(min_skew_s, skew_factor * med) and med >= 0.0 \
                    and v > min_skew_s:
                alerts.append({
                    "name": "straggler_skew", "severity": "alert",
                    "scope": "cross", "proc": sid,
                    "detail": (f"member {sid} wait p99 {v:.3g}s vs "
                               f"fleet median {med:.3g}s")})
    burns = {sid: p["burn_fast"] for sid, p in procs.items()}
    if len(burns) >= 2:
        med_burn = statistics.median(burns.values())
        for sid, v in sorted(burns.items()):
            if v > burn_threshold and med_burn <= burn_threshold / 2:
                alerts.append({
                    "name": "straggler_skew", "severity": "alert",
                    "scope": "cross", "proc": sid,
                    "detail": (f"member {sid} burns {v:.0%} of submits "
                               f"while the fleet median burns "
                               f"{med_burn:.0%}")})

    # quota_imbalance: windowed per-tenant submit share per process.
    tenant_share: dict[str, dict[str, float]] = {}
    for sid, samples in streams.items():
        tenants = ((samples[-1].get("qos") or {}).get("tenants") or {})
        for tname in tenants:
            d = _delta(samples, fast_window_s,
                       lambda s, _t=tname: _tenant_counter(
                           s, _t, "submits"))
            tenant_share.setdefault(tname, {})[sid] = d
    for tname, shares in sorted(tenant_share.items()):
        if len(shares) < 2:
            continue
        total = sum(shares.values())
        if total < _IMBALANCE_MIN_SUBMITS:
            continue
        top_sid, top = max(shares.items(), key=lambda kv: kv[1])
        if top / total > imbalance_share:
            alerts.append({
                "name": "quota_imbalance", "severity": "warn",
                "scope": "cross", "proc": top_sid, "tenant": tname,
                "detail": (f"{top:g}/{total:g} of tenant {tname!r}'s "
                           f"windowed submits land on {top_sid}")})

    firing = [a for a in alerts if a.get("severity") == "alert"]
    return {
        "schema": FLEET_SCHEMA,
        "status": ("alert" if firing
                   else "warn" if alerts else "ok"),
        "procs": procs,
        "fleet": fleet_verdict,
        "alerts": alerts,
        "offsets": dict(sorted(offsets.items())),
        "samples": sum(len(s) for s in streams.values()),
        "bucket_s": width,
    }


# ----------------------------------------------------------- Prometheus


def prometheus_from_fleet(
    streams: dict[str, list[dict]],
    *,
    offsets: dict[str, float] | None = None,
) -> str:
    """The fleet in Prometheus text exposition format: every stream's
    newest sample rendered with ``proc``/``host`` labels (one ``# TYPE``
    per family across the whole document), plus the fleet aggregates —
    member count, summed queue depth, per-member clock offset — from
    the merged view."""
    if offsets is None:
        offsets = estimate_offsets(streams)
    rows: list[tuple] = []
    for sid, samples in sorted(streams.items()):
        newest = samples[-1]
        extra = {"proc": sid, "host": str(newest.get("host") or "")}
        rows.extend(_prom_rows(newest, extra))
    merged = merge_streams(streams, offsets=offsets)
    rows.append(("dfft_fleet_procs", "gauge",
                 f"dfft_fleet_procs {len(streams):g}"))
    if merged:
        newest = merged[-1]
        qb = newest.get("queue") or {}
        rows.append(("dfft_fleet_queue_depth", "gauge",
                     f"dfft_fleet_queue_depth {qb.get('depth', 0):g}"))
        rows.append(("dfft_fleet_queue_stalls_total", "counter",
                     f"dfft_fleet_queue_stalls_total "
                     f"{qb.get('stalls_total', 0):g}"))
        wv = qb.get("waves") or {}
        if wv:
            rows.append(("dfft_fleet_waves_total", "counter",
                         f"dfft_fleet_waves_total "
                         f"{wv.get('waves', 0):g}"))
            rows.append(("dfft_fleet_wave_preemptions_total", "counter",
                         f"dfft_fleet_wave_preemptions_total "
                         f"{wv.get('preemptions', 0):g}"))
            frac = wv.get("idle_fraction")
            if isinstance(frac, (int, float)):
                rows.append(("dfft_fleet_wave_idle_fraction", "gauge",
                             f"dfft_fleet_wave_idle_fraction "
                             f"{frac:.6f}"))
        for tname, t in sorted(
                ((newest.get("qos") or {}).get("tenants") or {}).items()):
            for fld, pname in (
                    ("submits", "dfft_fleet_tenant_submits_total"),
                    ("deadline_misses",
                     "dfft_fleet_tenant_slo_misses_total")):
                v = t.get(fld)
                if isinstance(v, (int, float)):
                    rows.append((
                        pname, "counter",
                        f'{pname}{{tenant="{tname}"}} {v:g}'))
    for sid in sorted(streams):
        rows.append((
            "dfft_fleet_clock_offset_seconds", "gauge",
            f'dfft_fleet_clock_offset_seconds{{proc="{sid}"}} '
            f"{offsets.get(sid, 0.0):.6f}"))
    return _render_prom(rows)


# ------------------------------------------------------------ rendering


def format_fleet(doc: dict) -> str:
    """Human rendering of a :func:`fleet_health` verdict: the fleet
    status line, one row per member, then the alerts."""
    lines = [f"fleet status: {doc.get('status', 'unknown')}   "
             f"({len(doc.get('procs') or {})} process(es), "
             f"{doc.get('samples', 0)} sample(s))"]
    procs = doc.get("procs") or {}
    if procs:
        wid = max(len("proc"), max(len(s) for s in procs))
        lines.append(f"{'proc':<{wid}}  {'status':<7} {'samples':>7}  "
                     f"{'offset_s':>9}  {'burn':>6}  {'p99_s':>9}  "
                     f"{'stalls':>6}  {'idle':>5}  progressed")
        for sid, p in sorted(procs.items()):
            p99 = p.get("wait_p99_s")
            idle = p.get("wave_idle_fraction")
            lines.append(
                f"{sid:<{wid}}  {str(p.get('status')):<7} "
                f"{p.get('samples', 0):>7d}  "
                f"{p.get('clock_offset_s', 0.0):>9.4f}  "
                f"{p.get('burn_fast', 0.0):>6.0%}  "
                f"{('-' if p99 is None else f'{p99:.6f}'):>9}  "
                f"{p.get('stalls', 0):>6g}  "
                f"{('-' if idle is None else f'{idle:.0%}'):>5}  "
                f"{'yes' if p.get('progressed') else 'no'}")
    alerts = doc.get("alerts") or []
    if not alerts:
        lines.append("no alerts")
    for a in alerts:
        where = f" proc={a['proc']}" if a.get("proc") else ""
        tenant = f" tenant={a['tenant']}" if a.get("tenant") else ""
        lines.append(f"[{a.get('severity', '?'):5s}] "
                     f"({a.get('scope', '?')}) {a.get('name', '?')}"
                     f"{where}{tenant}: {a.get('detail', '')}")
    return "\n".join(lines)
