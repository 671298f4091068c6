"""Multi-tenant QoS: priority classes, weighted-fair drain, quotas, SLOs.

The port of ``distributedfft_tpu/qos.py``, line for line (the module is
pure Python). Four pieces:

1. :class:`Tenant`: one traffic source, with a priority class
   (``realtime`` > ``interactive`` > ``batch``), a weight (its fair
   share against same-class peers), an optional token-bucket rate quota
   (transforms/s with burst) and an optional declared wait SLO.
2. :class:`QosPolicy`: the tenant registry and the three decisions the
   :class:`.serving.CoalescingQueue` asks for:

   - **admission** (:meth:`QosPolicy.admit`): an over-quota submit is
     shed with :class:`QuotaExceeded` (queue ``admission="raise"``) or
     parked until the bucket refills (``"block"``), bounded by the
     request's deadline. A realtime tenant may overdraw its bucket by
     one extra burst, so under equal configurations a realtime tenant
     never sheds before a batch tenant does. Retries and degraded
     rebuilds are charged to the owning tenant's bucket
     (:meth:`QosPolicy.charge`).
   - **drain order** (:meth:`QosPolicy.order_groups`): strict priority
     class first, then weighted-fair queueing across the tenants of a
     class (per-tenant virtual time advancing by transforms/weight). A
     starvation clock promotes any group older than ``max_wait_s x
     starvation_factor`` to the front, whatever its class.
   - **concurrent-wave placement** (:meth:`QosPolicy.concurrent_chunks`,
     :meth:`QosPolicy.preempt_wave`): higher classes keep the earlier
     slots of a merged schedule, a realtime group never rides a cohort
     with batch groups, and a realtime group is guaranteed a slot in the
     next streaming wave.

3. **Accounting**: the in-process SLO ledger (per-tenant p50/p99 queue
   wait and deadline misses against the declared target,
   :meth:`QosPolicy.slo_report`, :func:`write_ledger`).
4. **Spec string**: ``DFFT_QOS`` declares the whole policy (grammar
   below); ``CoalescingQueue(policy=)`` overrides.

Spec grammar (env ``DFFT_QOS``; tenants separated by ``;``)::

    spec   = tenant (";" tenant)*
    tenant = name ":" kv ("," kv)*
    kv     = "class=" ("realtime"|"interactive"|"batch")   default interactive
           | "weight=" W        fair-share weight within the class (default 1)
           | "rate=" R          token-bucket quota, transforms/s (default none)
           | "burst=" B         bucket capacity (default max(R, 1))
           | "slo=" T           declared wait-SLO target, seconds

Example: ``DFFT_QOS="acme:class=realtime,weight=3,rate=100,slo=0.05;
bulk:class=batch,rate=10"``. ``DFFT_QOS_STARVE_FACTOR`` scales the
starvation clock (default 4.0 x the queue's ``max_wait_s``).

With no policy configured the serving tier's behaviour is that of the
policy-free queue. Neither knob changes what a plan computes, so
neither keys the plan cache. ``clock=`` (default ``time.monotonic``)
is the buckets' clock; tests pass a fake one.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass

__all__ = [
    "CLASSES",
    "Tenant",
    "QosPolicy",
    "QuotaExceeded",
    "class_rank",
    "parse_qos",
    "write_ledger",
]

#: Priority classes, strongest first — drain order is strict across
#: classes (weighted-fair only *within* one).
CLASSES = ("realtime", "interactive", "batch")

#: Default starvation-clock multiplier: a group older than
#: ``max_wait_s x factor`` is promoted to the front of the drain order
#: regardless of class (``DFFT_QOS_STARVE_FACTOR`` overrides).
DEFAULT_STARVE_FACTOR = 4.0

#: Starvation reference age when the queue has no ``max_wait_s`` of its
#: own (seconds).
DEFAULT_STARVE_WAIT_S = 1.0

#: Bound of the per-tenant wait reservoir the SLO ledger keeps (oldest
#: samples drop first; p50/p99 are computed over the tail).
_WAIT_RESERVOIR = 8192

#: Bound of the reservoir *export* (``slo_report(include_waits=True)``)
#: — the newest tail that rides inside monitor sample documents so the
#: fleet aggregator can quantile-merge waits across processes without
#: shipping the full 8192-sample ring on every sample.
_WAIT_EXPORT = 256


def class_rank(klass: str) -> int:
    """0 = realtime (drains first) .. 2 = batch (drains last)."""
    return CLASSES.index(klass)


class QuotaExceeded(RuntimeError):
    """Admission shed a submit: the tenant's token bucket is empty and
    the queue runs ``admission="raise"``. ``retry_after_s`` is the
    bucket's refill estimate — the backoff a well-behaved client
    applies before resubmitting."""

    def __init__(self, tenant: str, retry_after_s: float):
        super().__init__(
            f"tenant {tenant!r} is over its rate quota; retry after "
            f"~{retry_after_s:.3f}s")
        self.tenant = tenant
        self.retry_after_s = retry_after_s


@dataclass(frozen=True)
class Tenant:
    """One registered traffic source of the serving tier.

    ``klass`` is the strict priority class, ``weight`` the fair-share
    ratio against same-class peers (a weight-3 tenant drains ~3x the
    transforms of a weight-1 peer under saturation), ``rate`` the
    token-bucket quota in transforms/s (None = unlimited), ``burst``
    the bucket capacity (default ``max(rate, 1)``), ``slo_wait_s`` the
    declared queue-wait target the SLO ledger judges p99 against."""

    name: str
    klass: str = "interactive"
    weight: float = 1.0
    rate: float | None = None
    burst: float | None = None
    slo_wait_s: float | None = None

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError(f"tenant name must be a non-empty string, "
                             f"got {self.name!r}")
        if self.klass not in CLASSES:
            raise ValueError(f"tenant {self.name!r}: class must be one "
                             f"of {CLASSES}, got {self.klass!r}")
        if not isinstance(self.weight, (int, float)) or isinstance(
                self.weight, bool) or not self.weight > 0:
            raise ValueError(f"tenant {self.name!r}: weight must be a "
                             f"positive number, got {self.weight!r}")
        if self.rate is not None and (
                isinstance(self.rate, bool)
                or not isinstance(self.rate, (int, float))
                or not self.rate > 0):
            raise ValueError(f"tenant {self.name!r}: rate must be a "
                             f"positive number or None, got {self.rate!r}")
        if self.burst is not None and (
                isinstance(self.burst, bool)
                or not isinstance(self.burst, (int, float))
                or not self.burst > 0):
            raise ValueError(f"tenant {self.name!r}: burst must be a "
                             f"positive number or None, got {self.burst!r}")
        if self.burst is not None and self.rate is None:
            raise ValueError(f"tenant {self.name!r}: burst without rate "
                             f"is meaningless (no bucket to cap)")

    @property
    def rank(self) -> int:
        return class_rank(self.klass)

    @property
    def bucket_burst(self) -> float:
        return float(self.burst if self.burst is not None
                     else max(self.rate or 1.0, 1.0))


class _Bucket:
    """One tenant's token bucket (transforms as tokens). Refilled lazily
    on access from a monotonic clock; ``charge`` may drive the balance
    negative (retries/degraded rebuilds are paid for after the fact —
    the tenant then waits out its own recovery debt at admission)."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float, *, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.stamp = now

    def _refill(self, now: float) -> None:
        if now > self.stamp:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now

    def take(self, n: float, *, floor: float, now: float) -> float:
        """Deduct ``n`` tokens if the balance stays >= ``floor``
        afterwards; returns 0.0 on success, else the seconds until it
        would (the admission park/shed figure)."""
        self._refill(now)
        if self.tokens - n >= floor:
            self.tokens -= n
            return 0.0
        return (n + floor - self.tokens) / self.rate

    def charge(self, n: float, *, now: float) -> None:
        self._refill(now)
        self.tokens -= n


class QosPolicy:
    """Tenant registry + the serving queue's three QoS decision points
    (admission, drain order, concurrent-wave placement) + the SLO
    ledger. Thread-safe: every mutating entry point serializes on one
    internal lock (the serving queue calls in from submit threads, the
    flush path, and deadline timers concurrently)."""

    def __init__(self, tenants=(), *,
                 starvation_factor: float | None = None,
                 clock=time.monotonic):
        if starvation_factor is None:
            raw = os.environ.get("DFFT_QOS_STARVE_FACTOR", "").strip()
            starvation_factor = float(raw) if raw else DEFAULT_STARVE_FACTOR
        if not starvation_factor > 0:
            raise ValueError(f"starvation_factor must be positive, got "
                             f"{starvation_factor!r}")
        self.starvation_factor = float(starvation_factor)
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: dict[str, Tenant] = {}
        self._buckets: dict[str, _Bucket] = {}
        # Weighted-fair state: per-tenant virtual time (advances by
        # transforms/weight as groups drain) and the tenants active in
        # the previous ordering round (a newly-active tenant's vtime is
        # floored at the active minimum so idle time never banks into
        # an unbounded burst credit).
        self._vtime: dict[str, float] = {}
        self._active: set[str] = set()
        # SLO ledger: per-tenant counters + bounded wait reservoir.
        self._ledger: dict[str, dict] = {}
        for t in tenants:
            self.register(t)

    # ------------------------------------------------------- registry

    def register(self, tenant: Tenant) -> Tenant:
        """Add (or replace) one tenant. Replacing resets its bucket and
        fair-share clock, keeps its ledger."""
        if not isinstance(tenant, Tenant):
            raise TypeError(f"register takes a Tenant, got {tenant!r}")
        with self._lock:
            self._tenants[tenant.name] = tenant
            self._buckets.pop(tenant.name, None)
            self._vtime.pop(tenant.name, None)
        return tenant

    def tenant(self, name: str) -> Tenant:
        with self._lock:
            t = self._tenants.get(name)
        if t is None:
            raise ValueError(
                f"unknown tenant {name!r}; registered: "
                f"{sorted(self._tenants)}")
        return t

    def resolve(self, name: str | None) -> Tenant:
        """The tenant of one submit: ``None`` maps to the implicit
        ``default`` tenant (interactive, weight 1, no quota — registered
        on first use), anything else must be registered."""
        if name is None:
            with self._lock:
                t = self._tenants.get("default")
                if t is None:
                    t = self._tenants["default"] = Tenant("default")
            return t
        return self.tenant(name)

    def tenants(self) -> tuple[Tenant, ...]:
        with self._lock:
            return tuple(self._tenants.values())

    def _entry(self, name: str) -> dict:
        # Caller holds the lock.
        e = self._ledger.get(name)
        if e is None:
            e = self._ledger[name] = {
                "submits": 0, "transforms": 0, "quota_shed": 0,
                "deadline_misses": 0, "waits": [],
            }
        return e

    # ------------------------------------------------------ admission

    def _bucket(self, t: Tenant, now: float) -> _Bucket | None:
        # Caller holds the lock.
        if t.rate is None:
            return None
        b = self._buckets.get(t.name)
        if b is None:
            b = self._buckets[t.name] = _Bucket(
                t.rate, t.bucket_burst, now=now)
        return b

    def admit(self, name: str | None, n: int = 1) -> float:
        """Admission decision for ``n`` transforms of tenant ``name``:
        0.0 = admitted (tokens taken), else the seconds until the bucket
        could cover them — the queue parks (``admission="block"``) or
        sheds with :class:`QuotaExceeded` (``"raise"``). Realtime
        tenants may overdraw down to ``-burst`` before a wait is ever
        demanded, so realtime never sheds before batch does. Pure bucket
        arithmetic — intake accounting is :meth:`note_submit` (the
        queue's park loop re-calls this without double-counting)."""
        t = self.resolve(name)
        now = self._clock()
        with self._lock:
            b = self._bucket(t, now)
            if b is None:
                return 0.0
            floor = -t.bucket_burst if t.klass == "realtime" else 0.0
            return b.take(float(n), floor=floor, now=now)

    def charge(self, name: str | None, n: int = 1) -> None:
        """Unconditionally deduct ``n`` transforms from the tenant's
        bucket — the recovery-work charge (retries, degraded rebuilds):
        the balance may go negative, and the tenant waits out its own
        debt at the next admission."""
        t = self.resolve(name)
        now = self._clock()
        with self._lock:
            b = self._bucket(t, now)
            if b is not None:
                b.charge(float(n), now=now)

    def note_submit(self, name: str | None, n: int = 1) -> None:
        t = self.resolve(name)
        with self._lock:
            self._entry(t.name)["submits"] += n

    def note_shed(self, name: str | None, n: int = 1) -> None:
        t = self.resolve(name)
        with self._lock:
            self._entry(t.name)["quota_shed"] += n

    # ---------------------------------------------------- drain order

    def starvation_s(self, max_wait_s: float | None) -> float:
        """The promotion age of the starvation clock: ``max_wait_s x
        starvation_factor`` (the queue's coalescing deadline scaled), or
        the default reference when the queue has none."""
        base = max_wait_s if max_wait_s else DEFAULT_STARVE_WAIT_S
        return float(base) * self.starvation_factor

    def order_groups(self, infos, *, max_wait_s: float | None = None):
        """Drain order of one flush: ``infos`` is a sequence of dicts
        ``{"key", "tenant", "n", "age_s"}`` (one pending group each, in
        formation order); returns them reordered:

        1. starved groups (``age_s`` past :meth:`starvation_s`) first,
           oldest first — regardless of class;
        2. then strict class rank (realtime, interactive, batch);
        3. within a class, weighted-fair queueing: repeatedly take the
           backlogged tenant with the smallest virtual time, advancing
           a *local* copy by ``n/weight`` per group taken — the
           deficit-weighted round robin whose long-run drain shares
           match the weights.

        The persistent virtual times advance only through
        :meth:`account_drain` (what actually drained — a flush with a
        ``limit`` may split a group and drain less than it ordered);
        ordering simulates charges on a local overlay so one tenant's
        many groups still interleave with its peers' within a call."""
        infos = list(infos)
        starve = self.starvation_s(max_wait_s)
        with self._lock:
            promoted = [i for i in infos if i["age_s"] >= starve]
            promoted.sort(key=lambda i: -i["age_s"])
            rest = [i for i in infos if i["age_s"] < starve]
            per_tenant: dict[str, list] = {}
            for i in rest:
                per_tenant.setdefault(i["tenant"], []).append(i)
            participating = set(per_tenant)
            returning = participating & self._active
            if returning:
                floor = min(self._vtime.get(t, 0.0) for t in returning)
                for t in participating - returning:
                    self._vtime[t] = max(self._vtime.get(t, 0.0), floor)
            self._active = participating
            vt = {t: self._vtime.get(t, 0.0) for t in participating}
            ordered = list(promoted)
            for rank in range(len(CLASSES)):
                backlog = {t: q for t, q in per_tenant.items()
                           if self._tenants.get(
                               t, Tenant(t)).rank == rank and q}
                while backlog:
                    t = min(backlog, key=lambda u: (vt.get(u, 0.0), u))
                    info = backlog[t].pop(0)
                    if not backlog[t]:
                        del backlog[t]
                    w = self._tenants.get(t, Tenant(t)).weight
                    vt[t] = vt.get(t, 0.0) + info["n"] / w
                    ordered.append(info)
            # Keep virtual times bounded: shift the whole axis toward
            # zero once it drifts far (ordering only reads differences).
            if self._vtime and min(self._vtime.values()) > 1e9:
                lo = min(self._vtime.values())
                for t in self._vtime:
                    self._vtime[t] -= lo
        return ordered

    def account_drain(self, name: str | None, n: int) -> None:
        """Record ``n`` transforms of tenant ``name`` actually drained:
        advances the persistent fair-share virtual time by ``n/weight``
        and the ledger's ``transforms`` counter. The queue calls this
        per executed group — a limited flush that splits a group
        charges only what it took, which is what makes the long-run
        drain shares track the weights."""
        t = self.resolve(name)
        with self._lock:
            self._vtime[t.name] = (self._vtime.get(t.name, 0.0)
                                   + n / t.weight)
            self._entry(t.name)["transforms"] += n

    # ------------------------------------------- concurrent placement

    def concurrent_chunks(self, infos, ncc: int):
        """Partition an ordered group list into the cohorts one
        concurrent dispatch merges (:func:`.stagegraph
        .schedule_concurrent`): consecutive runs of at most ``ncc``
        groups, never mixing a realtime group with a batch group — a
        realtime flush splits off alone (or with realtime/interactive
        peers) rather than riding a batch cohort. Earlier drain order =
        earlier schedule index = the earliest waves, so higher classes
        keep the front of each merged program."""
        chunks: list[list] = []
        cur: list = []
        cur_ranks: set[int] = set()
        for info in infos:
            t = info["tenant"]
            with self._lock:
                rank = self._tenants.get(t, Tenant(t)).rank
            splits = (rank == 0 and 2 in cur_ranks) or (
                rank == 2 and 0 in cur_ranks)
            if cur and (len(cur) >= ncc or splits):
                chunks.append(cur)
                cur, cur_ranks = [], set()
            cur.append(info)
            cur_ranks.add(rank)
        if cur:
            chunks.append(cur)
        return chunks

    def preempt_wave(self, infos, width: int):
        """Wave admission with realtime preemption — the streaming
        scheduler's admission point. ``infos`` is the full pending
        sequence in drain order (:meth:`order_groups` output, dicts with
        at least ``tenant``/``n``), ``width`` the next wave's capacity.
        Returns ``(admit, bumped, charges)``:

        - ``admit`` — the groups the next wave dispatches (at most
          ``width``, relative order preserved), with EVERY realtime
          group guaranteed a slot ahead of lower classes: a realtime
          arrival never waits out a saturated wave.
        - ``bumped`` — the would-have-dispatched lower-class groups a
          realtime group displaced. They are re-queued, never dropped:
          the caller leaves them pending with formation stamps intact,
          so they sit at the front of the next drain order and their
          starvation clocks keep running.
        - ``charges`` — ``{tenant: transforms}`` already deducted (via
          :meth:`charge`) from the preempting realtime tenants: each
          bumped transform is recovery-shaped work paid by whoever
          demanded the slot, the same even-recovery-work-charges
          discipline retries follow.

        Without a realtime group past the cutoff this is plain
        truncation: ``(infos[:width], [], {})``.
        """
        infos = list(infos)
        width = max(1, int(width))
        with self._lock:
            ranks = {id(i): self._tenants.get(
                i["tenant"], Tenant(i["tenant"] or "default")).rank
                for i in infos}
        window = infos[:width]
        window_ids = {id(i) for i in window}
        rt = [i for i in infos if ranks[id(i)] == 0]
        jumpers = [i for i in rt if id(i) not in window_ids]
        if not jumpers:
            return window, [], {}
        others = [i for i in infos if ranks[id(i)] != 0]
        admit = (rt + others)[:width]
        # Preserve drain order within the admitted set: realtime first
        # is a guarantee of ADMISSION, not of schedule position —
        # concurrent_chunks/order already put higher classes first.
        admit_ids = {id(i) for i in admit}
        admit = [i for i in infos if id(i) in admit_ids]
        bumped = [i for i in window if id(i) not in admit_ids]
        charges: dict[str, int] = {}
        for k, b in enumerate(bumped):
            t = jumpers[k % len(jumpers)]["tenant"]
            charges[t] = charges.get(t, 0) + int(b.get("n", 1))
        for t, n in charges.items():
            self.charge(t, n)
        with self._lock:
            for t, n in charges.items():
                e = self._entry(t or "default")
                e["preemptions"] = e.get("preemptions", 0) + n
        return admit, bumped, charges

    # ------------------------------------------------------ SLO ledger

    def note_wait(self, name: str | None, seconds: float) -> None:
        t = self.resolve(name)
        with self._lock:
            e = self._entry(t.name)
            e["waits"].append(float(seconds))
            if len(e["waits"]) > _WAIT_RESERVOIR:
                del e["waits"][:len(e["waits"]) - _WAIT_RESERVOIR]

    def note_miss(self, name: str | None, n: int = 1) -> None:
        t = self.resolve(name)
        with self._lock:
            self._entry(t.name)["deadline_misses"] += n

    def slo_report(self, *, include_waits: bool | int = False) -> dict:
        """The SLO ledger as one JSON document: per tenant, the class/
        weight/quota declaration, the intake/drain/shed/miss counters,
        the p50/p99 queue wait over the reservoir, and — when the
        tenant declared ``slo_wait_s`` — whether p99 currently meets it
        (``slo_ok``; misses count against it too).

        ``include_waits`` additionally exports the newest tail of each
        tenant's wait reservoir as a ``waits`` list (True = the
        ``_WAIT_EXPORT`` default cap, an int = that cap) — the raw
        samples the fleet aggregator quantile-merges across processes;
        the per-process p50/p99 rows alone cannot be merged."""
        cap = 0
        if include_waits:
            cap = (_WAIT_EXPORT if include_waits is True
                   else max(1, int(include_waits)))
        with self._lock:
            out = {}
            names = set(self._ledger) | set(self._tenants)
            for name in sorted(names):
                t = self._tenants.get(name, Tenant(name))
                e = self._ledger.get(name, {})
                waits = sorted(e.get("waits", ()))
                row = {
                    "class": t.klass,
                    "weight": t.weight,
                    "rate": t.rate,
                    "submits": e.get("submits", 0),
                    "transforms": e.get("transforms", 0),
                    "quota_shed": e.get("quota_shed", 0),
                    "deadline_misses": e.get("deadline_misses", 0),
                    "preemptions": e.get("preemptions", 0),
                    "wait_p50_s": _quantile(waits, 0.50),
                    "wait_p99_s": _quantile(waits, 0.99),
                    "slo_wait_s": t.slo_wait_s,
                }
                if t.slo_wait_s is not None:
                    p99 = row["wait_p99_s"]
                    row["slo_ok"] = (row["deadline_misses"] == 0
                                     and (p99 is None
                                          or p99 <= t.slo_wait_s))
                if cap:
                    raw = e.get("waits", ())
                    row["waits"] = [round(float(w), 6)
                                    for w in list(raw)[-cap:]]
                out[name] = row
        return {"schema": 1, "tenants": out}

    def ledger_json(self) -> str:
        return json.dumps(self.slo_report(), indent=2, sort_keys=True)

    # ------------------------------------------------------------- env

    @classmethod
    def from_spec(cls, raw: str) -> "QosPolicy | None":
        """Parse one ``DFFT_QOS`` spec string (module docstring grammar)
        into a policy; empty/whitespace -> None (no policy)."""
        tenants = parse_qos(raw)
        return cls(tenants) if tenants else None

    @classmethod
    def from_env(cls) -> "QosPolicy | None":
        return cls.from_spec(os.environ.get("DFFT_QOS", ""))


def _quantile(sorted_vals, q: float) -> float | None:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def parse_qos(raw: str) -> list[Tenant]:
    """``DFFT_QOS`` spec string -> tenants. Raises ``ValueError`` on a
    malformed clause — a policy that silently drops a tenant would let
    its traffic bypass every quota."""
    tenants: list[Tenant] = []
    for clause in (raw or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if ":" not in clause:
            raise ValueError(
                f"DFFT_QOS clause {clause!r} lacks a ':' (name:kv,...)")
        name, _, body = clause.partition(":")
        kw: dict = {"name": name.strip()}
        for directive in body.split(","):
            directive = directive.strip()
            if not directive:
                continue
            k, sep, v = directive.partition("=")
            k, v = k.strip(), v.strip()
            if not sep or not v:
                raise ValueError(
                    f"DFFT_QOS clause {clause!r}: directive "
                    f"{directive!r} is not key=value")
            try:
                if k == "class":
                    kw["klass"] = v
                elif k == "weight":
                    kw["weight"] = float(v)
                elif k == "rate":
                    kw["rate"] = float(v)
                elif k == "burst":
                    kw["burst"] = float(v)
                elif k == "slo":
                    kw["slo_wait_s"] = float(v)
                else:
                    raise ValueError(f"unknown key {k!r}")
            except ValueError as e:
                raise ValueError(
                    f"DFFT_QOS clause {clause!r}: {e}") from None
        tenants.append(Tenant(**kw))
    return tenants


def write_ledger(policy: QosPolicy, path: str) -> str:
    """Persist the policy's SLO ledger as JSON (line-atomic replace) —
    the file a QoS report reads."""
    from .utils.atomicio import replace_file

    replace_file(path, policy.ledger_json() + "\n")
    return path
