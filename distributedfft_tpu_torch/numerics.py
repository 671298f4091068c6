"""Runtime numerical-health plane: shadow audits and non-finite sentinels.

The port of ``distributedfft_tpu/numerics.py``. The port trades accuracy
for speed in three places (wire codecs, matmul precision tiers, the
fused tier), and every error figure the tuner admits a plan against
(:func:`.parallel.exchange.wire_roundtrip_error`,
:func:`.ops.executors.executor_roundtrip_error`) is an estimate made at
plan time on a seeded Gaussian input. This module observes the error
realized on live traffic:

1. **Shadow-sampled accuracy audit.** ``DFFT_SHADOW_RATE=p[,seed]`` arms
   a seeded sampler on every :class:`.serving.CoalescingQueue`; a
   fraction ``p`` of requests are, after their primary (batched,
   compressed or fused) execution, executed again through a memoized
   exact reference plan (same geometry, exact wire, exact executor tier,
   fusion off). The realized relative error lands in a per-(plan, tenant)
   reservoir of this module's process-global ledger beside the plan's
   admitted budget, and :func:`judge_bucket` gives the drift verdict:
   realized p99 against the admitted budget times a slack factor. Unset,
   the plane is dark and the serving path takes none of its branches.

2. **Non-finite sentinels.** ``isfinite`` reductions at the serving
   output boundary, the input checked first so a caller's NaN is told
   apart from codec or executor damage, count
   ``numerics_nonfinite{site,kind}``. A non-finite output from a finite
   input raises :class:`NonFiniteResult` (deterministic for
   ``faults.classify``), which sends the group into the retry ->
   degraded rebuild -> bisect chain, so the poisoned request fails alone
   while its cohort completes. A non-finite input is the caller's:
   counted, delivered, never retried.

3. **Surfacing.** :func:`numerics_snapshot` is the ``numerics`` block a
   monitor sample carries.

The array helpers run on the tensors' own device: :func:`realized_error`
takes the two L2 norms there in float64 / complex128 (the JAX package
copies both arrays to the host), and :func:`nonfinite_kind` is two
reductions with one ``.item()`` each.
"""

from __future__ import annotations

import os
import random
import threading

import torch

from .utils import metrics as _metrics

__all__ = [
    "NonFiniteResult",
    "NumericsPlane",
    "Reservoir",
    "DEFAULT_SLACK",
    "MIN_DRIFT_SAMPLES",
    "parse_shadow_rate",
    "realized_error",
    "nonfinite_kind",
    "record_audit",
    "record_audit_failure",
    "record_nonfinite",
    "drift_floor",
    "judge_bucket",
    "numerics_snapshot",
    "reset_numerics",
    "NUMERICS_SCHEMA",
]

#: Version stamp of the ``numerics`` block inside monitor samples.
NUMERICS_SCHEMA = 1

#: Drift slack: realized p99 may exceed the admitted budget by this
#: factor before a bucket drifts. Headroom for the gap between the
#: admitted figure (max-relative on a seeded Gaussian) and the realized
#: one (L2-relative on live data).
DEFAULT_SLACK = 8.0

#: A bucket needs this many audits before its drift verdict can fire.
MIN_DRIFT_SAMPLES = 5

#: Reservoir capacity per (plan, tenant) bucket, and the exported tail.
_RESERVOIR_CAP = 256
_TAIL_EXPORT = 64


class NonFiniteResult(ArithmeticError):
    """A serving execution produced NaN/Inf from a finite input.

    Raised by the armed plane at the output boundary before any handle
    resolves, so the fault chain owns the failure: the poisoned request
    fails alone with this error on its handle while finite cohort
    members complete. ``faults.classify`` sees it as deterministic."""

    def __init__(self, message: str, *, site: str = "output",
                 kind: str = "inf"):
        super().__init__(message)
        self.site = site
        self.kind = kind


def parse_shadow_rate(raw: str | None) -> tuple[float, int] | None:
    """``DFFT_SHADOW_RATE=p[,seed]`` -> ``(p, seed)``; unset or empty ->
    None (plane dark). ``p`` clamps to [0, 1]; rate 0 still arms the
    non-finite sentinels. A malformed value raises."""
    if raw is None:
        return None
    raw = raw.strip()
    if not raw:
        return None
    head, _, tail = raw.partition(",")
    try:
        p = float(head)
        seed = int(tail) if tail.strip() else 0
    except ValueError:
        raise ValueError(
            f"DFFT_SHADOW_RATE must be 'p[,seed]' (e.g. '0.1' or "
            f"'0.25,7'), got {raw!r}") from None
    return (min(max(p, 0.0), 1.0), seed)


class NumericsPlane:
    """Per-queue arm of the plane: the seeded shadow sampler, one draw
    per request in dispatch order (same seed and traffic, same picks).
    The ledger is process-global."""

    def __init__(self, rate: float, seed: int = 0):
        self.rate = float(rate)
        self.seed = int(seed)
        self._rng = random.Random(f"shadow:{seed}")
        self._lock = threading.Lock()
        global _ARMED
        _ARMED = True

    @classmethod
    def from_env(cls) -> "NumericsPlane | None":
        parsed = parse_shadow_rate(os.environ.get("DFFT_SHADOW_RATE"))
        if parsed is None:
            return None
        return cls(*parsed)

    def pick(self) -> bool:
        """Whether the next request is shadow-audited."""
        if self.rate <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < self.rate


# ------------------------------------------------------------- metrics


def _wide(t: torch.Tensor, cplx: bool) -> torch.Tensor:
    return t.reshape(-1).to(torch.complex128 if cplx else torch.float64)


def realized_error(y, yref) -> float:
    """``||y - yref||_2 / ||yref||_2`` (L2-relative: a cohort member
    whose wire tiles were zeroed by a co-batched outlier reads O(1));
    a zero reference gives the absolute L2 of ``y``. Both norms are
    taken on ``y``'s device in complex128 (float64 for two real
    tensors); only the two scalars leave it."""
    y = torch.as_tensor(y)
    yref = torch.as_tensor(yref).to(y.device)
    cplx = y.is_complex() or yref.is_complex()
    a, b = _wide(y, cplx), _wide(yref, cplx)
    denom = float(torch.linalg.vector_norm(b).item())
    num = float(torch.linalg.vector_norm(a - b).item())
    if num != num or num in (float("inf"), float("-inf")):
        return float("inf")
    return num / denom if denom > 0.0 else num


def nonfinite_kind(x) -> str | None:
    """``"nan"`` / ``"inf"`` when ``x`` holds a non-finite value, None
    when clean (or not a floating tensor). Two reductions on the
    tensor's device."""
    if not isinstance(x, torch.Tensor):
        if getattr(x, "dtype", None) is None:
            return None
        x = torch.as_tensor(x)
    if not (x.is_floating_point() or x.is_complex()):
        return None
    if bool(torch.isfinite(x).all().item()):
        return None
    return "nan" if bool(torch.isnan(x).any().item()) else "inf"


def drift_floor(dtype) -> float:
    """Noise floor under the drift verdict: 100 machine epsilons of the
    torch dtype's real component. Exact plans admit a budget of 0.0; a
    rounding wiggle above zero must not read as infinite drift."""
    if not isinstance(dtype, torch.dtype) or not (
            dtype.is_floating_point or dtype.is_complex):
        return 1e-12
    return 100.0 * float(torch.finfo(dtype.to_real()).eps)


# ------------------------------------------------------------ reservoir


class Reservoir:
    """Algorithm-R reservoir of realized errors (seeded, bounded): a
    uniform sample of up to ``cap`` observations and a bounded tail for
    pooling across processes."""

    __slots__ = ("cap", "n", "values", "_rng")

    def __init__(self, cap: int = _RESERVOIR_CAP, seed: int = 0):
        self.cap = cap
        self.n = 0
        self.values: list[float] = []
        self._rng = random.Random(f"reservoir:{seed}")

    def add(self, x: float) -> None:
        self.n += 1
        if len(self.values) < self.cap:
            self.values.append(float(x))
            return
        j = self._rng.randrange(self.n)
        if j < self.cap:
            self.values[j] = float(x)

    def quantile(self, q: float) -> float:
        return _quantile(sorted(self.values), q)

    def tail(self, k: int = _TAIL_EXPORT) -> list[float]:
        """The ``k`` largest held values (the informative end of an
        error distribution), the exported pooling payload."""
        return sorted(self.values)[-k:]


def _quantile(ordered: list[float], q: float) -> float:
    """Nearest-rank quantile of an ascending list; 0.0 on empty."""
    if not ordered:
        return 0.0
    i = min(len(ordered) - 1, max(0, int(q * len(ordered))))
    return float(ordered[i])


def judge_bucket(errors: list[float], n: int, admitted: float,
                 floor: float, slack: float = DEFAULT_SLACK) -> dict:
    """The drift verdict: realized p99 (nearest rank over ``errors``)
    against ``max(admitted, floor) * slack``; fires only with ``n >=
    MIN_DRIFT_SAMPLES``."""
    ordered = sorted(float(e) for e in errors)
    budget = max(float(admitted), float(floor))
    p99 = _quantile(ordered, 0.99)
    ratio = (p99 / budget) if budget > 0.0 else 0.0
    return {
        "n": int(n),
        "admitted_err": float(admitted),
        "floor": float(floor),
        "realized_p50": _quantile(ordered, 0.50),
        "realized_p99": p99,
        "drift_ratio": ratio,
        "drifting": bool(n >= MIN_DRIFT_SAMPLES and ratio > slack),
    }


# --------------------------------------------------------------- ledger


class _Ledger:
    """Process-global accuracy and non-finite ledger (the monitor
    block's store; one per process, like the metrics registry)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.sampled = 0
            self.audited = 0
            self.audit_failures = 0
            self.nonfinite: dict[str, int] = {}
            # bucket key "<plan>@<tenant|->" -> dict with reservoir
            self.plans: dict[str, dict] = {}

    def record_sampled(self) -> None:
        with self._lock:
            self.sampled += 1
        _metrics.inc("numerics_shadow_sampled")

    def record_audit(self, plan_label: str, tenant: str | None,
                     realized: float, admitted: float,
                     floor: float) -> None:
        key = f"{plan_label}@{tenant or '-'}"
        with self._lock:
            self.audited += 1
            b = self.plans.get(key)
            if b is None:
                b = {"plan": plan_label, "tenant": tenant,
                     "admitted_err": float(admitted),
                     "floor": float(floor),
                     "reservoir": Reservoir(seed=len(self.plans))}
                self.plans[key] = b
            b["admitted_err"] = float(admitted)
            b["floor"] = float(floor)
            b["reservoir"].add(realized)
        _metrics.inc("numerics_shadow_audits")

    def record_audit_failure(self) -> None:
        with self._lock:
            self.audit_failures += 1

    def record_nonfinite(self, site: str, kind: str) -> None:
        key = f"{site}:{kind}"
        with self._lock:
            self.nonfinite[key] = self.nonfinite.get(key, 0) + 1
        _metrics.inc("numerics_nonfinite", site=site, kind=kind)

    def snapshot(self, slack: float = DEFAULT_SLACK) -> dict | None:
        """The ``numerics`` block; None while the plane has never been
        armed and nothing was recorded."""
        with self._lock:
            active = (_ARMED or self.sampled or self.audited
                      or self.audit_failures or self.nonfinite
                      or self.plans)
            if not active:
                return None
            out = {
                "schema": NUMERICS_SCHEMA,
                "sampled": self.sampled,
                "audited": self.audited,
                "audit_failures": self.audit_failures,
                "slack": slack,
                "nonfinite": dict(self.nonfinite),
                "plans": {},
            }
            for key, b in sorted(self.plans.items()):
                res: Reservoir = b["reservoir"]
                doc = judge_bucket(res.values, res.n, b["admitted_err"],
                                   b["floor"], slack)
                doc["plan"] = b["plan"]
                doc["tenant"] = b["tenant"]
                doc["errors"] = res.tail()
                out["plans"][key] = doc
            return out


_LEDGER = _Ledger()
#: True once any NumericsPlane was made in this process: from then on
#: snapshots carry the block even when it is all zeros.
_ARMED = False


def record_audit(plan_label: str, tenant: str | None, realized: float,
                 admitted: float, floor: float) -> None:
    _LEDGER.record_audit(plan_label, tenant, realized, admitted, floor)


def record_audit_failure() -> None:
    _LEDGER.record_audit_failure()


def record_nonfinite(site: str, kind: str) -> None:
    _LEDGER.record_nonfinite(site, kind)


def record_sampled() -> None:
    _LEDGER.record_sampled()


def numerics_snapshot(slack: float = DEFAULT_SLACK) -> dict | None:
    """The process-global ``numerics`` block, or None when the plane has
    never been armed and nothing was recorded."""
    return _LEDGER.snapshot(slack)


def reset_numerics() -> None:
    """Clear the ledger (the armed flag stays: arming is a property of
    the process's lifetime)."""
    _LEDGER.reset()
