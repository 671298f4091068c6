"""Mixed-traffic load generator: the fleet's workload driver. The port
of ``distributedfft_tpu/loadgen.py``.

``python -m distributedfft_tpu_torch.loadgen`` drives the monitor,
health and QoS stack under sustained mixed multi-tenant traffic,
deterministically, and then judges the run with the fleet gate:

1. **Schedule** (:func:`build_schedule`): a pure function of ``(seed,
   rank, knobs)``, the JAX package's to the event: open-loop Poisson
   arrivals at ``--rate`` per process over ``--duration`` seconds, each
   event drawing a tenant from the weighted ``--mix``, a shape from
   ``--shapes``, a dtype from ``--dtypes`` and a direction from
   ``--ops``. Same seed, same schedule.

2. **Workers.** The parent spawns ``--procs`` subprocesses (``python -m
   distributedfft_tpu_torch.loadgen --worker --rank i``), each driving
   its own ``DFFT_QOS`` + ``DFFT_MONITOR_DIR``-armed
   :class:`..serving.CoalescingQueue` on ``--device``: the card by
   default (worker i on ``cuda:{i % device_count}``; several workers on
   one card each hold a CUDA context of their own), ``--device cpu``
   where there is none (without a card the default raises, it never
   falls back to the CPU). Each worker turns the metrics registry on
   (:func:`..utils.metrics.enable_metrics`). Open-loop discipline: the
   worker submits on schedule regardless of completion and drains with
   an explicit ``flush()`` cadence (``--flush-every``), so backpressure
   shows in the monitor series (depth, waits, sheds) instead of slowing
   the generator. ``--streaming`` swaps the cadence for the persistent
   drain loop (``serve()`` / ``stop()``); each worker's stats line then
   carries its wave count, preemptions and idle fraction.

3. **Fault drill.** ``DFFT_FAULT_INJECT`` in the parent environment is
   forwarded to exactly one worker (``--fault-rank``, default 0) and
   stripped from the rest. When the injected fault kills that worker's
   flush, its dispatcher wedges: it keeps *submitting* but stops
   *draining*. Its pending groups age past the monitor's stall watchdog
   with no flush progress, its series records the stall, and the fleet
   gate goes red while the healthy peers stay green.

4. **Verdict.** After the workers join, the parent aggregates the
   ``--dir`` series via :func:`..fleet.fleet_health` and prints the
   fleet report (``--json`` for the machine form); ``--gate`` turns it
   into an exit code: 1 on an ``alert`` verdict or a worker that exited
   with an error, else 0.

The parent and the schedule need no device; the parent resolves
``--device`` before it spawns, so a missing card fails there.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile
import time

__all__ = [
    "Event",
    "build_schedule",
    "parse_mix",
    "parse_shapes",
    "DEFAULT_QOS",
    "DEFAULT_MIX",
    "DEFAULT_SHAPES",
    "main",
]

#: Default two-tenant policy: a realtime tenant with a generous wait
#: SLO and 3x the batch tenant's drain share. Deliberately quota-free —
#: the healthy smoke must gate green, so nothing sheds by default.
DEFAULT_QOS = "rt:class=realtime,weight=3,slo=5;bulk:class=batch"

#: Default traffic mix (tenant:weight, matching :data:`DEFAULT_QOS`).
DEFAULT_MIX = "rt:3,bulk:1"

#: Default shape mix — tiny 3D tuples (the queue serves unbatched 3D
#: transforms) so a CPU worker sustains hundreds of arrivals per second
#: without the FFT dominating the run (the JAX package's).
DEFAULT_SHAPES = "8x8x8,16x8x4"


# ------------------------------------------------------------- schedule


class Event:
    """One scheduled arrival: ``t`` seconds after worker start."""

    __slots__ = ("t", "tenant", "shape", "dtype", "op")

    def __init__(self, t, tenant, shape, dtype, op):
        self.t = t
        self.tenant = tenant
        self.shape = shape
        self.dtype = dtype
        self.op = op

    def astuple(self) -> tuple:
        return (self.t, self.tenant, self.shape, self.dtype, self.op)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Event{self.astuple()!r}"


def parse_mix(raw: str) -> list[tuple[str | None, float]]:
    """``"rt:3,bulk:1"`` -> ``[("rt", 3.0), ("bulk", 1.0)]``. A bare
    name weighs 1; ``"-"`` is the anonymous (no-tenant) lane; empty
    spec -> one anonymous lane."""
    out: list[tuple[str | None, float]] = []
    for part in (p.strip() for p in raw.split(",")):
        if not part:
            continue
        name, _, w = part.partition(":")
        weight = 1.0
        if w.strip():
            weight = float(w)
            if weight <= 0:
                raise ValueError(
                    f"mix weight must be positive, got {part!r}")
        out.append((None if name.strip() == "-" else name.strip(),
                    weight))
    return out or [(None, 1.0)]


def parse_shapes(raw: str) -> list[tuple[int, ...]]:
    """``"16x16,32x8x2"`` -> ``[(16, 16), (32, 8, 2)]``."""
    out = []
    for part in (p.strip() for p in raw.split(",")):
        if not part:
            continue
        dims = tuple(int(d) for d in part.split("x"))
        if not dims or any(d < 1 for d in dims):
            raise ValueError(f"bad shape {part!r}")
        out.append(dims)
    if not out:
        raise ValueError(f"no shapes in {raw!r}")
    return out


def build_schedule(
    *,
    seed: int,
    rank: int,
    duration_s: float,
    rate_hz: float,
    mix: list[tuple[str | None, float]],
    shapes: list[tuple[int, ...]],
    dtypes: list[str],
    ops: list[str],
) -> list[Event]:
    """The rank's full arrival schedule — a pure function of its
    arguments (the rng seeds on ``seed:rank``, so ranks draw distinct
    but reproducible streams). Open-loop Poisson arrivals: exponential
    inter-arrival gaps at ``rate_hz``, truncated at ``duration_s``."""
    if rate_hz <= 0 or duration_s <= 0:
        return []
    rng = random.Random(f"{seed}:{rank}")
    tenants = [t for t, _ in mix]
    weights = [w for _, w in mix]
    out: list[Event] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate_hz)
        if t >= duration_s:
            return out
        out.append(Event(
            t,
            rng.choices(tenants, weights)[0],
            rng.choice(shapes),
            rng.choice(dtypes),
            rng.choice(ops),
        ))




# --------------------------------------------------------------- worker


def _worker_device(ns: argparse.Namespace):
    """Worker ``rank``'s device: ``--device`` through
    :func:`..api.resolve_device` (raises without a card unless it names
    the CPU); a bare ``cuda`` spreads the ranks over the cards."""
    import torch

    from .api import resolve_device

    dev = resolve_device(ns.device)
    if dev.type == "cuda" and torch.device(ns.device).index is None:
        dev = torch.device("cuda", ns.rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _run_worker(ns: argparse.Namespace) -> int:
    """One load-generating process: drive a monitor-armed queue through
    this rank's schedule, explicit-flush cadence, wedge-on-fault."""
    import numpy as np
    import torch

    from .api import BACKWARD, FORWARD
    from .ops import cuda_fft, cuda_fuse
    from .serving import CoalescingQueue
    from .utils import metrics

    events = build_schedule(
        seed=ns.seed, rank=ns.rank, duration_s=ns.duration,
        rate_hz=ns.rate, mix=parse_mix(ns.mix),
        shapes=parse_shapes(ns.shapes),
        dtypes=[d.strip() for d in ns.dtypes.split(",") if d.strip()],
        ops=[o.strip() for o in ns.ops.split(",") if o.strip()])
    dev = _worker_device(ns)
    metrics.enable_metrics()   # DFFT_METRICS=1 of the JAX package's worker

    # One buffer per (shape, dtype), made from the seed with numpy and
    # moved to the device once, before the clock starts: the generator
    # measures the serving tier, not allocation or the device's start.
    bufs: dict[tuple, torch.Tensor] = {}
    for ev in events:
        key = (ev.shape, ev.dtype)
        if key not in bufs:
            rng = np.random.default_rng(ns.seed + ns.rank)
            x = rng.standard_normal(ev.shape)
            if ev.dtype.startswith("complex"):
                x = x.astype(ev.dtype) + 1j * rng.standard_normal(
                    ev.shape).astype(ev.dtype)
            else:
                x = x.astype(ev.dtype)
            bufs[key] = torch.from_numpy(x).to(dev)
    world = None
    if ns.mesh > 0:
        # Distributed plans: the wire codec (DFFT_WIRE_DTYPE) only
        # engages on a world of several ranks, so numerics drift drills
        # need this armed (single-device plans are exact).
        from .parallel.mesh import World

        world = World(ns.mesh)
    queue = CoalescingQueue(
        world,
        max_batch=ns.max_batch,
        max_wait_s=ns.max_wait if ns.max_wait and ns.max_wait > 0
        else None,
        streaming=bool(ns.streaming),
        device=dev)
    has_policy = queue.policy is not None

    stats = {"rank": ns.rank, "pid": os.getpid(), "submitted": 0,
             "shed": 0, "flushed": 0, "wedged": False,
             "mode": "streaming" if ns.streaming else "flush",
             "device": str(dev)}
    # --hot-tail P: seeded heavy-tailed amplitude mixing — a fraction P
    # of submits scale one random octant block of their input by ~1e4.
    # Pure data shaping: the schedule, tenancy and arrival times stay
    # those of the P=0 run; what changes is the dynamic range the
    # block-scaled wire codecs see (a hot member batched into a cohort
    # poisons the shared per-tile scales, and the shadow audit must
    # catch it).
    hot_rng = random.Random(f"{ns.seed}:{ns.rank}:hot")

    def maybe_hot(x):
        if ns.hot_tail <= 0 or hot_rng.random() >= ns.hot_tail:
            return x
        y = x.clone()
        sl = tuple(
            slice(0, max(1, n // 2)) if hot_rng.random() < 0.5
            else slice(n - max(1, n // 2), n) for n in y.shape)
        y[sl] *= 1e4
        return y

    wedged = False
    start = time.monotonic()
    next_flush = ns.flush_every
    for ev in events:
        now = time.monotonic() - start
        if ev.t > now:
            time.sleep(ev.t - now)
            now = ev.t
        # Streaming mode: the persistent drain loop owns dispatch (an
        # injected fault fails that wave's handles but never wedges the
        # loop, so the wedge drill is a flush-mode shape).
        while not ns.streaming and not wedged and now >= next_flush:
            next_flush += ns.flush_every
            try:
                stats["flushed"] += queue.flush(reason="manual")
            except Exception:  # noqa: BLE001 — injected faults land
                # here: the dispatcher wedges (stops draining) while
                # arrivals continue, so the stall is visible to the
                # monitor instead of crashing the generator.
                wedged = True
                stats["wedged"] = True
        try:
            queue.submit(maybe_hot(bufs[(ev.shape, ev.dtype)]),
                         direction=FORWARD if ev.op != "ifft"
                         else BACKWARD,
                         tenant=ev.tenant if has_policy else None)
            stats["submitted"] += 1
        except Exception:  # noqa: BLE001 — quota sheds / admission
            stats["shed"] += 1  # rejects are load-test data, not crashes
    # Let the monitor observe the terminal state: a wedged worker sits
    # on its leftover pending groups until they age past the stall
    # watchdog's grace, so the stall lands in the series before the
    # final sample.
    if wedged:
        time.sleep(ns.linger)
        m = queue._monitor
        if m is not None:
            m.stop()  # final sample; close() would flush (and raise)
    elif ns.streaming:
        # Drain the in-flight waves through the loop, then snapshot the
        # scheduler occupancy into the stats line before close().
        queue.stop(drain=True)
        ws = queue._wave_stats
        if ws is not None:
            snap = ws.snapshot()
            stats["waves"] = snap.get("waves", 0)
            stats["preemptions"] = snap.get("preemptions", 0)
            stats["idle_fraction"] = snap.get("idle_fraction")
        queue.close()
    else:
        try:
            stats["flushed"] += queue.flush(reason="manual")
        except Exception:  # noqa: BLE001
            stats["wedged"] = True
        queue.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # The kernels this worker launched, and at which cases (counted
    # where each wrapper launches its kernel; none on the CPU, where the
    # plain versions run): [*case, count] per case of cuda_fft.CASES.
    stats["launches"] = {**cuda_fft.launches(), **cuda_fuse.launches()}
    stats["cases"] = [[*k, v] for k, v in sorted(cuda_fft.CASES.items(),
                                                 key=str)]
    # Numerics-plane summary (when DFFT_SHADOW_RATE armed the plane):
    # how many requests were shadow-audited and the worst bucket's
    # drift ratio.
    from .numerics import numerics_snapshot

    nsnap = numerics_snapshot()
    if nsnap is not None:
        stats["shadow_sampled"] = nsnap.get("sampled", 0)
        stats["drift_ratio"] = max(
            (b.get("drift_ratio", 0.0)
             for b in (nsnap.get("plans") or {}).values()), default=0.0)
    print(json.dumps(stats), flush=True)
    return 0


# --------------------------------------------------------------- parent


def _spawn(ns: argparse.Namespace, rank: int, dir_: str):
    env = dict(os.environ)
    env["DFFT_MONITOR_DIR"] = dir_
    env["DFFT_MONITOR"] = f"{ns.interval:g}"
    if ns.qos:
        env["DFFT_QOS"] = ns.qos
    else:
        env.pop("DFFT_QOS", None)
    # The fault drill hits exactly one member; everyone else must not
    # inherit the injection from the parent environment.
    if rank != ns.fault_rank:
        env.pop("DFFT_FAULT_INJECT", None)
    # The workers import this package from where the parent found it.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    argv = [sys.executable, "-m", "distributedfft_tpu_torch.loadgen",
            "--worker", "--rank", str(rank)]
    for flag, val in (
            ("--seed", ns.seed), ("--duration", ns.duration),
            ("--rate", ns.rate), ("--mix", ns.mix),
            ("--shapes", ns.shapes), ("--dtypes", ns.dtypes),
            ("--ops", ns.ops), ("--max-batch", ns.max_batch),
            ("--max-wait", ns.max_wait),
            ("--flush-every", ns.flush_every),
            ("--hot-tail", ns.hot_tail),
            ("--mesh", ns.mesh),
            ("--linger", ns.linger),
            ("--device", ns.device)):
        argv.extend([flag, str(val)])
    if ns.streaming:
        argv.append("--streaming")
    return subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributedfft_tpu_torch.loadgen",
        description="Deterministic open-loop mixed-traffic generator "
                    "+ fleet gate")
    ap.add_argument("--procs", type=int, default=2,
                    help="worker processes to spawn (default 2)")
    ap.add_argument("--duration", type=float, default=4.0,
                    help="seconds of traffic per worker (default 4)")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="arrivals/s per worker (default 50)")
    ap.add_argument("--seed", type=int, default=0,
                    help="schedule seed (same seed = same traffic)")
    ap.add_argument("--dir", default=None,
                    help="fleet series directory (default: a fresh "
                         "temp dir, printed)")
    ap.add_argument("--qos", default=DEFAULT_QOS,
                    help="DFFT_QOS spec for the workers ('' disables)")
    ap.add_argument("--mix", default=DEFAULT_MIX,
                    help="tenant:weight arrival mix (default "
                         f"{DEFAULT_MIX!r}; '-' = anonymous)")
    ap.add_argument("--shapes", default=DEFAULT_SHAPES,
                    help=f"shape mix (default {DEFAULT_SHAPES!r})")
    ap.add_argument("--dtypes", default="complex64",
                    help="dtype mix (default complex64)")
    ap.add_argument("--ops", default="fft,ifft",
                    help="op mix: fft|ifft (default both)")
    ap.add_argument("--streaming", action="store_true",
                    help="drive the workers through the persistent "
                         "streaming drain loop (serve()/stop()) instead "
                         "of the explicit flush cadence")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="queue max_batch (default 8)")
    ap.add_argument("--max-wait", type=float, default=0.0,
                    help="queue max_wait_s; 0 = explicit-flush only "
                         "(default)")
    ap.add_argument("--interval", type=float, default=0.25,
                    help="monitor sampling interval seconds "
                         "(default 0.25)")
    ap.add_argument("--flush-every", type=float, default=0.05,
                    help="worker flush cadence seconds (default 0.05)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="worker world size: 0 (default) = single-device "
                         "plans (exact, no wire); N >= 1 = a loopback "
                         "World(N) of distributed plans so the wire "
                         "codec engages (numerics drills)")
    ap.add_argument("--hot-tail", type=float, default=0.0, metavar="P",
                    help="fraction of submits that scale a random "
                         "block of the input by ~1e4 (seeded "
                         "heavy-tailed amplitude mixing; stresses "
                         "shared-exponent wire codecs for numerics "
                         "drift drills)")
    ap.add_argument("--linger", type=float, default=4.5,
                    help="wedged-worker linger after the schedule ends "
                         "so its leftover pending groups age past the "
                         "monitor's stall grace (4x1s by default) and "
                         "the watchdog fires before the final sample "
                         "(default 4.5)")
    ap.add_argument("--fault-rank", type=int, default=0,
                    help="the one rank that inherits DFFT_FAULT_INJECT "
                         "from the parent env (default 0)")
    ap.add_argument("--device", default="cuda",
                    help="the workers' device: cuda (default; worker i "
                         "on cuda:{i %% device_count}), cuda:K, or cpu")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 when the fleet verdict is 'alert' or a "
                         "worker failed")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable fleet verdict")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0,
                    help=argparse.SUPPRESS)
    ns = ap.parse_args(argv)

    if ns.worker:
        return _run_worker(ns)

    from .api import resolve_device
    from .fleet import fleet_health, format_fleet, load_fleet

    resolve_device(ns.device)    # no card: raise here, before spawning
    dir_ = ns.dir or tempfile.mkdtemp(prefix="dfft-fleet-")
    os.makedirs(dir_, exist_ok=True)
    procs = [_spawn(ns, r, dir_) for r in range(max(1, ns.procs))]
    worker_stats, rcs = [], []
    deadline = time.monotonic() + ns.duration + ns.linger + 60.0
    for p in procs:
        try:
            out, _ = p.communicate(
                timeout=max(5.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        rcs.append(p.returncode)
        for line in (out or "").splitlines():
            try:
                worker_stats.append(json.loads(line))
            except ValueError:
                pass

    doc = fleet_health(load_fleet(dir_))
    doc["dir"] = dir_
    doc["workers"] = worker_stats
    doc["worker_rcs"] = rcs
    failed = [r for r, rc in enumerate(rcs) if rc != 0]
    if ns.json:
        print(json.dumps(doc, indent=2, sort_keys=True, default=str))
    else:
        print(f"series dir: {dir_}")
        for w in worker_stats:
            print(f"worker rank={w.get('rank')} pid={w.get('pid')}: "
                  f"{w.get('submitted', 0)} submitted, "
                  f"{w.get('shed', 0)} shed, "
                  f"{w.get('flushed', 0)} flushed"
                  + (f", {w['waves']} waves"
                     f" ({w.get('preemptions', 0)} preempted)"
                     if w.get("waves") is not None else "")
                  + (" [WEDGED]" if w.get("wedged") else ""))
        for r in failed:
            print(f"worker rank={r} exited with code {rcs[r]}")
        print(format_fleet(doc))
    if ns.gate:
        return 1 if doc.get("status") == "alert" or failed else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
