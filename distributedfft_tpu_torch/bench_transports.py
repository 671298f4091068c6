"""Time the exchange transports of the slab C2C plan, or two plans as
one concurrent schedule, across processes.

One process per card (NCCL; ``--cpu`` runs gloo on the CPU at a small
size to rehearse), meeting at a ``file://`` store under ``--out``. For
each transport (``alltoall``, ``alltoallv``, ``ppermute`` on the 1D
world of all ranks; ``hierarchical`` on the (2, P/2) hybrid world) and
each overlap K (1, 2, ``"auto"``) it checks that the forward output
equals the ``alltoall``, K = 1 plan's bit for bit on every rank, times
the forward plan (CUDA events, median of 10, the largest over the
ranks) and its staged pipeline (best of 5 per stage, the largest over
the ranks: t0, t2 -- at K = 1 the hierarchical t2a and t2b legs -- and
t3), and prints one JSON line per case after a line with the card's
name and power limit.

With ``--concurrent`` it takes two pairs of n^3 C2C plans instead: two
slab plans on the 1D world of all ranks, and a slab (``hierarchical``)
and a pencil plan on the (2, P/2) hybrid world. For each pair it checks
that :func:`.stagegraph.schedule_concurrent`'s outputs equal the plans
called one after another, bit for bit on every rank, times the schedule
against the two calls (as above), then a
:class:`.stagegraph.WaveSchedule` of 4 waves of the pair (``depth`` 2),
and prints one JSON line per pair.

With ``--tune`` every rank first runs :func:`.calibrate.calibrate` (its
wire figure a ring shift over the ranks: NVLink between the cards of one
node), then plans one n^3 slab C2C plan over the 1D world of all ranks
with ``tune="measure"`` (a wisdom store and profile of the run's own,
under ``--out``), prints its winner, and the run fails unless every
rank's winner is the same; the profile, each rank's winner and rank 0's
candidate times are printed as JSON lines. Run from the root of a
checkout::

    python -m distributedfft_tpu_torch.bench_transports --ranks 4 --n 512
    python -m distributedfft_tpu_torch.bench_transports --ranks 4 --n 512 \
        --concurrent
    python -m distributedfft_tpu_torch.bench_transports --ranks 4 --n 512 \
        --tune
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .api import plan_dft_c2c_3d
from .parallel.exchange import ALGORITHMS
from .parallel.mesh import HYBRID_AXES, process_group_world
from .parallel.slab import build_slab_stages
from .stagegraph import WaveSchedule, schedule_concurrent
from .utils.timing import cuda_time_ms, time_staged

#: Each mode's result file and the key that says its check held.
RESULTS = {"transports": ("bench_transports.json",
                          "bit_identical_to_alltoall_k1"),
           "concurrent": ("bench_concurrent.json",
                          "bit_identical_to_sequential"),
           "tune": ("bench_tune.json", "winners_agree")}


def _max(v: float, device) -> float:
    t = torch.tensor([v], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _worlds(size: int):
    return process_group_world(), process_group_world(
        grid=(2, size // 2), axis_names=HYBRID_AXES)


def _ms(fn, cpu: bool, device) -> float:
    return float("nan") if cpu else _max(cuda_time_ms(fn, iters=10), device)


def _transport_rows(rank: int, size: int, n: int, cpu: bool,
                    device) -> list:
    flat, hybrid = _worlds(size)
    shape = (n, n, n)
    g = torch.Generator(device=device)
    g.manual_seed(4242 + rank)
    base = plan_dft_c2c_3d(shape, flat, device=device)
    x = torch.randn(base.in_boxes[rank].shape, generator=g,
                    device=device, dtype=torch.complex64)
    y0 = base(x)
    rows = []
    for alg in ALGORITHMS:
        world = hybrid if alg == "hierarchical" else flat
        for k in (1, 2, "auto"):
            plan = plan_dft_c2c_3d(shape, world, device=device,
                                   algorithm=alg, overlap_chunks=k)
            same = torch.equal(plan(x), y0)
            ok = _max(0.0 if same else 1.0, device) == 0.0
            ms = _ms(lambda: plan(x), cpu, device)
            stages, _ = build_slab_stages(
                world, shape, algorithm=alg,
                overlap_chunks=plan.overlap_chunks)
            times, _ = time_staged(stages, x, iters=5)
            rows.append(dict(
                algorithm=alg, K=plan.overlap_chunks,
                world=list(world.grid) if world.grid else [size],
                bit_identical_to_alltoall_k1=ok, forward_ms=ms,
                stages_ms={s: _max(t, device) * 1e3
                           for s, t in times.times.items()}))
    return rows


def _concurrent_rows(rank: int, size: int, n: int, cpu: bool,
                     device) -> list:
    flat, hybrid = _worlds(size)
    shape = (n, n, n)
    pairs = {
        "slab+slab": [plan_dft_c2c_3d(shape, flat, device=device)
                      for _ in range(2)],
        "slab+pencil": [plan_dft_c2c_3d(shape, hybrid, device=device,
                                        algorithm="hierarchical"),
                        plan_dft_c2c_3d(shape, hybrid, device=device,
                                        decomposition="pencil")],
    }
    rows = []
    for label, plans in pairs.items():
        g = torch.Generator(device=device)
        g.manual_seed(4242 + rank)
        xs = [torch.randn(p.in_boxes[rank].shape, generator=g,
                          device=device, dtype=torch.complex64)
              for p in plans]
        cp = schedule_concurrent(plans)
        seq = lambda: tuple(p(x) for p, x in zip(plans, xs))
        same = all(torch.equal(a, b) for a, b in zip(cp(*xs), seq()))
        ok = _max(0.0 if same else 1.0, device) == 0.0
        ws = WaveSchedule(max_width=2, depth=2)
        start = time.perf_counter()
        for _ in range(4):
            ws.dispatch(plans, xs)
        ws.drain()
        waves_s = time.perf_counter() - start
        rows.append(dict(
            pair=label, n=n, ranks=size,
            decompositions=[p.decomposition for p in plans],
            algorithms=[p.algorithm for p in plans],
            bit_identical_to_sequential=ok,
            concurrent_ms=_ms(lambda: cp(*xs), cpu, device),
            sequential_ms=_ms(seq, cpu, device),
            waves_host_s=_max(waves_s, device),
            wave_records=[{k: r[k] for k in ("index", "width",
                                             "interleaved", "duration_s")}
                          for r in ws.records]))
    return rows


def _tune_rows(rank: int, size: int, n: int, cpu: bool, device,
               store: str) -> list:
    """Calibrate on every rank, then one tuned slab plan over the world
    of all ranks (wisdom and profile under ``store``); one row with the
    profile, every rank's winner and whether they agree."""
    from . import calibrate, tuner
    from .utils import metrics

    os.environ["DFFT_WISDOM"] = os.path.join(store, "wisdom.jsonl")
    os.environ["DFFT_HW_PROFILE"] = os.path.join(store, "hwprofile.json")
    prof = calibrate.calibrate(iters=10, device=device)
    if rank == 0:
        calibrate.write_profile(prof)
    dist.barrier()
    world = process_group_world()
    metrics.enable_metrics()
    start = time.perf_counter()
    plan = plan_dft_c2c_3d((n, n, n), world, device=device, tune="measure")
    tune_s = time.perf_counter() - start
    label = tuner.tuned_label(plan)
    print(f"rank {rank}: tuned winner {label} ({tune_s:.1f} s)", flush=True)
    labels = [None] * size
    dist.all_gather_object(labels, label)
    entries, _ = tuner.load_wisdom(os.environ["DFFT_WISDOM"])
    times = next(iter(entries.values()), {}).get("times", {})
    return [dict(n=n, ranks=size, profile=prof, winners=labels,
                 winners_agree=len(set(labels)) == 1,
                 candidate_s=times, tune_s=_max(tune_s, device),
                 timing_executions=metrics.counter_total(
                     "tune_timing_executions"))]


def _rank(rank: int, size: int, n: int, cpu: bool, mode: str,
          init: str, out: str) -> None:
    device = torch.device("cpu")
    if not cpu:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init,
                            rank=rank, world_size=size)
    try:
        if mode == "tune":
            rows = _tune_rows(rank, size, n, cpu, device,
                              os.path.dirname(init.removeprefix("file://")))
        else:
            rows = (_concurrent_rows if mode == "concurrent"
                    else _transport_rows)(rank, size, n, cpu, device)
        if rank == 0:
            with open(os.path.join(out, RESULTS[mode][0]), "w") as f:
                json.dump(rows, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the CPU (a rehearsal: no times)")
    ap.add_argument("--concurrent", action="store_true",
                    help="time two plans as one concurrent schedule")
    ap.add_argument("--tune", action="store_true",
                    help="calibrate, then one tuned slab plan per rank")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    if not args.cpu:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < args.ranks:
            print(f"needs {args.ranks} NVIDIA cards", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True)
        print(smi.stdout.strip(), flush=True)
    if args.ranks < 2 or args.ranks % 2:
        print("--ranks must be even and at least 2", file=sys.stderr)
        return 1
    mode = ("tune" if args.tune else "concurrent" if args.concurrent
            else "transports")
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=args.out) as tmp:
        mp.start_processes(
            _rank, args=(args.ranks, args.n, args.cpu, mode,
                         f"file://{os.path.join(os.path.abspath(tmp), 's')}",
                         args.out),
            nprocs=args.ranks, join=True, start_method="spawn")
    name, ok = RESULTS[mode]
    rows = json.load(open(os.path.join(args.out, name)))
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0 if all(r[ok] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
