"""Time the exchange transports of the slab C2C plan across processes.

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
name and power limit. Run from the root of a checkout::

    python -m distributedfft_tpu_torch.bench_transports --ranks 4 --n 512
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .api import plan_dft_c2c_3d
from .parallel.exchange import ALGORITHMS
from .parallel.mesh import HYBRID_AXES, process_group_world
from .parallel.slab import build_slab_stages
from .utils.timing import cuda_time_ms, time_staged


def _max(v: float, device) -> float:
    t = torch.tensor([v], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _rank(rank: int, size: int, n: int, cpu: bool, init: str,
          out: str) -> None:
    device = torch.device("cpu")
    if not cpu:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init,
                            rank=rank, world_size=size)
    try:
        flat = process_group_world()
        hybrid = process_group_world(grid=(2, size // 2),
                                     axis_names=HYBRID_AXES)
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
                if cpu:
                    ms = float("nan")
                else:
                    ms = _max(cuda_time_ms(lambda: plan(x), iters=10),
                              device)
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
        if rank == 0:
            with open(os.path.join(out, "bench_transports.json"), "w") as f:
                json.dump(rows, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the CPU (a rehearsal: no times)")
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
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=args.out) as tmp:
        mp.start_processes(
            _rank, args=(args.ranks, args.n, args.cpu,
                         f"file://{os.path.join(os.path.abspath(tmp), 's')}",
                         args.out),
            nprocs=args.ranks, join=True, start_method="spawn")
    rows = json.load(open(os.path.join(args.out, "bench_transports.json")))
    bad = [r for r in rows if not r["bit_identical_to_alltoall_k1"]]
    for r in rows:
        print(json.dumps(r), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
