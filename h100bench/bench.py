"""One run of one cell: set-up, the measured window, the traced capture
and the check, on one rank; the cell's files found by name.

A unit of work is a pair: one forward transform of the rank's box of the
seeded field, then one backward transform of its spectrum, through the
port's ``Plan3D.__call__`` on plans made once in set-up (``executor=
"cuda"``, tuning off). The window issues a fixed number of pairs back to
back with no host synchronisation between them, so the host dispatches
ahead; the number is the run's seconds over a pair's time in set-up,
agreed by every rank. CUDA events recorded between pairs give each
pair's time. Two pairs' outputs, one drawn from the seed and the last,
are kept for the check, which runs once the window has closed, the
memory peak has been read and the plans are freed. What each rank holds
is read from the plans, which must run what the cell's files ask for.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import random
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.distributed as dist

from . import check, devtrace, yardstick
from .field import make_field

#: Top-level modules no process of a run may load, compared whole: the
#: port's name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "distributedfft_tpu")
PORT = "distributedfft_tpu_torch"
CODE_ROOT = Path(__file__).resolve().parent.parent

#: Traced captures made before a run gives up on one that lost records,
#: and the fills of a scratch tensor launched outside every pair around
#: the traced pairs in the first (each later capture's pads 4x longer):
#: on the H100 a capture has lost the records of its first launches.
CAPTURES = 4
PAD_LAUNCHES = 64

#: Pairs of each phase of a run, the same in every cell: warm-up, the
#: estimate of a pair's time that sizes the window, the window's pairs
#: kept for the check (the last and the rest drawn from the seed), the
#: traced capture, and the host's enqueue timing.
WARM_PAIRS = 2
ESTIMATE_PAIRS = 20
SAMPLE_PAIRS = 2
TRACE_PAIRS = 20
HOST_PAIRS = 100


class ForbiddenLoaded(RuntimeError):
    """A process of the run loaded one of :data:`FORBIDDEN`."""


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its configuration's and traffic
    mix's files, and its metrics' (name, unit) pairs."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple
    per_layer: tuple
    root: str


@dataclass(frozen=True)
class RunSpec:
    seed: int
    seconds: float
    trace: bool
    cpu: bool
    t_start: float


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root, workload: str) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``, its files read
    from under ``root``."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "h100bench" / "traffic"
                          / f"{entry['traffic']}.json").read_text())
    pick = lambda ms: tuple((m["name"], m["unit"]) for m in ms
                            if _applies(m, workload))
    return Cell(workload, int(entry["chips"]), config, traffic,
                pick(bench["end_to_end"]), pick(bench["per_layer"]),
                str(root))


def _load(path: Path):
    name = "h100bench_file_" + "_".join(path.with_suffix("").parts[-2:])
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(cell: Cell, name: str):
    """``metrics/<name>.py``: ``read(ctx)`` gives the value or None."""
    return _load(Path(cell.root) / "h100bench" / "metrics" / f"{name}.py")


def reference(cell: Cell):
    """The plain reference the configuration names."""
    return _load(Path(cell.root) / "h100bench" / "references"
                 / f"{cell.config['reference']}.py")


def limits(cell: Cell) -> dict:
    return {**cell.config["limits"], **cell.traffic.get("limits", {})}


@dataclass(frozen=True)
class Layout:
    """What the ranks hold: the global shape, the transform, and every
    rank's box (low, high) of the input and of the spectrum, in rank
    order, read from the plans."""

    shape: tuple
    transform: str
    precision: str
    rank: int
    device: torch.device
    in_boxes: tuple
    out_boxes: tuple

    @property
    def in_dtype(self) -> torch.dtype:
        cplx, real = yardstick.DTYPES[self.precision]
        return getattr(torch, cplx if self.transform == "c2c" else real)

    @property
    def out_shape(self) -> tuple:
        return (self.shape if self.transform == "c2c"
                else yardstick.half_shape(self.shape))

    @property
    def in_box(self) -> tuple:
        return self.in_boxes[self.rank]

    @property
    def out_box(self) -> tuple:
        return self.out_boxes[self.rank]


def _boxes(plan, side_in: bool) -> tuple:
    boxes = plan.in_boxes if side_in else plan.out_boxes
    if any(tuple(b.order) != (0, 1, 2) for b in boxes):
        raise ValueError("the plan stores a box in a permuted axis order")
    return tuple((tuple(b.low), tuple(b.high)) for b in boxes)


def layout_for(cell: Cell, rank: int, device, fwd, bwd) -> Layout:
    """The boxes of the forward plan, which the backward plan mirrors and
    which tile the grid on each side; otherwise the check would compare
    the wrong parts."""
    shape = tuple(int(s) for s in cell.config["shape"])
    layout = Layout(shape, cell.traffic["transform"],
                    cell.config["precision"], rank, torch.device(device),
                    _boxes(fwd, True), _boxes(fwd, False))
    if (_boxes(bwd, True), _boxes(bwd, False)) != (layout.out_boxes,
                                                    layout.in_boxes):
        raise RuntimeError("the backward plan's boxes are not the forward "
                           "plan's with input and output swapped")
    ranks = int(cell.config["ranks"])
    for boxes, whole in ((layout.in_boxes, shape),
                         (layout.out_boxes, layout.out_shape)):
        if len(boxes) != ranks:
            raise RuntimeError(f"the plan has {len(boxes)} boxes, the "
                               f"configuration {ranks} ranks")
        yardstick.check_tiling(boxes, whole)
    return layout


class Comm:
    """The ranks of one run: reductions and gathers over
    ``torch.distributed`` (none on one rank)."""

    def __init__(self, size: int, rank: int, device):
        self.size, self.rank, self.device = size, rank, device

    def _reduce(self, vals, op) -> list:
        vals = [float(v) for v in vals]
        if self.size == 1 or not vals:
            return vals
        t = torch.tensor(vals, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=op)
        return t.tolist()

    def max(self, vals) -> list:
        return self._reduce(vals, dist.ReduceOp.MAX)

    def min(self, vals) -> list:
        return self._reduce(vals, dist.ReduceOp.MIN)

    def gather(self, obj) -> list:
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def assemble(self, t: torch.Tensor, boxes, shape) -> torch.Tensor:
        """The global array of ``shape`` whose box ``boxes[r]`` rank r
        holds as ``t``, on every rank (``boxes`` tile ``shape``)."""
        if self.size == 1:
            return t
        out = torch.empty(tuple(shape), dtype=t.dtype, device=t.device)
        for r, (low, high) in enumerate(boxes):
            part = (t.contiguous() if r == self.rank else
                    torch.empty(tuple(h - l for l, h in zip(low, high)),
                                dtype=t.dtype, device=t.device))
            if part.numel():
                dist.broadcast(part, src=r)
                out[low[0]:high[0], low[1]:high[1], low[2]:high[2]] = part
        return out

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def _same(a, b) -> bool:
    """Equal plan settings, ``"none"`` and None both the exact wire."""
    return (None if a == "none" else a) == (None if b == "none" else b)


def make_plans(cell: Cell, world, device, extra: dict | None = None):
    """The forward and backward plans of the cell, through the port's
    public planners: the configuration's decomposition, its ``plan``
    keywords, the traffic mix's, then ``extra`` (the control's
    lower-precision wire). Raises where a plan does not run the
    decomposition or a keyword it was given, as a single-rank plan drops
    an exchange's."""
    from distributedfft_tpu_torch import api

    cfg, tr = cell.config, cell.traffic
    shape = tuple(int(s) for s in cfg["shape"])
    asked = {**cfg.get("plan", {}), **tr.get("plan", {}), **(extra or {})}
    kw = dict(executor="cuda", tune="off", device=device,
              dtype=getattr(torch, yardstick.DTYPES[cfg["precision"]][0]),
              decomposition=cfg["decomposition"], **asked)
    if tr["transform"] == "c2c":
        plans = (api.plan_dft_c2c_3d(shape, world, direction=api.FORWARD,
                                     **kw),
                 api.plan_dft_c2c_3d(shape, world, direction=api.BACKWARD,
                                     **kw))
    else:
        plans = (api.plan_dft_r2c_3d(shape, world, **kw),
                 api.plan_dft_c2r_3d(shape, world, **kw))
    for plan in plans:
        for key, want in (("decomposition", cfg["decomposition"]),
                          *asked.items()):
            got = getattr(plan, key, getattr(plan.options, key, want))
            if not _same(got, want):
                raise ValueError(f"the plan runs {key}={got!r} where the "
                                 f"cell asks for {want!r}")
    return plans


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def draw_sample(seed: int, n: int, count: int) -> set[int]:
    """``count`` pair indices of a window of ``n``: the last, and the
    rest drawn from the seed."""
    rest = random.Random(seed).sample(range(n - 1), min(count - 1, n - 1))
    return set(rest) | {n - 1}


def window(fwd, bwd, x, n: int, sample: set, device):
    """The measured window: ``n`` pairs back to back. Returns the host
    seconds from before the first pair to after the last one finished,
    each pair's seconds by CUDA events (None off the card) and the kept
    pairs' outputs."""
    cuda = device.type == "cuda"
    evs = ([torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
           if cuda else None)
    kept = []
    sync(device)
    t0 = time.perf_counter()
    if cuda:
        evs[0].record()
    for k in range(n):
        y = fwd(x)
        z = bwd(y)
        if cuda:
            evs[k + 1].record()
        if k in sample:
            kept.append((y, z))
        y = z = None
    sync(device)
    secs = time.perf_counter() - t0
    pair_s = ([evs[k].elapsed_time(evs[k + 1]) / 1e3 for k in range(n)]
              if cuda else None)
    return secs, pair_s, kept


def pair_seconds(fwd, bwd, x, n: int, device) -> float:
    """A pair's seconds, for sizing the window: the median of ``n`` pairs
    issued back to back by CUDA events (a moment the host stalls moves
    it little), the host clock's mean off the card."""
    secs, pair_s, _ = window(fwd, bwd, x, n, set(), device)
    return statistics.median(pair_s) if pair_s else secs / n


def kept_bytes(pairs) -> int:
    """Bytes of the storages the outputs of ``pairs`` hold."""
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for pair in pairs for t in pair}
    return sum(storages.values())


def host_calls(fwd, bwd, x, n: int, device) -> list[float]:
    """Host seconds from the forward call's start to the backward call's
    return, each pair issued on an idle card: the enqueue cost."""
    out = []
    for _ in range(n):
        sync(device)
        t = time.perf_counter()
        z = bwd(fwd(x))
        out.append(time.perf_counter() - t)
        z = None
    sync(device)
    return out


def capture(fwd, bwd, x, pairs: int, device, comm: Comm):
    """A ``torch.profiler`` capture of ``pairs`` pairs issued back to
    back, each under a :data:`devtrace.PAIR_SPAN`, between pads of fills
    outside every pair, after one profiled warm-up step. Made again,
    with longer pads, while any rank's capture lost device records;
    raises after :data:`CAPTURES`. Returns the :class:`devtrace.Timeline`."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    scratch = torch.empty(256, dtype=torch.float32, device=device)
    fd, path = tempfile.mkstemp(prefix="h100bench_trace_", suffix=".json")
    os.close(fd)
    try:
        for attempt in range(CAPTURES):
            pads = PAD_LAUNCHES * 4 ** attempt
            with profile(activities=acts,
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1),
                         on_trace_ready=lambda p: p.export_chrome_trace(
                             path)) as prof:
                bwd(fwd(x))
                sync(device)
                prof.step()
                for _ in range(pads):
                    scratch.fill_(0.0)
                for _ in range(pairs):
                    with record_function(devtrace.PAIR_SPAN):
                        z = bwd(fwd(x))
                    z = None
                for _ in range(pads):
                    scratch.fill_(0.0)
                sync(device)
                prof.step()
            with open(path) as f:
                tl = devtrace.parse(json.load(f))
            ok = tl is not None and tl.pairs == pairs and (
                not cuda or tl.complete())
            if comm.min([1.0 if ok else 0.0])[0] == 1.0:
                return tl
        raise RuntimeError(f"{CAPTURES} traced captures lost device records")
    finally:
        os.remove(path)


def check_port(module) -> None:
    """The port must be this checkout's, not an installed copy."""
    where = Path(module.__file__).resolve()
    if not where.is_relative_to(CODE_ROOT):
        raise RuntimeError(f"{PORT} was loaded from {where}, outside the "
                           f"checkout {CODE_ROOT}")


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _device_kind(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def _reduce(values: list, how: str):
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    if how == "min":
        return min(vals)
    if how == "mean":
        return sum(vals) / len(vals)
    return max(vals)


@contextlib.contextmanager
def rank_context(rank: int, size: int, cpu: bool, init: str | None):
    """This rank's device, with the process group of ``size`` ranks
    (NCCL on the cards, gloo on the CPU) open while the block runs."""
    device = torch.device("cpu") if cpu else torch.device("cuda", rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    elif size > 1:
        torch.set_num_threads(2)
    if size > 1:
        dist.init_process_group("gloo" if cpu else "nccl", init_method=init,
                                rank=rank, world_size=size)
    try:
        yield device
    finally:
        if size > 1:
            dist.destroy_process_group()


def open_rank(cell: Cell, rank: int, size: int, device):
    """This rank's :class:`Comm`, world (a 2D one where the
    configuration gives a ``grid``), :class:`Layout` and checked forward
    and backward plans."""
    world = None
    if size > 1:
        from distributedfft_tpu_torch.parallel.mesh import process_group_world

        world = process_group_world(grid=cell.config.get("grid"))
    plans = make_plans(cell, world, device)
    layout = layout_for(cell, rank, device, *plans)
    return Comm(size, rank, device), world, layout, plans


def run_rank(rank: int, size: int, cell: Cell, spec: RunSpec,
             init: str | None = None) -> dict | None:
    """This rank's part of the run; rank 0 returns the result line."""
    with rank_context(rank, size, spec.cpu, init) as device:
        return _run(rank, size, cell, spec, device)


def _run(rank, size, cell, spec, device) -> dict | None:
    import distributedfft_tpu_torch as port
    from distributedfft_tpu_torch import api

    check_port(port)
    comm, _, layout, (fwd, bwd) = open_rank(cell, rank, size, device)
    x = make_field(layout.shape, *layout.in_box, layout.in_dtype, spec.seed,
                   device)
    for _ in range(WARM_PAIRS):
        bwd(fwd(x))
    comm.barrier()
    est = comm.max([pair_seconds(fwd, bwd, x, ESTIMATE_PAIRS, device)])[0]
    n = max(SAMPLE_PAIRS, round(spec.seconds / est))
    sample = draw_sample(spec.seed, n, SAMPLE_PAIRS)
    comm.barrier()
    sync(device)
    cuda = device.type == "cuda"
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - spec.t_start
    secs, pair_s, kept = window(fwd, bwd, x, n, sample, device)
    peak = work_peak = None
    if cuda:
        win_peak = torch.cuda.max_memory_allocated(device)
        peak = max(setup_peak, win_peak)
        # a kept pair before the last outlives its pair; the last pair's
        # outputs are live at the window's end in any loop
        work_peak = max(setup_peak, win_peak - kept_bytes(kept[:-1]))
    kind = _device_kind(device)
    layer, tl = {}, None
    if spec.trace:
        ctx = SimpleNamespace(
            host_call_s=host_calls(fwd, bwd, x, HOST_PAIRS, device),
            timeline=capture(fwd, bwd, x, TRACE_PAIRS, device, comm),
            least_pair_s=yardstick.pair_least_seconds(
                layout.shape, layout.transform, layout.precision,
                float(cell.traffic["flops_factor"]), comm.size, kind))
        tl = ctx.timeline
        for name, _ in cell.per_layer:
            layer[name] = metric_reader(cell, name).read(ctx)
    del x
    for plan in (fwd, bwd):
        api.destroy_plan(plan)
    del fwd, bwd
    if device.type == "cuda":
        torch.cuda.empty_cache()
    per_pair = check.compare(layout, reference(cell), spec.seed, kept, comm)
    kept.clear()
    win = tl.window() if tl is not None else None
    part = dict(setup_s=setup_s, window_s=secs, pair_s=pair_s, peak=peak,
                work_peak=work_peak, layer=layer, found=forbidden_loaded(),
                busy_s=tl.busy() / 1e6 if win else None,
                traced_s=(win[1] - win[0]) / 1e6 if win else None,
                breakdown=devtrace.breakdown(tl) if win else None)
    parts = comm.gather(part)
    found = sorted({m for p in parts for m in p["found"]})
    if found:
        raise ForbiddenLoaded(f"loaded in a rank of the run: "
                              f"{', '.join(found)}")
    if rank != 0:
        return None
    return _line(cell, spec, size, kind, n, parts, per_pair)


def _line(cell, spec, size, kind, n, parts, per_pair) -> dict:
    tr, lim = cell.traffic, limits(cell)
    pair_s = None
    if parts[0]["pair_s"] is not None:
        pair_s = [max(vs) for vs in zip(*(p["pair_s"] for p in parts))]
    peak = _reduce([p["peak"] for p in parts], "max")
    if spec.trace:
        chosen = cell.per_layer
        values = {name: _reduce([p["layer"][name] for p in parts],
                                getattr(metric_reader(cell, name), "REDUCE",
                                        "max"))
                  for name, _ in chosen}
    else:
        chosen = cell.end_to_end
        ctx = SimpleNamespace(
            transforms=2 * n,
            flops_per_transform=yardstick.transform_flops(
                cell.config["shape"], float(tr["flops_factor"])),
            window_s=max(p["window_s"] for p in parts), pair_s=pair_s,
            peak_bytes=_reduce([p["work_peak"] for p in parts], "max"),
            setup_s=max(p["setup_s"] for p in parts))
        values = {name: metric_reader(cell, name).read(ctx)
                  for name, _ in chosen}
    metrics = {name: {"value": values[name], "unit": unit}
               for name, unit in chosen if values[name] is not None}
    device = {"platform": "cpu" if spec.cpu else "gpu", "kind": kind,
              "count": size, "memory_peak_bytes": peak}
    busy = _reduce([p["busy_s"] for p in parts], "mean")
    if spec.trace and busy is not None:
        device["busy_s"] = busy
        device["window_s"] = _reduce([p["traced_s"] for p in parts], "mean")
    nums = check.numbers(per_pair)
    nfail = check.failed(per_pair, lim)
    line = {"correct": nfail == 0, "attempted": 2 * n, "failed": nfail,
            "metrics": metrics, "device": device}
    if spec.trace and parts[0]["breakdown"] is not None:
        line["breakdown"] = parts[0]["breakdown"]
    line["checks"] = {k: {"value": nums[k], "limit": lim[k]}
                      for k in check.NUMBERS}
    return line


def spawn(entry, size: int, *args):
    """``entry(rank, size, *args, init, out)`` in one spawned process per
    rank, meeting at a ``file://`` store in a fresh directory under
    ``$TMPDIR``; waits for all, and returns the JSON rank 0 wrote to
    ``out``. A rank that fails ends the others and raises here."""
    import shutil

    import torch.multiprocessing as mp

    store = tempfile.mkdtemp(prefix="h100bench_")
    try:
        out = os.path.join(store, "result.json")
        mp.start_processes(
            entry, args=(size, *args, "file://" + os.path.join(store, "rdv"),
                         out),
            nprocs=size, join=True, start_method="spawn")
        with open(out) as f:
            return json.load(f)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def rank_entry(rank: int, size: int, cell: Cell, spec: RunSpec, init: str,
               out: str) -> None:
    """A spawned rank: rank 0 writes the result line to ``out``."""
    line = run_rank(rank, size, cell, spec, init)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(line, f)
