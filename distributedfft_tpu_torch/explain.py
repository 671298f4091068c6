"""Plan explain and attribution: predicted against measured, per stage.

The port of ``distributedfft_tpu/explain.py``. For one built plan it
joins, per ``t0..t3`` stage (and ``t_mid`` for an operator plan), three
views:

- **model**: the analytic prediction the tuner ranks with
  (:func:`..plan_logic.model_stage_seconds`: the HBM roofline of each
  FFT pass, each exchange's wire bytes under the plan's transport, the
  K-chunk crossover), on the hardware profile of :func:`device_profile`;
- **compiled**: the memory one call holds. The port compiles nothing per
  plan, so JAX's keys are filled from the caching allocator: argument and
  output bytes from the tensors, ``peak_hbm_bytes`` from
  ``torch.cuda.max_memory_allocated`` over one call, ``temp_bytes`` the
  rest; ``flops``, ``bytes_accessed``, ``compile_seconds`` and
  ``generated_code_bytes`` are None, and on the CPU every field it
  cannot measure is None;
- **measured**: warm per-stage times of the plan's staged pipeline,
  host brackets around each synchronised stage, or with
  ``device_timing=True`` / ``DFFT_DEVICE_TIMING=1`` the time the card
  spent under each stage span of a ``torch.profiler`` timeline
  (:func:`parse_device_trace`; on the CPU the host brackets stay, with
  the reason).

It adds per-stage MFU and link utilisation, a divergence flag wherever
the model falls outside the samples' median + MAD band, the measured
overlap of an overlap-K or concurrent schedule (:mod:`.monitor`) beside
the model's hide budget, and the fusion pass's verdict. Surfaces:
``dfft.explain(plan)``, :func:`format_explain`.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Sequence

import numpy as np
import torch

from .calibrate import _current_identity, matching_profile, model_correction
from .plan_logic import (fused_model_stages, model_concurrent_seconds,
                         model_stage_seconds)
from .tuner import (MODEL_DCN_GBPS, MODEL_HBM_GBPS, MODEL_LAUNCH_SECONDS,
                    MODEL_MM_TFLOPS, MODEL_WIRE_GBPS, _mesh_group,
                    _process_count, mm_tier_tflops, robust_stats)
from .tuner import _allgather_rows as _gather_rows
from .utils import metrics as _metrics
from .utils.timing import _last_tensor, sync
from .utils.trace import OP_STAGE_KEYS, STAGE_KEYS, stage_key

__all__ = [
    "EXPLAIN_SCHEMA",
    "DEVICE_SPECS",
    "device_profile",
    "explain",
    "compiled_summary",
    "model_stage_estimates",
    "stage_divergence",
    "parse_device_trace",
    "device_stage_samples",
    "across_hosts_stages",
    "format_explain",
    "explain_from_record",
]

EXPLAIN_SCHEMA = 1

#: Device name substring -> (peak bf16 TFlop/s, HBM GB/s, per-link wire
#: GB/s). NVIDIA H100 80GB HBM3 (the SXM part, power limit 700 W, as
#: nvidia-smi names it): 989 TFlop/s dense bf16 and 3350 GB/s HBM3 are
#: NVIDIA's published H100 SXM figures (H100 Tensor Core GPU datasheet);
#: the link figure is the tuner's MODEL_WIRE_GBPS, the one-hop NVLink
#: ring measured over NCCL between four such cards.
DEVICE_SPECS = {
    "h100 80gb hbm3": (989.0, 3350.0, MODEL_WIRE_GBPS),
}

#: Divergence gate defaults: the port's copies of the JAX package's
#: ``regress.DEFAULT_MADS`` / ``DEFAULT_MIN_REL`` / ``DEFAULT_MIN_SAMPLES``.
DEFAULT_MADS = 3.0
DEFAULT_MIN_REL = 0.05
DEFAULT_MIN_SAMPLES = 2
_MAD_SCALE = 1.4826       # MAD -> sigma under a normal noise model

_MB = 1.0 / (1024 * 1024)


def _band(med: float, mad: float, mads: float, min_rel: float) -> float:
    """Half-width of the within-noise band around a median (the port's
    copy of ``regress._band``)."""
    return max(_MAD_SCALE * mads * mad, min_rel * abs(med))


def device_profile() -> dict:
    """The hardware constants the model side runs on. Identity is
    ``(torch.cuda.get_device_name(), "gpu")`` on the card, ``("cpu",
    "cpu")`` otherwise (:func:`..calibrate._current_identity`). A card
    in :data:`DEVICE_SPECS` gives ``source: "table"``; anything else
    (the CPU included) the tuner's ranking constants, ``source:
    "default"``, whose peak is the fastest matmul tier the port measured
    (``tuner.MODEL_MM_TFLOPS``). A calibrated profile of this hardware
    (:func:`..calibrate.matching_profile`) wins field by field
    (``source: "calibrated"``, with ``calibrated_at``)."""
    kind, backend = _current_identity()
    spec = next((v for k, v in DEVICE_SPECS.items() if k in kind.lower()),
                None)
    if spec is None:
        peak_tf, hbm, wire, source = (max(MODEL_MM_TFLOPS.values()),
                                      MODEL_HBM_GBPS, MODEL_WIRE_GBPS,
                                      "default")
    else:
        peak_tf, hbm, wire = spec
        source = "table"
    out = {
        "device_kind": kind,
        "backend": backend,
        "peak_tflops": peak_tf,
        "hbm_gbps": hbm,
        "wire_gbps": wire,
        # the inter-node leg's ranking default until a multi-process
        # calibration measures it
        "dcn_gbps": MODEL_DCN_GBPS,
        "launch_seconds": MODEL_LAUNCH_SECONDS,
        "source": source,
    }
    cal = matching_profile()
    if cal is not None and isinstance(cal.get("hbm_gbps"), (int, float)):
        # a field the calibration could not measure keeps its table or
        # default value
        for field in ("hbm_gbps", "wire_gbps", "dcn_gbps", "peak_tflops",
                      "launch_seconds", "mm_bf16_tflops", "mm_f32_tflops",
                      "mm_highest_tflops"):
            v = cal.get(field)
            if isinstance(v, (int, float)) and v > 0:
                out[field] = float(v)
        # the exchange model prices a leg inside a node at wire_gbps, so
        # the per-leg figure wins over the flat ring's
        ici = cal.get("ici_gbps")
        if isinstance(ici, (int, float)) and ici > 0:
            out["wire_gbps"] = float(ici)
        out["source"] = "calibrated"
        if cal.get("recorded_at"):
            out["calibrated_at"] = cal["recorded_at"]
    return out


# ---------------------------------------------------------------- model

def _model_shape_itemsize(plan) -> tuple[tuple[int, int, int], int]:
    """The complex-side 3D shape and itemsize the model runs on: a real
    plan's spectrum side, the per-transform shape of a batched plan (the
    model scales by ``LogicPlan.batch``)."""
    real = plan.kind == "r2c"
    shape = plan.out_shape if (real and plan.forward) else (
        plan.in_shape if real else plan.shape)
    if getattr(plan, "batch", None) is not None and len(shape) == 4:
        shape = shape[1:]
    return tuple(shape), int(plan.dtype.itemsize)


def model_stage_estimates(plan, hw: dict | None = None) -> dict:
    """Per-stage model of one execution of ``plan``
    (:func:`..plan_logic.model_stage_seconds` on the plan's
    :class:`~.plan_logic.LogicPlan`, its transport, K, executor tier and
    fused stages), the exchange scaled by the matching profile's
    correction for the transport and the hide budgets by its
    ``"leg_hide"`` correction."""
    hw = hw or device_profile()
    lp = plan.logic
    if lp is None:
        raise ValueError("plan carries no logic skeleton to model")
    shape, itemsize = _model_shape_itemsize(plan)
    oc = plan.overlap_chunks
    return model_stage_seconds(
        lp, shape, itemsize,
        hbm_gbps=hw["hbm_gbps"], wire_gbps=hw["wire_gbps"],
        launch_seconds=hw["launch_seconds"],
        dcn_gbps=hw.get("dcn_gbps"),
        algorithm=plan.algorithm,
        overlap_chunks=oc if isinstance(oc, int) else 1,
        exchange_correction=model_correction(plan.algorithm),
        hide_correction=model_correction("leg_hide"),
        mm_tflops=mm_tier_tflops(plan.executor),
        fused=fused_model_stages(lp, shape, itemsize,
                                 executor=plan.executor),
    )


# ------------------------------------------------------------- compiled

def _nbytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor or nested lists and
    tuples of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _device_of(x) -> torch.device | None:
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, (list, tuple)):
        for v in x:
            d = _device_of(v)
            if d is not None:
                return d
    return None


def _memory_view(arg_bytes: int, out_bytes: int | None,
                 peak: int | None) -> dict:
    """JAX's compiled-view keys with what the allocator measured; the
    compiler's fields are None (nothing compiles per plan)."""
    return {
        "available": True,
        "compile_seconds": None,
        "flops": None,
        "bytes_accessed": None,
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": (None if peak is None or out_bytes is None
                       else max(0, peak - arg_bytes - out_bytes)),
        "generated_code_bytes": None,
        "peak_hbm_bytes": peak,
    }


def _run_measured(fn, arg) -> tuple[Any, dict]:
    """``fn(arg)`` and its memory view: on the card the allocator's peak
    over the call, less what was live before, plus the argument; on the
    CPU no peak."""
    dev = _device_of(arg)
    on_card = dev is not None and dev.type == "cuda"
    arg_bytes = _nbytes(arg)
    if on_card:
        sync(arg)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    out = fn(arg)
    peak = None
    if on_card:
        sync(out)
        peak = int(torch.cuda.max_memory_allocated(dev) - before + arg_bytes)
    return out, _memory_view(arg_bytes, _nbytes(out), peak)


def _static_out_bytes(plan) -> int:
    """Bytes of this process's output of ``plan``, from its shapes."""
    world = plan.world
    if world is None or world.loopback or plan.brick_edges is not None:
        shape = tuple(plan.out_shape)
    else:
        bpfx = () if plan.batch is None else (plan.batch,)
        shape = bpfx + tuple(plan.out_boxes[world.rank].shape)
    return math.prod(shape) * plan.out_dtype.itemsize


def compiled_summary(plan, x=None, *, run: bool = True) -> dict | None:
    """Whole-plan memory block ``{flops, bytes_accessed, peak_hbm_bytes,
    argument_bytes, output_bytes, temp_bytes, generated_code_bytes,
    compile_seconds}`` (JAX's keys). On the card with ``run`` the plan
    runs once (on a copy of ``x`` when it donates) and the allocator's
    peak is read; else, and on the CPU, the peak and temporary fields
    are None and the output's bytes come from the plan's shapes. None
    when no input can be made (never raises). A measured view (or any
    CPU view) is cached on the plan; with metrics on, the
    ``plan_peak_hbm_bytes`` gauge is set once per plan."""
    cached = getattr(plan, "_compiled_summary", None)
    if cached is not None:
        return cached or None  # False: known unavailable
    from .api import alloc_local

    try:
        if x is None:
            x = alloc_local(plan)
    except Exception:  # noqa: BLE001 -- explain must survive any plan
        plan._compiled_summary = False
        return None
    on_card = x.device.type == "cuda"
    if on_card and run:
        try:
            _, res = _run_measured(plan, x.clone() if plan.donate else x)
        except Exception:  # noqa: BLE001
            plan._compiled_summary = False
            return None
    else:
        res = _memory_view(_nbytes(x), _static_out_bytes(plan), None)
    res.pop("available")
    if on_card and not run:
        return res            # not measured yet: not cached
    plan._compiled_summary = res
    if _metrics._enabled and res.get("peak_hbm_bytes") is not None:
        _metrics.set_gauge(
            "plan_peak_hbm_bytes", res["peak_hbm_bytes"],
            decomposition=plan.decomposition, executor=plan.executor)
    return res


# --------------------------------------------------------------- staged

def _canonical_chain(plan) -> bool:
    """True when the plan runs the canonical chain the staged builders
    rebuild: no brick edges, ``r2c_axis == 2``, the slab chain on its
    default axes, a real pencil chain on its default perm and order."""
    lp = plan.logic
    if lp is None or plan.brick_edges is not None:
        return False
    if getattr(plan, "r2c_axis", 2) != 2:
        return False
    if lp.decomposition == "slab":
        want = (0, 1) if plan.forward else (1, 0)
        return lp.slab_axes in (None, want)
    if lp.decomposition == "pencil":
        if plan.kind == "r2c":
            want_perm = (0, 1, 2) if plan.forward else (1, 2, 0)
            want_order = "col_first" if plan.forward else "row_first"
            return (lp.pencil_perm in (None, want_perm)
                    and lp.pencil_order in (None, want_order))
    return True


def _staged_for(plan):
    """The staged ``[(name, fn), ...]`` pipeline matching ``plan``, or
    None when the plan family has none. An operator plan measures its
    own staged chain (t0 | t2 | t_mid | t2 | t3), on the flat slab only;
    other operator geometries report the model and memory views."""
    if getattr(plan, "op", None):
        lp = plan.logic
        if (lp is None or lp.decomposition != "slab" or plan.world is None
                or plan.world.grid is not None
                or plan.algorithm == "hierarchical"
                or getattr(plan, "multiplier", None) is None):
            return None
        from .parallel.staged import build_slab_op_stages

        oc = plan.overlap_chunks
        try:
            return build_slab_op_stages(
                plan.world, plan.shape, plan.multiplier,
                executor=plan.executor, algorithm=plan.algorithm,
                overlap_chunks=oc if isinstance(oc, int) else 1,
                batch=plan.batch, wire_dtype=plan.wire_dtype)[0]
        except Exception:  # noqa: BLE001 -- no staged view is a soft miss
            return None
    if not _canonical_chain(plan):
        return None
    lp = plan.logic
    oc = plan.overlap_chunks
    real = plan.kind == "r2c"
    kw = dict(executor=plan.executor, forward=plan.forward,
              batch=plan.batch)
    try:
        if lp.decomposition == "single" or plan.world is None:
            if real:
                return None
            from .parallel.staged import build_single_stages

            return build_single_stages(plan.shape, **kw)
        kw.update(algorithm=plan.algorithm,
                  overlap_chunks=oc if isinstance(oc, int) else 1,
                  wire_dtype=plan.wire_dtype)
        if lp.decomposition == "slab":
            if real:
                from .parallel.staged import build_slab_rfft_stages

                return build_slab_rfft_stages(plan.world, plan.shape,
                                              **kw)[0]
            from .parallel.slab import build_slab_stages

            # a hierarchical plan runs over the combined axis; its t2 is
            # the per-leg t2a / t2b stages at K = 1
            return build_slab_stages(plan.world, plan.shape, **kw)[0]
        if real:
            from .parallel.staged import build_pencil_rfft_stages

            return build_pencil_rfft_stages(plan.world, plan.shape, **kw)[0]
        from .parallel.staged import build_pencil_stages

        return build_pencil_stages(plan.world, plan.shape,
                                   perm=lp.pencil_perm,
                                   order=lp.pencil_order, **kw)[0]
    except Exception:  # noqa: BLE001 -- no staged view is a soft miss
        return None


def _measure_stages(stages, x, iters: int) -> tuple[dict, dict, dict]:
    """Per-stage host brackets: one warm pass (each stage's memory view
    read on it), then ``iters`` passes, each stage between two
    :func:`..utils.timing.sync`. Returns ``(samples, compiled, legs)``:
    stage key -> seconds per pass (a key of two stages, the pencil's
    t2a and t2b, summed per pass), stage key -> memory view (summed over
    the key's stages), and the leg sub-keys ``t2a`` / ``t2b`` -> their
    own samples."""
    samples: dict[str, list[float]] = {}
    legs: dict[str, list[float]] = {}
    compiled: dict[str, dict] = {}
    for it in range(iters + 1):
        cur = x
        for name, fn in stages:
            key = stage_key(name) or name
            sync(cur)
            if it == 0:
                cur, res = _run_measured(fn, cur)
                agg = compiled.get(key)
                if agg is None:
                    compiled[key] = res
                else:
                    for k2, v in res.items():
                        if isinstance(v, (int, float)) and not isinstance(
                                v, bool):
                            agg[k2] = v if agg.get(k2) is None else (
                                agg[k2] + v)
                continue
            t0 = time.perf_counter()
            cur = fn(cur)
            sync(cur)
            dt = time.perf_counter() - t0
            samples.setdefault(key, []).append(dt)
            if name[:3] in ("t2a", "t2b"):
                legs.setdefault(name[:3], []).append(dt)
    counts: dict[str, int] = {}
    for name, _ in stages:
        key = stage_key(name) or name
        counts[key] = counts.get(key, 0) + 1
    per_pass: dict[str, list[float]] = {}
    for key, vals in samples.items():
        n = counts.get(key, 1)
        per_pass[key] = vals if n <= 1 else [
            sum(vals[j * n:(j + 1) * n]) for j in range(len(vals) // n)]
    return per_pass, compiled, legs


# -------------------------------------------------------- device timing

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def join_device_ops(doc, span_key=stage_key) -> tuple[list, list] | None:
    """The join of a ``torch.profiler`` chrome trace (Kineto's
    ``traceEvents``): each device operation (``cat`` ``kernel``,
    ``gpu_memcpy``, ``gpu_memset``) with the host time of its launch
    (the ``cuda_runtime`` / ``cuda_driver`` event of the same
    ``args.correlation``) and the innermost ``user_annotation`` span
    whose name ``span_key`` maps to a value (a stage key of
    :func:`..utils.trace.stage_key` by default) and whose host range
    holds that launch. Returns ``(ops, spans)``: ``(op, launch_us or
    None, span or None)`` per operation, and those spans. None for a
    document that is not a trace."""
    raw = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    if not isinstance(raw, list):
        return None
    entries = [e for e in raw if isinstance(e, dict)]
    spans = [e for e in entries if e.get("cat") == "user_annotation"
             and span_key(str(e.get("name", ""))) is not None
             and "ts" in e and "dur" in e]
    launch = {}
    for e in entries:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in _LAUNCH_CATS and corr is not None:
            launch[corr] = float(e["ts"])
    ops = []
    for op in entries:
        if op.get("cat") not in _DEVICE_CATS:
            continue
        t = launch.get((op.get("args") or {}).get("correlation"))
        inner = None
        if t is not None:
            for s in spans:
                ts = float(s["ts"])
                if ts <= t <= ts + float(s["dur"]) and (
                        inner is None or s["dur"] < inner["dur"]):
                    inner = s
        ops.append((op, t, inner))
    return ops, spans


def parse_device_trace(doc, iters: int = 1) -> dict | None:
    """Per-stage device samples out of one ``torch.profiler`` chrome
    trace (:func:`join_device_ops`): each stage span's device time is
    the sum of the operations charged to it, so the seconds are what
    the card spent inside each stage, not the host's bracket.

    Returns ``{"samples": {key: [seconds, ...]}, "chunks": {raw_name:
    {"count", "seconds"}}, "device_pids": [...]}``. When a key's span
    count divides ``iters`` (each pass opens the same spans),
    consecutive groups make one sample per pass; otherwise one aggregate
    sample (total / iters) is kept and the divergence gate withholds its
    verdict. ``chunks`` holds the per-chunk ``[k]`` spans. None when no
    device operation lies under a stage span (the CPU's case): the
    caller falls back to host brackets."""
    joined = join_device_ops(doc)
    if joined is None:
        return None
    ops, spans = joined
    charged: dict[int, float] = {}
    pids = set()
    for op, _, span in ops:
        if span is None:
            continue
        charged[id(span)] = (charged.get(id(span), 0.0)
                             + float(op.get("dur", 0.0)) / 1e6)
        pids.add(op.get("pid"))
    if not charged:
        return None
    per_key: dict[str, list[tuple[float, float]]] = {}
    chunks: dict[str, dict] = {}
    for s in spans:
        name = str(s["name"])
        sec = charged.get(id(s), 0.0)
        per_key.setdefault(stage_key(name), []).append((float(s["ts"]), sec))
        if "[" in name:
            c = chunks.setdefault(name, {"count": 0, "seconds": 0.0})
            c["count"] += 1
            c["seconds"] += sec
    iters = max(1, int(iters))
    samples: dict[str, list[float]] = {}
    for key, evs in per_key.items():
        evs.sort()
        durs = [d for _, d in evs]
        if len(durs) >= iters and len(durs) % iters == 0:
            per = len(durs) // iters
            samples[key] = [sum(durs[i * per:(i + 1) * per])
                            for i in range(iters)]
        else:
            samples[key] = [sum(durs) / iters]
    return {"samples": samples, "chunks": chunks,
            "device_pids": sorted(pids, key=str)}


def _load_trace_doc(path: str):
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


#: Captures :func:`device_stage_samples` makes before it keeps one that
#: lost a pass.
DEVICE_CAPTURES = 4

#: Fills of a small scratch tensor launched outside every stage span
#: right after the profiled window opens and again before it closes, in
#: the first capture; each capture that lost a pass makes the next one's
#: pads :data:`DEVICE_PAD_GROWTH` times longer. On the H100, in a process
#: some minutes old, a capture often lost the records of its first 4-7
#: kernel launches (whatever they were and however long after the window
#: opened) and once its last 2, launches present; the pads take the loss.
DEVICE_PAD_LAUNCHES = 64
DEVICE_PAD_GROWTH = 4


def _pad(scratch: torch.Tensor, n: int) -> None:
    """``n`` fills of ``scratch`` (one kernel launch each on a card),
    then a wait for them."""
    for _ in range(n):
        scratch.fill_(0.0)
    sync(scratch)


def _lost_pass(parsed: dict) -> bool:
    """True when a stage has device time in some passes and none in
    another: the trace dropped that pass's operations (seen on the H100
    at the start of a capture window)."""
    return any(min(v) <= 0.0 < max(v)
               for v in parsed["samples"].values())


def device_stage_samples(
    stages, x, iters: int = 3, logdir: str | None = None,
) -> tuple[dict | None, str | None]:
    """Run ``iters`` pipeline passes under ``torch.profiler`` (CPU and,
    with a card, CUDA activities; every stage span is a
    ``record_function`` range) after one unprofiled warm pass and one
    profiled warm-up step, export the chrome trace to ``logdir`` (a
    temporary directory, removed after, when None) and attribute the
    stage times from the device timeline. The passes sit between two pads
    of :data:`DEVICE_PAD_LAUNCHES` fills outside every stage span. A
    capture in which a stage has device time in some passes and none in
    another lost operations and is made again with longer pads, up to
    :data:`DEVICE_CAPTURES` times. Returns ``(parsed, None)``
    (:func:`parse_device_trace`, with the capture's ``pad_launches``) or
    ``(None, reason)`` when the run cannot give a device attribution
    (the CPU's case)."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    iters = max(1, int(iters))
    tmp = None
    if logdir is None:
        tmp = tempfile.mkdtemp(prefix="dfft_devtrace_")
        logdir = tmp
    path = os.path.join(logdir, "dfft_devtrace.json")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)

    def one_pass():
        cur = x
        for _, fn in stages:
            cur = fn(cur)
        sync(cur)

    held = _last_tensor(x)
    scratch = torch.empty(256, dtype=torch.float32,
                          device=held.device if held is not None else "cpu")

    try:
        one_pass()
        pads = DEVICE_PAD_LAUNCHES
        for attempt in range(DEVICE_CAPTURES):
            if attempt:
                pads *= DEVICE_PAD_GROWTH
            if os.path.exists(path):
                os.remove(path)
            try:
                with profile(activities=acts,
                             schedule=schedule(wait=0, warmup=1,
                                               active=iters, repeat=1),
                             on_trace_ready=lambda p: p.export_chrome_trace(
                                 path)) as prof:
                    one_pass()
                    prof.step()     # the window opens here
                    _pad(scratch, pads)
                    for i in range(iters):
                        one_pass()
                        if i == iters - 1:
                            _pad(scratch, pads)
                        prof.step()
            except Exception as e:  # noqa: BLE001 -- capture is best-effort
                return None, f"profiler capture failed: {type(e).__name__}"
            if not os.path.exists(path):
                return None, "profiler wrote no trace file"
            try:
                parsed = parse_device_trace(_load_trace_doc(path),
                                            iters=iters)
            except (OSError, ValueError) as e:
                return None, f"unreadable trace: {type(e).__name__}"
            if parsed is None:
                return None, ("no device operations under stage spans in "
                              "trace")
            parsed["pad_launches"] = pads
            if not _lost_pass(parsed):
                break
        return parsed, None
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------- multi-host

def _allgather_rows(vec: np.ndarray, group=None) -> np.ndarray:
    """One float row per process of ``group`` as a (nproc, len(vec))
    matrix (:func:`..tuner._allgather_rows`); one row in one process or
    on a loopback world's group (``tuner.LOCAL``)."""
    if _process_count(group) <= 1:
        return np.asarray(vec, np.float64).reshape(1, -1)
    return _gather_rows(vec, group)


def across_hosts_stages(stage_medians: dict, group=None) -> dict:
    """Gather each process's per-stage medians over ``group`` and fold
    them into min / median / max rows with a ``straggler_ratio`` (max /
    median): one slow process stretches ``max`` while the median stays.
    One process gives n = 1 rows of the same schema. Every process of
    the group must call it."""
    vec = np.array(
        [float(stage_medians.get(k) if stage_medians.get(k) is not None
               else math.nan) for k in STAGE_KEYS], np.float64)
    rows = np.asarray(_allgather_rows(vec, group),
                      np.float64).reshape(-1, len(vec))
    out: dict[str, Any] = {}
    for i, key in enumerate(STAGE_KEYS):
        col = rows[:, i]
        col = col[np.isfinite(col)]
        if not len(col):
            continue
        med = float(np.median(col))
        out[key] = {
            "min": float(col.min()),
            "median": med,
            "max": float(col.max()),
            "n": int(len(col)),
            "straggler_ratio": (float(col.max() / med) if med else None),
        }
    return {"processes": int(rows.shape[0]), "stages": out}


# ----------------------------------------------------------- divergence

def stage_divergence(
    model_seconds: float,
    samples: Sequence[float],
    *,
    mads: float = DEFAULT_MADS,
    min_rel: float = DEFAULT_MIN_REL,
    min_samples: int = DEFAULT_MIN_SAMPLES,
) -> dict:
    """Does the model's time for one stage fall outside the samples'
    noise band, median +/- max(``mads`` scaled MADs, ``min_rel`` x
    median)? ``diverged`` is None (no verdict) with fewer than
    ``min_samples`` samples or a model time that is not positive."""
    out = {
        "model_seconds": float(model_seconds),
        "n": len(samples),
        "diverged": None,
    }
    if len(samples) < min_samples or not model_seconds > 0.0:
        return out
    med, mad = robust_stats([float(s) for s in samples])
    band = _band(med, mad, mads, min_rel)
    out.update(
        median=med, mad=mad, band=band,
        ratio=(med / model_seconds) if model_seconds else math.inf,
        diverged=abs(med - model_seconds) > band,
    )
    if out["diverged"]:
        out["direction"] = "slower" if med > model_seconds else "faster"
    return out


def _median(samples: Sequence[float]) -> float | None:
    if not samples:
        return None
    return robust_stats([float(s) for s in samples])[0]


# -------------------------------------------------- overlap attribution

def _overlap_block(
    plan,
    concurrent,
    model: dict,
    *,
    iters: int,
    measure: bool = True,
    mads: float,
    min_rel: float,
    min_samples: int,
) -> dict | None:
    """The measured overlap of the plan's schedule beside the model's
    hide budget, under the stage rows' divergence gate.
    ``concurrent`` (an int >= 2, or a sequence of plans) measures the
    :func:`..stagegraph.schedule_concurrent` interleave (kind
    ``"concurrent"``); otherwise a K > 1 plan measures its chunk
    pipeline (kind ``"overlap_k"``); anything else gives None, as does a
    plan below the stage-graph tier. The measured side runs the merged
    program ``iters`` times (:func:`..monitor.dispatch_spans`); without
    ``measure`` it stays empty. The measured / model ratio is persisted
    (:func:`..monitor.update_overlap_correction`)."""
    from .monitor import (dispatch_spans, overlap_from_events,
                          update_overlap_correction)

    if concurrent is not None:
        if isinstance(concurrent, bool) or (
                isinstance(concurrent, int) and concurrent < 2):
            raise ValueError(f"concurrent must be an int >= 2 or a "
                             f"sequence of plans, got {concurrent!r}")
        cohort = ((plan,) * concurrent if isinstance(concurrent, int)
                  else tuple(concurrent))
        if len(cohort) < 2:
            raise ValueError("a concurrent cohort needs >= 2 plans")
        kind, join = "concurrent", "concurrent"
    else:
        oc = plan.overlap_chunks
        if not (isinstance(oc, int) and oc > 1):
            return None
        cohort, kind, join = (plan,), "overlap_k", "legs"
    if any(getattr(p, "graph", None) is None
           or getattr(p, "logic", None) is None for p in cohort):
        return None

    # the model's hide ratio on the measured join's scale
    if kind == "concurrent":
        hw = device_profile()
        transforms = []
        for p in cohort:
            shape, itemsize = _model_shape_itemsize(p)
            transforms.append((p.logic, shape, itemsize, p.executor))
        mcs = model_concurrent_seconds(
            transforms, hbm_gbps=hw["hbm_gbps"], wire_gbps=hw["wire_gbps"],
            launch_seconds=hw["launch_seconds"],
            dcn_gbps=hw.get("dcn_gbps"))
        seq = mcs["sequential_seconds"]
        model_side = {
            "hide_seconds": mcs["hidden_seconds"],
            "hide_ratio": (mcs["hidden_seconds"] / seq
                           if seq > 0 else None),
            "speedup": mcs["speedup"],
        }
    else:
        t2 = model.get("t2") or {}
        raw = t2.get("raw_seconds")
        legs = t2.get("legs") or []
        hide_total = sum(leg.get("hide_seconds") or 0.0 for leg in legs)
        # hidden wire over raw wire (chunk launches can push the exposed
        # price above the raw wire)
        model_side = {
            "hide_seconds": hide_total,
            "hide_ratio": (min(1.0, hide_total / raw)
                           if isinstance(raw, (int, float)) and raw > 0
                           else None),
        }

    samples: list[float] = []
    groups = None
    for _ in range(max(1, iters) if measure else 0):
        try:
            ov = overlap_from_events(dispatch_spans(cohort))[join]
        except Exception:  # noqa: BLE001 -- attribution, not contract
            return None
        if ov is None:
            break
        samples.append(ov["hide_ratio"])
        groups = ov["groups"]
    block: dict[str, Any] = {
        "kind": kind,
        "cohort": len(cohort),
        "groups": groups,
        "measured_hide_ratio": _median(samples),
        "measured_samples": [round(v, 6) for v in samples],
        "model_hide_seconds": model_side.get("hide_seconds"),
        "model_hide_ratio": model_side.get("hide_ratio"),
    }
    if "speedup" in model_side:
        block["model_speedup"] = model_side["speedup"]
    mr = block["model_hide_ratio"]
    block["divergence"] = stage_divergence(
        mr if isinstance(mr, (int, float)) else 0.0, samples,
        mads=mads, min_rel=min_rel, min_samples=min_samples)
    try:
        update_overlap_correction(block)
    except Exception:  # noqa: BLE001 -- feedback is best-effort
        pass
    return block


# -------------------------------------------------------------- explain

def explain(
    plan,
    *,
    iters: int = 3,
    measure: bool = True,
    device_timing: bool | None = None,
    allgather: bool = False,
    mads: float = DEFAULT_MADS,
    min_rel: float = DEFAULT_MIN_REL,
    min_samples: int = DEFAULT_MIN_SAMPLES,
    concurrent: int | Sequence | None = None,
) -> dict:
    """One attribution record of a built plan: per stage the model, the
    memory view and the measured samples with MFU, link utilisation and
    a divergence verdict; the whole plan's memory view; for overlap-K and
    concurrent schedules the measured overlap (``record["overlap"]``);
    the fusion pass's verdict (``record["fusion"]``).

    ``measure=False`` runs nothing (model and shape-derived views only;
    an overlap block keeps its model side).
    ``iters`` passes feed the samples. ``device_timing`` (None: env
    ``DFFT_DEVICE_TIMING``) takes the samples from the card's timeline
    (:func:`device_stage_samples`), keeping the host brackets' medians in
    ``record["timing"]["host_stage_seconds"]`` and the capture's pad
    length in ``device_pad_launches``; where there is no device
    timeline the host brackets stay and ``timing`` says why.
    ``concurrent`` (an int >= 2 or a sequence of plans) measures the
    cross-transform interleave instead of the plan's own chunks.
    ``allgather=True`` adds min / median / max rows across the processes
    of the plan's world (``record["across_hosts"]``; every process must
    call). Sections the run cannot fill carry None, so the record's
    shape is stable."""
    from .api import alloc_local

    hw = device_profile()
    model = model_stage_estimates(plan, hw)
    world = plan.world
    ndev = 1 if world is None else int(world.size)
    opname = getattr(plan, "op", None) or None
    keys = OP_STAGE_KEYS if "t_mid" in model else STAGE_KEYS
    if opname:
        kind = f"op_{opname}"
    else:
        kind = ("r2c" if plan.kind == "r2c" and plan.forward
                else "c2r" if plan.kind == "r2c" else "c2c")
    oc = plan.overlap_chunks
    opts = plan.options
    record: dict[str, Any] = {
        "schema": EXPLAIN_SCHEMA,
        "generated_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "plan": {
            "shape": list(plan.shape),
            "kind": kind,
            "op": opname,
            "forward": plan.forward,
            "decomposition": plan.decomposition,
            "executor": plan.executor,
            "algorithm": plan.algorithm,
            "overlap_chunks": oc if isinstance(oc, int) else 1,
            "devices": ndev,
            "mesh": (None if world is None
                     else list(world.grid or (world.size,))),
            "dtype": str(plan.dtype).removeprefix("torch."),
            "donate": bool(plan.donate),
            "wire_dtype": plan.wire_dtype,
            # MFU below is judged on this matmul tier's rate
            "mm_precision": getattr(opts, "mm_precision", None),
            "mm_complex": getattr(opts, "mm_complex", None),
        },
        "hw": hw,
        "gate": {"mads": mads, "min_rel": min_rel,
                 "min_samples": min_samples},
    }
    wd = plan.wire_dtype
    try:
        from .parallel.exchange import wire_itemsize, wire_roundtrip_error

        _, itemsize = _model_shape_itemsize(plan)
        record["wire"] = {
            "wire_dtype": wd,
            "compression_err": wire_roundtrip_error(plan.dtype, wd),
            "wire_factor": (wire_itemsize(itemsize, wd) / itemsize
                            if wd else 1.0),
        }
    except Exception:  # noqa: BLE001 -- attribution, not contract
        record["wire"] = {"wire_dtype": wd, "compression_err": None,
                          "wire_factor": None}

    x = None
    try:
        x = alloc_local(plan)
    except Exception:  # noqa: BLE001
        pass

    whole = (compiled_summary(plan, x, run=measure)
             if x is not None else None)
    record["compiled"] = dict(whole) if whole else None

    if device_timing is None:
        device_timing = os.environ.get(
            "DFFT_DEVICE_TIMING", "") not in ("", "0")
    timing: dict[str, Any] = {"source": "host",
                              "device_requested": bool(device_timing)}
    samples: dict[str, list[float]] = {}
    leg_samples: dict[str, list[float]] = {}
    stage_compiled: dict[str, dict] = {}
    chunk_rows: dict[str, dict] = {}
    staged_available = False
    if measure and x is not None and not plan.donate:
        stages = _staged_for(plan)
        if stages is not None:
            try:
                samples, stage_compiled, leg_samples = _measure_stages(
                    stages, x, iters)
                staged_available = True
            except Exception:  # noqa: BLE001 -- sick dispatch, keep going
                samples, stage_compiled, leg_samples = {}, {}, {}
            if staged_available and device_timing:
                dev, reason = device_stage_samples(stages, x, iters)
                if dev is not None:
                    timing["host_stage_seconds"] = {
                        k: _median(v) for k, v in samples.items()
                        if k in keys}
                    samples = {k: v for k, v in dev["samples"].items()
                               if k in keys}
                    chunk_rows = dev["chunks"]
                    timing["source"] = "device"
                    timing["device_pids"] = dev["device_pids"]
                    timing["device_pad_launches"] = dev["pad_launches"]
                else:
                    timing["fallback_reason"] = reason
    record["staged_available"] = staged_available
    record["timing"] = timing

    peak_flops = hw["peak_tflops"] * 1e12
    try:
        tier_tf = mm_tier_tflops(plan.executor)
        if tier_tf:
            peak_flops = tier_tf * 1e12
            record["plan"]["mm_tflops"] = tier_tf
    except Exception:  # noqa: BLE001 -- attribution, not contract
        pass
    wire_bps = hw["wire_gbps"] * 1e9
    stages_out: dict[str, dict] = {}
    diverged: list[str] = []
    for key in keys:
        m = model.get(key) or {}
        s = samples.get(key, [])
        med = _median(s)
        comp = stage_compiled.get(key) or {"available": False}
        div = stage_divergence(
            m.get("seconds", 0.0), s, mads=mads, min_rel=min_rel,
            min_samples=min_samples)
        flops = comp.get("flops") or m.get("flops") or 0.0
        entry = {
            "model": m,
            "compiled": comp,
            "measured": {
                "available": bool(s),
                "seconds": med,
                "best_seconds": min(s) if s else None,
                "samples": [round(v, 9) for v in s],
            },
            "divergence": div,
            "mfu": (flops / (med * peak_flops)
                    if med and flops and peak_flops else None),
        }
        if key == "t2":
            wire = m.get("wire_bytes", 0.0)
            entry["ici_utilization"] = (
                wire / (med * wire_bps) if med and wire else None)
            model_legs = m.get("legs")
            if model_legs and len(model_legs) > 1:
                # each leg's model beside its own samples (pencil t2a /
                # t2b, hierarchical ICI / DCN)
                entry["legs"] = []
                for leg in model_legs:
                    ls = leg_samples.get(leg.get("stage"), [])
                    entry["legs"].append({
                        **leg,
                        "measured_seconds": _median(ls),
                        "measured_samples": [round(v, 9) for v in ls],
                    })
        if chunk_rows:
            mine = {n: c for n, c in chunk_rows.items()
                    if stage_key(n) == key}
            if mine:
                entry["chunks"] = mine
        stages_out[key] = entry
        if div.get("diverged"):
            diverged.append(key)
    record["stages"] = stages_out

    model_total = sum((model.get(k) or {}).get("seconds", 0.0)
                      for k in keys)
    meds = [stages_out[k]["measured"]["seconds"] for k in keys]
    record["totals"] = {
        "model_seconds": model_total,
        "measured_stage_seconds": (sum(v for v in meds if v)
                                   if any(meds) else None),
    }
    record["divergence"] = {"any": bool(diverged), "stages": diverged}
    try:
        record["overlap"] = _overlap_block(
            plan, concurrent, model, iters=iters, measure=measure,
            mads=mads, min_rel=min_rel, min_samples=min_samples)
    except ValueError:
        raise
    except Exception:  # noqa: BLE001 -- attribution, not contract
        record["overlap"] = None
    if allgather:
        try:
            record["across_hosts"] = across_hosts_stages(
                {k: stages_out[k]["measured"]["seconds"]
                 for k in STAGE_KEYS}, _mesh_group(world))
        except Exception:  # noqa: BLE001
            record["across_hosts"] = None
    # the fusion pass's verdict; its sites fill in as the plan runs
    try:
        meta = getattr(plan.graph, "meta", None)
        fu = meta.get("fusion") if isinstance(meta, dict) else None
    except Exception:  # noqa: BLE001 -- plans below the graph tier
        fu = None
    record["fusion"] = None if not isinstance(fu, dict) else {
        "requested": bool(fu.get("requested")),
        "active": bool(fu.get("active")),
        "reasons": [str(r) for r in (fu.get("reasons") or ())],
        "sites": {str(k): dict(v)
                  for k, v in (fu.get("sites") or {}).items()},
    }
    return record


# ------------------------------------------------------------ rendering

def _fmt(v, unit: str = "") -> str:
    if v is None:
        return "-"
    if unit == "s":
        return f"{v:.6f}"
    if unit == "MB":
        return f"{v * _MB:.2f}"
    if unit == "%":
        return f"{100.0 * v:.1f}%"
    if isinstance(v, float) and (abs(v) >= 1e5 or (0 < abs(v) < 1e-3)):
        return f"{v:.3e}"
    return str(v)


def format_explain(record: dict) -> str:
    """The attribution table of one explain record, as text."""
    p = record.get("plan") or {}
    hw = record.get("hw") or {}
    shape = "x".join(str(s) for s in p.get("shape") or [])
    lines = [
        f"plan: {shape} {p.get('kind')} "
        + (f"(fused {p['op']} operator)  " if p.get("op")
           else f"{'forward' if p.get('forward', True) else 'backward'}  ")
        + f"{p.get('decomposition')}/{p.get('algorithm')}"
        f"/{p.get('executor')}/ov{p.get('overlap_chunks')}  "
        f"{p.get('devices')} device(s)  [{p.get('dtype')}]",
        f"hw: {hw.get('device_kind')} (hbm {hw.get('hbm_gbps')} GB/s, "
        f"ici {hw.get('wire_gbps')} GB/s, peak {hw.get('peak_tflops')} "
        f"TFlop/s; {hw.get('source')} profile)",
    ]
    wire = record.get("wire") or {}
    if wire.get("wire_dtype"):
        err = wire.get("compression_err")
        wf = wire.get("wire_factor")
        lines.append(
            f"wire: {wire['wire_dtype']} compression"
            + (f" (x{wf:.2f} wire bytes" if wf else " (")
            + (f", round-trip err {err:.2e})" if err is not None else ")"))
    fu = record.get("fusion")
    if isinstance(fu, dict) and fu.get("requested"):
        if fu.get("active"):
            sites = fu.get("sites") or {}
            routes = sorted(
                f"{v.get('sender', '?')}+{v.get('receiver', '?')}"
                for v in sites.values()) if sites else []
            lines.append(
                "fusion: active (stage-pair mega-kernels"
                + (f"; sites {', '.join(routes)}" if routes else "")
                + ")")
        else:
            lines.append(
                "fusion: requested but gated off "
                f"({', '.join(fu.get('reasons') or ['unknown'])})")
    timing = record.get("timing") or {}
    if timing.get("source") == "device":
        lines.append("timing: device timeline (torch.profiler capture)")
    elif timing.get("device_requested"):
        lines.append(
            f"timing: host sync brackets (device capture fell back: "
            f"{timing.get('fallback_reason', 'unavailable')})")
    header = (f"{'stage':<6} {'model(s)':>11} {'measured(s)':>12} "
              f"{'flops':>11} {'peakHBM(MB)':>12} {'MFU':>7} "
              f"{'ICI':>7}  divergence")
    lines.append(header)
    rec_stages = record.get("stages") or {}
    row_keys = ([k for k in OP_STAGE_KEYS if k in rec_stages]
                or list(STAGE_KEYS))
    for key in row_keys:
        st = rec_stages.get(key) or {}
        m = st.get("model") or {}
        comp = st.get("compiled") or {}
        meas = st.get("measured") or {}
        div = st.get("divergence") or {}
        if div.get("diverged"):
            note = (f"DIVERGED {div.get('ratio', 0.0):.1f}x "
                    f"{div.get('direction', '')}")
        elif div.get("diverged") is False:
            note = "within noise"
        else:
            note = "-"
        lines.append(
            f"{key:<6} {_fmt(m.get('seconds'), 's'):>11} "
            f"{_fmt(meas.get('seconds'), 's'):>12} "
            f"{_fmt(comp.get('flops')):>11} "
            f"{_fmt(comp.get('peak_hbm_bytes'), 'MB'):>12} "
            f"{_fmt(st.get('mfu'), '%'):>7} "
            f"{_fmt(st.get('ici_utilization'), '%'):>7}  {note}")
        for leg in st.get("legs") or []:
            lines.append(
                f"  {leg.get('stage', '?'):<4} "
                f"{_fmt(leg.get('seconds'), 's'):>11} "
                f"{_fmt(leg.get('measured_seconds'), 's'):>12} "
                f"{'':>11} {'':>12} {'':>7} {'':>7}  "
                f"[{leg.get('link', '?')} axis {leg.get('mesh_axis')}, "
                f"{leg.get('parts')} parts"
                + (", pipelined" if leg.get("leg_pipelined") else "")
                + "]")
    tot = record.get("totals") or {}
    lines.append(
        f"totals: model {_fmt(tot.get('model_seconds'), 's')} s | "
        f"measured stages "
        f"{_fmt(tot.get('measured_stage_seconds'), 's')} s")
    whole = record.get("compiled")
    if whole:
        lines.append(
            f"compiled (whole plan): flops {_fmt(whole.get('flops'))} | "
            f"bytes accessed {_fmt(whole.get('bytes_accessed'), 'MB')} MB"
            f" | peak HBM {_fmt(whole.get('peak_hbm_bytes'), 'MB')} MB "
            f"(arg {_fmt(whole.get('argument_bytes'), 'MB')}"
            f" + out {_fmt(whole.get('output_bytes'), 'MB')}"
            f" + temp {_fmt(whole.get('temp_bytes'), 'MB')})"
            f" | compile {_fmt(whole.get('compile_seconds'), 's')} s")
    else:
        lines.append("compiled (whole plan): unavailable")
    ah = record.get("across_hosts")
    if isinstance(ah, dict) and ah.get("stages"):
        lines.append(f"across {ah.get('processes')} host process(es) "
                     f"(measured seconds, min/median/max):")
        for key in STAGE_KEYS:
            row = ah["stages"].get(key)
            if not row:
                continue
            strag = row.get("straggler_ratio")
            lines.append(
                f"  {key:<4} {_fmt(row['min'], 's')} / "
                f"{_fmt(row['median'], 's')} / {_fmt(row['max'], 's')}"
                + (f"  (straggler {strag:.2f}x)"
                   if strag and strag > 1.2 else ""))
    d = record.get("divergence") or {}
    if d.get("any"):
        lines.append(
            f"divergence: model and measurement disagree beyond the "
            f"noise gate on {', '.join(d['stages'])}"
            + (" (default hw profile: constants, not calibration)"
               if hw.get("source") == "default" else ""))
    return "\n".join(lines)


def explain_from_record(record: dict) -> dict | None:
    """The explain block of a run record (``record["explain"]``), the
    record itself when it is an explain record (schema and stages), else
    None."""
    if not isinstance(record, dict):
        return None
    exp = record.get("explain")
    if isinstance(exp, dict) and exp.get("stages"):
        return exp
    if record.get("schema") == EXPLAIN_SCHEMA and isinstance(
            record.get("stages"), dict):
        return record
    return None
