"""Measured plan autotuner with a persistent wisdom store.

The port of ``distributedfft_tpu/tuner.py``. The reference builds
several backends' plans side by side and keeps the fastest
(``setFFTPlans``, ``fft_mpi_3d_api.cpp:318-429``); heFFTe and AccFFT
found that the best decomposition and transport depend on the
configuration and must be searched, and FFTW's wisdom pays the search
once. This module searches the joint space

    decomposition (slab | pencil) x transport (alltoall | alltoallv |
    ppermute, hierarchical on a hybrid world) x executor x overlap K
    x wire codec (under an error budget)

in three tiers:

1. **Candidates** (:func:`enumerate_candidates`, :func:`prune_candidates`):
   the space is enumerated and pruned to at most ``DFFT_TUNE_MAX``
   survivors by an analytical model (:func:`model_cost`: the exchanges'
   wire bytes of :func:`.plan_logic.exchange_payloads` under each
   transport and three HBM passes) before anything is built. The model
   ranks; it never picks.
2. **The tournament** (:func:`measured_select`, also behind
   ``executor="auto"``): the processes of a process-group world agree
   on the candidates every one of them built, time them in the same
   order, gather the whole time matrix and take the winner from process
   0's row among the candidates finite on every process.
3. **Wisdom**: winners are appended to a JSONL store (``DFFT_WISDOM``;
   default ``<compile cache dir>/wisdom.jsonl``) keyed by plan family,
   problem, world, hardware and library versions, and replayed by
   ``PlanOptions.tune="wisdom"|"measure"`` with no timing execution.

The ranking constants below come from ``calibrate()`` runs on the
card; a matching calibrated profile refines them with its measured
matmul rates and its per-transport corrections. Knobs:
``DFFT_TUNE``, ``DFFT_WISDOM``, ``DFFT_TUNE_ITERS`` (``ITERS`` or
``ITERSxREPEATS``), ``DFFT_TUNE_MAX``, ``DFFT_AUTO_EXECUTORS``,
``DFFT_TUNE_CORRECTION``, ``DFFT_WIDTH_TOURNAMENT``.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .parallel.exchange import WIRE_BYTE_KEYS, np_dtype
from .parallel.mesh import World
from .plan_logic import (PlanOptions, auto_overlap_chunks,
                         eligible_decompositions, exchange_payloads,
                         logic_plan3d, resolve_tune_mode)
from .utils import metrics as _metrics
from .utils.cache import compile_cache_dir
from .utils.trace import timed_span

__all__ = [
    "Candidate",
    "enumerate_candidates",
    "prune_candidates",
    "model_cost",
    "tune_budget",
    "agree_winner",
    "measured_select",
    "default_wisdom_path",
    "wisdom_key",
    "load_wisdom",
    "lookup_wisdom",
    "record_wisdom",
    "stale_wisdom_entries",
    "tuned_plan",
    "tuned_label",
    "width_budget",
    "concurrent_width_key",
    "tune_concurrent_width",
]

WISDOM_SCHEMA = 1

#: Survivor cap of the pruning stage (``DFFT_TUNE_MAX`` overrides).
DEFAULT_MAX_CANDIDATES = 8

# Ranking constants of the pruning model: they order candidates and never
# pick a winner. Measured by calibrate() on each of four NVIDIA H100 80GB
# HBM3 cards at 700.00 W (nvidia-smi name and power limit; torch 2.11,
# CUDA 12.8), rank 0's profile of `python -m
# distributedfft_tpu_torch.bench_transports --ranks 4 --n 512 --tune`:
# the link from the one-hop ring of 8 MiB blocks between the cards
# (NVLink, NCCL send/recv), the launch floor from a tiny op synchronised
# per call. HBM from the streamed v + 1 over the profile's 1 GiB block,
# the lower of two runs of `python -m distributedfft_tpu_torch.calibrate
# --sizes` on one such card (2994.96 and 3022.49 GB/s).
MODEL_WIRE_GBPS = 62.75
MODEL_HBM_GBPS = 2995.0
MODEL_LAUNCH_SECONDS = 2.04e-5
#: Inter-node leg: a ranking guess (no inter-node link was measured; the
#: four cards share one node), set below the measured NVLink ring.
MODEL_DCN_GBPS = 25.0
#: Matmul rate per precision tier (TFlop/s) as the port runs each
#: (:mod:`.ops.dft_matmul`; n = 8192, same run): ``bf16`` rounds the
#: operands and multiplies in fp32, ``f32`` is TF32, ``highest`` fp32
#: with TF32 off. A matching profile's ``mm_bf16_tflops`` /
#: ``mm_f32_tflops`` / ``mm_highest_tflops`` override
#: (:func:`mm_tier_tflops`).
MODEL_MM_TFLOPS = {"bf16": 50.35, "f32": 454.35, "highest": 51.86}

#: Executor order where the model cannot rank them (the menu order of
#: ``api._AUTO_CANDIDATES``).
_EXECUTOR_RANK = ("torch", "torch_minor", "matmul", "cuda")

#: ``measured_select``'s group for a loopback world: this process alone.
LOCAL = "local"


@dataclass(frozen=True)
class Candidate:
    """One point of the search space (what a wisdom entry records).
    ``wire_dtype`` is the wire codec (None: exact); compressed candidates
    enter only for plans with a ``max_roundtrip_err`` budget."""

    decomposition: str
    algorithm: str
    executor: str
    overlap_chunks: int
    wire_dtype: str | None = None

    @property
    def label(self) -> str:
        base = (f"{self.decomposition}/{self.algorithm}/{self.executor}"
                f"/ov{self.overlap_chunks}")
        return base + (f"+w{self.wire_dtype}" if self.wire_dtype else "")


def tuned_label(plan) -> str:
    """A tuned plan's winner as ``decomposition/transport/executor/ovK
    [+wDTYPE]``."""
    opts = plan.options
    return Candidate(
        decomposition=plan.decomposition,
        algorithm=opts.algorithm,
        executor=plan.executor,
        overlap_chunks=int(opts.overlap_chunks or 1),
        wire_dtype=getattr(opts, "wire_dtype", None),
    ).label


# ------------------------------------------------------------ candidates

#: Executor bases whose compute the model prices as dense matmul-DFT
#: contractions. The JAX package prices ``pallas`` so too (its TPU
#: kernels are MXU matmul DFTs); the port's ``cuda`` kernels are radix
#: FFTs, whose tier reaches only the ``dft_matmul`` fallback of short or
#: prime lengths, so the HBM roofline alone prices them.
MM_PRICED_BASES = ("matmul",)


def mm_tier_tflops(executor: str) -> float | None:
    """The matmul rate (TFlop/s) the model prices a matmul-priced
    executor's contractions at (:data:`MM_PRICED_BASES`): its tier's
    measured rate from a matching calibrated profile, else
    :data:`MODEL_MM_TFLOPS`. A bare label is the ``highest`` tier. None
    for executors whose compute is no matmul.

    The port measures each of its three tiers (``mm_highest_tflops``
    among them); a profile without that field prices ``highest`` at half
    the ``f32`` rate, as the JAX package derives it."""
    from .calibrate import matching_profile
    from .ops.executors import split_executor

    base = executor.split(":", 1)[0]
    if not base.startswith(MM_PRICED_BASES):
        return None
    tier = (split_executor(executor)[1] or "highest") if ":" in executor \
        else "highest"
    prof = matching_profile()
    if prof is not None:
        rate = prof.get(f"mm_{tier}_tflops")
        if isinstance(rate, (int, float)) and rate > 0:
            return float(rate)
        f32 = prof.get("mm_f32_tflops")
        if tier == "highest" and isinstance(f32, (int, float)) and f32 > 0:
            return float(f32) / 2.0
    return MODEL_MM_TFLOPS[tier]


def candidate_roundtrip_error(cand: Candidate, dtype) -> float:
    """The round-trip error a candidate's reduced-accuracy axes cost
    together: the wire cast's
    (:func:`.parallel.exchange.wire_roundtrip_error`) plus the executor
    tier's (:func:`.ops.executors.executor_roundtrip_error`), the sum
    one ``max_roundtrip_err`` budget governs. 0.0 for an exact
    candidate."""
    from .ops.executors import executor_roundtrip_error
    from .parallel.exchange import wire_roundtrip_error

    err = 0.0
    if cand.wire_dtype is not None:
        err += wire_roundtrip_error(dtype, cand.wire_dtype)
    err += executor_roundtrip_error(cand.executor, dtype)
    return err


def _cuda_reads_tiers(shape: Sequence[int], itemsize: int = 8,
                     real: bool = False) -> bool:
    """Whether a plan's ``cuda`` executor reaches a matmul product, the
    only place its tier acts: its kernels are radix FFTs, and
    :func:`.ops.cuda_fft.fft_along_axis` sends to :mod:`.ops.dft_matmul`
    every transform of a complex128 plan (``itemsize`` 16) and a length
    with neither a kernel split nor a two-level one. ``real``: the last
    axis runs at its packed half length where that is even and > 2
    (:mod:`.ops.realfft`)."""
    from .ops import cuda_fft

    if itemsize != 8:
        return True
    lengths = set(int(n) for n in shape)
    if real and shape[-1] % 2 == 0 and shape[-1] > 2:
        lengths.add(int(shape[-1]) // 2)
    return any(n > 1 and not cuda_fft.eligible(n)
               and cuda_fft.outer_split(n) is None for n in lengths)


def _cross_tiers(execs: Sequence[str],
                 mm_tiers: Sequence[str | None],
                 cuda_tiers: bool) -> list[str]:
    """The executor axis crossed with the precision tiers: each
    matmul-family base gains one tiered label per non-None tier; others
    and the None tier keep the bare name. ``cuda_tiers`` False leaves
    ``cuda`` bare too (:func:`_cuda_reads_tiers`: its tiered labels
    would run the same kernels). Order kept, deduplicated."""
    from .ops.executors import MM_EXECUTOR_BASES, tiered_name

    bases = MM_EXECUTOR_BASES if cuda_tiers else tuple(
        b for b in MM_EXECUTOR_BASES if b != "cuda")
    out: list[str] = []
    for ex in execs:
        for tier in mm_tiers:
            if (tier is not None
                    and ex.split(":", 1)[0].startswith(bases)
                    and ":" not in ex):
                name = tiered_name(ex, tier)
            else:
                name = ex
            if name not in out:
                out.append(name)
    return out


def _default_executors(device=None) -> list[str]:
    """The executor axis: ``DFFT_AUTO_EXECUTORS`` or the menu of
    ``api._AUTO_CANDIDATES``, without ``auto`` itself and, off the card
    (``device`` not CUDA; no CUDA when None), without ``cuda``: there its
    kernels run their plain versions, which is not worth measuring."""
    from .api import _AUTO_CANDIDATES

    names = [e.strip() for e in os.environ.get(
        "DFFT_AUTO_EXECUTORS", ",".join(_AUTO_CANDIDATES)).split(",")
        if e.strip() and e.strip() != "auto"]
    on_card = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    if not on_card:
        names = [n for n in names if not n.startswith("cuda")] or ["torch"]
    return names


def _overlap_values(shape, ndev: int, itemsize: int) -> list[int]:
    """The K axis: 1, the auto model's K and twice it."""
    k = auto_overlap_chunks(shape, ndev, itemsize)
    return sorted({1, k, 2 * k}) if k > 1 else [1]


def enumerate_candidates(
    shape: Sequence[int],
    ndev: int,
    *,
    mesh_dims: tuple[int, ...] | None = None,
    executors: Sequence[str] | None = None,
    itemsize: int = 8,
    batch: int | None = None,
    hybrid: bool = False,
    wire_dtypes: Sequence[str | None] = (None,),
    mm_tiers: Sequence[str | None] = (None,),
    real: bool = False,
) -> list[Candidate]:
    """The joint (decomposition x transport x executor x K x wire x tier)
    space of one plan. ``mesh_dims`` (a caller's world) pins the
    decomposition: 1D slab, 2D pencil; an int count leaves both.
    ``batch`` scales the block the K axis brackets. ``hybrid`` (a
    dcn x ici world) runs pencils on the flat transports and the slab
    chain only under ``hierarchical``. ``wire_dtypes`` and ``mm_tiers``
    are the reduced-accuracy axes (widened by the tuned planner under a
    budget); ``cuda`` takes the tiers only where
    :func:`_cuda_reads_tiers` (``real``: an R2C plan) says a tier reaches
    its products, where the JAX package crosses ``pallas`` always. Every
    ``cuda``-family executor also enters fused (``cuda:fuse``), crossed
    only with a real codec at K = 1, the plans whose fusion pass can
    act."""
    from .ops.executors import FUSE_BASES, fused_name, split_fuse
    from .parallel.exchange import FLAT_ALGORITHMS

    shape = tuple(int(s) for s in shape)
    if hybrid:
        pairs = [("pencil", alg) for alg in FLAT_ALGORITHMS]
        pairs += [("slab", "hierarchical")]
    else:
        if mesh_dims is not None:
            decomps: tuple[str, ...] = (
                "slab" if len(mesh_dims) == 1 else "pencil",)
        else:
            decomps = tuple(d for d in eligible_decompositions(shape, ndev)
                            if d != "single")
        pairs = [(d, alg) for d in decomps for alg in FLAT_ALGORITHMS]
    execs = _cross_tiers(
        list(executors) if executors is not None else _default_executors(),
        mm_tiers, _cuda_reads_tiers(shape, itemsize, real))
    fused_execs = []
    for ex in execs:
        try:
            bare, has_fuse = split_fuse(ex)
        except ValueError:
            continue
        if not has_fuse and bare.split(":", 1)[0] in FUSE_BASES:
            fused_execs.append(fused_name(ex, True))
    ks = _overlap_values(shape, ndev, itemsize * (batch or 1))
    out = []
    for d, alg in pairs:
        for wd in wire_dtypes:
            for k in ks:
                for ex in execs:
                    out.append(Candidate(d, alg, ex, k, wd))
                if wd is not None and k == 1:
                    for ex in fused_execs:
                        out.append(Candidate(d, alg, ex, k, wd))
    return out


def model_cost(
    cand: Candidate,
    shape: Sequence[int],
    mesh,
    *,
    itemsize: int = 8,
    batch: int | None = None,
    corrected: bool = True,
) -> float:
    """Analytical seconds of one candidate: the pruning model.

    Compute is three HBM passes of the rank's block (a matmul-family
    executor's dense contraction flops at its tier's rate when slower);
    each exchange's wire bytes are :func:`.plan_logic.exchange_payloads`
    under the candidate's transport, scaled by the codec, at the link
    rate, with :func:`.transport_steps` launches; at K chunks the exposed
    exchange is ``t/K + max(0, t - t_stage)(K-1)/K`` plus K-1 launches a
    step. A fused candidate (``cuda:fuse`` with a codec at K = 1) keeps
    one stream of each fused stage. ``batch`` prices B transforms. The
    exchange term is scaled by the matching profile's
    ``model_correction`` for the transport unless ``corrected=False`` or
    ``DFFT_TUNE_CORRECTION=0``. ``mesh`` is the plan's world (a
    :class:`~.parallel.mesh.World`, an int, a ``(rows, cols)`` tuple or
    None)."""
    from .calibrate import model_correction
    from .parallel.exchange import exchange_model_seconds

    corr = 1.0
    if corrected and os.environ.get("DFFT_TUNE_CORRECTION", "1") != "0":
        corr = model_correction(cand.algorithm)
    shape = tuple(int(s) for s in shape)
    lp = logic_plan3d(shape, mesh, PlanOptions(
        decomposition=cand.decomposition, algorithm=cand.algorithm,
        wire_dtype=cand.wire_dtype or "none", tune="off"), batch=batch)
    ndev = lp.world.size if lp.world is not None else 1
    world_bytes = itemsize * math.prod(shape) * (batch or 1)
    t_fft = 3 * 2 * (world_bytes / ndev) / (MODEL_HBM_GBPS * 1e9)
    mm_rate = mm_tier_tflops(cand.executor)
    if mm_rate is not None:
        from .plan_logic import mm_dft_flops

        t_mm = (mm_dft_flops(shape) * (batch or 1) / ndev) / (mm_rate * 1e12)
        t_fft = max(t_fft, t_mm)
    if cand.wire_dtype is not None and cand.overlap_chunks == 1:
        from .ops.executors import split_fuse

        try:
            _, has_fuse = split_fuse(cand.executor)
        except ValueError:
            has_fuse = False
        if has_fuse:
            from .parallel.exchange import wire_itemsize

            wf = wire_itemsize(itemsize, cand.wire_dtype) / float(itemsize)
            if wf < 1.0:
                nf = 3 if cand.decomposition == "pencil" else 1
                t_fft *= 1.0 - nf * (1.0 - wf) / 6.0
    payloads = exchange_payloads(lp, shape, itemsize)
    t_stage = t_fft / (len(payloads) + 1)
    leg_pipelined = (cand.algorithm == "hierarchical"
                     and cand.overlap_chunks > 1)
    dcn_raw = 0.0
    if leg_pipelined:
        for e in payloads:
            if e["stage"] == "t2b":
                wb = (e[WIRE_BYTE_KEYS[cand.algorithm]]
                      * e.get("wire_factor", 1.0) / ndev)
                gb = (MODEL_DCN_GBPS if e.get("link") == "dcn"
                      else MODEL_WIRE_GBPS)
                dcn_raw = exchange_model_seconds(
                    wb, e["parts"], cand.algorithm, wire_gbps=gb,
                    launch_seconds=MODEL_LAUNCH_SECONDS)["seconds"]
                break
    total = t_fft
    for e in payloads:
        gbps = (MODEL_DCN_GBPS if e.get("link") == "dcn"
                else MODEL_WIRE_GBPS)
        wire = (e[WIRE_BYTE_KEYS[cand.algorithm]]
                * e.get("wire_factor", 1.0) / ndev)
        hide = t_stage
        if leg_pipelined and e["stage"] == "t2a":
            hide += dcn_raw
        total += exchange_model_seconds(
            wire, e["parts"], cand.algorithm, wire_gbps=gbps,
            launch_seconds=MODEL_LAUNCH_SECONDS,
            overlap_chunks=cand.overlap_chunks,
            hide_seconds=hide)["exposed_seconds"] * corr
    return total


def prune_candidates(
    candidates: Sequence[Candidate],
    shape: Sequence[int],
    mesh,
    *,
    itemsize: int = 8,
    limit: int | None = None,
    batch: int | None = None,
    max_err: float | None = None,
    dtype=None,
) -> list[Candidate]:
    """At most ``limit`` survivors (``DFFT_TUNE_MAX``, default 8), before
    anything is built: geometries (decomposition, transport, K, wire)
    ranked by :func:`model_cost`, each crossed with its executors
    best-geometry-first (within a geometry by tier cost, then the menu
    order), so the survivors measure every executor on the model's
    favourite geometry before the runners-up. ``max_err`` drops every
    candidate whose :func:`candidate_roundtrip_error` at ``dtype``
    (complex64 when None) exceeds it."""
    if max_err is not None:
        dt = dtype if dtype is not None else np.complex64
        candidates = [
            c for c in candidates
            if candidate_roundtrip_error(c, dt) <= max_err]
    if limit is None:
        limit = int(os.environ.get("DFFT_TUNE_MAX", DEFAULT_MAX_CANDIDATES))
    limit = max(1, limit)
    geos: dict[tuple, list[Candidate]] = {}
    for c in candidates:
        geos.setdefault(
            (c.decomposition, c.algorithm, c.overlap_chunks,
             c.wire_dtype or ""), []).append(c)

    def cost(c: Candidate) -> float:
        return model_cost(c, shape, mesh, itemsize=itemsize, batch=batch)

    ranked = sorted(geos, key=lambda g: (cost(geos[g][0]), g))

    def exec_rank(c: Candidate) -> tuple:
        base = c.executor.split(":", 1)[0]
        try:
            return (_EXECUTOR_RANK.index(base), c.executor)
        except ValueError:
            return (len(_EXECUTOR_RANK), c.executor)

    out: list[Candidate] = []
    for g in ranked:
        for c in sorted(geos[g], key=lambda c: (cost(c), exec_rank(c))):
            out.append(c)
            if len(out) >= limit:
                return out
    return out


# ------------------------------------------------------------ tournament

def tune_budget() -> tuple[int, int]:
    """(iters, repeats) of each candidate's amortised timing:
    ``DFFT_TUNE_ITERS`` as ``"ITERS"`` or ``"ITERSxREPEATS"`` (default
    10x2)."""
    raw = os.environ.get("DFFT_TUNE_ITERS", "").strip()
    if not raw:
        return 10, 2
    parts = raw.lower().split("x")
    try:
        if len(parts) == 1:
            it, rep = int(parts[0]), 2
        elif len(parts) == 2:
            it, rep = int(parts[0]), int(parts[1])
        else:
            raise ValueError
        if it < 1 or rep < 1:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"DFFT_TUNE_ITERS must be 'ITERS' or 'ITERSxREPEATS' "
            f"(ints >= 1), got {raw!r}") from None
    return it, rep


def _process_count(group=None) -> int:
    """Processes that decide together: 1 for :data:`LOCAL`, else the
    size of ``group`` (the default group when None; 1 without
    ``torch.distributed``)."""
    if isinstance(group, str) and group == LOCAL:
        return 1
    import torch.distributed as dist

    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _allgather_rows(vec: np.ndarray, group=None) -> np.ndarray:
    """One float row per process of ``group`` gathered into a (nproc,
    len(vec)) matrix (``dist.all_gather_into_tensor``; on the card's
    memory under NCCL)."""
    import torch.distributed as dist

    vec = np.asarray(vec, np.float64)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.as_tensor(vec, device=dev)
    out = torch.empty(dist.get_world_size(group) * len(vec),
                      dtype=torch.float64, device=dev)
    dist.all_gather_into_tensor(out, t, group=group)
    return out.cpu().numpy().reshape(-1, len(vec))


def agree_winner(times: np.ndarray, names: Sequence[str]) -> str:
    """The winner, as a pure function of the gathered (nproc, ncand)
    time matrix: among candidates finite on every process, the fastest
    by process 0's clock."""
    times = np.asarray(times, np.float64).reshape(-1, len(names))
    eligible = np.isfinite(times).all(axis=0)
    if not eligible.any():
        raise ValueError(
            "no candidate was timed successfully on every process")
    row0 = np.where(eligible, times[0], np.inf)
    return list(names)[int(np.argmin(row0))]


def measured_select(
    names: Sequence[str],
    build: Callable[[str], Any],
    measure: Callable[[Any], float],
    *,
    what: str = "candidate",
    group=None,
) -> tuple[str, dict[str, Any], dict[str, float]]:
    """Build every candidate, time those every process built, keep the
    fastest. Returns ``(winner, built, times)``; build and measure costs
    go to ``tune_build_*`` / ``tune_measure_*`` spans and the
    ``tune_build_seconds`` / ``tune_measure_seconds`` histograms, each
    timing to ``tune_timing_executions``.

    ``group``: the processes deciding together (the plan's world's
    group; :data:`LOCAL` for this process alone; None: the default
    group). Across processes: (1) a candidate built on only some
    processes is timed on none (the build flags gathered first); (2)
    every process times the same candidates in the same order; (3) the
    winner comes from :func:`agree_winner` over the gathered times. A
    failing candidate is skipped; only an empty set raises, after the
    collectives, so no process is left waiting in one. Each skip is one
    stderr line with its exception and one ``tune_candidate_failures``
    count (by candidate and phase, ``build`` or ``measure``)."""
    names = list(names)
    errors: list[str] = []

    def skipped(nm: str, phase: str, e: Exception) -> None:
        # a skip keeps JAX's semantics but must not hide a broken kernel
        errors.append(f"{nm}: {type(e).__name__}")
        _metrics.inc("tune_candidate_failures", candidate=nm, phase=phase)
        print(f"tuner: {what} {nm} skipped ({phase}): "
              f"{type(e).__name__}: {e}", file=sys.stderr)

    built: dict[str, Any] = {}
    for nm in names:
        try:
            with timed_span(f"tune_build_{nm}") as span:
                obj = build(nm)
        except Exception as e:  # noqa: BLE001 -- candidate skipped
            skipped(nm, "build", e)
            continue
        built[nm] = obj
        _metrics.observe("tune_build_seconds", span["seconds"], candidate=nm)
    multi = _process_count(group) > 1
    if not built and not multi:
        raise ValueError(
            f"no {what} succeeded ({'; '.join(errors)})")

    candidates = [nm for nm in names if nm in built]
    if multi:
        flags = np.array([1.0 if nm in built else 0.0 for nm in names])
        common = _allgather_rows(flags, group).min(axis=0) > 0
        candidates = [nm for i, nm in enumerate(names) if common[i]]
        if not candidates:
            raise ValueError(
                f"no {what} built on every process "
                f"(local: {sorted(built)}; errors: {'; '.join(errors)})")

    times: dict[str, float] = {}
    for nm in candidates:
        try:
            with timed_span(f"tune_measure_{nm}") as span:
                t = float(measure(built[nm]))
        except Exception as e:  # noqa: BLE001
            skipped(nm, "measure", e)
            t = math.inf
        times[nm] = t
        _metrics.inc("tune_timing_executions", candidate=nm)
        _metrics.observe("tune_measure_seconds", span["seconds"],
                         candidate=nm)

    vec = np.array([times[nm] for nm in candidates], np.float64)
    matrix = _allgather_rows(vec, group) if multi else vec.reshape(1, -1)
    try:
        winner = agree_winner(matrix, candidates)
    except ValueError:
        raise ValueError(
            f"every {what} failed timing"
            + (f" ({'; '.join(errors)})" if errors else "")) from None
    return winner, built, times


# ---------------------------------------------------------------- wisdom

def default_wisdom_path() -> str | None:
    """``DFFT_WISDOM`` when set (empty or ``0``: no store, None), else
    ``wisdom.jsonl`` under :func:`.utils.cache.compile_cache_dir`."""
    env = os.environ.get("DFFT_WISDOM")
    if env is not None:
        env = env.strip()
        return None if env in ("", "0") else env
    return os.path.join(compile_cache_dir(), "wisdom.jsonl")


def _dtype_name(dtype) -> str:
    return str(np_dtype(dtype))


def wisdom_key(
    *,
    kind: str,
    shape: Sequence[int],
    dtype,
    direction: int,
    ndev: int,
    mesh_dims: Sequence[int] | None = None,
    layouts: str | None = None,
    device_kind: str | None = None,
    platform: str | None = None,
    batch: int | None = None,
    err_budget: float | None = None,
    mm_precision: str | None = None,
) -> dict:
    """The identity a wisdom entry is valid for: plan family, problem,
    world, batch, error budget, pinned tier, hardware, and the versions
    of the package, torch and CUDA (a new release may change what any
    candidate runs). The JAX package's fields, its ``jax`` and ``x64``
    replaced by ``torch`` and ``cuda``."""
    from . import __version__

    if device_kind is None or platform is None:
        from .calibrate import _current_identity

        kind_now, platform_now = _current_identity()
        device_kind = kind_now if device_kind is None else device_kind
        platform = platform_now if platform is None else platform
    return {
        "kind": str(kind),
        "shape": [int(s) for s in shape],
        "dtype": _dtype_name(dtype),
        "direction": int(direction),
        "ndev": int(ndev),
        "mesh": None if mesh_dims is None else [int(d) for d in mesh_dims],
        "layouts": layouts,
        "batch": None if batch is None else int(batch),
        "err_budget": None if err_budget is None else float(err_budget),
        "mm_precision": mm_precision,
        "device_kind": str(device_kind),
        "platform": str(platform),
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def _key_id(key: dict) -> str:
    return json.dumps(key, sort_keys=True)


def load_wisdom(path: str | None) -> tuple[dict[str, dict], int]:
    """The JSONL store as ``({key_id: entry}, dropped)``: malformed lines
    (a killed writer's tail, non-JSON, entries without key or winner)
    are counted, never raised; the newest entry per key wins."""
    if path is None:
        return {}, 0
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return {}, 0
    entries: dict[str, dict] = {}
    dropped = 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            dropped += 1
            continue
        if (not isinstance(obj, dict) or not isinstance(obj.get("key"), dict)
                or not isinstance(obj.get("winner"), dict)):
            dropped += 1
            continue
        entries[_key_id(obj["key"])] = obj
    return entries, dropped


#: The key fields every current entry carries (:func:`wisdom_key`).
_CURRENT_KEY_FIELDS = frozenset((
    "kind", "shape", "dtype", "direction", "ndev", "mesh", "layouts",
    "batch", "err_budget", "mm_precision", "device_kind", "platform",
    "version", "torch", "cuda",
))

_STALE_KEY_WARNED: set = set()


def stale_wisdom_entries(entries: dict[str, dict]) -> int:
    """Entries whose key lacks a current :func:`wisdom_key` field
    (recorded under an older key; they never match)."""
    return sum(
        1 for e in entries.values()
        if not _CURRENT_KEY_FIELDS <= set(e.get("key", {})))


def _read_wisdom(path: str | None) -> dict[str, dict]:
    entries, dropped = load_wisdom(path)
    if dropped:
        print(f"tuner: {path}: skipped {dropped} malformed wisdom line(s)",
              file=sys.stderr)
    stale = stale_wisdom_entries(entries)
    if stale and path not in _STALE_KEY_WARNED:
        _STALE_KEY_WARNED.add(path)
        print(
            f"tuner: {path}: {stale} wisdom entr"
            f"{'y' if stale == 1 else 'ies'} recorded under an older "
            f"key schema (missing current wisdom_key fields); they "
            f"will never match -- re-measure to repopulate",
            file=sys.stderr)
    return entries


def lookup_wisdom(key: dict, path: str | None = None) -> dict | None:
    """The newest stored entry for ``key`` (exact match), or None."""
    if path is None:
        path = default_wisdom_path()
    return _read_wisdom(path).get(_key_id(key))


def record_wisdom(
    key: dict,
    winner: Candidate,
    seconds: float,
    *,
    path: str | None = None,
    times: dict[str, float] | None = None,
) -> dict | None:
    """Append one tournament's result to the store (one ``O_APPEND``
    write: :func:`.utils.atomicio.append_line`). Returns the entry, or
    None when the store is disabled."""
    if path is None:
        path = default_wisdom_path()
    if path is None:
        return None
    it, rep = tune_budget()
    entry = {
        "schema": WISDOM_SCHEMA,
        "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "key": key,
        "winner": {
            "decomposition": winner.decomposition,
            "algorithm": winner.algorithm,
            "executor": winner.executor,
            "overlap_chunks": int(winner.overlap_chunks),
            "wire_dtype": winner.wire_dtype,
        },
        "seconds": float(seconds),
        "budget": [it, rep],
    }
    if winner.wire_dtype is not None:
        from .parallel.exchange import wire_roundtrip_error

        entry["compression_err"] = wire_roundtrip_error(
            key.get("dtype", "complex64"), winner.wire_dtype)
    from .ops.executors import executor_roundtrip_error

    prec_err = executor_roundtrip_error(
        winner.executor, key.get("dtype", "complex64"))
    if prec_err:
        entry["precision_err"] = prec_err
    if times:
        entry["times"] = {
            nm: (None if not math.isfinite(t) else float(t))
            for nm, t in times.items()}
    from .utils.atomicio import append_line

    append_line(path, json.dumps(entry, sort_keys=True))
    return entry


def robust_stats(values: Sequence[float]) -> tuple[float, float]:
    """(median, MAD) of ``values``: the port's copy of
    ``regress.robust_stats`` (NaNs when empty)."""
    if not values:
        return math.nan, math.nan
    s = sorted(values)
    n = len(s)
    med = (s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2]))
    dev = sorted(abs(v - med) for v in s)
    mad = (dev[n // 2] if n % 2 else 0.5 * (dev[n // 2 - 1] + dev[n // 2]))
    return med, mad


def _log_model_divergence(
    by_label: dict[str, Candidate],
    times: dict[str, float],
    winner: str,
    shape,
    mesh,
    *,
    itemsize: int = 8,
    batch: int | None = None,
) -> None:
    """Audit the pruning model against the tournament: each candidate's
    measured / modelled ratio to the ``tune_model_measured_ratio``
    gauge, the per-transport median of the uncorrected ratios into the
    profile's ``model_correction`` (the next pruning's feedback), and one
    stderr line when the model's favourite is not the winner. Never
    fatal, never changes the winner."""
    try:
        model = {label: model_cost(c, shape, mesh, itemsize=itemsize,
                                   batch=batch)
                 for label, c in by_label.items()
                 if label in times and math.isfinite(times[label])}
        for label, m in model.items():
            if m > 0:
                _metrics.set_gauge("tune_model_measured_ratio",
                                   times[label] / m, candidate=label)
        if not model:
            return
        try:
            from .calibrate import update_model_correction

            raw: dict[str, list[float]] = {}
            for label, c in by_label.items():
                if label not in times or not math.isfinite(times[label]):
                    continue
                m0 = model_cost(c, shape, mesh, itemsize=itemsize,
                                batch=batch, corrected=False)
                if m0 > 0:
                    raw.setdefault(c.algorithm, []).append(
                        times[label] / m0)
            update_model_correction(
                {alg: robust_stats(v)[0] for alg, v in raw.items() if v})
        except Exception:  # noqa: BLE001 -- feedback is best-effort
            pass
        model_pick = min(model, key=model.__getitem__)
        if model_pick != winner and model_pick in times:
            print(
                f"tuner: model/measured divergence: model ranked "
                f"{model_pick!r} first "
                f"({model[model_pick]:.6f}s predicted, "
                f"{times[model_pick]:.6f}s measured) but "
                f"{winner!r} won ({model.get(winner, math.nan):.6f}s "
                f"predicted, {times[winner]:.6f}s measured)",
                file=sys.stderr)
    except Exception:  # noqa: BLE001 -- audit trail only
        pass


# ------------------------------------------------------ planner dispatch

def _mesh_context(mesh) -> tuple[int, tuple[int, ...] | None]:
    """(rank count, fixed world dims or None) of a planner's world: None
    is one device, an int a count the planner decomposes, a ``(rows,
    cols)`` tuple or a :class:`~.parallel.mesh.World` a fixed world."""
    if mesh is None:
        return 1, None
    if isinstance(mesh, int):
        return mesh, None
    if isinstance(mesh, World):
        return mesh.size, (tuple(mesh.grid) if mesh.grid is not None
                           else (mesh.size,))
    dims = tuple(int(d) for d in mesh)
    return math.prod(dims), dims


def _mesh_group(mesh):
    """The ``measured_select`` group of a planner's world: the group of a
    process-group world, else :data:`LOCAL` (a loopback world is this
    process's alone)."""
    if isinstance(mesh, World) and not mesh.loopback:
        return mesh.group
    return LOCAL


def _build_candidate(plan_fn: Callable, shape, mesh, base: PlanOptions,
                     plan_kw: dict, cand: Candidate, *, donate: bool):
    """One plan of a candidate, always with ``tune="off"``."""
    opts = replace(
        base, tune="off", decomposition=cand.decomposition,
        algorithm=cand.algorithm, executor=cand.executor,
        overlap_chunks=int(cand.overlap_chunks), donate=donate,
        wire_dtype=cand.wire_dtype or "none")
    return plan_fn(shape, mesh, options=opts, **plan_kw)


def _replay_candidate(entry: dict, dtype, err_budget) -> Candidate:
    """A wisdom entry's winner as a candidate to build: a
    reduced-accuracy winner (compressed wire, reduced tier, or both)
    replays only where the budget admits the sum of its recorded errors,
    else exact (exact wire and the bare, unfused label)."""
    from .ops.executors import (REDUCED_TIERS, executor_roundtrip_error,
                                split_executor, split_fuse)

    win = entry["winner"]
    wd = win.get("wire_dtype")
    ex = str(win["executor"])
    tier = split_executor(ex)[1] if ":" in ex else None
    reduced_tier = tier in REDUCED_TIERS
    if wd is not None or reduced_tier:
        total = 0.0
        if wd is not None:
            rec_err = entry.get("compression_err")
            if rec_err is None:
                from .parallel.exchange import wire_roundtrip_error

                rec_err = wire_roundtrip_error(dtype, wd)
            total += float(rec_err)
        if reduced_tier:
            rec_prec = entry.get("precision_err")
            if rec_prec is None:
                rec_prec = executor_roundtrip_error(ex, dtype)
            total += float(rec_prec)
        if err_budget is None or total > err_budget:
            wd = None
            if reduced_tier:
                ex = split_executor(ex)[0]
            ex = split_fuse(ex)[0]
    return Candidate(
        decomposition=str(win["decomposition"]),
        algorithm=str(win["algorithm"]),
        executor=ex,
        overlap_chunks=int(win["overlap_chunks"]),
        wire_dtype=wd,
    )


def _amortized_measure(iters: int, repeats: int) -> Callable:
    """A tournament's ``measure``: one zero-filled input
    (:func:`.api.alloc_local`; an FFT's cost does not depend on the
    data) and :func:`.utils.timing.time_fn_amortized` of the plan."""
    from . import api
    from .utils import timing

    def measure(plan) -> float:
        x = api.alloc_local(plan)
        t, _ = timing.time_fn_amortized(plan, x, iters=iters,
                                        repeats=repeats)
        return t

    return measure


def tuned_plan(kind: str, shape, mesh, options: PlanOptions,
               plan_kw: dict, *, plan_fn: Callable | None = None,
               reduced: tuple[tuple, tuple] | None = None):
    """The tuned tier of the public planners (``tune="wisdom"`` /
    ``"measure"``): wisdom first; on a miss the static heuristics
    (wisdom mode, never measures) or the pruned tournament, whose winner
    is recorded (measure mode). ``kind`` is the wisdom kind (``c2c``,
    ``r2c``, an operator's ``op:<name>``); ``plan_fn(shape, mesh,
    options=..., **plan_kw)`` builds one plan (None: the public planner
    of ``kind``); ``reduced`` is the (wire dtypes, matmul tiers) a
    ``max_roundtrip_err`` budget admits (None: every codec and the
    ``bf16`` / ``f32`` tiers). ``plan_kw`` carries ``direction``,
    ``dtype``, ``device``, ``in_spec`` / ``out_spec`` and ``batch``. The
    tournament's plans are built without donation (a donated input
    cannot be timed twice); the caller's ``donate`` rebuilds the
    winner."""
    from . import api

    shape = tuple(int(s) for s in shape)
    base = replace(options, tune="off", donate=False,
                   executor=options.executor.split(":", 1)[0],
                   mm_precision=None, mm_complex=None, fuse=None)
    ndev, mesh_dims = _mesh_context(mesh)
    heuristic = replace(options, tune="off")
    if plan_fn is None:
        plan_fn = (api.plan_dft_r2c_3d if kind == "r2c"
                   else api.plan_dft_c2c_3d)
    if ndev <= 1:
        return plan_fn(shape, mesh, options=heuristic, **plan_kw)

    dtype = plan_kw.get("dtype") or torch.complex64
    in_spec, out_spec = plan_kw.get("in_spec"), plan_kw.get("out_spec")
    batch = plan_kw.get("batch")
    err_budget = options.max_roundtrip_err
    layouts = (f"{in_spec}|{out_spec}"
               if (in_spec is not None or out_spec is not None) else None)
    key = wisdom_key(
        kind=kind, shape=shape, dtype=dtype,
        direction=plan_kw.get("direction", -1),
        ndev=ndev, mesh_dims=mesh_dims, layouts=layouts, batch=batch,
        err_budget=err_budget, mm_precision=options.mm_precision)
    path = default_wisdom_path()

    def build_one(cand: Candidate, donate: bool):
        return _build_candidate(plan_fn, shape, mesh, base, plan_kw, cand,
                                donate=donate)

    entry = lookup_wisdom(key, path) if path is not None else None
    if entry is not None:
        _metrics.inc("tune_wisdom_hits", kind=kind)
        return build_one(_replay_candidate(entry, dtype, err_budget),
                         options.donate)
    _metrics.inc("tune_wisdom_misses", kind=kind)
    if resolve_tune_mode(options.tune) == "wisdom":
        return plan_fn(shape, mesh, options=heuristic, **plan_kw)

    from .parallel.multihost import is_hybrid_mesh

    itemsize = np_dtype(dtype).itemsize
    wire_dtypes: tuple = (None,)
    mm_tiers: tuple = (None,)
    if err_budget is not None:
        if reduced is None:
            from .parallel.exchange import WIRE_DTYPES

            reduced = (tuple(WIRE_DTYPES), (None, "bf16", "f32"))
        wire_dtypes, mm_tiers = reduced
    if options.mm_precision is not None:
        mm_tiers = (options.mm_precision,)
    hybrid = kind != "r2c" and is_hybrid_mesh(mesh)
    cands = prune_candidates(
        enumerate_candidates(shape, ndev, mesh_dims=mesh_dims,
                             executors=_default_executors(
                                 api.resolve_device(plan_kw.get("device"))),
                             itemsize=itemsize, batch=batch, hybrid=hybrid,
                             wire_dtypes=wire_dtypes, mm_tiers=mm_tiers,
                             real=kind == "r2c"),
        shape, mesh, itemsize=itemsize, batch=batch,
        max_err=err_budget, dtype=dtype)
    _metrics.set_gauge("tune_candidates", len(cands), kind=kind,
                       stage="pruned")
    by_label = {c.label: c for c in cands}
    _metrics.inc("tune_tournaments", kind=kind)

    winner, built, times = measured_select(
        list(by_label), lambda label: build_one(by_label[label], False),
        _amortized_measure(*tune_budget()),
        what=f"{kind} tune candidate", group=_mesh_group(mesh))
    _log_model_divergence(by_label, times, winner, shape, mesh,
                          itemsize=itemsize, batch=batch)
    record_wisdom(key, by_label[winner], times[winner], path=path,
                  times=times)
    if options.donate:
        return build_one(by_label[winner], True)
    return built[winner]


# -------------------------------------------- concurrent-width tournament

def width_budget() -> tuple[int, int] | None:
    """(iters, repeats) of the concurrent-width tournament from
    ``DFFT_WIDTH_TOURNAMENT`` (``"ITERS"`` or ``"ITERSxREPEATS"``,
    repeats 2 by default); unset, ``""``, ``"0"`` or ``"off"``: None
    (the tournament is disarmed)."""
    raw = os.environ.get("DFFT_WIDTH_TOURNAMENT", "").strip()
    if raw.lower() in ("", "0", "off"):
        return None
    parts = raw.lower().split("x")
    try:
        if len(parts) == 1:
            iters, repeats = int(parts[0]), 2
        elif len(parts) == 2:
            iters, repeats = int(parts[0]), int(parts[1])
        else:
            raise ValueError
        if iters < 1 or repeats < 1:
            raise ValueError
    except ValueError:
        raise ValueError(
            "DFFT_WIDTH_TOURNAMENT must be 'ITERS' or 'ITERSxREPEATS' "
            f"(positive ints), or ''/'0'/'off' to disarm; got {raw!r}"
        ) from None
    return iters, repeats


def _plan_world_dims(plan) -> tuple[int, tuple[int, ...] | None]:
    world = getattr(plan, "world", None)
    if world is None:
        return 1, None
    return _mesh_context(world)


def concurrent_width_key(plans: Sequence, counts: Sequence[int]) -> dict:
    """The wisdom identity of one width tournament: the lead plan's
    problem under ``kind="concurrent"``, with ``"tuple"`` naming every
    member plan (shape, dtype, direction, batch, in drain order) and the
    per-group transform ``"counts"``."""
    p0 = plans[0]
    ndev, dims = _plan_world_dims(p0)
    key = wisdom_key(
        kind="concurrent",
        shape=p0.shape,
        dtype=getattr(p0, "in_dtype", None) or p0.dtype,
        direction=p0.direction,
        ndev=ndev,
        mesh_dims=dims,
        batch=getattr(p0, "batch", None),
    )
    key["tuple"] = [
        "x".join(str(s) for s in p.shape)
        + f":{_dtype_name(getattr(p, 'in_dtype', None) or p.dtype)}"
        + f":d{p.direction}:b{getattr(p, 'batch', None) or 1}"
        for p in plans
    ]
    key["counts"] = [int(c) for c in counts]
    return key


def tune_concurrent_width(
    plans: Sequence,
    counts: Sequence[int],
    *,
    path: str | None = None,
) -> int | None:
    """Measured tournament over concurrent widths: width ``w`` runs the
    first ``w`` plans as one interleaved program
    (:func:`.stagegraph.schedule_concurrent`), ranked by seconds per
    transform (``counts[:w]`` transforms a wave). Returns the winning
    width, or None when :func:`width_budget` disarms it. Wisdom-keyed
    (``kind="concurrent"``): a hit replays the width with no timing
    execution; a measured winner is appended with its per-width
    times."""
    budget = width_budget()
    if budget is None:
        return None
    plans = list(plans)
    counts = [int(c) for c in counts]
    if len(plans) < 2:
        return max(1, len(plans))
    if path is None:
        path = default_wisdom_path()
    key = concurrent_width_key(plans, counts)
    if path is not None:
        entry = lookup_wisdom(key, path)
        if entry is not None:
            w = entry.get("winner", {}).get("width")
            if isinstance(w, int) and 1 <= w <= len(plans):
                _metrics.inc("tune_wisdom_hits", kind="concurrent")
                return w
    _metrics.inc("tune_wisdom_misses", kind="concurrent")

    from . import api
    from .stagegraph import schedule_concurrent
    from .utils import timing

    iters, repeats = budget
    names = [f"w{w}" for w in range(1, len(plans) + 1)]

    def build(nm):
        w = int(nm[1:])
        fn = plans[0] if w == 1 else schedule_concurrent(plans[:w])
        xs = tuple(api.alloc_local(p) for p in plans[:w])
        return w, fn, xs

    def measure(built_obj):
        w, fn, xs = built_obj
        t, _ = timing.time_fn_amortized(fn, *xs, iters=iters,
                                        repeats=repeats)
        return t / sum(counts[:w])

    winner, built, times = measured_select(
        names, build, measure, what="concurrent width",
        group=_mesh_group(getattr(plans[0], "world", None)))
    w = built[winner][0]
    if path is not None:
        per_transform = times[winner]
        secs = per_transform * sum(counts[:w])
        entry = {
            "schema": WISDOM_SCHEMA,
            "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "key": key,
            "winner": {"width": int(w)},
            "seconds": float(secs),
            "waves_per_s": (1.0 / secs) if secs > 0 else None,
            "transforms_per_s":
                (1.0 / per_transform) if per_transform > 0 else None,
            "times": {nm: (float(t) if math.isfinite(t) else None)
                      for nm, t in times.items()},
            "budget": [iters, repeats],
        }
        from .utils.atomicio import append_line

        append_line(path, json.dumps(entry, sort_keys=True))
    return int(w)
