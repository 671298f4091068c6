#!/usr/bin/env python3
"""Smoke test of distributedfft_tpu_torch on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``
(``--real-rows``: only the fused real rows passes of REAL_ROWS_CASES, as
phase 2 holds and times them; ``--plane-gate``: only PLANE_GATE_CASES and the
planes past the plane gate, as phase 2 holds and times them, and their
records; ``--route-cases``: only the
fused cases at ``cols = 1`` and past 8192 of phase 3, the 608^3 and long
paths of phase 5, the split fused pencil, the two-level calls at the
TWO_LEVEL shapes and a digest of the output of every kernel 1-5 case
phases 2 and 3 hold, on whichever package sits beside the script, so
that a parent commit's tree can be timed and compared bit for bit beside
it). It

1. prints the card's name and power limit and builds the CUDA kernels
   from ``distributedfft_tpu_torch/csrc`` (nvcc, sm_90a);
2. holds each kernel against its plain PyTorch version at every shape
   the main path gives it (complex64, zero-mean seeded data; max-norm
   and L2 relative error each <= 5e-4), and against the torch.fft call
   that computes the same function, whose arithmetic is independent of
   the kernel's; times the kernel, the plain version and that call (a
   yardstick only) beside the least time the card could take (and, on
   the two-pass route past 8192, twice its bytes: that route's cap) and a
   device copy of the same tensor (one read, one write), the kernel and
   that call also back to back (device time without the host's launch
   time), and the plane kernel both walking the batch in L2-sized chunks
   and in one go; the GENERIC_CASES hold the generic prime stage of the
   row and strided kernels (608, 361 = 19 * 19, the two-pass 9728, 8194
   and 12482, whose 241 and 79 are one-stage passes) and of the plane
   at [152, 608, 608], with the 608^3 slab's other cases; the
   REAL_ROWS_CASES hold the fused real rows passes (``csrc/real_rows.cu``)
   against their plain version and torch.fft.rfft / irfft, timed beside
   both and the bytes-once bound; the PLANE_GATE_CASES hold the single
   1024^3 pair's passes (the (16, 8, 8) plan's radix-16 variants) and the
   plane kernel at that size, each plain version past PLAIN_BLOCK
   elements run in blocks; then the planes of PLANE_GATE_SHAPE, past the
   plane gate, run through the plane kernel directly and per axis as the
   gate has them, each against the other and torch.fft, timed;
3. holds the two fused stage+codec kernels (``csrc/fuse.cu``) against
   their plain versions at every shape and codec the compressed path
   gives them: sidecars bit-identical, mantissas at most one level apart,
   decoded outputs within 5e-4 (max-norm and L2) of the plain decode,
   and the codec's own bound against the exact transform; the decode
   also against the strided kernel on the decoded wire (relative L2 <=
   1e-6), timed beside a device copy and the unfused decode + torch.fft;
   the encode also against the codec's encode of the strided kernel's
   output (payload and sidecar bit for bit), timed beside a device copy
   and that unfused sender (the row kernel at a last-axis site, cols =
   1, where the fused kernels take their row form; past 8192 the
   two-pass route, whose cases also print ``bound_2pass_ms``); the fused
   cases include the 608^3 paths' sites, 76 = 4 * 19 on the generic
   stage (generic_fused_cases) and the sites past 8192
   (long_fused_cases);
4. checks the port on a small uneven input against numpy's float64 fftn
   (single device and the 4-rank slab; the repo's seeded world data);
5. drives the C2C main path: the single-device plan at 512^3 forward and
   backward, then the slab chain on a loopback world of 4 ranks at 512^3
   and at (510, 510, 512), each checked against torch.fft.fftn and by a
   round trip; every row, strided and plane kernel must have been
   launched in that run, by the radix route only; then (counts from 0)
   the non-smooth paths, the slab at [608, 512, 512] on 4 loopback ranks
   and the pencil at [512, 512, 608] on 2x2 (608 = 2^5 * 19 on the
   generic prime stage), forward against torch.fft.fftn and backward
   against torch.fft.ifftn and by round trip, every row, strided and
   plane kernel launched by the radix route only, with their times and
   t0..t3; then (counts from 0) the 608^3 paths: the slab C2C at 608^3
   on 4 loopback ranks (t0 planes [152, 608, 608]) exact, then with the
   split, bf16 and int8 wires fused, each fused plan against its unfused
   twin bit for bit both ways, and the [512, 512, 608] pencil on 2x2
   with the split wire fused against its twin (kernels 4 and 5 at cols
   = 1, their row form, on its t0_fft_z / t3_fft_z sites); the plane,
   encode and decode kernels launched, by the radix route (and the fused
   kernels' row form) only, no fallback; peak device memory, plan times
   and t0..t3; then (counts from 0) the paths past 8192 at 2^28
   elements: the slab C2C [16384, 128, 128] on 4 loopback ranks exact
   and with each wire fused against its twin (the forward's t3 decode
   along X with columns on the two-pass route), and the split fused
   pencils [128, 128, 16384] (t0_fft_z's encode and the backward's
   t3_fft_z decode in the row form on the two-pass route) and [16384,
   128, 128] (the X sites with columns) on 2x2 against their twins,
   every fused output bit for bit, every launch on its length's route
   and form (none direct), the fused kernels in each two-pass form;
6. drives the compressed and real path at 512^3 on a loopback world of
   4: the C2C plans with the split codec fused (and their unfused twins,
   compared bit for bit and printed), the R2C/C2R plans exact and with
   each codec fused and unfused, and the single-device R2C/C2R; checked
   against torch.fft.fftn/rfftn/irfftn, the port's exact plan and round
   trips; each codec's fused R2C/C2R outputs must equal the unfused
   ones bit for bit, the fused sites must take the routes of the JAX
   package, both fused kernels must have been launched in that run, and
   the row, strided, plane, decode and encode kernels by the radix route
   only;
7. times the plans and their t0..t3 stages;
8. drives the pencil path at 512^3 on a 2x2 loopback world: the C2C plan
   forward and backward against torch.fft.fftn and by round trip, the
   C2C plans with the split codec fused and their unfused twins (bit
   for bit both ways, the fused sites on the JAX package's routes), the
   R2C/C2R plans against torch.fft.rfftn/irfftn; every row, strided,
   encode and decode kernel must have been launched in that run, by the
   radix route only (the fused kernels on the last-axis sites by its
   row form), and no complex64 phase at 512 may have taken a
   fallback; times each plan and its t0/t2a/t1/t2b/t3 stages (median of
   10);
9. drives the exchange transports at 512^3: the slab C2C plan on a
   4-rank loopback world under ``alltoall``, ``alltoallv`` and
   ``ppermute`` and on a 2x2 hybrid world under ``hierarchical``, each
   at overlap K = 1, 2 and "auto" (8 here), forward and backward, each
   equal bit for bit to the alltoall, K = 1 plan and within the tier of
   torch.fft.fftn; ``alltoallv`` at (510, 510, 512) against the dense
   plan; the 2x2 pencil under each flat transport at K = 2 and "auto"
   against its K = 1 plan; one split-wire fused plan per transport at K
   = 1 against its unfused twin (bit for bit; the C2R one, whose sender
   is the fused encode, over each flat transport too), the fusion pass
   recording ``overlap_k`` at K > 1; the staged pipelines (slab,
   hierarchical per leg, pencil, R2C, single) against their plans, with
   each stage's CUDA-event time; one traced run of the slab plan under
   torch.profiler with the trace spans on, printing the device time
   under each t0..t3 span and the device's idle share over the traced
   window; then the transport, K, forward and backward times and the
   per-stage times of each plan;
10. drives the brick, batched, layout and r2c_axis path at 512^3 on a
   4-rank loopback world (counts from 0): the brick plans of
   ``speed3d.py -bricks`` (uneven Z-slabs in, X-pencils out) over the
   ring and the a2av edges, one with the in-bricks stored in shuffled
   axis orders, gathered and held against the inner slab plan bit for
   bit forward and backward; the R2C/C2R brick plans against the inner
   real plan; the r2c_axis=0 plan against the canonical plan on the
   transposed input; the batch = 2 slab and pencil C2C and slab R2C plans
   against two unbatched calls (bit for bit, both directions); an
   absorbed in_spec within the tier of torch.fft.fftn and an edge-wrapped
   in_spec/out_spec on the 2x2 pencil against the default plan (bit for
   bit); every kernel call at a shape the kernel phases held, no
   fallback; then the brick plans' times beside the inner plan's (the
   two edges' cost), the batched plans against two unbatched calls, the
   peak device memory of each, and donate=True against donate=False
   (bit for bit, peak memory and time; single and slab);
11. drives the spectral-operator path at 512^3 (counts from 0): the
   Poisson and gradient(1) op plans on the 4-rank slab, the Gaussian on
   the 2x2 pencil and the single-device Poisson, each within 5e-4 of
   ifftn(m * fftn(x)) computed in complex128 with torch.fft; every
   transport, K = 2, the 2x2 hybrid world and batch = 2 bit for bit
   against the alltoall, K = 1, unbatched plan, with the collective
   rounds of one call (exchange.ROUNDS: 2 slab, 4 pencil, 2K, 2(P - 1)
   on the ring); the split op plans fused against unfused bit for bit on
   the JAX package's fusion routes; a convolution at 256^3 against the
   shift it is; every kernel of the path launched, no fallback; then the
   staged op pipeline against the fused plan with its stage times, one
   traced call (device time per stage, under t_mid_pointwise, and the
   idle share), and the op plans' times and peak memory beside the
   unfused pair (forward plan, multiply, backward plan), each printed
   with the card's name and power limit;
12. drives the two-level path (counts from 0): ``fft_along_axis`` of
   [1, 5^11], [1, 2^24] and [64, 2^20] complex64 (lengths past one
   kernel's reach: the two-level route, ``csrc/two_level.cu``, short
   column passes whose stores carry the twiddle and the reorder, then
   one rows pass storing the transpose, the inverse's 1/n in its
   store), forward and inverse, each within 5e-4 of torch.fft in
   complex128; at [1, 2^24] a torch.profiler capture of each call
   counts its kernels (the route's passes, nothing else: no copy,
   transpose or scaling kernel), and the path must launch the route
   and neither the strided nor the row kernel; then the distributed 1D path
   (counts from 0): ``plan_dft_c2c_1d_dist`` at n = 2^28 and 3 * 2^26 on
   a 4-rank loopback world, both orders, forward against torch.fft in
   complex128 and backward by round trip, ``ppermute`` equal to
   ``alltoall`` bit for bit; each path's launches by the route their
   lengths take (past 8192: the two-pass radix route, printed per
   length; the two-level launches by its own) and no fallback; then
   each two-level launch against its plain version
   (``two_level_passes_plain``) and the JAX-shaped composition
   (``_fft_last_big_plain``), 5e-4, its time beside torch.fft's, the
   pass count times the one-pass bound, each pass's device time, and
   the plan of the fewest passes where it differs; and the 2^28 plans'
   times and stages;
13. drives the concurrent path (counts from 0): two 512^3 slab plans on
   4 loopback ranks, and a slab (hierarchical) and a pencil plan on the
   2x2 hybrid world, through ``schedule_concurrent``, each output equal
   to its plan called alone bit for bit, and a WaveSchedule of 4 waves
   of width 2 (depth 2, each wave the same bits, retired in order);
   then each schedule's time against the two calls;
14. runs complex128 through the cuda executor's dft_matmul route and
   through the torch executor (a 4-rank slab at 256^3 against
   torch.fft.fftn, 1e-11), and the matmul executor's three precision
   tiers on a [4096, 512] row batch against torch.fft.fft (each tier's
   error within its band, the three strictly ordered);
15. drives the dd tier at 512^3 (the (hi, lo) pairs of
   ``dd_from_host`` on seeded numpy data, joined into complex128 on the
   ``torch`` engine): the C2C plans on one card, on 4 loopback ranks
   (slab) and on the 2x2 pencil, forward against scipy.fft.fftn in
   float64 on the host and backward by round trip, the R2C/C2R plans
   against scipy.fft.rfftn and by round trip, a brick plan (Z-slabs in,
   X-pencils out) against the slab plan (bits reported), batch = 2
   against two calls (bits reported), each within 1e-11; no kernel
   launch and no fallback on that path; then each dd plan's times
   beside the complex128 plan on the ``torch`` executor and the
   complex64 exact plan (median of 10), the join and split alone, the
   memory each call needs over the data held, and one line of the
   metrics registry's counters after one planned pass (plan builds,
   cache hits, executes, exchange bytes);
16. drives measured planning at 512^3 (counts from 0; a wisdom store
   and profile of the run's own, ``DFFT_TUNE_ITERS=3x2``):
   ``calibrate()`` (printed with the card line; it fails on a null
   field a card can measure), ``executor="auto"`` on the single and
   4-rank slab C2C plans, ``tune="measure"`` on the slab C2C plan (each
   candidate's model seconds and measured time, the winner within 5e-4
   of torch.fft.fftn) and its ``tune="wisdom"`` replay (same label, no
   timing execution, bit-identical output), ``tune="measure"`` under
   ``max_roundtrip_err=1e-2`` on the slab R2C plan and the slab Poisson
   op (the survivor cap the least that holds a ``cuda`` and a
   ``cuda:fuse`` candidate; each winner within 10% of the unfused
   ``cuda`` plan on its wire, 5e-4 when exact), and
   ``tune_concurrent_width`` on two slab plans; it fails on a candidate
   that did not build or has no finite time, or a kernel not launched;
17. explains eight plans at 512^3 (counts from 0; ``dfft.explain`` with
   ``iters=5`` and ``device_timing=True``, under phase 16's calibrated
   profile): the single plan, the 4-rank slab C2C forward (with its
   two-transform concurrent overlap) and backward, the slab R2C, the 2x2
   pencil, the slab Poisson op, the slab C2C at K = 2 (its chunk
   overlap) and the split fused 2x2 pencil (its fusion verdict; kernels
   4 and 5 through its whole-plan memory view); per stage the model,
   host-bracket and device ms, their ratio and the divergence verdict,
   each plan's peak memory, its overlap and fusion blocks, and the slab
   forward's table. It fails when a record's stages are not read from
   the device timeline, a pass of a stage has no device time, the device
   medians sum past 1.05x the host brackets', an overlap block is
   missing, a memory view has no peak, the fused plan's fusion is not
   active, or a kernel is not launched; the records go to
   ``chiprun_out/explain_records.jsonl``;
18. serves requests at full width through ``CoalescingQueue`` (counts
   from 0, metrics on): (a) a C2C queue with max_batch=2 on the 4-rank
   slab world at 512^3, 4 forward then 4 backward requests in two
   batched flushes each, every result against the unbatched plan (bit
   equality printed, 5e-4 enforced) and torch.fft, then 8 requests
   through the queue against 8 direct plan calls (median of 5); (b) an
   R2C queue, two requests against torch.fft.rfftn; (c) the streaming
   drain loop at 256^3 (max_batch=8, concurrent_groups="auto" on the
   calibrated profile, a realtime and a batch tenant): two threads
   submit 32 mixed-direction requests, in a cold and then a warm round,
   each result within 5e-4 of torch.fft, stop() within 10 s, the same
   transforms as direct calls, the width, wave occupancy, wait
   quantiles and SLO report printed; (d) the recovery chain at 256^3: a
   transient fault retried once, a deterministic fault on every cuda
   execution recovered by one degraded rebuild on matmul, one NaN input
   in a batch delivered as it is while its cohort completes; (e) the
   shadow audit at 512^3 on split fused 2x2 pencil plans, every request
   audited against the exact cuda plan and held to the plane's drift
   rule, each result bit for bit against the unfused batch-2 twin, the
   fused kernels on the last-axis sites in their row form; (f) right after (c)'s warm round, the same round (two tenants,
   two threads, 32 requests at 256^3; cold, then warm) on a queue armed
   by ``DFFT_MONITOR=0.05,chiprun_out/monitor.jsonl``, then ten pairs of
   blocks of at least 1 s of such rounds on that queue, the sampler
   thread on then off and off then on in turn: every result equal bit for bit to the
   unmonitored warm round's for the same request, at least on_s / 0.05
   / 2 samples taken by the sampler thread itself (on_s: the time it
   ran) and none failed, every sample of schema 4 with a ``waves``
   block that ``load_series`` reads back, no health alert,
   ``serving_stalls`` 0, kernels 1-3 launched with no fallback; the
   monitored warm round's transforms/s is printed beside the
   unmonitored one's, and the blocks with the sampler on and off, their
   medians and the on/off ratio within each pair (its host cost;
   printed, not gated). It fails on a
   timed-out result, on recovery outside (d), on
   a kernel or fusion fallback in (a), (b), (c), (e) or (f), unless
   kernels 1-3 ran at their batch = 2 cases and kernels 4 and 5 at the
   fused queue's, or past 90 s;
19. runs the fleet on the card (counts from 0): ``python -m
   distributedfft_tpu_torch.loadgen`` twice, two worker processes each
   with its own CUDA context on the card, single-device queues at
   256x256x256 and 256x256x128, 100 arrivals/s each for 5 s: (a) the
   streaming run gates 0 with two streams, no alert, ``executes`` in
   both and no kernel or fusion fallback; (b) the flush-mode run with
   ``DFFT_FAULT_INJECT=execute:every=1,kind=deterministic`` on rank 0
   gates 1 with worker 0 wedged, a stall on rank 0's stream and none on
   rank 1's; then (c) ``ramp_roundtrip_check`` of the 4-rank slab and
   the 2x2 pencil at 256^3 complex64 (5e-4) and ``check_layout`` of the
   slab forward's output at 512^3 complex128 against its ``out_boxes``,
   with ``decode_ramp`` of elements of each block of the round trip
   inside that block's box. The workers' kernel cases
   (``fleet_cases``) are held in phase 2; being other processes, their
   launches are counted by their own wrappers, and each stats line
   carries them by case (``cuda_fft.CASES``), which must add up to its
   launches and be cases phase 2 held. It prints each worker's stats line, the
   verdicts and the loadgen wall times beside the card line, and fails
   past 120 s;
20. runs the regression loop and the report CLI (counts from 0; every
   subcommand through ``report.main`` in this process, but ``history``,
   run once as ``python -m distributedfft_tpu_torch.report`` under a
   timeout; each printed with its argv, exit code and seconds, any
   other exit code than the one listed fails): (b) ``explain --plan
   512,512,512 -n 4 --device cuda --device-timing --json`` exits 0 and
   its record is held as phase 17's are; (a) that slab C2C forward on 4
   loopback ranks timed 6 times (CUDA events, median of 5 calls each),
   each a line in ``bench.py``'s schema (GFlop/s, t0..t3 from
   ``StageTimer``, the metrics snapshot, the explain layer's memory view
   as ``cost``; the newest line carries (b)'s record) recorded into a
   fresh ``chiprun_out/phase20/history.jsonl``: ``history`` and ``compare
   --gate`` exit 0; one doctored copy of the newest line (value halved,
   t2 tripled) makes ``compare --gate`` exit 1 with t2 its first
   regressed stage; ``explain --record`` of phase 17's records and
   ``explain --trend`` of the history exit 0; (c) one traced call of
   that plan in chrome format, merged alone, with phase 9's text log and
   with ``--align start`` (exit 0; the t0..t3 counts equal the spans
   the two sessions recorded); (d) ``wisdom --gate`` on phase 16's store
   with three runs of its replayed c2c winner stamped ``tuned=`` (exit 1
   if their verdict against the stored time is ``regressed``, else 0:
   both are host-clock times minutes apart on a shared host), then with
   three runs at the stored time (exit 0, ``within-noise``) and at 1.5
   times it (exit 1, ``regressed +50.0%``), ``qos --ledger`` on phase 18 (c)'s ledger, ``health``, ``health
   --gate`` and ``live --prom`` on 18 (f)'s series (exit 0),
   ``numerics`` on that series (exit 2: (f) ran before (e) armed the
   numerics plane, so its samples carry no numerics block) and on one
   monitor sample taken now (``--gate``, exit 0), ``fleet --gate`` on
   phase 19's runs (exit 0 healthy, 1 on the drill, with ``stall`` and
   ``fleet_stall`` on rank 0's stream); (e) ``calibrate --device cuda
   --dry-run --json --no-wire`` (exit 0), its HBM figure beside phase
   16's. It fails past 45 s;
21. drives the C ABI (counts from 0): (a) the port's host library
   (``csrc/dfft_native.cpp``, built with g++ into ``_build/`` before the
   kernels; its build time) and ``capi.install_c_api`` on the card; (b)
   the four selftests from compiled C at 512^3 (``c_selftest`` and
   ``c_selftest_r2c`` on r2c_axis 0, 1 and 2 within 5e-4,
   ``c_selftest_z2z`` within 1e-11, ``c_selftest_resident`` with 10
   repeats within 5e-4); (c) ``dfft_plan_c2c_3d`` / ``dfft_execute_c2c``
   through ctypes at 512^3 on one device, a 4-rank loopback slab and a
   2x2 loopback pencil, each output bit-equal to the same plan's direct
   output on the card and within 5e-4 of torch.fft.fftn; (d) medians of
   10: the host-to-host call and ``dfft_execute_resident`` (host clock
   around the ctypes call), the plan call alone (CUDA events), the
   bridge's cost per call (resident less plan, host-to-host less
   resident) and the two pageable copies; (e) every plan destroyed and
   ``torch.cuda.memory_allocated()`` back to its level before (b); (f)
   one slab forward in a log session of the C recorder and one of the
   Python recorder with the same t0..t3 spans. It fails on a nonzero
   return code, a negative selftest, a library that does not build, or
   past 60 s, and prints the script's seconds;
   prints one JSON line of the five kernels and the two-level route
   and, last, the device line.

Each counted path (5, 6, 8, 9, 10, 11, 12, 13, 16, 17, 18, 19, 20, 21) also
records the case of every kernel call (the calls this thread makes, and
``cuda_fft.CASES``, which every launch of the process counts from any
thread, such as a serving queue's drain loop) and fails on one that
phases 2 and 3 (or, for the two-level route, phase 12's timing) did
not hold against its plain version.

Any failed check exits nonzero before the last line. Without a CUDA
device, or without the package beside it, it exits nonzero at once.
"""

from __future__ import annotations

import contextlib
import json
from collections import Counter
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

TOL = 5e-4          # complex64 tier of distributedfft_tpu/testing.py
TOL128 = 1e-11      # complex128 tier
SEED = 4242
SLAB_RANKS = 4
PENCIL_GRID = (2, 2)
SOURCE = "distributedfft_tpu_torch/csrc/four_step.cu"
RADIX_SOURCE = "distributedfft_tpu_torch/csrc/radix.cuh"
FUSE_SOURCE = "distributedfft_tpu_torch/csrc/fuse.cu"
TWO_LEVEL_SOURCE = "distributedfft_tpu_torch/csrc/two_level.cu"
REAL_ROWS_SOURCE = "distributedfft_tpu_torch/csrc/real_rows.cu"
REPLACES = {
    "fft2_last": "distributedfft_tpu/ops/pallas_fft.py:488",
    "fft_axis0": "distributedfft_tpu/ops/pallas_fft.py:580",
    "fft_last": "distributedfft_tpu/ops/pallas_fft.py:406",
    "fft_encode": "distributedfft_tpu/ops/pallas_fuse.py:254",
    "decode_fft": "distributedfft_tpu/ops/pallas_fuse.py:293",
    "fft_last_big": "distributedfft_tpu/ops/pallas_fft.py:682",
    "r2c_half": "distributedfft_tpu/ops/realfft.py:50",
    "c2r_half": "distributedfft_tpu/ops/realfft.py:79",
}
CODECS = ("bf16", "int8", "split")
# The codecs' bounds of tests/test_a2q_fusion.py:308 (_ENC_BOUNDS): a
# decoded wire block against the exact transform, over its max |.|.
ENC_BOUNDS = {"bf16": 8e-3, "int8": 2e-2, "split": 2e-4}
PAIR_BYTES = {"bf16": 4, "int8": 2, "split": 4}   # wire bytes per c64
# The decode kernel against fft_axis0 of the decoded wire (relative L2):
# both run the same radix stages on the same exactly decoded values.
FUSED_VS_UNFUSED = 1e-6


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_rates(name: str) -> tuple[float, float, str]:
    """(HBM bytes/s, fp32 flop/s, variant) of an H100 from its name:
    NVIDIA's data sheet figures, SXM unless the name says PCIe."""
    if "PCIe" in name:
        return 2.0e12, 51e12, "H100 PCIe data sheet: 2.0 TB/s, 51 TFLOP/s fp32"
    return 3.35e12, 67e12, "H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s fp32"


def rel_err(torch, got, want) -> tuple[float, float, float]:
    """(max |got - want| / max |want|, ||got - want|| / ||want||,
    max |got - want|). The first is the repo's measure (testing.rel_error);
    the L2 one also holds every output that is small beside the largest."""
    d = got - want
    diff = float(d.abs().max())
    l2 = float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(want))
    return diff / float(want.abs().max()), l2, diff


def seeded(torch, shape, device, seed=SEED):
    """Standard normal complex64 data: zero mean, so no single output (the
    zero frequency of data with a mean) outweighs the rest."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.complex64)


# The planes of the single 1024^3 grid, each 1024 x 1024 = 1048576
# elements, past the plane gate (cuda_fft.eligible2d: at most 524288, the
# JAX package's gate), so the cuda executor runs them per axis.
PLANE_GATE_SHAPE = (1024, 1024, 1024)
# The kernel calls of the single 1024^3 pair, three passes per axis on the
# (16, 8, 8) plan's radix-16 variants, and the plane kernel that
# check_plane_gate times beside them (no path launches it past the gate).
PLANE_GATE_CASES = [
    ("fft_axis0", True, (1, 1024, 1048576), "single 1024^3 fwd x"),
    ("fft_axis0", False, (1, 1024, 1048576), "single 1024^3 bwd x"),
    ("fft_axis0", True, PLANE_GATE_SHAPE, "single 1024^3 fwd y"),
    ("fft_axis0", False, PLANE_GATE_SHAPE, "single 1024^3 bwd y"),
    ("fft_last", True, (1048576, 1024), "single 1024^3 fwd z"),
    ("fft_last", False, (1048576, 1024), "single 1024^3 bwd z"),
    ("fft2_last", True, PLANE_GATE_SHAPE, "1024^3 plane past the gate"),
    ("fft2_last", False, PLANE_GATE_SHAPE, "1024^3 plane past the gate"),
]
# A plain version runs whole on at most this many elements (every case at
# 512^3) and past it in blocks of as many: run whole on an 8 GiB tensor,
# its complex128 stages with their copies would not fit the card beside
# the kernel's output.
PLAIN_BLOCK = 2**27


# Every (kernel, direction, shape) the counted paths launch, and where:
# the slab chain at 512^3 and (510, 510, 512) on 4 ranks, the single
# device at 512^3, the pencil chain at 512^3 on 2x2, and the R2C/C2R
# plans (half-length rows, the 257-wide half spectrum and, on the
# pencil, its 129-wide column split), and PLANE_GATE_CASES. The first
# case of each kernel is its record's shape. Three more (marked "also")
# are the other direction at a slab shape. check_covered fails a path
# that launches a case not listed here.
KERNEL_CASES = [
    ("fft2_last", True, (128, 512, 512), "slab fwd t0"),
    ("fft2_last", False, (128, 512, 512), "also"),
    ("fft2_last", True, (128, 510, 512), "uneven slab fwd t0"),
    ("fft2_last", True, (512, 512, 512), "single fwd"),
    ("fft2_last", False, (512, 512, 512), "single bwd"),
    ("fft_axis0", True, (1, 512, 65536), "slab and pencil fwd t3"),
    ("fft_axis0", False, (1, 512, 65536), "slab and pencil bwd t0"),
    ("fft_axis0", True, (128, 512, 512), "also"),
    ("fft_axis0", False, (128, 512, 512), "slab bwd t3"),
    ("fft_axis0", True, (1, 510, 65536), "uneven slab fwd t3"),
    ("fft_axis0", False, (1, 510, 65536), "uneven slab bwd t0"),
    ("fft_axis0", False, (128, 510, 512), "uneven slab bwd t3"),
    ("fft_axis0", True, (1, 512, 262144), "single fwd"),
    ("fft_axis0", False, (1, 512, 262144), "single bwd"),
    ("fft_axis0", True, (256, 512, 256), "pencil fwd t1"),
    ("fft_axis0", False, (256, 512, 256), "pencil bwd t1"),
    ("fft_axis0", True, (128, 512, 257), "slab r2c t0 y"),
    ("fft_axis0", False, (128, 512, 257), "slab c2r t0 y"),
    ("fft_axis0", True, (1, 512, 32896), "slab r2c t3"),
    ("fft_axis0", False, (1, 512, 32896), "slab c2r t3"),
    ("fft_axis0", True, (512, 512, 257), "single r2c y"),
    ("fft_axis0", False, (512, 512, 257), "single c2r y"),
    ("fft_axis0", True, (1, 512, 131584), "single r2c x"),
    ("fft_axis0", False, (1, 512, 131584), "single c2r x"),
    ("fft_axis0", True, (256, 512, 129), "pencil r2c t1"),
    ("fft_axis0", False, (256, 512, 129), "pencil c2r t1"),
    ("fft_axis0", True, (1, 512, 33024), "pencil r2c t3"),
    ("fft_axis0", False, (1, 512, 33024), "pencil c2r t3"),
    ("fft_last", False, (65536, 512), "slab bwd t0, pencil bwd t3"),
    ("fft_last", True, (65536, 512), "pencil fwd t0"),
    ("fft_last", False, (65280, 512), "uneven slab bwd t0"),
    ("fft_last", True, (65536, 256), "slab r2c t0"),
    ("fft_last", False, (65536, 256), "slab c2r t0"),
    ("fft_last", True, (262144, 256), "single r2c"),
    ("fft_last", False, (262144, 256), "single c2r"),
] + PLANE_GATE_CASES

# The two-level route's cases (``fft_last_big``, (batch, n)): long_cases'
# first entries, held by time_two_level against both plain versions.
TWO_LEVEL_CASES = []
# Wrappers only the long 1D paths launch, and the real wrappers, which
# only R2C / C2R plans launch: the paths at 512^3 and the like are not
# held to launch them.
NOT_EVERY_PATH = ("fft_last_big", "r2c_half", "c2r_half")
# Captures a traced run takes before it fails, each one after a capture
# that lost the profiler's records of a stage's kernels.
LOST_TRIES = 3


def steady_ms(torch, fn, reps=20):
    """Device time per call of ``fn`` launched ``reps`` times back to back
    between two CUDA events: the host's time to launch each call hides
    behind the device's work, where the one-call times of
    ``timing.cuda_time_ms`` include it."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_breakdown(torch, fn, reps=10) -> str:
    """Device time per call of each kernel ``fn`` launches (torch.profiler
    over ``reps`` calls), longest first; "not measured" when the trace
    holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        name = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
        name = name.removeprefix("void ").strip()
        if us and ev.count >= reps and not name.startswith(("aten::",
                                                             "cuda")):
            rows.append((us / reps, name[:60]))
    if not rows:
        return "not measured"
    return "; ".join(f"{n} {us:.1f} us" for us, n in sorted(rows,
                                                            reverse=True))


def library_call(torch, name, fwd, normalize=True):
    """The torch.fft call that computes what kernel ``name`` does
    (``normalize=False``: the inverse without its 1/n)."""
    if name == "fft2_last":
        return torch.fft.fft2 if fwd else torch.fft.ifft2
    dim = 1 if name == "fft_axis0" else -1
    f = torch.fft.fft if fwd else torch.fft.ifft
    norm = "backward" if normalize else "forward"
    return lambda x: f(x, dim=dim, norm=norm)


def case_key(case):
    """The key :func:`recording_cases` gives a kernel case: (kernel,
    forward, shape), and "unnormalized" after an inverse case whose fifth
    entry is False (a stage of the two-level transform)."""
    unnormalized = len(case) > 4 and not case[4] and not case[1]
    return tuple(case[:3]) + (("unnormalized",) if unnormalized else ())


def route_flops(cf, radix, how, n):
    """Real flops of one length-n transform by route ``how``: the radix
    stages; the two-pass route's stages of both factors n = m1*m2 and the
    twiddle's complex product (6 flops) per element; or 8 n (n1 + n2) of
    the direct four-step sums."""
    if how == "radix":
        return radix.plan_flops(n)
    m1, m2 = cf.split_for(n)
    if how == "radix2":
        return m2 * radix.plan_flops(m1) + m1 * radix.plan_flops(m2) + 6 * n
    return 8 * n * (m1 + m2)


def plain_in_blocks(torch, plain, x, name):
    """``plain(x)``, past PLAIN_BLOCK elements block by block along an
    axis whose entries the kernel transforms apart: the batch of
    ``fft_last`` and ``fft2_last``, the ``lead`` of ``fft_axis0`` (its
    columns where ``lead`` is 1)."""
    if x.numel() <= PLAIN_BLOCK:
        return plain(x)
    dim = 2 if name == "fft_axis0" and x.shape[0] == 1 else 0
    step = max(1, PLAIN_BLOCK * x.shape[dim] // x.numel())
    out = torch.empty_like(x)
    for i in range(0, x.shape[dim], step):
        block = (slice(None),) * dim + (slice(i, i + step),)
        out[block] = plain(x[block])
    return out


def check_kernels(torch, cf, radix, timing, rates, cases=None):
    """Phase 2: each kernel against its plain version at every shape the
    main path gives it (``cases``: KERNEL_CASES unless given). Returns one
    record per kernel."""
    hbm, fp32, _ = rates
    dev = torch.device("cuda", torch.cuda.current_device())
    records = {}
    for i, case in enumerate(KERNEL_CASES if cases is None else cases):
        name, fwd, shape, where = case[:4]
        kw = {} if case_key(case) == tuple(case[:3]) else {"normalize": False}
        kernel = lambda x, f, _k=getattr(cf, name): _k(x, f, **kw)
        plain = lambda x, f, _p=getattr(cf, f"{name}_plain"): (
            plain_in_blocks(torch, lambda b: _p(b, f, **kw), x, name))
        lib = library_call(torch, name, fwd, not kw)
        label = (f"{'fwd' if fwd else 'inv'}{' unnormalized' if kw else ''} "
                 f"[{','.join(map(str, shape))}] ({where})")
        x = seeded(torch, shape, dev, SEED + i)
        y = kernel(x, fwd)
        torch.cuda.synchronize()
        want = plain(x, fwd)
        err, l2, abs_err = rel_err(torch, y, want)
        del want
        lib_err, lib_l2, _ = rel_err(torch, y, lib(x))
        del y
        if not max(err, l2, lib_err, lib_l2) <= TOL:
            fail(f"{name} {label}: rel err vs plain max {err:.3e} l2 "
                 f"{l2:.3e}, vs torch.fft max {lib_err:.3e} l2 {lib_l2:.3e}"
                 f" > {TOL}")
        ms = timing.cuda_time_ms(lambda: kernel(x, fwd), iters=10)
        plain_ms = timing.cuda_time_ms(lambda: plain(x, fwd), iters=10)
        library_ms = timing.cuda_time_ms(lambda: lib(x), iters=10)
        steady = (steady_ms(torch, lambda: kernel(x, fwd)),
                  steady_ms(torch, lambda: lib(x)))
        # a device copy reads x once and writes it once: the rate one pass
        # over this tensor can reach on this card
        out = torch.empty_like(x)
        copy_ms = timing.cuda_time_ms(lambda: out.copy_(x), iters=10)
        del out
        numel = math.prod(shape)
        if name == "fft2_last":
            n = shape[1] * shape[2]
            lengths = tuple((m, numel // m) for m in shape[1:])
        else:
            n = shape[1] if name == "fft_axis0" else shape[-1]
            lengths = ((n, numel // n),)
        how = (cf.route2d(*shape[1:]) if name == "fft2_last"
               else cf.route(n))
        kernel_flops = sum(seqs * route_flops(cf, radix, how, m)
                           for m, seqs in lengths)
        model_flops = 5.0 * numel * math.log2(n)
        bytes_moved = 2 * numel * 8               # read once, write once
        t_bytes, t_ops = bytes_moved / hbm * 1e3, model_flops / fp32 * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        # the two-pass route reads and writes the data twice: its own cap
        two_pass = (f"bound_2pass_ms={max(2 * t_bytes, t_ops):.4f} "
                    if how == "radix2" else "")
        forms = ""
        if name == "fft2_last":   # the plane in L2-sized chunks, in one go
            chunk = radix.plane_chunk(*shape[1:])
            for tag, c in ((f"chunk{chunk}", chunk), ("one_go", shape[0])):
                t = timing.cuda_time_ms(lambda: cf.plane_launch(x, fwd, c),
                                        iters=10)
                forms += f"plane_{tag}_ms={t:.4f} "
        print(f"kernel {name:9s} {label:40s} route={how} "
              f"max_rel_err={err:.3e} "
              f"l2_rel_err={l2:.3e} max_abs_err={abs_err:.3e} "
              f"vs_torch_fft_max_rel={lib_err:.3e} "
              f"vs_torch_fft_l2_rel={lib_l2:.3e} "
              f"kernel_ms={ms:.4f} {forms}"
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"copy_ms={copy_ms:.4f} kernel_steady_ms={steady[0]:.4f} "
              f"library_steady_ms={steady[1]:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) {two_pass}"
              f"kernel_gflop={kernel_flops / 1e9:.3f} "
              f"kernel_gflops_rate={kernel_flops / ms / 1e6:.1f}", flush=True)
        rec = records.setdefault(name, dict(
            name=name, route="cuda",
            source=RADIX_SOURCE if how.startswith("radix") else SOURCE,
            replaces=REPLACES[name],
            launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
        rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
        del x
        torch.cuda.empty_cache()
    return records


# The fused real rows passes' cases (``cuda_fft.r2c_half`` /
# ``c2r_half``, csrc/real_rows.cu): (forward, [rows, n] real, where), every
# shape the counted paths give them (check_covered fails a path that
# launches one at any other) and the generic prime stage (608 = 2 * 304,
# 304 = 16 * 19), held only. The first pair is the records' shape.
REAL_ROWS_CASES = [
    (True, (262144, 512), "single r2c, C ABI single r2c"),
    (False, (262144, 512), "single c2r, C ABI single c2r"),
    (True, (65536, 512), "slab and pencil r2c t0"),
    (False, (65536, 512), "slab and pencil c2r t0"),
    (True, (131072, 512), "batch=2 slab r2c t0"),
    (False, (131072, 512), "batch=2 slab c2r t0"),
    (True, (65536, 608), "608 r2c t0"),
    (False, (65536, 608), "608 c2r t0"),
]


def check_real_rows(torch, cf, timing, rates, card):
    """The fused real rows passes against their plain version (the
    packed-real trick around the row kernel, as the card ran it before the
    fused pass) and torch.fft.rfft / irfft on the last axis, each case's
    error <= TOL; times each (median of 10, CUDA events; and back to back)
    beside its plain version, that library call, a device copy of the
    larger side and the bytes-once bound (real side and half spectrum
    each read or written once), and names the kernels it launched.
    Returns the records of ``r2c_half`` and ``c2r_half``, as
    :func:`check_kernels` returns its kernels'."""
    hbm, _, _ = rates
    dev = torch.device("cuda", torch.cuda.current_device())
    records = {}
    for i, (fwd, shape, where) in enumerate(REAL_ROWS_CASES):
        rows, n = shape
        x = seeded(torch, shape, dev, SEED + 50 + i).real.contiguous()
        spec = torch.fft.rfft(x, dim=-1)
        if fwd:
            kernel = lambda: cf.r2c_half(x, -1)
            plain = lambda: cf.r2c_half_plain(x, -1)
            lib = lambda: torch.fft.rfft(x, dim=-1)
        else:
            kernel = lambda: cf.c2r_half(spec, n, -1)
            plain = lambda: cf.c2r_half_plain(spec, n, -1)
            lib = lambda: torch.fft.irfft(spec, n=n, dim=-1)
        key = ("r2c_half" if fwd else "c2r_half", "fused")
        routed = cf.ROUTES[key]
        got = kernel()
        torch.cuda.synchronize()
        if cf.ROUTES[key] != routed + 1:
            fail(f"real rows {where}: the call did not take the fused pass")
        err, l2, abs_err = rel_err(torch, got, plain())
        lib_err, lib_l2, _ = rel_err(torch, got, lib())
        del got
        label = (f"{'fwd' if fwd else 'inv'} [{rows},{n}] real "
                 f"{'->' if fwd else '<-'} [{rows},{n // 2 + 1}] ({where})")
        if not max(err, l2, lib_err, lib_l2) <= TOL:
            fail(f"real rows {label}: rel err vs plain max {err:.3e} l2 "
                 f"{l2:.3e}, vs torch.fft max {lib_err:.3e} l2 "
                 f"{lib_l2:.3e} > {TOL}")
        ms = timing.cuda_time_ms(kernel, iters=10)
        plain_ms = timing.cuda_time_ms(plain, iters=10)
        library_ms = timing.cuda_time_ms(lib, iters=10)
        steady = (steady_ms(torch, kernel), steady_ms(torch, lib))
        big = spec if spec.numel() * 8 >= x.numel() * 4 else x
        out = torch.empty_like(big)
        copy_ms = timing.cuda_time_ms(lambda: out.copy_(big), iters=10)
        del out
        bytes_moved = x.numel() * 4 + spec.numel() * 8
        bound_ms = bytes_moved / hbm * 1e3
        print(f"real rows {label}: route=fused max_rel_err={err:.3e} "
              f"l2_rel_err={l2:.3e} max_abs_err={abs_err:.3e} "
              f"vs_torch_fft_max_rel={lib_err:.3e} "
              f"vs_torch_fft_l2_rel={lib_l2:.3e} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"copy_ms={copy_ms:.4f} kernel_steady_ms={steady[0]:.4f} "
              f"library_steady_ms={steady[1]:.4f} bound_ms={bound_ms:.4f} "
              f"(bytes) kernel_x_bound={ms / bound_ms:.3f}; kernels: "
              f"{device_breakdown(torch, kernel)} [{card}]", flush=True)
        rec = records.setdefault(key[0], dict(
            name=key[0], route="cuda", source=REAL_ROWS_SOURCE,
            replaces=REPLACES[key[0]], launches=0, max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
            library_ms=library_ms))
        rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
        del x, spec
        torch.cuda.empty_cache()
    return records


def check_plane_gate(torch, cf, ex, timing, rates, card):
    """The trailing planes of PLANE_GATE_SHAPE both ways through the plane
    kernel directly (``fft2_last``: its launcher has no plane limit) and
    through the route the gate chooses (the ``cuda`` executor over axes
    (1, 2): one ``fft_along_axis`` pass per axis, a ``plane2d`` fallback
    counted); each held against the other and against torch.fft (error <=
    TOL) and timed (median of 10, CUDA events; and back to back) beside
    torch.fft and the bytes-once bound: whether lifting the gate on the
    card would pay. Every kernel call must be a case of PLANE_GATE_CASES,
    which phase 2 holds against its plain version (check_covered on the
    launches counted from 0)."""
    hbm, fp32, _ = rates
    dev = torch.device("cuda", torch.cuda.current_device())
    x = seeded(torch, PLANE_GATE_SHAPE, dev, SEED + 90)
    _, ny, nz = x.shape
    t_bytes = 2 * x.numel() * 8 / hbm * 1e3
    t_ops = 5.0 * x.numel() * math.log2(ny * nz) / fp32 * 1e3
    bound_ms = max(t_bytes, t_ops)
    cf.reset_launches()
    for fwd in (True, False):
        direct = lambda: cf.fft2_last(x, fwd)
        per_axis = lambda: ex(x, (1, 2), fwd)
        lib = lambda: torch.fft.fft2(x) if fwd else torch.fft.ifft2(x)
        label = f"{'fwd' if fwd else 'inv'} {list(x.shape)}"
        refused = cf.FALLBACKS[(2, "plane2d")]
        got = per_axis()
        if cf.FALLBACKS[(2, "plane2d")] != refused + 1:
            fail(f"plane gate {label}: the executor took the plane kernel")
        want = direct()
        errs = rel_err(torch, got, want)[:2]
        del want
        want = lib()
        errs += rel_err(torch, got, want)[:2]
        del got, want
        if not max(errs) <= TOL:
            fail(f"plane gate {label}: rel err per axis vs direct max / l2 "
                 f"{errs[0]:.3e} / {errs[1]:.3e}, vs torch.fft "
                 f"{errs[2]:.3e} / {errs[3]:.3e} > {TOL}")
        ms = {k: timing.cuda_time_ms(fn, iters=10) for k, fn in
              (("direct", direct), ("per_axis", per_axis), ("library", lib))}
        steady = {k: steady_ms(torch, fn, reps=10) for k, fn in
                  (("direct", direct), ("per_axis", per_axis))}
        print(f"plane gate {label}: per_axis_vs_direct_max_rel={errs[0]:.3e} "
              f"l2_rel={errs[1]:.3e} vs_torch_fft_max_rel={errs[2]:.3e} "
              f"l2_rel={errs[3]:.3e} direct_ms={ms['direct']:.4f} "
              f"per_axis_ms={ms['per_axis']:.4f} "
              f"library_ms={ms['library']:.4f} "
              f"direct_steady_ms={steady['direct']:.4f} "
              f"per_axis_steady_ms={steady['per_axis']:.4f} "
              f"bound_ms={bound_ms:.4f} "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}) "
              f"per_axis_over_direct={ms['per_axis'] / ms['direct']:.3f}; "
              f"kernels per axis: {device_breakdown(torch, per_axis, 3)} "
              f"[{card}]", flush=True)
    check_covered((), "the plane gate")
    del x
    torch.cuda.empty_cache()


# The routes each wrapper may take on the paths whose lengths are all at
# most 8192 (512, 510, 256, 608, ...): the radix route, and for the fused
# kernels also its row form at cols = 1 (cuda_fuse.fused_form).
RADIX_FORMS = {"fft_last": ("radix",), "fft2_last": ("radix",),
               "fft_axis0": ("radix",), "decode_fft": ("radix", "radix_rows"),
               "fft_encode": ("radix", "radix_rows")}


def fused_form(cfu, shape, axis):
    """The route a fused launch over ``shape`` along ``axis`` is counted
    under (``cuda_fuse.fused_form``; on a tree without it, as a parent's
    timed by ``--route-cases``, its ``fused_route``)."""
    n, cols = shape[axis], math.prod(shape[axis + 1:])
    form = getattr(cfu, "fused_form", None)
    return form(n, cols) if form else cfu.fused_route(n)


@contextlib.contextmanager
def recording_cases(cf, cfu):
    """Yield a Counter of the case key of every call of the five kernel
    wrappers and of the two-level route inside the block: (kernel,
    forward, shape) as in KERNEL_CASES and TWO_LEVEL_CASES, and for the
    fused kernels (kernel, codec, forward, shape, axis, tiles) as in
    FUSED_CASES. The calls are seen by
    ``sys.setprofile``, so the wrappers and their counts stay as they
    are."""
    names = {cf.fft_last.__code__: "fft_last",
             cf.fft_axis0.__code__: "fft_axis0",
             cf.fft2_last.__code__: "fft2_last",
             cf._fft_last_big.__code__: "fft_last_big",
             cfu.fused_fft_encode.__code__: "fft_encode",
             cfu.fused_decode_fft.__code__: "decode_fft"}
    seen = Counter()

    def on_call(frame, event, _arg):
        name = names.get(frame.f_code) if event == "call" else None
        if name is None:
            return
        a = frame.f_locals
        if name in ("fft_encode", "decode_fft"):
            shape = (a["x"].shape if name == "fft_encode"
                     else a["parts"][0].shape[:-1])
            seen[(name, a["wire_dtype"], a["forward"], tuple(shape),
                  a["fft_axis"], a["tiles"])] += 1
        elif name == "fft_last_big":
            key = (name, a["forward"], tuple(a["x2"].shape))
            if not a["forward"] and a.get("scale", 1.0) == 1.0:
                key += ("unnormalized",)
            seen[key] += 1
        else:
            key = (name, a["forward"], tuple(a["x"].shape))
            if not a["forward"] and not a.get("normalize", True):
                key += ("unnormalized",)
            seen[key] += 1

    sys.setprofile(on_call)
    try:
        yield seen
    finally:
        sys.setprofile(None)


def check_covered(seen, path, extra=()):
    """Fail unless every kernel call of ``path`` (keys of
    :func:`recording_cases`, which sees this thread's calls, and of
    ``cuda_fft.CASES``, which counts every launch of this process since
    the path's reset, from any thread) and every case in ``extra`` (what
    other processes reported) is a case the kernel phases held against
    its plain version."""
    from distributedfft_tpu_torch.ops import cuda_fft

    seen = set(seen) | set(cuda_fft.CASES) | set(extra)
    held = ({case_key(c) for c in KERNEL_CASES + TWO_LEVEL_CASES}
            | {c[:6] for c in FUSED_CASES}
            | {("r2c_half" if fwd else "c2r_half", fwd, shape)
               for fwd, shape, _ in REAL_ROWS_CASES})
    missing = sorted(seen - held, key=str)
    if missing:
        fail(f"{path} launches kernels at cases no kernel phase checked: "
             f"{missing}")
    print(f"kernel calls on {path}: {len(seen)} (kernel, shape) cases, "
          f"each held against its plain version", flush=True)


def check_routes(cf, path, first, total):
    """Print the launches of each wrapper by route (``first``: the counts
    of the path's first part, the single device) and fail if a row,
    strided, plane, decode or encode kernel took a route other than the
    radix one (the fused kernels: or its row form)."""
    rest = {k: v - first.get(k, 0) for k, v in total.items()}
    print(f"routes on {path} (wrapper, route): "
          + (f"single {first}; rest {rest}; " if first else "")
          + f"all {total}", flush=True)
    for (wrapper, how), v in total.items():
        if wrapper in RADIX_FORMS and how not in RADIX_FORMS[wrapper] and v:
            fail(f"{wrapper} took the {how} route {v} times on {path}")


def check_small(torch, dfft):
    """The repo's own check on a small uneven input: seeded world data
    through the port on the card, against numpy's float64 fftn."""
    import numpy as np
    from distributedfft_tpu_torch import testing

    shape = (64, 66, 72)
    x = testing.make_world_data(shape, np.complex64)
    want = np.fft.fftn(x.astype(np.complex128))
    l2 = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for world in (None, SLAB_RANKS):
        fwd = dfft.plan_dft_c2c_3d(shape, world)
        bwd = dfft.plan_dft_c2c_3d(shape, world, direction=dfft.BACKWARD)
        y = fwd(torch.from_numpy(x).to(fwd.device))
        got, back = y.cpu().numpy(), bwd(y).cpu().numpy()
        errs = (testing.rel_error(got, want), l2(got, want),
                testing.rel_error(back, x), l2(back, x))
        print(f"small {shape} world={world}: vs numpy fftn (float64) "
              f"max rel err={errs[0]:.3e} l2 rel err={errs[1]:.3e}; "
              f"roundtrip max rel err={errs[2]:.3e} l2 rel err={errs[3]:.3e}",
              flush=True)
        if not max(errs) <= TOL:
            fail(f"small {shape} world={world}: error over {TOL}")


def run_plan_pair(torch, dfft, shape, world, x, label, timer=None):
    """Forward then backward through the port, each checked against
    torch.fft.fftn / the input. Returns (fwd plan, bwd plan)."""
    fwd = dfft.plan_dft_c2c_3d(shape, world)
    bwd = dfft.plan_dft_c2c_3d(shape, world, direction=dfft.BACKWARD)
    y = fwd(x, timer=timer)
    torch.cuda.synchronize()
    if tuple(y.shape) != tuple(shape) or not bool(torch.isfinite(
            torch.view_as_real(y)).all()):
        fail(f"{label}: forward output not finite or of shape {tuple(y.shape)}")
    ref = torch.fft.fftn(x)
    errs = rel_err(torch, y, ref)[:2]
    del ref
    r = bwd(y, timer=timer)
    torch.cuda.synchronize()
    errs += rel_err(torch, r, x)[:2]
    del y, r
    torch.cuda.empty_cache()
    print(f"{label}: forward vs torch.fft.fftn max rel err={errs[0]:.3e} "
          f"l2 rel err={errs[1]:.3e}; roundtrip max rel err={errs[2]:.3e} "
          f"l2 rel err={errs[3]:.3e}", flush=True)
    if not max(errs) <= TOL:
        fail(f"{label}: error over {TOL}")
    return fwd, bwd


def time_plans(torch, timing, fwd, bwd, x, label):
    """CUDA-event times of the forward and backward plan (median of 10)."""
    y = fwd(x)
    t_f = timing.cuda_time_ms(lambda: fwd(x), iters=10)
    t_b = timing.cuda_time_ms(lambda: bwd(y), iters=10)
    del y
    torch.cuda.empty_cache()
    shape = fwd.shape
    print(f"{label}: forward_ms={t_f:.3f} ({timing.gflops(shape, t_f / 1e3):.1f}"
          f" GFlop/s) backward_ms={t_b:.3f} "
          f"({timing.gflops(shape, t_b / 1e3):.1f} GFlop/s)", flush=True)


def stage_split(torch, timing, fwd, bwd, x, label, x_bwd=None):
    """t0..t3 of one forward and one backward run of a slab plan
    (``x_bwd``: the backward's input, ``x`` when None)."""
    for plan, what, inp in ((fwd, "forward", x),
                            (bwd, "backward", x if x_bwd is None else x_bwd)):
        plan(inp)  # warm
        timer = timing.StageTimer(x.device)
        y = plan(inp, timer=timer)
        times = timer.times()
        del y
        print(f"{label} {what} stages (CUDA events, ms): " + " ".join(
            f"{k}={v * 1e3:.3f}" for k, v in times.items()), flush=True)


# Every (kernel, codec, forward, shape, axis, tiles, where) the
# compressed paths launch at 512^3: the slab on 4 ranks (tiles = 4) and
# the pencil on 2x2 (tiles = 2); the tile axis is the FFT axis. The
# first case of each kernel is its record's shape. On the last axis
# (axis 2) the strided layout has one column (cols = 1).
FUSED_CASES = (
    [("decode_fft", "split", True, (512, 128, 512), 0, 4,
      "C2C fwd t3_fft_x"),
     ("decode_fft", "split", False, (128, 512, 512), 1, 4,
      "C2C bwd t3_fft_y")]
    + [("decode_fft", c, True, (512, 128, 257), 0, 4, "R2C fwd t3_fft_x")
       for c in CODECS]
    + [("decode_fft", c, False, (128, 512, 257), 1, 4, "C2R bwd t0_ifft_y")
       for c in CODECS]
    + [("fft_encode", c, False, (512, 128, 257), 0, 4, "C2R bwd t3_ifft_x")
       for c in ("split", "bf16", "int8")]
    + [("fft_encode", c, True, (256, 256, 512), 2, 2,
        "pencil fwd t0_fft_z, cols=1") for c in ("split", "bf16", "int8")]
    + [("decode_fft", c, False, (256, 256, 512), 2, 2,
        "pencil bwd t3_fft_z, cols=1") for c in ("split", "bf16", "int8")]
    + [("decode_fft", "split", True, (256, 512, 256), 1, 2,
        "pencil fwd t1_fft_y"),
       ("decode_fft", "split", True, (512, 256, 256), 0, 2,
        "pencil fwd t3_fft_x"),
       ("fft_encode", "split", False, (512, 256, 256), 0, 2,
        "pencil bwd t0_fft_x"),
       ("decode_fft", "split", False, (256, 512, 256), 1, 2,
        "pencil bwd t1_fft_y")]
    + [("decode_fft", "bf16", False, (128, 512, 512), 1, 4,
        "bf16 op slab t3_ifft_y (tuned op tier)"),
       ("fft_encode", "split", True, (512, 256), 0, 8,
        "calibrate fuse_speedup")])


def exact_dft(torch, x, axis, fwd):
    """The exact-arithmetic yardstick of a fused kernel: torch.fft."""
    return (torch.fft.fft if fwd else torch.fft.ifft)(x, dim=axis)


def check_fused_kernels(torch, cf, cfu, wire_codec, timing, rates,
                        cases=None):
    """Phase 3: the fused stage+codec kernels against their plain
    versions at every (shape, codec) the compressed path gives them
    (``cases``: FUSED_CASES unless given), the encode also against the
    codec's encode of the strided or row kernel's output and the decode
    against that kernel on the decoded wire: bit for bit on every route
    but a parent tree's direct one (``--route-cases``), which is
    reported. Returns one record per kernel."""
    hbm, fp32, _ = rates
    dev = torch.device("cuda", torch.cuda.current_device())
    records = {}
    for i, case in enumerate(FUSED_CASES if cases is None else cases):
        name, codec, fwd, shape, axis, tiles, where = case[:7]
        bounded = case[7] if len(case) > 7 else True
        how = fused_form(cfu, shape, axis)
        kw = dict(fft_axis=axis, forward=fwd, tile_axis=axis,
                  tiles=tiles, wire_dtype=codec)
        cw = wire_codec(codec)
        dec = lambda parts: cw.decode(parts, torch.complex64, tile_axis=axis,
                                      tiles=tiles)
        label = (f"{codec:5s} {'fwd' if fwd else 'inv'} axis {axis} "
                 f"[{','.join(map(str, shape))}] ({where})")
        x = seeded(torch, shape, dev, SEED + 100 + i)
        exact = exact_dft(torch, x, axis, fwd)
        if name == "fft_encode":
            kernel = lambda: cfu.fused_fft_encode(x, **kw)
            plain = lambda: cfu.fused_fft_encode_plain(x, **kw)
            # the unfused sender on the card: the strided kernel (the row
            # kernel on the last axis), then the codec; the encode runs the
            # same passes and packs or quantizes what the last produces,
            # so the two agree to the bit
            unfused = lambda: cw.encode(cf.fft_along_axis(x, axis, fwd),
                                        tile_axis=axis, tiles=tiles)
            got, want, twin = kernel(), plain(), unfused()
            torch.cuda.synchronize()
            if [(g.shape, g.dtype) for g in got] != [
                    (w.shape, w.dtype) for w in want] or [
                    (g.shape, g.dtype) for g in got] != [
                    (t.shape, t.dtype) for t in twin]:
                fail(f"{name} {label}: wire parts differ in shape or dtype")
            apart_twin = [int((g != t).sum()) for g, t in zip(got, twin)]
            if any(apart_twin) and "direct" not in how:
                fail(f"{name} {label}: differs from the codec's encode of "
                     f"fft_axis0(x) in {apart_twin} values (payload, "
                     f"sidecar)")
            del twin
            if codec == "bf16":
                # One level of bf16 at each value, plus the fp32 difference
                # of the two transforms before the cast (~2e-7 of the
                # block's max; 1e-6 allowed), which is all there is near 0.
                g, w = got[0].float(), want[0].float()
                off = int(((g - w).abs() > 0).sum())
                apart = bool(((g - w).abs() <= 2.0 ** -8 * (g.abs() + w.abs())
                              + 1e-6 * float(w.abs().max())).all())
                side = "no sidecar"
            else:
                d = (got[0].int() - want[0].int()).abs()
                off, apart = int((d > 0).sum()), int(d.max()) <= 1
                if not torch.equal(got[1], want[1]):
                    fail(f"{name} {label}: sidecars differ")
                side = "sidecars bit-identical"
            if not apart:
                fail(f"{name} {label}: mantissas more than one level apart")
            got_y, want_y = dec(got), dec(want)
            err, l2, abs_err = rel_err(torch, got_y, want_y)
            out = torch.empty_like(x)
            detail = (f"route={how}; vs codec(fft_along_axis(x)): "
                      f"{apart_twin} values apart (payload, sidecar); "
                      f"steady_ms="
                      f"{steady_ms(torch, kernel):.4f} copy_ms="
                      f"{steady_ms(torch, lambda: out.copy_(x)):.4f} "
                      f"unfused_ms="
                      f"{timing.cuda_time_ms(unfused, iters=10):.4f}; device "
                      f"time per call by kernel: "
                      f"{device_breakdown(torch, kernel)}; vs "
                      f"plain: {side}, {off} of {got[0].numel()} mantissas "
                      f"one level apart; decoded vs plain decoded")
            del out
            wire_rw = 8 + PAIR_BYTES[codec]
        else:
            parts = cw.encode(x, tile_axis=axis, tiles=tiles)
            kernel = lambda: cfu.fused_decode_fft(parts, torch.complex64,
                                                  **kw)
            plain = lambda: cfu.fused_decode_fft_plain(parts,
                                                       torch.complex64, **kw)
            got_y, want_y = kernel(), plain()
            torch.cuda.synchronize()
            err, l2, abs_err = rel_err(torch, got_y, want_y)
            if not max(err, l2) <= TOL:
                fail(f"{name} {label}: vs plain max {err:.3e} l2 {l2:.3e} "
                     f"> {TOL}")
            # the unfused receiver on the card: the strided kernel (the
            # row kernel on the last axis) on the decoded wire; the
            # decode kernel runs the same passes on the same exactly
            # decoded values, so the two agree to the bit
            unfused_y = cf.fft_along_axis(dec(parts), axis, fwd)
            _, fu_l2, _ = rel_err(torch, got_y, unfused_y)
            twin = twin_report(torch, (got_y,), (unfused_y,))
            del unfused_y
            if "direct" not in how and not (fu_l2 <= FUSED_VS_UNFUSED
                                            and twin == "bit-identical"):
                fail(f"{name} {label}: vs fft_along_axis(decode): {twin}, "
                     f"l2 {fu_l2:.3e}")
            # unfused_ms: the codec's decode, then torch.fft (two calls:
            # a reference, not a library_ms); twin_ms: the unfused twin,
            # the codec's decode, then the strided or row kernel
            lib = lambda: exact_dft(torch, dec(parts), axis, fwd)
            unfused = lambda: cf.fft_along_axis(dec(parts), axis, fwd)
            out = torch.empty_like(got_y)
            detail = (f"route={how}; vs "
                      f"fft_along_axis(decode): {twin}; steady_ms="
                      f"{steady_ms(torch, kernel):.4f} copy_ms="
                      f"{steady_ms(torch, lambda: out.copy_(got_y)):.4f} "
                      f"unfused_ms={timing.cuda_time_ms(lib, iters=10):.4f}"
                      f" twin_ms={timing.cuda_time_ms(unfused, iters=10):.4f}"
                      f"; vs plain")
            del out
            wire_rw = PAIR_BYTES[codec] + 8
        codec_err = float((got_y - exact).abs().max() / exact.abs().max())
        # the codec's own error on the same data: its round trip of the
        # exact transform (encode), or torch.fft of the decoded wire
        if name == "fft_encode":
            ref_y = cw.decode(cw.encode(exact, tile_axis=axis, tiles=tiles),
                              torch.complex64, tile_axis=axis, tiles=tiles)
        else:
            ref_y = exact_dft(torch, dec(parts), axis, fwd)
        codec_ref = float((ref_y - exact).abs().max() / exact.abs().max())
        del ref_y
        # The JAX package's bounds were measured at four tiles (its slab
        # cases). At the pencil's two tiles each step covers twice the
        # values, and the int8 codec alone exceeds its bound there (2.04e-2
        # on an H100 at the [256,256,512] inverse); on the data of the
        # paths past 8192 (long_fused_cases, marked unbounded) it does at
        # four tiles too (2.244e-2 at the [16384,32,128] forward decode,
        # 2.054e-2 at the [4096,128,128] inverse). So every case holds
        # the kernel to the codec's own error, the other four-tile cases
        # also to the bound.
        if not codec_err <= codec_ref + 1e-6 or (
                tiles == SLAB_RANKS and bounded
                and not codec_err <= ENC_BOUNDS[codec]):
            fail(f"{name} {label}: decoded vs torch.fft {codec_err:.3e}, "
                 f"the codec's own {codec_ref:.3e}, bound "
                 f"{ENC_BOUNDS[codec]}")
        del got_y, want_y, exact
        ms = timing.cuda_time_ms(kernel, iters=10)
        plain_ms = timing.cuda_time_ms(plain, iters=10)
        numel, n = math.prod(shape), shape[axis]
        t_bytes = numel * wire_rw / hbm * 1e3
        t_ops = 5.0 * numel * math.log2(n) / fp32 * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        # the two-pass route also reads and writes a c64 scratch of the
        # data: its own cap
        two_pass = (f" bound_2pass_ms="
                    f"{max(t_bytes + numel * 16 / hbm * 1e3, t_ops):.4f}"
                    if how.startswith("radix2") else "")
        print(f"kernel {name:10s} {label:54s} {detail} max_rel_err={err:.3e} "
              f"l2_rel_err={l2:.3e} max_abs_err={abs_err:.3e} "
              f"vs_torch_fft_max_rel={codec_err:.3e} (the codec's own "
              f"{codec_ref:.3e}, bound {ENC_BOUNDS[codec]}) "
              f"kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}){two_pass}", flush=True)
        rec = records.setdefault(name, dict(
            name=name, route="cuda", source=FUSE_SOURCE,
            replaces=REPLACES[name], launches=0, max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))
        rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
        del x
        if name == "decode_fft":
            del parts
        torch.cuda.empty_cache()
    return records


def seeded_real(torch, shape, device, seed=SEED):
    """Standard normal float32 data (zero mean)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32)


#: The fused sites' (sender, receiver) routes the JAX package takes on
#: these slab plans (a 4-device CPU mesh at 64^3 with pallas, split, fuse).
SITE_ROUTES = {"c2c fwd": ("multi_axis", "kernel"),
               "c2c bwd": ("multi_axis", "kernel"),
               "r2c fwd": ("ops", "kernel"),
               "c2r bwd": ("kernel", "kernel")}


def check_sites(plan, key, label):
    sites = list(plan.graph.meta["fusion"]["sites"].values())
    routes = [(s["sender"], s["receiver"]) for s in sites]
    print(f"{label}: fusion sites {sites}", flush=True)
    if routes != [SITE_ROUTES[key]]:
        fail(f"{label}: fused sites {routes}, expected {[SITE_ROUTES[key]]}")


def twin_report(torch, got, want) -> str:
    """``bit-identical`` when every tensor of ``got`` equals its twin in
    ``want``, else how many values of each differ and by how much."""
    if all(torch.equal(g, w) for g, w in zip(got, want)):
        return "bit-identical"
    return "; ".join(
        f"#{i}: {int((g != w).sum())} of {g.numel()} values differ, max abs "
        f"diff {float((g - w).abs().max()):.3e}"
        for i, (g, w) in enumerate(zip(got, want)))


def check_fused_plans(torch, dfft, world, n=512):
    """Phase 6: the compressed and real plans at n^3. Returns the plans
    the timing phase times."""
    shape = (n, n, n)
    dev = torch.device("cuda", torch.cuda.current_device())
    plans = {}

    # C2C with the split codec fused, forward and backward.
    x = seeded(torch, shape, dev)
    fwd = dfft.plan_dft_c2c_3d(shape, world, wire_dtype="split", fuse=True)
    bwd = dfft.plan_dft_c2c_3d(shape, world, wire_dtype="split", fuse=True,
                               direction=dfft.BACKWARD)
    y = fwd(x)
    back = bwd(y)
    errs = rel_err(torch, y, torch.fft.fftn(x))[:2]
    errs += rel_err(torch, back, x)[:2]
    print(f"c2c split fused {n}^3 P={SLAB_RANKS}: forward vs torch.fft.fftn "
          f"max rel err={errs[0]:.3e} l2 rel err={errs[1]:.3e}; roundtrip "
          f"max rel err={errs[2]:.3e} l2 rel err={errs[3]:.3e}", flush=True)
    if not max(errs) <= TOL:
        fail(f"c2c split fused: error over {TOL}")
    check_sites(fwd, "c2c fwd", "c2c split fused fwd")
    check_sites(bwd, "c2c bwd", "c2c split fused bwd")
    plans["c2c split fused"] = (fwd, bwd, "c2c")
    # its unfused twin on the same inputs: the receivers are the fused
    # decode, equal to fft_axis0 of the decoded wire, and the senders are
    # unfused in both (multi_axis), so the outputs should be equal
    twin_f = dfft.plan_dft_c2c_3d(shape, world, wire_dtype="split")
    twin_b = dfft.plan_dft_c2c_3d(shape, world, wire_dtype="split",
                                  direction=dfft.BACKWARD)
    print(f"c2c split {n}^3 P={SLAB_RANKS}: fused vs unfused twin "
          f"(forward, backward of the fused forward's output): "
          f"{twin_report(torch, (y, back), (twin_f(x), twin_b(y)))}",
          flush=True)
    del x, y, back
    torch.cuda.empty_cache()

    # R2C / C2R: exact, then each codec unfused and fused.
    xr = seeded_real(torch, shape, dev)
    spec = torch.fft.rfftn(xr)
    back_ref = torch.fft.irfftn(spec, s=shape)
    exact_f = dfft.plan_dft_r2c_3d(shape, world)
    exact_b = dfft.plan_dft_c2r_3d(shape, world)
    y_exact = exact_f(xr)
    r_exact = exact_b(spec)
    results = {}
    for codec in (None,) + CODECS:
        for fuse in ((False,) if codec is None else (False, True)):
            f = dfft.plan_dft_r2c_3d(shape, world, wire_dtype=codec,
                                     fuse=fuse)
            b = dfft.plan_dft_c2r_3d(shape, world, wire_dtype=codec,
                                     fuse=fuse)
            y = f(xr)
            if tuple(y.shape) != (n, n, n // 2 + 1) or not bool(
                    torch.isfinite(torch.view_as_real(y)).all()):
                fail(f"r2c {codec}: output not finite or of shape "
                     f"{tuple(y.shape)}")
            r = b(spec)
            rt = b(y)
            errs = (rel_err(torch, y, spec)[:2] + rel_err(torch, r, back_ref)[:2]
                    + rel_err(torch, rt, xr)[:2])
            vs_exact = (rel_err(torch, y, y_exact)[0],
                        rel_err(torch, r, r_exact)[0])
            label = (f"r2c/c2r {codec or 'exact'}"
                     f"{' fused' if fuse else ''} {n}^3 P={SLAB_RANKS}")
            print(f"{label}: r2c vs torch.fft.rfftn max rel err={errs[0]:.3e}"
                  f" l2 rel err={errs[1]:.3e}; c2r vs torch.fft.irfftn max "
                  f"rel err={errs[2]:.3e} l2 rel err={errs[3]:.3e}; "
                  f"roundtrip max rel err={errs[4]:.3e} l2 rel err="
                  f"{errs[5]:.3e}; vs the exact port plan max rel err "
                  f"r2c={vs_exact[0]:.3e} c2r={vs_exact[1]:.3e}", flush=True)
            if codec is not None and not fuse:
                twin = (y, r, rt)
            elif codec is not None:
                # every fused site (the C2R sender: kernel 4; each
                # receiver: kernel 5) equals its unfused form to the bit
                report = twin_report(torch, (y, r, rt), twin)
                print(f"{label}: vs the unfused plan (r2c, c2r, roundtrip): "
                      f"{report}", flush=True)
                if report != "bit-identical":
                    fail(f"{label}: outputs differ from the unfused plan's: "
                         f"{report}")
                del twin
            del y, r, rt
            results[(codec, fuse)] = errs
            if fuse:
                check_sites(f, "r2c fwd", f"{label} fwd")
                check_sites(b, "c2r bwd", f"{label} bwd")
            if codec in (None, "split") and not max(errs) <= TOL:
                fail(f"{label}: error over {TOL}")
            if codec is not None:
                plans[f"r2c/c2r {codec}{' fused' if fuse else ''}"] = (
                    f, b, "r2c")
            torch.cuda.empty_cache()
    plans["r2c/c2r exact"] = (exact_f, exact_b, "r2c")
    for codec in CODECS:
        unfused, fused = results[(codec, False)], results[(codec, True)]
        print(f"r2c/c2r {codec}: fused vs unfused errors (r2c max, l2; c2r "
              f"max, l2; roundtrip max, l2): "
              + " ".join(f"{a:.3e}/{b:.3e}" for a, b in zip(fused, unfused)),
              flush=True)
        if codec != "split" and not all(
                a <= 1.1 * b for a, b in zip(fused, unfused)):
            fail(f"r2c/c2r {codec}: the fused plan is less accurate than "
                 f"the unfused one by more than 10%")
    del y_exact, r_exact

    # R2C / C2R on a single device.
    f = dfft.plan_dft_r2c_3d(shape)
    b = dfft.plan_dft_c2r_3d(shape)
    y = f(xr)
    errs = (rel_err(torch, y, spec)[:2] + rel_err(torch, b(spec), back_ref)[:2]
            + rel_err(torch, b(y), xr)[:2])
    print(f"r2c/c2r single {n}^3: r2c vs torch.fft.rfftn max rel err="
          f"{errs[0]:.3e} l2 rel err={errs[1]:.3e}; c2r vs torch.fft.irfftn "
          f"max rel err={errs[2]:.3e} l2 rel err={errs[3]:.3e}; roundtrip "
          f"max rel err={errs[4]:.3e} l2 rel err={errs[5]:.3e}", flush=True)
    if not max(errs) <= TOL:
        fail(f"r2c/c2r single: error over {TOL}")
    plans["r2c/c2r single"] = (f, b, "r2c")
    del xr, spec, back_ref, y
    torch.cuda.empty_cache()
    return plans


def time_real(torch, timing, fwd, bwd, x, label):
    """CUDA-event times of an R2C and a C2R plan (median of 10)."""
    y = fwd(x)
    t_f = timing.cuda_time_ms(lambda: fwd(x), iters=10)
    t_b = timing.cuda_time_ms(lambda: bwd(y), iters=10)
    del y
    torch.cuda.empty_cache()
    print(f"{label}: r2c_ms={t_f:.3f} c2r_ms={t_b:.3f}", flush=True)


#: The fused sites' (sender, receiver) routes the JAX package takes on a
#: pencil C2C plan (a 2x2 CPU mesh at 64^3 with pallas, split, fuse),
#: forward and backward: the first sender on the encode kernel, the
#: second encoding only, both receivers on the decode kernel.
PENCIL_SITE_ROUTES = [("kernel", "kernel"), ("encode_only", "kernel")]


def check_pencil(torch, dfft, dev, n=512):
    """Phase 8: the pencil plans at n^3 on a 2x2 loopback world. Returns
    the plans the timing phase times."""
    shape = (n, n, n)
    grid = PENCIL_GRID
    kw = dict(device=dev)
    plans = {}
    x = seeded(torch, shape, dev)
    fwd = dfft.plan_dft_c2c_3d(shape, grid, **kw)
    bwd = dfft.plan_dft_c2c_3d(shape, grid, direction=dfft.BACKWARD, **kw)
    if (fwd.decomposition, fwd.world.grid) != ("pencil", grid):
        fail(f"pencil plan is {fwd.decomposition} on {fwd.world.grid}")
    y = fwd(x)
    if tuple(y.shape) != shape or not bool(torch.isfinite(
            torch.view_as_real(y)).all()):
        fail(f"pencil forward output not finite or of shape {tuple(y.shape)}")
    errs = rel_err(torch, y, torch.fft.fftn(x))[:2]
    back = bwd(y)
    errs += rel_err(torch, back, x)[:2]
    label = f"pencil c2c {n}^3 {grid[0]}x{grid[1]}"
    print(f"{label}: forward vs torch.fft.fftn max rel err={errs[0]:.3e} "
          f"l2 rel err={errs[1]:.3e}; roundtrip max rel err={errs[2]:.3e} "
          f"l2 rel err={errs[3]:.3e}", flush=True)
    if not max(errs) <= TOL:
        fail(f"{label}: error over {TOL}")
    plans["pencil c2c exact"] = (fwd, bwd, "c2c")
    del y, back

    # the split codec fused against its unfused twin, both directions
    ff = dfft.plan_dft_c2c_3d(shape, grid, wire_dtype="split", fuse=True,
                              **kw)
    fb = dfft.plan_dft_c2c_3d(shape, grid, wire_dtype="split", fuse=True,
                              direction=dfft.BACKWARD, **kw)
    uf = dfft.plan_dft_c2c_3d(shape, grid, wire_dtype="split", **kw)
    ub = dfft.plan_dft_c2c_3d(shape, grid, wire_dtype="split",
                              direction=dfft.BACKWARD, **kw)
    y = ff(x)
    report = twin_report(torch, (y,), (uf(x),))
    back = fb(y)
    report_b = twin_report(torch, (back,), (ub(y),))
    errs = rel_err(torch, y, torch.fft.fftn(x))[:2] + rel_err(
        torch, back, x)[:2]
    label = f"pencil c2c split fused {n}^3 {grid[0]}x{grid[1]}"
    print(f"{label}: forward vs torch.fft.fftn max rel err={errs[0]:.3e} l2 "
          f"rel err={errs[1]:.3e}; roundtrip max rel err={errs[2]:.3e} l2 "
          f"rel err={errs[3]:.3e}; vs the unfused twin: forward {report}, "
          f"backward {report_b}", flush=True)
    if not max(errs) <= TOL:
        fail(f"{label}: error over {TOL}")
    if (report, report_b) != ("bit-identical", "bit-identical"):
        fail(f"{label}: outputs differ from the unfused twin's")
    for plan, what in ((ff, "fwd"), (fb, "bwd")):
        sites = list(plan.graph.meta["fusion"]["sites"].values())
        routes = [(st["sender"], st["receiver"]) for st in sites]
        print(f"{label} {what}: fusion sites {sites}", flush=True)
        if routes != PENCIL_SITE_ROUTES:
            fail(f"{label} {what}: fused sites {routes}, expected "
                 f"{PENCIL_SITE_ROUTES}")
    plans["pencil c2c split fused"] = (ff, fb, "c2c")
    plans["pencil c2c split unfused"] = (uf, ub, "c2c")
    del x, y, back

    # R2C / C2R exact
    xr = seeded_real(torch, shape, dev)
    spec = torch.fft.rfftn(xr)
    rf = dfft.plan_dft_r2c_3d(shape, grid, **kw)
    rb = dfft.plan_dft_c2r_3d(shape, grid, **kw)
    y = rf(xr)
    if tuple(y.shape) != (n, n, n // 2 + 1):
        fail(f"pencil r2c output of shape {tuple(y.shape)}")
    errs = (rel_err(torch, y, spec)[:2]
            + rel_err(torch, rb(spec), torch.fft.irfftn(spec, s=shape))[:2]
            + rel_err(torch, rb(y), xr)[:2])
    label = f"pencil r2c/c2r exact {n}^3 {grid[0]}x{grid[1]}"
    print(f"{label}: r2c vs torch.fft.rfftn max rel err={errs[0]:.3e} l2 rel "
          f"err={errs[1]:.3e}; c2r vs torch.fft.irfftn max rel err="
          f"{errs[2]:.3e} l2 rel err={errs[3]:.3e}; roundtrip max rel err="
          f"{errs[4]:.3e} l2 rel err={errs[5]:.3e}", flush=True)
    if not max(errs) <= TOL:
        fail(f"{label}: error over {TOL}")
    plans["pencil r2c/c2r exact"] = (rf, rb, "r2c")
    del xr, spec, y
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return plans


def stage_medians(torch, timing, plan, x, label, reps=10):
    """Median over ``reps`` runs of each stage's CUDA-event time."""
    plan(x)  # warm
    runs = []
    for _ in range(reps):
        timer = timing.StageTimer(x.device)
        y = plan(x, timer=timer)
        runs.append(timer.times())
        del y
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    print(f"{label} stages (CUDA events, median of {reps}, ms): " + " ".join(
        f"{k}={v * 1e3:.3f}" for k, v in med.items()), flush=True)


def check_complex128(torch, dfft, dev, n=256, ranks=SLAB_RANKS):
    """Phase 9a: complex128 through the cuda executor (its dft_matmul
    route) and the torch executor, a slab at n^3 on ``ranks`` loopback
    ranks, against torch.fft.fftn at the complex128 tier. Returns the
    plans the timing phase times."""
    shape = (n, n, n)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    x = torch.randn(shape, generator=g, device=dev, dtype=torch.complex128)
    ref = torch.fft.fftn(x)
    plans = {}
    for ex in ("cuda", "torch"):
        kw = dict(executor=ex, dtype=torch.complex128, device=dev)
        f = dfft.plan_dft_c2c_3d(shape, ranks, **kw)
        b = dfft.plan_dft_c2c_3d(shape, ranks, direction=dfft.BACKWARD, **kw)
        y = f(x)
        errs = rel_err(torch, y, ref)[:2] + rel_err(torch, b(y), x)[:2]
        label = f"c128 slab {n}^3 P={ranks} executor={ex}"
        print(f"{label}: forward vs torch.fft.fftn max rel err={errs[0]:.3e}"
              f" l2 rel err={errs[1]:.3e}; roundtrip max rel err="
              f"{errs[2]:.3e} l2 rel err={errs[3]:.3e}", flush=True)
        if not max(errs) <= TOL128:
            fail(f"{label}: error over {TOL128}")
        plans[label] = (f, b, x)
        del y
    return plans


# Each tier's band on the card (relative error against torch.fft.fft,
# max-norm and L2): its operands' unit roundoff sets the scale, fp32
# 2^-24 ~ 6e-8, TF32 2^-11 ~ 5e-4, bf16 2^-8 ~ 4e-3. The lower ends fail
# a tier whose products silently run at a finer precision (TF32 not
# taken, or the bf16 rounding lost), the upper ends one that runs
# coarser.
TIER_BANDS = {"highest": (0.0, TOL), "f32": (1e-5, 2e-3),
              "bf16": (1e-3, 1e-2)}


def check_matmul_tiers(torch, timing, dev, rows=4096, n=512):
    """Phase 9b: the matmul executor's three tiers on a [rows, n]
    complex64 batch against torch.fft.fft. On the card each tier's
    errors must fall in its band of TIER_BANDS and grow strictly from
    ``highest`` to ``f32`` to ``bf16``, so that each tier is seen to
    govern its products; on the CPU every tier is full fp32 and only
    ``highest``'s bound is held. Times each when ``timing`` is given."""
    from distributedfft_tpu_torch.ops.executors import MM_TIERS, get_executor

    x = seeded(torch, (rows, n), dev)
    ref = torch.fft.fft(x, dim=1)
    errs = {}
    for tier in MM_TIERS:
        ex = get_executor(f"matmul:{tier}")
        e = errs[tier] = rel_err(torch, ex(x, (1,), True), ref)[:2]
        ms = (f"{timing.cuda_time_ms(lambda: ex(x, (1,), True)):.4f}"
              if timing else "not measured")
        lo, hi = TIER_BANDS[tier] if dev.type == "cuda" else (0.0, TOL)
        print(f"matmul:{tier} [{rows},{n}] c64: vs torch.fft.fft max rel "
              f"err={e[0]:.3e} l2 rel err={e[1]:.3e} ms={ms} (band "
              f"{lo:g}..{hi:g})", flush=True)
        if tier == "highest" or dev.type == "cuda":
            if not (lo <= min(e) and max(e) <= hi):
                fail(f"matmul:{tier}: errors {e[0]:.3e}/{e[1]:.3e} outside "
                     f"its band {lo:g}..{hi:g}")
    if dev.type == "cuda":
        order = [errs[t] for t in ("highest", "f32", "bf16")]
        if not all(a[i] < b[i] for a, b in zip(order, order[1:])
                   for i in range(2)):
            fail(f"matmul tiers' errors are not strictly ordered highest < "
                 f"f32 < bf16: {order}")
    if timing:
        print(f"torch.fft.fft [{rows},{n}] c64 ms="
              f"{timing.cuda_time_ms(lambda: torch.fft.fft(x, dim=1)):.4f}",
              flush=True)


# ------------------------------------------------------------- transports

def overlap_cases(n, ks, ranks=SLAB_RANKS):
    """The kernel cases the overlap chunks add at n^3 for each K > 1: the
    slab on ``ranks`` ranks and the 2x2 pencil, each exchange's compute
    run on K chunks of its bystander axis."""
    out = []
    for k in sorted(k for k in set(ks) if k > 1):
        out += [("fft_axis0", True, (1, n, n * n // (ranks * k)),
                 f"K={k} slab and pencil fwd t3 chunk"),
                ("fft_axis0", False, (n // ranks, n, n // k),
                 f"K={k} slab bwd t3 chunk"),
                ("fft_axis0", True, (n // (2 * k), n, n // 2),
                 f"K={k} pencil fwd t1 chunk"),
                ("fft_axis0", False, (n // 2, n, n // (2 * k)),
                 f"K={k} pencil bwd t1 chunk"),
                ("fft_last", False, (n * n // (4 * k), n),
                 f"K={k} pencil bwd t3 chunk")]
    return out


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def transport_plans(dfft, shape, world, algorithm, k, **kw):
    f = dfft.plan_dft_c2c_3d(shape, world, algorithm=algorithm,
                             overlap_chunks=k, **kw)
    b = dfft.plan_dft_c2c_3d(shape, world, algorithm=algorithm,
                             overlap_chunks=k, direction=dfft.BACKWARD, **kw)
    return f, b


def check_transports(torch, dfft, dev, n=512, ks=(2, "auto")):
    """Phase 9a: every transport and K on the slab (and the flat ones on
    the pencil) against the alltoall, K = 1 plan, bit for bit. Returns
    the plans the timing phase times, by label."""
    from distributedfft_tpu_torch.parallel.exchange import (ALGORITHMS,
                                                            FLAT_ALGORITHMS)

    shape = (n, n, n)
    flat = dfft.make_world(SLAB_RANKS)
    hybrid = dfft.make_world(PENCIL_GRID, dfft.HYBRID_AXES)
    plans = {}
    x = seeded(torch, shape, dev)
    ref = torch.fft.fftn(x)
    base = transport_plans(dfft, shape, flat, "alltoall", 1, device=dev)
    y0 = base[0](x)
    r0 = base[1](y0)
    errs = rel_err(torch, y0, ref)[:2] + rel_err(torch, r0, x)[:2]
    del ref
    for alg in ALGORITHMS:
        world = hybrid if alg == "hierarchical" else flat
        for k in (1,) + tuple(ks):
            f, b = transport_plans(dfft, shape, world, alg, k, device=dev)
            if (alg, f.overlap_chunks) in plans:
                continue
            y = f(x)
            r = b(y0)
            sync(torch, dev)
            report = twin_report(torch, (y, r), (y0, r0))
            label = (f"slab c2c {n}^3 {alg} K={f.overlap_chunks} "
                     f"({'2x2 hybrid' if world.grid else 'P=4'} loopback)")
            print(f"{label}: vs the alltoall K=1 plan (forward, backward): "
                  f"{report}; forward vs torch.fft.fftn max rel err="
                  f"{errs[0]:.3e} l2 rel err={errs[1]:.3e}; roundtrip max "
                  f"rel err={errs[2]:.3e} l2 rel err={errs[3]:.3e}",
                  flush=True)
            if report != "bit-identical" or not max(errs) <= TOL:
                fail(f"{label}: {report}; errors {errs}")
            plans[(alg, f.overlap_chunks)] = (f, b, "slab")
            del y, r
    del r0

    # alltoallv on an uneven world against the dense plan
    uneven = (n - 2, n - 2, n)
    xu = seeded(torch, uneven, dev)
    dense = transport_plans(dfft, uneven, flat, "alltoall", 1,
                            device=dev)
    ragged = transport_plans(dfft, uneven, flat, "alltoallv", 1,
                             device=dev)
    yd = dense[0](xu)
    yr = ragged[0](xu)
    report = twin_report(torch, (yr, ragged[1](yd)), (yd, dense[1](yd)))
    err = rel_err(torch, yr, torch.fft.fftn(xu))[:2]
    print(f"slab c2c {uneven} alltoallv K=1 P=4: vs the dense plan "
          f"(forward, backward): {report}; forward vs torch.fft.fftn max "
          f"rel err={err[0]:.3e} l2 rel err={err[1]:.3e}", flush=True)
    if report != "bit-identical" or not max(err) <= TOL:
        fail(f"alltoallv {uneven}: {report}; errors {err}")
    del xu, yd, yr

    # the pencil under each flat transport and K
    pbase = transport_plans(dfft, shape, PENCIL_GRID, "alltoall", 1,
                            device=dev)
    py0 = pbase[0](x)
    pr0 = pbase[1](py0)
    for alg in FLAT_ALGORITHMS:
        for k in (1,) + tuple(ks):
            f, b = transport_plans(dfft, shape, PENCIL_GRID, alg, k,
                                   device=dev)
            if alg == "alltoall" and f.overlap_chunks == 1:
                plans[("pencil", alg, 1)] = (f, b, "pencil")
                continue
            report = twin_report(torch, (f(x), b(py0)), (py0, pr0))
            label = f"pencil c2c {n}^3 2x2 {alg} K={f.overlap_chunks}"
            print(f"{label}: vs the alltoall K=1 plan (forward, backward): "
                  f"{report}", flush=True)
            if report != "bit-identical":
                fail(f"{label}: {report}")
            plans[("pencil", alg, f.overlap_chunks)] = (f, b, "pencil")
    del py0, pr0

    # one split-wire fused plan per transport at K = 1, and the gate at K > 1
    for alg in ALGORITHMS:
        world = hybrid if alg == "hierarchical" else flat
        fused = transport_plans(dfft, shape, world, alg, 1,
                                wire_dtype="split", fuse=True, device=dev)
        twin = transport_plans(dfft, shape, world, alg, 1,
                               wire_dtype="split", device=dev)
        yf = fused[0](x)
        report = twin_report(torch, (yf, fused[1](yf)),
                             (twin[0](x), twin[1](yf)))
        sites = [(st["sender"], st["receiver"]) for st in
                 fused[0].graph.meta["fusion"]["sites"].values()]
        label = f"slab c2c {n}^3 {alg} split fused K=1"
        print(f"{label}: vs the unfused twin (forward, backward): {report};"
              f" fusion sites {sites}", flush=True)
        if report != "bit-identical" or sites != [SITE_ROUTES["c2c fwd"]]:
            fail(f"{label}: {report}, sites {sites}")
        k_plan = dfft.plan_dft_c2c_3d(shape, world, algorithm=alg,
                                      overlap_chunks=2, wire_dtype="split",
                                      fuse=True, device=dev)
        fusion = k_plan.graph.meta["fusion"]
        if fusion["active"] or fusion["reasons"] != ("overlap_k",):
            fail(f"{alg} split fused K={k_plan.overlap_chunks}: fusion "
                 f"{fusion}")
        plans[(alg, "split fused", 1)] = (*fused, "slab")
        del yf
    print(f"fused split plans at K>1: the fusion pass records overlap_k on "
          f"every transport", flush=True)
    del x, y0
    # the C2R split fused sender (kernel 4) over each flat transport
    spec = torch.fft.rfftn(seeded_real(torch, shape, dev))
    for alg in FLAT_ALGORITHMS:
        kw = dict(algorithm=alg, wire_dtype="split", device=dev)
        fused = dfft.plan_dft_c2r_3d(shape, flat, fuse=True, **kw)
        report = twin_report(torch, (fused(spec),),
                             (dfft.plan_dft_c2r_3d(shape, flat, **kw)(spec),))
        sites = [(st["sender"], st["receiver"]) for st in
                 fused.graph.meta["fusion"]["sites"].values()]
        label = f"c2r {n}^3 {alg} split fused K=1"
        print(f"{label}: vs the unfused twin: {report}; fusion sites "
              f"{sites}", flush=True)
        if report != "bit-identical" or sites != [SITE_ROUTES["c2r bwd"]]:
            fail(f"{label}: {report}, sites {sites}")
    del spec
    return plans


def check_staged(torch, dfft, timing, dev, n=512):
    """Phase 9b: the staged pipelines at n^3 against their plans (bit for
    bit; the slab C2C backward within the tier, its stages transforming X
    first as the JAX package's do) and each stage's CUDA-event time."""
    from distributedfft_tpu_torch.parallel import staged
    from distributedfft_tpu_torch.parallel.slab import build_slab_stages

    shape = (n, n, n)
    flat = dfft.make_world(SLAB_RANKS)
    hybrid = dfft.make_world(PENCIL_GRID, dfft.HYBRID_AXES)
    x = seeded(torch, shape, dev)
    xr = seeded_real(torch, shape, dev)
    cases = []
    for fwd in (True, False):
        d = dfft.FORWARD if fwd else dfft.BACKWARD
        tag = "fwd" if fwd else "bwd"
        cases += [
            (f"slab {tag}", build_slab_stages(flat, shape, forward=fwd)[0],
             dfft.plan_dft_c2c_3d(shape, flat, direction=d, device=dev), x,
             fwd),
            (f"pencil 2x2 {tag}", staged.build_pencil_stages(
                dfft.make_world(PENCIL_GRID), shape, forward=fwd)[0],
             dfft.plan_dft_c2c_3d(shape, PENCIL_GRID, direction=d,
                                  device=dev), x, True),
            (f"single {tag}", staged.build_single_stages(shape, forward=fwd),
             dfft.plan_dft_c2c_3d(shape, None, direction=d, device=dev), x,
             True)]
    for k in (1, 2):
        cases.append((f"hierarchical 2x2 K={k} fwd", build_slab_stages(
            hybrid, shape, algorithm="hierarchical", overlap_chunks=k)[0],
            dfft.plan_dft_c2c_3d(shape, hybrid, algorithm="hierarchical",
                                 overlap_chunks=k, device=dev), x, True))
    r2c = dfft.plan_dft_r2c_3d(shape, flat, device=dev)
    spec = r2c(xr)
    cases += [("slab r2c", staged.build_slab_rfft_stages(flat, shape)[0],
               r2c, xr, True),
              ("slab c2r", staged.build_slab_rfft_stages(
                  flat, shape, forward=False)[0],
               dfft.plan_dft_c2r_3d(shape, flat, device=dev), spec, True)]
    for label, stages, plan, inp, exact in cases:
        times, out = timing.time_staged(stages, inp, iters=5)
        want = plan(inp)
        sync(torch, dev)
        report = twin_report(torch, (out,), (want,))
        err = rel_err(torch, out, want)[0]
        print(f"staged {label} {n}^3: stages (CUDA events, best of 5, ms) "
              + " ".join(f"{k}={v * 1e3:.3f}" for k, v in times.times.items())
              + f" total={times.total * 1e3:.3f}; composed vs the plan: "
              f"{report}", flush=True)
        if (exact and report != "bit-identical") or not err <= TOL:
            fail(f"staged {label}: {report}, max rel err {err:.3e}")
        del out, want
    del x, xr, spec


def trace_breakdown(path):
    """Device time under each span of a torch.profiler chrome trace: each
    kernel, copy or fill is charged to the innermost ``t0..t3`` span (by
    :func:`stage_key`) whose host range holds its launch, found by the
    launch's correlation id (:func:`explain.join_device_ops`, the join
    ``dfft.explain`` reads its device samples with); and the device's
    idle share over the window from the start of the ``execute_*`` span
    to the end of the last device activity it launched. Returns (per
    span, per key, idle share, window us, busy us, device ops)."""
    from distributedfft_tpu_torch.explain import join_device_ops
    from distributedfft_tpu_torch.utils.trace import stage_key

    doc = json.load(open(path))
    ops, _ = join_device_ops(doc)
    execute = [e for e in doc["traceEvents"]
               if e.get("cat") == "user_annotation"
               and e["name"].startswith("execute_")]
    if not execute or not ops:
        fail(f"traced run: {len(execute)} execute spans, {len(ops)} device "
             f"operations in the trace")
    lo = execute[0]["ts"]
    hi_host = lo + execute[0]["dur"]
    per_span, per_key, busy_iv = {}, {}, []
    for op, t, span in ops:
        if t is None or not lo <= t <= hi_host:
            continue
        if span is not None:
            name = span["name"]
            per_span[name] = per_span.get(name, 0.0) + op["dur"]
            key = stage_key(name)
            per_key[key] = per_key.get(key, 0.0) + op["dur"]
        busy_iv.append((op["ts"], op["ts"] + op["dur"]))
    if not busy_iv:
        fail("traced run: no device operation launched inside the plan")
    start = min(lo, min(a for a, _ in busy_iv))
    end = max(b for _, b in busy_iv)
    busy, cur = 0.0, None
    for a, b in sorted(busy_iv):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += cur[1] - cur[0]
    window = end - start
    return per_span, per_key, 1.0 - busy / window, window, busy, len(busy_iv)


def traced_run(torch, dfft, dev, here, n=512):
    """Phase 9c: one slab C2C exact forward under torch.profiler with the
    trace spans on (a host-side log too); the device time under each
    span and the device's idle share over the traced window. Returns a
    Counter of the spans the trace session recorded (its text log is
    one of phase 20's merge inputs)."""
    from torch.profiler import ProfilerActivity, profile

    from distributedfft_tpu_torch.utils import trace

    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    shape = (n, n, n)
    x = seeded(torch, shape, dev)
    plan = dfft.plan_dft_c2c_3d(shape, dfft.make_world(SLAB_RANKS))
    plan(x)                                   # warm
    torch.cuda.synchronize()
    # a capture with no device time under a stage lost the profiler's
    # records of its kernels: it is taken again, LOST_TRIES captures in all
    for _ in range(LOST_TRIES):
        trace.init_tracing(os.path.join(out_dir, "chip_smoke_trace"))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                trace.capture_events() as spans:
            plan(x)
            torch.cuda.synchronize()
        log = trace.finalize_tracing()
        path = os.path.join(out_dir, "chip_smoke_slab_trace.json")
        prof.export_chrome_trace(path)
        per_span, per_key, idle, window, busy, nops = trace_breakdown(path)
        print(f"traced slab c2c {n}^3 P={SLAB_RANKS} forward (torch.profiler, "
              f"{nops} device operations; host spans in "
              f"{os.path.relpath(log, here)}): device time per stage (ms) "
              + " ".join(f"{k}={v / 1e3:.3f}"
                         for k, v in sorted(per_key.items()))
              + "; per span (ms) "
              + " ".join(f"{k}={v / 1e3:.3f}" for k, v in per_span.items())
              + f"; traced window {window / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms, idle share {idle:.4f}", flush=True)
        if {"t0", "t2", "t3"} <= set(per_key):
            break
    else:
        fail(f"traced run: device time under {sorted(per_key)} only, "
             f"{LOST_TRIES} captures")
    del x
    return Counter(e[0] for e in spans)


def time_transport_plans(torch, timing, dev, plans, n=512):
    """The transport, K, forward and backward ms (median of 10) and the
    stage medians of each transport plan."""
    x = seeded(torch, (n, n, n), dev)
    for key, (f, b, kind) in plans.items():
        y = f(x)
        t_f = timing.cuda_time_ms(lambda: f(x), iters=10)
        t_b = timing.cuda_time_ms(lambda: b(y), iters=10)
        grid = ("2x2" if f.world.grid else f"P={f.world.size}")
        label = (f"{kind} c2c {n}^3 {grid} {f.algorithm} K={f.overlap_chunks}"
                 f"{' split fused' if f.wire_dtype else ''}")
        print(f"{label}: transport={f.algorithm} K={f.overlap_chunks} "
              f"forward_ms={t_f:.3f} backward_ms={t_b:.3f}", flush=True)
        stage_medians(torch, timing, f, x, f"{label} forward", reps=5)
        stage_medians(torch, timing, b, y, f"{label} backward", reps=5)
        del y
    del x
    torch.cuda.empty_cache()


def batch_cases(n, ranks=SLAB_RANKS):
    """The kernel cases the batch = 2 plans add at n^3: the slab C2C and
    R2C/C2R on ``ranks`` ranks and the 2x2 pencil C2C, the batch folded
    into each kernel's own batch axis (the plane's planes, the strided
    kernel's ``lead``, the row kernel's rows)."""
    q, h, m = n // ranks, n // 2 + 1, n // 2
    return [
        ("fft2_last", True, (2 * q, n, n), "batch=2 slab fwd t0"),
        ("fft_axis0", True, (2, n, q * n), "batch=2 slab and pencil fwd t3"),
        ("fft_axis0", False, (2, n, q * n),
         "batch=2 slab and pencil bwd t0"),
        ("fft_last", False, (2 * q * n, n),
         "batch=2 slab bwd t0, pencil bwd t3"),
        ("fft_axis0", False, (2 * q, n, n), "batch=2 slab bwd t3"),
        ("fft_last", True, (2 * m * m, n), "batch=2 pencil fwd t0"),
        ("fft_axis0", True, (2 * m, n, m), "batch=2 pencil fwd t1"),
        ("fft_axis0", False, (2 * m, n, m), "batch=2 pencil bwd t1"),
        ("fft_last", True, (2 * q * n, m), "batch=2 slab r2c t0"),
        ("fft_last", False, (2 * q * n, m), "batch=2 slab c2r t0"),
        ("fft_axis0", True, (2 * q, n, h), "batch=2 slab r2c t0 y"),
        ("fft_axis0", False, (2 * q, n, h), "batch=2 slab c2r t0 y"),
        ("fft_axis0", True, (2, n, q * h), "batch=2 slab r2c t3"),
        ("fft_axis0", False, (2, n, q * h), "batch=2 slab c2r t3"),
    ]


def brick_boxes(dfft, shape, ranks=SLAB_RANKS, orders=False):
    """The ``speed3d.py -bricks`` layouts of ``shape``: uneven (ceil)
    Z-slabs in, X-pencils on the min-surface grid out; ``orders`` stores
    the in-bricks in shuffled axis orders."""
    geo = dfft.geometry
    w = geo.world_box(shape)
    ins = geo.make_slabs(w, ranks, axis=2, rule=geo.ceil_splits)
    outs = geo.make_pencils(w, geo.pencil_grid_min_surface(shape, ranks), 0)
    if orders:
        ins = [b.with_order(o) for b, o in zip(
            ins, [(2, 0, 1), (0, 1, 2), (1, 2, 0), (2, 1, 0)])]
    return ins, outs


def check_bricks(torch, dfft, dev, n=512):
    """Phase 10a: the brick-in/brick-out, batched, layout and r2c_axis
    plans at n^3 on a 4-rank loopback world, each against its inner,
    unbatched or default plan bit for bit (the absorbed layout, whose
    chain transforms in another order, within the tier of torch.fft).
    Returns the plans the timing phase times."""
    shape = (n, n, n)
    world = dfft.make_world(SLAB_RANKS)
    out = {}
    x = seeded(torch, shape, dev)
    inner_f = dfft.plan_dft_c2c_3d(shape, world, device=dev)
    inner_b = dfft.plan_dft_c2c_3d(shape, world, direction=dfft.BACKWARD,
                                   device=dev)
    y0 = inner_f(x)
    r0 = inner_b(y0)
    for alg, orders in (("alltoall", False), ("alltoallv", False),
                        ("alltoall", True)):
        ins, outs = brick_boxes(dfft, shape, orders=orders)
        f = dfft.plan_brick_dft_c2c_3d(shape, world, ins, outs,
                                       algorithm=alg, device=dev)
        b = dfft.plan_brick_dft_c2c_3d(shape, world, outs, ins,
                                       algorithm=alg,
                                       direction=dfft.BACKWARD, device=dev)
        stack = dfft.scatter_bricks(x, ins)
        ys = f(stack)
        rs = b(dfft.scatter_bricks(y0, outs))
        got = (dfft.gather_bricks(ys, outs), dfft.gather_bricks(rs, ins))
        report = twin_report(torch, got, (y0, r0))
        edges = [(e.algorithm, e.payload_elems, e.wire_elems)
                 for e in f.brick_edges]
        label = (f"brick c2c {n}^3 P={SLAB_RANKS} {alg}"
                 f"{' ordered' if orders else ''}")
        print(f"{label}: Z-slabs {f.in_shape} in, X-pencils {f.out_shape} "
              f"out; edges (transport, payload, wire elems) {edges}; "
              f"gathered vs the inner slab plan (forward, backward): "
              f"{report}", flush=True)
        if report != "bit-identical":
            fail(f"{label}: {report}")
        if not orders:
            out[f"brick c2c {alg}"] = (f, b, stack, f(stack))
        del ys, rs, got
    del r0
    torch.cuda.empty_cache()

    # R2C / C2R brick plans against the inner real plan
    xr = seeded_real(torch, shape, dev)
    rf = dfft.plan_dft_r2c_3d(shape, world, device=dev)
    rb = dfft.plan_dft_c2r_3d(shape, world, device=dev)
    h0 = rf(xr)
    g0 = rb(h0)
    ins, _ = brick_boxes(dfft, shape)
    _, couts = brick_boxes(dfft, (n, n, n // 2 + 1))
    bf = dfft.plan_brick_dft_r2c_3d(shape, world, ins, couts, device=dev)
    bb = dfft.plan_brick_dft_c2r_3d(shape, world, couts, ins, device=dev)
    got = (dfft.gather_bricks(bf(dfft.scatter_bricks(xr, ins)), couts),
           dfft.gather_bricks(bb(dfft.scatter_bricks(h0, couts)), ins))
    report = twin_report(torch, got, (h0, g0))
    print(f"brick r2c/c2r {n}^3 P={SLAB_RANKS}: vs the inner real plan "
          f"(forward, backward): {report}", flush=True)
    if report != "bit-identical":
        fail(f"brick r2c/c2r: {report}")
    del got, g0

    # r2c_axis = 0: the canonical plan on the transposed input
    a0 = dfft.plan_dft_r2c_3d(shape, world, r2c_axis=0, device=dev)
    xt = xr.permute(2, 1, 0).contiguous()
    report = twin_report(torch, (a0(xr),),
                         (rf(xt).permute(2, 1, 0).contiguous(),))
    print(f"r2c_axis=0 {n}^3 P={SLAB_RANKS}: vs the canonical plan on the "
          f"transposed input: {report}", flush=True)
    if report != "bit-identical":
        fail(f"r2c_axis=0: {report}")
    del xt, h0

    # batch = 2 against two unbatched calls
    x1 = seeded(torch, shape, dev, SEED + 1)
    xb = torch.stack([x, x1])
    for label, grid, kind in (("slab c2c", world, "c2c"),
                              ("pencil c2c", PENCIL_GRID, "c2c"),
                              ("slab r2c", world, "r2c")):
        planner = (dfft.plan_dft_c2c_3d if kind == "c2c"
                   else dfft.plan_dft_r2c_3d)
        fb = planner(shape, grid, batch=2, device=dev)
        bb_ = planner(shape, grid, batch=2, direction=dfft.BACKWARD,
                      device=dev)
        f1 = planner(shape, grid, device=dev)
        b1 = planner(shape, grid, direction=dfft.BACKWARD, device=dev)
        inp = xb if kind == "c2c" else xb.real.contiguous()
        yb = fb(inp)
        rb_ = bb_(yb)
        ys = torch.stack([f1(inp[0]), f1(inp[1])])
        rs = torch.stack([b1(yb[0]), b1(yb[1])])
        report = twin_report(torch, (yb, rb_), (ys, rs))
        print(f"{label} {n}^3 batch=2: vs two unbatched calls (forward, "
              f"backward): {report}", flush=True)
        if report != "bit-identical":
            fail(f"{label} batch=2: {report}")
        out[f"{label} batch=2"] = (fb, bb_, f1, b1, inp)
        del yb, rb_, ys, rs
    del xb, x1

    # layouts: absorbed (Y-slabs in) and edge-wrapped (a 2x2 world's
    # combined axis in and out) against the default-layout plans
    ref = torch.fft.fftn(x)
    ab = dfft.plan_dft_c2c_3d(shape, world, device=dev,
                              in_spec=dfft.Spec(None, "slab", None))
    errs = rel_err(torch, ab(x), ref)[:2]
    print(f"absorbed in_spec {ab.in_spec} {n}^3 P={SLAB_RANKS}: slab axes "
          f"{ab.logic.slab_axes}; vs torch.fft.fftn max rel err="
          f"{errs[0]:.3e} l2 rel err={errs[1]:.3e}", flush=True)
    if not ab.logic.in_absorbed or not max(errs) <= TOL:
        fail(f"absorbed in_spec: absorbed {ab.logic.in_absorbed}, {errs}")
    combined = ("row", "col")
    wr = dfft.plan_dft_c2c_3d(shape, PENCIL_GRID, device=dev,
                              in_spec=dfft.Spec(combined, None, None),
                              out_spec=dfft.Spec(None, combined, None))
    default = dfft.plan_dft_c2c_3d(shape, PENCIL_GRID, device=dev)
    report = twin_report(torch, (wr(x),), (default(x),))
    print(f"edge-wrapped in_spec {wr.in_spec} out_spec {wr.out_spec} "
          f"{n}^3 2x2: vs the default-layout pencil plan: {report}",
          flush=True)
    if wr.logic.in_absorbed or wr.logic.out_absorbed or \
            report != "bit-identical":
        fail(f"edge-wrapped layouts: {report}")
    out["layouts"] = (ab, wr, default)
    del ref, x, y0
    return out


def peak_gib(torch, fn) -> float:
    """Peak device memory (GiB) while ``fn`` runs, from a reset, with
    no plan kept alive by the plan cache but those ``fn`` holds."""
    sys.modules["distributedfft_tpu_torch"].clear_plan_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = fn()
    torch.cuda.synchronize()
    del r
    return torch.cuda.max_memory_allocated() / 2**30


def time_bricks(torch, dfft, timing, dev, plans, n=512):
    """Phase 10b: the brick plans' forward and backward ms beside their
    inner slab plan's (median of 10), the batch = 2 plans against two
    unbatched calls, the peak device memory of each, and donate against
    not."""
    shape = (n, n, n)
    world = dfft.make_world(SLAB_RANKS)
    x = seeded(torch, shape, dev)
    for alg in ("alltoall", "alltoallv"):
        # the inner chain runs the brick plan's transport
        inner_f = dfft.plan_dft_c2c_3d(shape, world, algorithm=alg,
                                       device=dev)
        inner_b = dfft.plan_dft_c2c_3d(shape, world, algorithm=alg,
                                       direction=dfft.BACKWARD, device=dev)
        y = inner_f(x)
        t_if = timing.cuda_time_ms(lambda: inner_f(x), iters=10)
        t_ib = timing.cuda_time_ms(lambda: inner_b(y), iters=10)
        print(f"inner slab c2c {n}^3 P={SLAB_RANKS} {alg}: forward_ms="
              f"{t_if:.3f} backward_ms={t_ib:.3f}", flush=True)
        del y
        f, b, stack, ystack = plans[f"brick c2c {alg}"]
        t_f = timing.cuda_time_ms(lambda: f(stack), iters=10)
        t_b = timing.cuda_time_ms(lambda: b(ystack), iters=10)
        mem = peak_gib(torch, lambda: f(stack))
        print(f"brick c2c {n}^3 P={SLAB_RANKS} edges {alg} "
              f"({f.brick_edges[0].algorithm}): forward_ms={t_f:.3f} "
              f"backward_ms={t_b:.3f}; edges cost forward "
              f"{t_f - t_if:.3f} backward {t_b - t_ib:.3f} ms over the "
              f"inner plan; peak {mem:.2f} GiB", flush=True)
    plans.pop("brick c2c alltoall")
    plans.pop("brick c2c alltoallv")
    del stack, ystack
    torch.cuda.empty_cache()
    for label in ("slab c2c batch=2", "pencil c2c batch=2",
                  "slab r2c batch=2"):
        fb, bb, f1, b1, inp = plans.pop(label)
        yb = fb(inp)
        t_bf = timing.cuda_time_ms(lambda: fb(inp), iters=10)
        t_bb = timing.cuda_time_ms(lambda: bb(yb), iters=10)
        t_2f = timing.cuda_time_ms(lambda: (f1(inp[0]), f1(inp[1])),
                                   iters=10)
        t_2b = timing.cuda_time_ms(lambda: (b1(yb[0]), b1(yb[1])),
                                   iters=10)
        mem = peak_gib(torch, lambda: fb(inp))
        print(f"{label} {n}^3: forward_ms={t_bf:.3f} (two unbatched calls "
              f"{t_2f:.3f}, ratio {t_bf / t_2f:.3f}) backward_ms={t_bb:.3f}"
              f" (two unbatched {t_2b:.3f}, ratio {t_bb / t_2b:.3f}); peak "
              f"{mem:.2f} GiB", flush=True)
        del yb, inp
        torch.cuda.empty_cache()
    ab, wr, default = plans.pop("layouts")
    for label, p in (("absorbed layout", ab), ("edge-wrapped layouts", wr),
                     ("default pencil", default)):
        t = timing.cuda_time_ms(lambda: p(x), iters=10)
        print(f"{label} {n}^3: forward_ms={t:.3f}; peak "
              f"{peak_gib(torch, lambda: p(x)):.2f} GiB", flush=True)
    for label, grid in (("single", None), (f"slab P={SLAB_RANKS}", world)):
        keep = dfft.plan_dft_c2c_3d(shape, grid, device=dev)
        give = dfft.plan_dft_c2c_3d(shape, grid, device=dev, donate=True)
        want = keep(x)
        xd = x.clone()
        report = twin_report(torch, (give(xd),), (want,))
        del want
        torch.cuda.empty_cache()
        xd.copy_(x)
        m_keep = peak_gib(torch, lambda: keep(xd))
        m_give = peak_gib(torch, lambda: give(xd))
        t_keep = timing.cuda_time_ms(lambda: keep(xd), iters=5)
        t_give = timing.cuda_time_ms(lambda: give(xd), iters=5)
        print(f"donate {label} c2c {n}^3: vs donate=False {report}; peak "
              f"{m_give:.2f} GiB against {m_keep:.2f} GiB; forward_ms="
              f"{t_give:.3f} against {t_keep:.3f}", flush=True)
        if report != "bit-identical":
            fail(f"donate {label}: {report}")
        del xd
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()


# The launch shapes the operator path adds at n^3 (the rest are cases of
# the paths above): the inverse X FFT of t_mid on a K = 2 chunk (the
# forward one is the transform's own K = 2 t3 chunk), and the slab
# convolution at c^3 (its plan makes the kernel's spectrum on the host).
def op_cases(n, c=256, ranks=SLAB_RANKS):
    q = c // ranks
    return [("fft_axis0", False, (1, n, n * n // (ranks * 2)),
             "K=2 op t_mid inverse chunk"),
            ("fft2_last", True, (q, c, c), f"op convolve {c}^3 t0"),
            ("fft_axis0", True, (1, c, q * c), f"op convolve {c}^3 t_mid"),
            ("fft_axis0", False, (1, c, q * c), f"op convolve {c}^3 t_mid"),
            ("fft_axis0", False, (q, c, c), f"op convolve {c}^3 t3_ifft_y"),
            ("fft_last", False, (q * c, c), f"op convolve {c}^3 t3_ifft_z")]


#: The fused sites' (sender, receiver) routes of the split op plans (JAX's,
#: tests/test_torch_operators.py): the slab's outbound sender is t0 and
#: t1_pack (multi_axis), its t_mid a factory receiver, its return sender
#: t1_pack alone (ops); the pencil's senders after a fused node are empty.
OP_SITE_ROUTES = {
    "slab": [("multi_axis", "factory"), ("ops", "kernel")],
    "pencil": [("kernel", "kernel"), ("encode_only", "factory"),
               ("encode_only", "kernel"), ("encode_only", "kernel")]}


# A split-wire op plan against the exact one: each leg quantizes with a
# step of 2^-15 of its tile's largest value, and a solve amplifies the
# noise of its smallest wavenumbers (the Poisson slab at 512^3: 3.3e-3 on
# an H100); a codec fault shows as an O(1) error.
OP_WIRE_BOUND = 1e-2


def op_rounds(torch, dex, plan, x):
    """Collective rounds of one plan call (``exchange.ROUNDS``)."""
    before = sum(dex.ROUNDS.values())
    y = plan(x)
    del y
    return sum(dex.ROUNDS.values()) - before


def check_operators(torch, dfft, dev, card, n=512, c=256):
    """Phase 11a: the spectral-operator plans at n^3. The Poisson slab (P
    = 4), gradient(1) slab, Gaussian 2x2 pencil and single-device Poisson
    against ifftn(m * fftn(x)) in complex128 with torch.fft on the card;
    every transport, K = 2, the hierarchical 2x2 hybrid world and batch =
    2 against the alltoall, K = 1, unbatched twin bit for bit, with the
    collective rounds of one call; the split fused op plans against their
    unfused twins bit for bit, on JAX's fusion routes; a convolution at
    c^3 against the shift it is. Returns the plans the timing phase
    times."""
    from distributedfft_tpu_torch import operators as dop
    from distributedfft_tpu_torch.parallel import exchange as dex

    shape = (n, n, n)
    flat = dfft.make_world(SLAB_RANKS)
    hybrid = dfft.make_world(PENCIL_GRID, dfft.HYBRID_AXES)
    kw = dict(device=dev)
    x = seeded(torch, shape, dev)
    big = torch.fft.fftn(x.to(torch.complex128))
    ops = {"poisson": dop.poisson(), "gradient1": dop.gradient(1),
           "gaussian": dop.gaussian(0.01)}
    plans = {}
    for label, world, name in (("slab P=4", flat, "poisson"),
                               ("slab P=4", flat, "gradient1"),
                               ("pencil 2x2", PENCIL_GRID, "gaussian"),
                               ("single", None, "poisson")):
        plan = dop.plan_spectral_op(shape, world, op=ops[name], **kw)
        y = plan(x)
        sync(torch, dev)
        if tuple(y.shape) != shape or y.dtype != torch.complex64 or not bool(
                torch.isfinite(torch.view_as_real(y)).all()):
            fail(f"op {name} {label}: output {y.dtype} {tuple(y.shape)}, "
                 f"not finite complex64 of {shape}")
        m = dop.multiplier_grid(ops[name], shape, torch.complex128, **kw)
        ref = torch.fft.ifftn(m * big)
        del m
        err = rel_err(torch, y, ref)[:2]
        del ref, y
        print(f"op {name} {n}^3 {label}: vs ifftn(m * fftn(x)) in complex128"
              f" (torch.fft) max rel err={err[0]:.3e} l2 rel err={err[1]:.3e}"
              f" [{card}]", flush=True)
        if not max(err) <= TOL:
            fail(f"op {name} {label}: error over {TOL}")
        plans[f"{name} {label}"] = plan
    del big
    torch.cuda.empty_cache()

    # the twins: each transport, K = 2, the hybrid world and batch = 2
    # against the alltoall, K = 1, unbatched plan, bit for bit
    x2 = seeded(torch, shape, dev, SEED + 1)
    for kind, world, name, base_key in (
            ("slab", flat, "poisson", "poisson slab P=4"),
            ("pencil", PENCIL_GRID, "gaussian", "gaussian pencil 2x2")):
        base = plans[base_key]
        y0, y1 = base(x), base(x2)
        rounds = op_rounds(torch, dex, base, x)
        want_rounds = {"slab": 2, "pencil": 4}[kind]
        print(f"op {name} {kind} alltoall K=1: {rounds} collective rounds "
              f"per call (expected {want_rounds})", flush=True)
        if rounds != want_rounds:
            fail(f"op {name} {kind}: {rounds} rounds, expected {want_rounds}")
        twins = [("K=2", dict(overlap_chunks=2), 2 * want_rounds)]
        if kind == "slab":
            twins = [("alltoallv", dict(algorithm="alltoallv"), 2),
                     ("ppermute", dict(algorithm="ppermute"),
                      2 * (SLAB_RANKS - 1)),
                     ("hierarchical 2x2 hybrid",
                      dict(algorithm="hierarchical"), 4)] + twins
        for label, tkw, want in twins:
            w = hybrid if "hierarchical" in label else world
            plan = dop.plan_spectral_op(shape, w, op=ops[name], **tkw, **kw)
            report = twin_report(torch, (plan(x),), (y0,))
            rounds = op_rounds(torch, dex, plan, x)
            print(f"op {name} {kind} {label}: vs the alltoall K=1 plan "
                  f"{report}; {rounds} collective rounds per call (expected "
                  f"{want})", flush=True)
            if report != "bit-identical" or rounds != want:
                fail(f"op {name} {kind} {label}: {report}, {rounds} rounds")
        xb = torch.stack([x, x2])
        plan = dop.plan_spectral_op(shape, world, op=ops[name], batch=2, **kw)
        yb = plan(xb)
        report = twin_report(torch, (yb[0], yb[1]), (y0, y1))
        rounds = op_rounds(torch, dex, plan, xb)
        print(f"op {name} {kind} batch=2: vs two unbatched calls {report}; "
              f"{rounds} collective rounds per call", flush=True)
        if report != "bit-identical" or rounds != want_rounds:
            fail(f"op {name} {kind} batch=2: {report}, {rounds} rounds")
        plans[f"{name} {kind} batch=2"] = (plan, xb)
        del yb, y0, y1, xb
        torch.cuda.empty_cache()
    del x2

    # the split codec fused against its unfused twin
    for kind, world, name, exact in (
            ("slab", flat, "poisson", "poisson slab P=4"),
            ("pencil", PENCIL_GRID, "gaussian", "gaussian pencil 2x2")):
        fused = dop.plan_spectral_op(shape, world, op=ops[name],
                                     wire_dtype="split", fuse=True, **kw)
        twin = dop.plan_spectral_op(shape, world, op=ops[name],
                                    wire_dtype="split", **kw)
        yf = fused(x)
        report = twin_report(torch, (yf,), (twin(x),))
        err = rel_err(torch, yf, plans[exact](x))[:2]
        sites = list(fused.graph.meta["fusion"]["sites"].values())
        routes = [(st["sender"], st["receiver"]) for st in sites]
        label = f"op {name} {kind} split fused {n}^3"
        print(f"{label}: vs the unfused twin {report}; vs the exact op plan "
              f"max rel err={err[0]:.3e} l2 rel err={err[1]:.3e}; fusion "
              f"sites {sites}", flush=True)
        if report != "bit-identical" or routes != OP_SITE_ROUTES[kind]:
            fail(f"{label}: {report}, sites {routes}")
        if not max(err) <= OP_WIRE_BOUND:
            fail(f"{label}: error over {OP_WIRE_BOUND}")
        plans[f"{name} {kind} split fused"] = fused
        plans[f"{name} {kind} split unfused"] = twin
        del yf

    # a convolution at c^3: the kernel's spectrum made on the host at plan
    # time, held once on the card for the four ranks
    xc = seeded(torch, (c, c, c), dev)
    kernel = torch.zeros((c, c, c), dtype=torch.float64)
    kernel[3, 5, 7] = 1.0
    t0 = time.perf_counter()
    plan = dop.plan_spectral_op((c, c, c), flat, op=dop.convolve(kernel),
                                **kw)
    made = time.perf_counter() - t0
    err = rel_err(torch, plan(xc), torch.roll(xc, (3, 5, 7), (0, 1, 2)))[:2]
    print(f"op convolve {c}^3 slab P=4 (delta at (3, 5, 7)): vs the shifted "
          f"input max rel err={err[0]:.3e} l2 rel err={err[1]:.3e}; plan "
          f"made in {made:.2f} s (host fftn of the kernel)", flush=True)
    if not max(err) <= TOL:
        fail(f"op convolve {c}^3: error over {TOL}")
    del xc, x, plan
    torch.cuda.empty_cache()
    return plans


def span_device_us(path, name):
    """(device us, spans): the device time of every operation launched
    inside a span called ``name`` of a torch.profiler chrome trace (the
    join of :func:`explain.join_device_ops`)."""
    from distributedfft_tpu_torch.explain import join_device_ops

    ops, spans = join_device_ops(json.load(open(path)),
                                 span_key=lambda n: n if n == name else None)
    return (sum(op["dur"] for op, _, span in ops if span is not None),
            len(spans))


def check_op_staged_and_traced(torch, dfft, timing, dev, here, card, plans,
                               n=512):
    """Phase 11b: the staged op pipeline (t0_fft_yz, t2_exchange_out,
    t_mid, t2_exchange_back, t3_ifft_yz) against the fused Poisson slab
    plan (within the tier: its t3 runs Y and Z as one plane pass), with
    each stage's CUDA-event time; then one traced call of that plan: the
    device time under each stage key, under ``t_mid_pointwise``, and the
    device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from distributedfft_tpu_torch.parallel.staged import build_slab_op_stages
    from distributedfft_tpu_torch.utils import trace

    shape = (n, n, n)
    plan = plans["poisson slab P=4"]
    x = seeded(torch, shape, dev)
    stages, _ = build_slab_op_stages(plan.world, shape, plan.multiplier)
    times, out = timing.time_staged(stages, x, iters=5)
    err = rel_err(torch, out, plan(x))[:2]
    print(f"staged op poisson {n}^3 P={SLAB_RANKS}: stages (CUDA events, "
          f"best of 5, ms) " + " ".join(
              f"{k}={v * 1e3:.3f}" for k, v in times.times.items())
          + f" total={times.total * 1e3:.3f}; composed vs the fused plan max "
          f"rel err={err[0]:.3e} l2 rel err={err[1]:.3e} [{card}]",
          flush=True)
    if not max(err) <= TOL:
        fail(f"staged op pipeline: error over {TOL}")
    del out

    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    plan(x)                                   # warm
    torch.cuda.synchronize()
    for _ in range(LOST_TRIES):     # as traced_run: lost records, again
        trace.init_tracing(os.path.join(out_dir, "chip_smoke_op_trace"))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            plan(x)
            torch.cuda.synchronize()
        trace.finalize_tracing()
        path = os.path.join(out_dir, "chip_smoke_op_trace.json")
        prof.export_chrome_trace(path)
        per_span, per_key, idle, window, busy, nops = trace_breakdown(path)
        pointwise, nspans = span_device_us(path, "t_mid_pointwise")
        print(f"traced op poisson {n}^3 P={SLAB_RANKS} (torch.profiler, "
              f"{nops} device operations): device time per stage (ms) "
              + " ".join(f"{k}={v / 1e3:.3f}"
                         for k, v in sorted(per_key.items()))
              + f"; t_mid_pointwise {pointwise / 1e3:.3f} ms over {nspans} "
              f"spans; traced window {window / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms, idle share {idle:.4f} [{card}]",
              flush=True)
        if {"t0", "t2", "t_mid", "t3"} <= set(per_key) and pointwise > 0:
            break
    else:
        fail(f"traced op run: device time under {sorted(per_key)}, "
             f"t_mid_pointwise {pointwise}, {LOST_TRIES} captures")
    del x


def time_operators(torch, dfft, timing, dev, card, plans, n=512):
    """Phase 11c: each op plan's ms per call (CUDA events, median of 10)
    and its stage medians (the two t2 legs summed) beside the unfused
    pair (forward plan, the multiply by ``multiplier_grid``, backward
    plan) and each part of it, with the peak device memory of each; the
    split fused op plans against their unfused twins; batch = 2 against
    two calls."""
    from distributedfft_tpu_torch import operators as dop
    from distributedfft_tpu_torch.stagegraph import apply_multiplier

    shape = (n, n, n)
    x = seeded(torch, shape, dev)
    for key in ("poisson slab P=4", "gaussian pencil 2x2"):
        plan = plans.pop(key)
        world = plan.world
        fwd = dfft.plan_dft_c2c_3d(shape, world, device=dev)
        bwd = dfft.plan_dft_c2c_3d(shape, world, direction=dfft.BACKWARD,
                                   device=dev)
        m = dop.multiplier_grid(plan.op_spec, shape, torch.complex64,
                                device=dev)
        y = fwd(x)
        t_op = timing.cuda_time_ms(lambda: plan(x), iters=10)
        t_pair = timing.cuda_time_ms(
            lambda: bwd(apply_multiplier(fwd(x), m)), iters=10)
        t_f = timing.cuda_time_ms(lambda: fwd(x), iters=10)
        t_m = timing.cuda_time_ms(lambda: apply_multiplier(y, m), iters=10)
        t_b = timing.cuda_time_ms(lambda: bwd(y), iters=10)
        mem_op = peak_gib(torch, lambda: plan(x))
        mem_pair = peak_gib(torch, lambda: bwd(apply_multiplier(fwd(x), m)))
        print(f"op {key} {n}^3: op plan ms={t_op:.3f} (peak {mem_op:.2f} GiB)"
              f"; unfused pair ms={t_pair:.3f} (forward {t_f:.3f} + multiply "
              f"{t_m:.3f} + backward {t_b:.3f}; peak {mem_pair:.2f} GiB); "
              f"ratio {t_op / t_pair:.3f} [{card}]", flush=True)
        stage_medians(torch, timing, plan, x, f"op {key} {n}^3")
        del y, m
        torch.cuda.empty_cache()
    for kind in ("slab", "pencil"):
        name = "poisson" if kind == "slab" else "gaussian"
        fused = plans.pop(f"{name} {kind} split fused")
        twin = plans.pop(f"{name} {kind} split unfused")
        t_fu = timing.cuda_time_ms(lambda: fused(x), iters=10)
        t_un = timing.cuda_time_ms(lambda: twin(x), iters=10)
        print(f"op {name} {kind} split {n}^3: fused ms={t_fu:.3f} unfused "
              f"ms={t_un:.3f} [{card}]", flush=True)
        stage_medians(torch, timing, fused, x,
                      f"op {name} {kind} split fused {n}^3", reps=5)
        plan, xb = plans.pop(f"{name} {kind} batch=2")
        one = dop.plan_spectral_op(shape, plan.world, op=plan.op_spec,
                                   device=dev)
        t_b2 = timing.cuda_time_ms(lambda: plan(xb), iters=10)
        t_2 = timing.cuda_time_ms(lambda: (one(xb[0]), one(xb[1])), iters=10)
        print(f"op {name} {kind} batch=2 {n}^3: ms={t_b2:.3f} (two unbatched "
              f"calls {t_2:.3f}, ratio {t_b2 / t_2:.3f}); peak "
              f"{peak_gib(torch, lambda: plan(xb)):.2f} GiB [{card}]",
              flush=True)
        del xb
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()


# ------------------------------------------------------- long 1D paths

# The two-level phase's (batch, n): the reference's largest 1D size (5^11
# = 3125 x 15625, its row stage on the two-pass radix route), 2^24 (4096
# x 4096) and a batched 2^20 (1024 x 1024).
TWO_LEVEL = ((1, 5 ** 11), (1, 1 << 24), (64, 1 << 20))
# The distributed 1D plan's lengths on SLAB_RANKS loopback ranks: 2^28
# (A = B = 16384) and 3 * 2^26 (12288 x 16384), both stages on the
# two-pass radix route.
DIST1D = (1 << 28, 3 << 26)
# ------------------------------- lengths with a prime factor over 17

# The paths at a length with a prime factor over 17: the slab at [608,
# 512, 512] on SLAB_RANKS and the pencil at [512, 512, 608] on
# PENCIL_GRID (608 = 2^5 * 19, plan 8.4.19 on the radix route's generic
# prime stage).
GENERIC_PATHS = (((608, 512, 512), SLAB_RANKS, "slab"),
                 ((512, 512, 608), PENCIL_GRID, "pencil"))
# Kernel cases of the row and strided kernels' generic prime stage: the
# two paths' n = 608; 361 = 19 * 19 (two generic stages in a row); 9728
# = 19 * 512 past 8192 (split 76 * 128, 76 = 4 * 19 on the generic
# stage); two-pass lengths with a one-stage factor, 8194 = 34 * 241 (the
# second pass) and 12482 = 79 * 158 (the first); and the slab C2C at
# 608^3 on 4 ranks (GENERIC_FUSED), its t0 planes [152, 608, 608] on the
# plane kernel's radix route (the generic stage on both axes), the
# plane's inverse held beside them.
GENERIC_CASES = [
    ("fft_axis0", True, (1, 608, 65536), "slab [608,512,512] fwd t3"),
    ("fft_axis0", False, (1, 608, 65536), "slab [608,512,512] bwd t0"),
    ("fft_last", True, (65536, 608), "pencil [512,512,608] fwd t0"),
    ("fft_last", False, (65536, 608), "pencil [512,512,608] bwd t3"),
    ("fft_last", True, (65536, 361), "361 = 19 * 19"),
    ("fft_axis0", True, (1, 9728, 512), "9728 = 19 * 512"),
    ("fft_last", True, (512, 9728), "9728 = 19 * 512"),
    ("fft_axis0", True, (1, 8194, 512), "8194 = 34 * 241"),
    ("fft_last", True, (512, 8194), "8194 = 34 * 241"),
    ("fft_last", True, (512, 12482), "12482 = 79 * 158"),
    ("fft2_last", True, (152, 608, 608), "slab 608^3 fwd t0"),
    ("fft2_last", False, (152, 608, 608), "the plane's inverse (held)"),
    ("fft_axis0", True, (1, 608, 92416), "slab 608^3 fwd t3"),
    ("fft_axis0", False, (1, 608, 92416), "slab 608^3 bwd t0"),
    ("fft_last", False, (92416, 608), "slab 608^3 bwd t0"),
    ("fft_axis0", False, (152, 608, 608), "slab 608^3 bwd t3"),
]


def generic_path_cases(ranks=SLAB_RANKS, grid=PENCIL_GRID):
    """The kernel cases of GENERIC_PATHS at n = 512 (the 608-long ones are
    GENERIC_CASES): the slab's t0 planes and backward Z rows and Y
    columns, the pencil's Y and X columns."""
    q = 608 // ranks
    rows, cols = grid
    y_cols = 608 // cols          # the pencil's Z split over its columns
    x_cols = (512 // rows) * y_cols
    cases = [("fft2_last", True, (q, 512, 512), "slab [608,512,512] t0"),
             ("fft_last", False, (608 * 512 // ranks, 512),
              "slab [608,512,512] bwd t0"),
             ("fft_axis0", False, (q, 512, 512), "slab [608,512,512] bwd t3")]
    for fwd in (True, False):
        cases += [("fft_axis0", fwd, (512 // rows, 512, y_cols),
                   "pencil [512,512,608] t1"),
                  ("fft_axis0", fwd, (1, 512, x_cols),
                   "pencil [512,512,608] t3 / bwd t0")]
    return cases


def check_generic_paths(torch, dfft, dev):
    """The GENERIC_PATHS plans: forward against torch.fft.fftn, backward
    against torch.fft.ifftn of the forward output and by round trip, each
    within TOL (max-norm and L2). Returns {label: (fwd, bwd, shape)}."""
    plans = {}
    for shape, world, kind in GENERIC_PATHS:
        label = (f"{kind} [{','.join(map(str, shape))}] loopback "
                 f"{world if kind == 'slab' else 'x'.join(map(str, world))}")
        x = seeded(torch, shape, dev)
        fwd = dfft.plan_dft_c2c_3d(shape, world, device=dev)
        bwd = dfft.plan_dft_c2c_3d(shape, world, direction=dfft.BACKWARD,
                                   device=dev)
        y = fwd(x)
        torch.cuda.synchronize()
        if tuple(y.shape) != shape or not bool(torch.isfinite(
                torch.view_as_real(y)).all()):
            fail(f"{label}: forward output not finite or of shape "
                 f"{tuple(y.shape)}")
        errs = rel_err(torch, y, torch.fft.fftn(x))[:2]
        back = bwd(y)
        torch.cuda.synchronize()
        errs += rel_err(torch, back, torch.fft.ifftn(y))[:2]
        errs += rel_err(torch, back, x)[:2]
        print(f"{label}: forward vs torch.fft.fftn max rel err={errs[0]:.3e}"
              f" l2 rel err={errs[1]:.3e}; backward vs torch.fft.ifftn max "
              f"rel err={errs[2]:.3e} l2 rel err={errs[3]:.3e}; roundtrip "
              f"max rel err={errs[4]:.3e} l2 rel err={errs[5]:.3e}",
              flush=True)
        if not max(errs) <= TOL:
            fail(f"{label}: error over {TOL}")
        plans[label] = (fwd, bwd, shape)
        del x, y, back
        torch.cuda.empty_cache()
    return plans


def time_generic_paths(torch, timing, dev, plans):
    """The GENERIC_PATHS plans' forward and backward times and t0..t3."""
    for label, (fwd, bwd, shape) in plans.items():
        x = seeded(torch, shape, dev)
        time_plans(torch, timing, fwd, bwd, x, label)
        stage_split(torch, timing, fwd, bwd, x, label)
        del x
        torch.cuda.empty_cache()


# The paths that launch the plane and the fused kernels at a length with
# a prime factor over 17 (GENERIC_FUSED): the slab C2C at 608^3 on
# SLAB_RANKS (its t0 planes [152, 608, 608]), exact and with each fusable
# wire fused beside its unfused twin, and the pencil at [512, 512, 608]
# on PENCIL_GRID with the split wire fused beside its twin (its
# t0_fft_z / t3_fft_z sites run kernels 4 and 5 at cols = 1).
GENERIC_FUSED = (608, 512)


def generic_fused_cases(n=GENERIC_FUSED[0], m=GENERIC_FUSED[1],
                        ranks=SLAB_RANKS, grid=PENCIL_GRID):
    """The fused kernel cases of the GENERIC_FUSED paths at the slab n^3
    and the pencil [m, m, n] (their row, strided and plane cases are
    GENERIC_CASES and generic_path_cases'), and at shapes no path
    launches (held only): the other codecs at the pencil's cols = 1
    sites, the encode's inverse with cols > 1 at n, and both kernels at
    76 = 4 * 19."""
    q = n // ranks
    rows, cols = grid
    pen = f"pencil [{m},{m},{n}]"
    z = (m // rows, m // cols, n)             # t0_fft_z / t3_fft_z blocks
    y = (m // rows, m, n // cols)             # t1_fft_y
    x = (m, m // rows, n // cols)             # t3_fft_x / bwd t0_fft_x
    fused = ([("decode_fft", c, True, (n, q, n), 0, ranks,
               f"slab {n}^3 fwd t3_fft_x") for c in CODECS]
             + [("decode_fft", c, False, (q, n, n), 1, ranks,
                 f"slab {n}^3 bwd t3_fft_y") for c in CODECS]
             + [("fft_encode", c, True, z, 2, cols,
                 f"{pen} fwd t0_fft_z, cols=1") for c in CODECS]
             + [("decode_fft", c, False, z, 2, cols,
                 f"{pen} bwd t3_fft_z, cols=1") for c in CODECS]
             + [("decode_fft", "split", True, y, 1, rows, f"{pen} fwd t1"),
                ("decode_fft", "split", True, x, 0, rows, f"{pen} fwd t3"),
                ("fft_encode", "split", False, x, 0, rows, f"{pen} bwd t0"),
                ("decode_fft", "split", False, y, 1, rows, f"{pen} bwd t1")]
             + [("fft_encode", c, False, (n, 64, 64), 0, ranks,
                 f"held: inverse, cols > 1 at {n}") for c in CODECS]
             + [("fft_encode", "split", True, (76, 256, 256), 0, ranks,
                 "held: 76 = 4 * 19"),
                ("decode_fft", "split", False, (256, 76, 256), 1, ranks,
                 "held: 76 = 4 * 19")])
    return fused


def check_fused_paths(torch, dfft, cfu, dev, slab, pencils):
    """The fused paths of a slab and pencils: (a) the slab C2C at
    ``slab`` on SLAB_RANKS exact, forward against torch.fft.fftn,
    backward against torch.fft.ifftn and by round trip; (b) the same slab
    with each fusable wire fused against its unfused twin, both
    directions, the split plan within TOL of torch.fft, the fused sites
    on the JAX package's routes; (c) each pencil in ``pencils`` on
    PENCIL_GRID with the split wire fused against its twin. Where the
    fused kernels take no direct route at a plan's lengths
    (``cuda_fuse.fused_route``) every fused output must equal its twin's
    bit for bit; elsewhere (a parent tree's direct route, timed by
    ``--route-cases``) the twins are reported. Returns {label: (fwd, bwd,
    shape)} for the timing phase."""
    shape = tuple(slab)
    bitwise = lambda shp: all(cfu.fused_route(m) != "direct" for m in shp)
    plans = {}
    x = seeded(torch, shape, dev)
    ref = torch.fft.fftn(x)
    name = "x".join(map(str, shape))
    label = f"slab {name} loopback {SLAB_RANKS}"
    fwd = dfft.plan_dft_c2c_3d(shape, SLAB_RANKS, device=dev)
    bwd = dfft.plan_dft_c2c_3d(shape, SLAB_RANKS, direction=dfft.BACKWARD,
                               device=dev)
    y = fwd(x)
    torch.cuda.synchronize()
    if tuple(y.shape) != shape or not bool(torch.isfinite(
            torch.view_as_real(y)).all()):
        fail(f"{label}: forward output not finite or of shape "
             f"{tuple(y.shape)}")
    errs = rel_err(torch, y, ref)[:2]
    del ref
    back = bwd(y)
    errs += rel_err(torch, back, torch.fft.ifftn(y))[:2]
    errs += rel_err(torch, back, x)[:2]
    print(f"{label}: forward vs torch.fft.fftn max rel err={errs[0]:.3e} l2 "
          f"rel err={errs[1]:.3e}; backward vs torch.fft.ifftn max rel err="
          f"{errs[2]:.3e} l2 rel err={errs[3]:.3e}; roundtrip max rel err="
          f"{errs[4]:.3e} l2 rel err={errs[5]:.3e}", flush=True)
    if not max(errs) <= TOL:
        fail(f"{label}: error over {TOL}")
    plans[label] = (fwd, bwd, shape)
    del y, back
    torch.cuda.empty_cache()

    def twins(label, fused, unfused, inp, key):
        """Run a fused pair and its unfused twin; fail unless the outputs
        are equal bit for bit (where ``bitwise``) and the sites take the
        JAX package's routes. Returns the errors."""
        (ff, fb), (uf, ub) = fused, unfused
        yf = ff(inp)
        rep_f = twin_report(torch, (yf,), (uf(inp),))
        bf = fb(yf)
        rep_b = twin_report(torch, (bf,), (ub(yf),))
        errs = (rel_err(torch, yf, torch.fft.fftn(inp))[:2]
                + rel_err(torch, bf, inp)[:2])
        print(f"{label}: forward vs torch.fft.fftn max rel err={errs[0]:.3e}"
              f" l2 rel err={errs[1]:.3e}; roundtrip max rel err="
              f"{errs[2]:.3e} l2 rel err={errs[3]:.3e}; vs the unfused twin:"
              f" forward {rep_f}, backward {rep_b}", flush=True)
        if bitwise(inp.shape) and (rep_f, rep_b) != ("bit-identical",
                                                    "bit-identical"):
            fail(f"{label}: outputs differ from the unfused twin's")
        for plan, what in ((ff, "fwd"), (fb, "bwd")):
            sites = list(plan.graph.meta["fusion"]["sites"].values())
            routes = [(st["sender"], st["receiver"]) for st in sites]
            want = (PENCIL_SITE_ROUTES if key == "pencil"
                    else [SITE_ROUTES[f"c2c {what}"]])
            if routes != want:
                fail(f"{label} {what}: fused sites {routes}, expected {want}")
        del yf, bf
        return errs

    for codec in CODECS:
        lab = f"slab {name} c2c {codec} fused loopback {SLAB_RANKS}"
        pair = lambda fuse: tuple(dfft.plan_dft_c2c_3d(
            shape, SLAB_RANKS, wire_dtype=codec, fuse=fuse, direction=d,
            device=dev) for d in (dfft.FORWARD, dfft.BACKWARD))
        fused, unfused = pair(True), pair(False)
        errs = twins(lab, fused, unfused, x, "slab")
        if codec == "split" and not max(errs) <= TOL:
            fail(f"{lab}: error over {TOL}")
        plans[lab] = (*fused, shape)
        plans[lab.replace(" fused", " unfused")] = (*unfused, shape)
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()

    grid = f"{PENCIL_GRID[0]}x{PENCIL_GRID[1]}"
    for pshape in map(tuple, pencils):
        xp = seeded(torch, pshape, dev)
        lab = f"pencil [{','.join(map(str, pshape))}] c2c split fused {grid}"
        pair = lambda fuse: tuple(dfft.plan_dft_c2c_3d(
            pshape, PENCIL_GRID, wire_dtype="split", fuse=fuse, direction=d,
            device=dev) for d in (dfft.FORWARD, dfft.BACKWARD))
        fused, unfused = pair(True), pair(False)
        if fused[0].world.grid != PENCIL_GRID:
            fail(f"{lab}: plan on {fused[0].world.grid}")
        errs = twins(lab, fused, unfused, xp, "pencil")
        if not max(errs) <= TOL:
            fail(f"{lab}: error over {TOL}")
        plans[lab] = (*fused, pshape)
        plans[lab.replace(" fused", " unfused")] = (*unfused, pshape)
        del xp
        torch.cuda.empty_cache()
    return plans


def check_generic_fused_paths(torch, dfft, cfu, dev, n=GENERIC_FUSED[0],
                              m=GENERIC_FUSED[1]):
    """The GENERIC_FUSED paths: check_fused_paths of the slab n^3 and the
    pencil [m, m, n]."""
    return check_fused_paths(torch, dfft, cfu, dev, (n, n, n), [(m, m, n)])


# The fused kernels' own gate (cuda_fuse.kernel_ineligible). The other
# reasons cuda_fuse.FUSION_FALLBACKS counts are the stage graph's sender
# and receiver routes (a slab's multi_axis sender), which are the JAX
# package's site routes and are held as such.
KERNEL_GATE = ("codec", "dtype", "empty", "tile_axis", "length",
               "uneven_tiles")


def gated(cfu) -> dict:
    """The fused sites the kernel gate refused, by (site, reason)."""
    return {k: v for k, v in cfu.FUSION_FALLBACKS.items()
            if k[1] in KERNEL_GATE}


def run_fused_paths(torch, dfft, cf, cfu, dev, label, drive, records=None,
                    need=(), by_length=False):
    """Drive a fused-paths phase (``drive()`` returns its plans) with
    counts from 0: prints the launches by wrapper and route and the peak
    device memory; with ``records`` (the full run) fails unless each
    entry of ``need`` (a wrapper, or a (wrapper, route) of
    ``cuda_fft.ROUTES``) was launched, every launch took the route its
    length takes (``by_length``: check_routes_by_length, the fused
    kernels' form included) or the radix route (check_routes), with no
    kernel fallback (``cuda_fft.FALLBACKS``) and no site the fused
    kernels' gate refused (KERNEL_GATE), and adds the launches to the
    records. Returns the plans."""
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = (dict(cf.FALLBACKS), gated(cfu))
    with recording_cases(cf, cfu) as seen:
        plans = drive()
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on {label}: {path}; by (wrapper, route): "
          f"{ {k: v for k, v in cf.ROUTES.items() if v} }", flush=True)
    print(f"peak device memory of {label}: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if records is None:
        print(f"cases on {label}: {sorted(seen, key=str)}", flush=True)
        return plans
    if by_length:
        check_routes_by_length(cf, seen, label, cfu)
    else:
        check_routes(cf, label, {}, dict(cf.ROUTES))
    check_covered(seen, label)
    for k in need:
        if (path[k] if isinstance(k, str) else cf.ROUTES[k]) <= 0:
            fail(f"{k} was not launched on {label}")
    if (dict(cf.FALLBACKS), gated(cfu)) != before:
        fail(f"{label} took a fallback: {dict(cf.FALLBACKS)}, "
             f"{gated(cfu)} (before: {before})")
    for k, v in path.items():
        records[k]["launches"] += v
    return plans


def run_generic_fused_paths(torch, dfft, cf, cfu, dev, records=None):
    """The GENERIC_FUSED paths (run_fused_paths): the plane, encode and
    decode kernels launched, by the radix route (the fused kernels also
    by its row form, on the pencil's last-axis sites) only."""
    return run_fused_paths(
        torch, dfft, cf, cfu, dev, "the 608^3 paths",
        lambda: check_generic_fused_paths(torch, dfft, cfu, dev), records,
        need=("fft2_last", "fft_encode", "decode_fft",
              ("fft_encode", "radix_rows"), ("decode_fft", "radix_rows")))


def time_generic_fused_paths(torch, timing, dev, plans):
    """The GENERIC_FUSED plans' forward and backward times (median of
    10), and t0..t3 of the exact and split fused slabs and the pencils."""
    for label, (fwd, bwd, shape) in plans.items():
        x = seeded(torch, shape, dev)
        time_plans(torch, timing, fwd, bwd, x, label)
        if "int8" not in label and "bf16" not in label:
            stage_split(torch, timing, fwd, bwd, x, label)
        del x
        torch.cuda.empty_cache()


# --------------------------------------------------- the paths past 8192

# The fused paths past 8192 at 2^28 elements (twice 512^3): the slab C2C
# [16384, 128, 128] on SLAB_RANKS, exact and with each fusable wire fused
# (its forward's t3_fft_x decodes along X = 16384 with columns, on the
# two-pass route; its backward's sender is a two-axis t0, unfused, and
# its receiver decodes along Y = 128); and the split fused pencils on
# PENCIL_GRID [128, 128, 16384] (t0_fft_z's encode and the backward's
# t3_fft_z decode in the row form, cols = 1, on the two-pass route) and
# [16384, 128, 128] (t3_fft_x's decode and the backward's t0_fft_x
# encode along X with columns on the two-pass route).
LONG_SLAB = (16384, 128, 128)
LONG_PENCILS = ((128, 128, 16384), (16384, 128, 128))


def long_path_cases(slab=LONG_SLAB, pencils=LONG_PENCILS, ranks=SLAB_RANKS,
                    grid=PENCIL_GRID):
    """The row, strided and plane kernel cases of the paths past 8192:
    the slab's t0 planes, t3 columns, backward X and Z axes of its
    two-axis t0 and backward t3 columns; each pencil's Z rows, Y and X
    columns, both directions (the unfused twins' and the exact plan's)."""
    xs, ys, zs = slab
    q, qy = xs // ranks, ys // ranks
    lab = f"slab [{xs},{ys},{zs}]"
    cases = [("fft2_last", True, (q, ys, zs), f"{lab} fwd t0"),
             ("fft_axis0", True, (1, xs, qy * zs), f"{lab} fwd t3"),
             ("fft_axis0", False, (1, xs, qy * zs), f"{lab} bwd t0 x"),
             ("fft_last", False, (xs * qy, zs), f"{lab} bwd t0 z"),
             ("fft_axis0", False, (q, ys, zs), f"{lab} bwd t3")]
    rows, cols = grid
    for a, b, c in pencils:
        lab = f"pencil [{a},{b},{c}]"
        for fwd in (True, False):
            cases += [("fft_last", fwd, (a // rows * (b // cols), c),
                       f"{lab} t0 / bwd t3 z"),
                      ("fft_axis0", fwd, (a // rows, b, c // cols),
                       f"{lab} t1 y"),
                      ("fft_axis0", fwd, (1, a, b // rows * (c // cols)),
                       f"{lab} t3 / bwd t0 x")]
    return cases


def long_fused_cases(slab=LONG_SLAB, pencils=LONG_PENCILS, ranks=SLAB_RANKS,
                     grid=PENCIL_GRID):
    """The fused kernel cases of the paths past 8192 (each codec at the
    slab's receivers, the split wire at the pencils' sites), and, held
    only, the other codecs in the two-pass forms no path runs with them:
    the encode in the row form and with columns, the decode in the row
    form (on smaller leads). Each case's eighth entry, False, exempts it
    from the JAX package's codec bound (ENC_BOUNDS), which the int8
    codec alone exceeds on these paths' data; check_fused_kernels holds
    it to the codec's own error."""
    xs, ys, zs = slab
    lab = f"slab [{xs},{ys},{zs}]"
    cases = []
    for c in CODECS:
        cases += [("decode_fft", c, True, (xs, ys // ranks, zs), 0, ranks,
                   f"{lab} fwd t3_fft_x"),
                  ("decode_fft", c, False, (xs // ranks, ys, zs), 1, ranks,
                   f"{lab} bwd t3_fft_y")]
    rows, cols = grid
    for a, b, c in pencils:
        lab = f"pencil [{a},{b},{c}]"
        z = (a // rows, b // cols, c)
        y = (a // rows, b, c // cols)
        x = (a, b // rows, c // cols)
        cases += [("fft_encode", "split", True, z, 2, cols,
                   f"{lab} fwd t0_fft_z, cols=1"),
                  ("decode_fft", "split", True, y, 1, rows,
                   f"{lab} fwd t1_fft_y"),
                  ("decode_fft", "split", True, x, 0, rows,
                   f"{lab} fwd t3_fft_x"),
                  ("fft_encode", "split", False, x, 0, rows,
                   f"{lab} bwd t0_fft_x"),
                  ("decode_fft", "split", False, y, 1, rows,
                   f"{lab} bwd t1_fft_y"),
                  ("decode_fft", "split", False, z, 2, cols,
                   f"{lab} bwd t3_fft_z, cols=1")]
    n = max(max(p) for p in pencils)
    for c in CODECS[:2]:
        cases += [("fft_encode", c, True, (4, 64, n), 2, cols,
                   "held: two-pass row form"),
                  ("decode_fft", c, False, (4, 64, n), 2, cols,
                   "held: two-pass row form"),
                  ("fft_encode", c, False, (n, 8, 64), 0, rows,
                   "held: two-pass with columns")]
    return [c + (False,) for c in cases]


def run_long_paths(torch, dfft, cf, cfu, dev, records=None,
                   slab=LONG_SLAB, pencils=LONG_PENCILS):
    """The paths past 8192 (run_fused_paths of check_fused_paths at
    ``slab`` and ``pencils``): every launch on the route and form its
    length takes (none on a direct route), the fused kernels in each of
    the two-pass route's forms, each fused plan bit for bit against its
    twin."""
    xs = max(max(slab), max(max(p) for p in pencils))
    return run_fused_paths(
        torch, dfft, cf, cfu, dev, f"the paths past 8192 (n = {xs})",
        lambda: check_fused_paths(torch, dfft, cfu, dev, slab, pencils),
        records, by_length=True,
        need=(("fft_encode", "radix2"), ("fft_encode", "radix2_rows"),
              ("decode_fft", "radix2"), ("decode_fft", "radix2_rows")))


def time_fused_pencil(torch, dfft, timing, dev, n=512):
    """The split fused pencil C2C at n^3 on PENCIL_GRID beside its
    unfused twin: forward and backward times (median of 10) and stage
    medians, whose t0 / backward t3 are the fused kernels' last-axis
    sites (``--route-cases``: the parent's beside this tree's)."""
    shape = (n, n, n)
    x = seeded(torch, shape, dev)
    grid = f"{PENCIL_GRID[0]}x{PENCIL_GRID[1]}"
    for fuse in (True, False):
        f, b = (dfft.plan_dft_c2c_3d(shape, PENCIL_GRID, wire_dtype="split",
                                     fuse=fuse, direction=d, device=dev)
                for d in (dfft.FORWARD, dfft.BACKWARD))
        label = (f"pencil c2c split {'fused' if fuse else 'unfused'} "
                 f"{n}^3 {grid}")
        time_plans(torch, timing, f, b, x, label)
        y = f(x)
        stage_medians(torch, timing, f, x, f"{label} forward")
        stage_medians(torch, timing, b, y, f"{label} backward")
        del y, f, b
        torch.cuda.empty_cache()


def long_cases(cf, choose_split_1d, ranks=SLAB_RANKS):
    """The kernel cases the long 1D paths launch: each two-level
    transform, one launch of the two-level route (``fft_last_big``, the
    inverse with its 1/n; held by :func:`time_two_level`), and the
    distributed 1D plan's s1 (the strided kernel over A of each rank's
    [A, B/P] columns) and s4 (the row kernel over B of its [A/P, B]
    rows)."""
    cases = []
    for batch, n in TWO_LEVEL:
        for fwd in (True, False):
            cases.append(("fft_last_big", fwd, (batch, n),
                          f"two-level [{batch},{n}]"))
    for n in DIST1D:
        a, b = choose_split_1d(n, ranks)
        for fwd in (True, False):
            cases += [("fft_axis0", fwd, (1, a, b // ranks),
                       f"dist 1D n={n} P={ranks} s1"),
                      ("fft_last", fwd, (a // ranks, b),
                       f"dist 1D n={n} P={ranks} s4")]
    return cases


def check_routes_by_length(cf, seen, path, cfu=None):
    """Fail unless every row, strided and plane launch of ``path`` took
    the route its length takes (``cuda_fft.route``), every two-level
    launch the two-level route's passes, and every fused launch (with
    ``cfu``) its form (``cuda_fuse.fused_form``): the long paths'
    lengths past 8192 take the two-pass radix one."""
    want = Counter()
    for key, v in seen.items():
        name = key[0]
        if name == "fft2_last":
            want[(name, cf.route2d(*key[2][1:]))] += v
        elif name in ("fft_axis0", "fft_last"):
            n = key[2][1] if name == "fft_axis0" else key[2][-1]
            want[(name, cf.route(n))] += v
        elif name == "fft_last_big":
            want[(name, "passes")] += v
        elif cfu is not None:
            want[(name, fused_form(cfu, key[3], key[4]))] += v
    got = {k: v for k, v in cf.ROUTES.items() if v}
    print(f"routes on {path} (wrapper, route): {got}", flush=True)
    if got != dict(want):
        fail(f"{path}: routes {got}, the lengths take {dict(want)}")


def device_kernels(torch, fn):
    """The device work of one call of ``fn`` (torch.profiler): the name
    of every kernel, copy and fill on the card, in launch order, each
    with its device time in us."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    evs.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.device_time) for e in evs]


def route_kernels(torch, fn, passes, what, tries=LOST_TRIES):
    """The kernels one call of ``fn`` (a two-level call) puts on the card:
    fails unless they are the route's ``passes`` passes (radix.cuh's
    column and rows kernels with the two-level outputs) and nothing else
    (no PyTorch elementwise, copy, transpose or scaling kernel). A
    capture short of the passes (the profiler has lost records) is taken
    again, up to ``tries`` times, then reported as not measured (None).
    Returns the kernels' device times (us)."""
    for _ in range(tries):
        got = device_kernels(torch, fn)
        other = [name for name, _ in got if "TwoLevel" not in name]
        if other:
            fail(f"{what}: kernels other than the route's passes on the "
                 f"card: {other}")
        if len(got) > passes:
            fail(f"{what}: {len(got)} kernels, the route has {passes} passes")
        if len(got) == passes:
            return [us for _, us in got]
    print(f"{what}: kernels on the card not measured (the capture held "
          f"{len(got)} of {passes} passes in {tries} tries)", flush=True)
    return None


def check_two_level(torch, cf, dev):
    """Phase 12: the two-level transform (``cuda_fft.fft_along_axis`` of
    a length past 65536) at each TWO_LEVEL shape, forward and inverse,
    against torch.fft in complex128. At [1, 2^24] a profiler capture of
    each call counts its kernels: the route's passes only."""
    for batch, n in TWO_LEVEL:
        x = seeded(torch, (batch, n), dev)
        ref = x.to(torch.complex128)
        cols, length = cf.two_level_passes(n)
        for fwd in (True, False):
            what = f"two-level [{batch},{n}] {'fwd' if fwd else 'inv'}"
            out = []
            call = lambda: out.append(cf.fft_along_axis(x, 1, fwd))
            if n == 1 << 24:
                # the tables on the card first: the capture is one call
                cf.two_level_args(n, fwd, dev, (cols, length))
                us = route_kernels(torch, call, len(cols) + 1, what)
                if us is not None:
                    print(f"{what}: one call's kernels on the card: "
                          f"{len(us)} passes, nothing else ("
                          + ", ".join(f"{u:.1f}" for u in us) + " us)",
                          flush=True)
            else:
                call()
            y = out[-1]
            sync(torch, dev)
            if tuple(y.shape) != (batch, n) or not bool(torch.isfinite(
                    torch.view_as_real(y)).all()):
                fail(f"{what}: output not finite or of shape "
                     f"{tuple(y.shape)}")
            f = torch.fft.fft if fwd else torch.fft.ifft
            err, l2, _ = rel_err(torch, y, f(ref, dim=1))
            del y, out
            print(f"{what}: passes {cols} x {length} (outer_split "
                  f"{cf.outer_split(n)}): vs torch.fft (complex128) max rel "
                  f"err={err:.3e} l2 rel err={l2:.3e}", flush=True)
            if not max(err, l2) <= TOL:
                fail(f"{what}: error over {TOL}")
        del x, ref
        torch.cuda.empty_cache()


def pass_times(torch, fn, passes, reps=5, tries=10):
    """Median device time (ms) of each pass of a two-level call ``fn``,
    in order, over ``reps`` captures of one call each (torch.profiler);
    a capture that lost a record is dropped, up to ``tries`` captures.
    Returns (times, captures used), times None when none was whole."""
    fn()
    whole = []
    for _ in range(tries):
        got = device_kernels(torch, fn)
        if len(got) == passes:
            whole.append([us for _, us in got])
            if len(whole) == reps:
                break
    if not whole:
        return None, 0
    return [statistics.median(w[i] for w in whole) / 1e3
            for i in range(passes)], len(whole)


def per_pass(parts) -> str:
    times, used = parts
    if times is None:
        return "not measured (every capture lost a record)"
    return " ".join(f"{v:.4f}" for v in times) + f" (median of {used})"


def time_two_level(torch, cf, timing, dev, card, rates, records):
    """The two-level route at each TWO_LEVEL shape, forward and inverse:
    each launch against its plain version (``two_level_passes_plain``)
    and the JAX-shaped composition (``_fft_last_big_plain``), 5e-4 max
    and L2; its time (CUDA events, median of 10; back to back) beside the
    plain version's (median of 3), torch.fft's, the pass count times the
    one-pass bound (one read and one write at the data sheet's rate) and
    each pass's device time (torch.profiler, median of up to 5 one-call
    captures); and, where it differs, the plan of the fewest passes with
    a long last pass. Fills the route's record from the first shape's
    forward."""
    hbm, fp32, _ = rates
    rec = records["fft_last_big"]
    for batch, n in TWO_LEVEL:
        plan = cf.two_level_passes(n)
        passes = len(plan[0]) + 1
        x = seeded(torch, (batch, n), dev, SEED + 7)
        for fwd in (True, False):
            sc = 1.0 if fwd else 1.0 / n
            what = f"two-level [{batch},{n}] {'fwd' if fwd else 'inv'}"
            y = cf._fft_last_big(x, n, fwd, sc)
            errs = []
            for name, plain in (
                    ("two_level_passes_plain",
                     lambda: cf.two_level_passes_plain(x, n, fwd, sc)),
                    ("_fft_last_big_plain",
                     lambda: cf._fft_last_big_plain(x, n, fwd) * sc)):
                err, l2, abs_err = rel_err(torch, y, plain())
                if not max(err, l2) <= TOL:
                    fail(f"{what}: vs {name} max {err:.3e} l2 {l2:.3e} > "
                         f"{TOL}")
                errs.append(f"vs {name} max rel err={err:.3e} l2 rel err="
                            f"{l2:.3e} max abs err={abs_err:.3e}")
                rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
            del y
            f = torch.fft.fft if fwd else torch.fft.ifft
            call = lambda: cf._fft_last_big(x, n, fwd, sc)
            ms = timing.cuda_time_ms(call)
            steady = steady_ms(torch, call)
            plain_ms = timing.cuda_time_ms(
                lambda: cf.two_level_passes_plain(x, n, fwd, sc), iters=3)
            lib_ms = timing.cuda_time_ms(lambda: f(x, dim=1))
            lib_steady = steady_ms(torch, lambda: f(x, dim=1))
            parts = pass_times(torch, lambda: cf.two_level_launch(
                x, n, fwd, sc, plan), passes)
            t_bytes = 2 * batch * n * 8 / hbm * 1e3
            t_ops = 5.0 * batch * n * math.log2(n) / fp32 * 1e3
            bound = max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            print(f"{what} passes {plan[0]} x {plan[1]}: "
                  + "; ".join(errs)
                  + f"; kernel_ms={ms:.4f} kernel_steady_ms={steady:.4f} "
                  f"plain_ms={plain_ms:.4f} (median of 3) library_ms="
                  f"{lib_ms:.4f} library_steady_ms={lib_steady:.4f} "
                  f"bound_ms={bound:.4f} ({bound_by}) bound_passes_ms="
                  f"{passes * t_bytes:.4f} ({passes} x {t_bytes:.4f}); "
                  f"per pass (ms): {per_pass(parts)} [{card}]", flush=True)
            # the plan of the fewest passes with any last length, where
            # the default's staged last pass costs one more pass
            alt = cf.two_level_passes(n, staged_cap=cf.radix.MAX_N)
            if alt != plan:
                run = lambda: cf.two_level_launch(x, n, fwd, sc, alt)
                alt_parts = pass_times(torch, run, len(alt[0]) + 1)
                print(f"{what} fewest passes {alt[0]} x {alt[1]} (its last "
                      f"pass stored from registers): kernel_ms="
                      f"{timing.cuda_time_ms(run):.4f} bound_passes_ms="
                      f"{(len(alt[0]) + 1) * t_bytes:.4f}; per pass (ms): "
                      f"{per_pass(alt_parts)} [{card}]", flush=True)
            if rec["ms"] is None:
                rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound, bound_by=bound_by)
        del x
        torch.cuda.empty_cache()


def check_dist1d(torch, dfft, dev, ranks=SLAB_RANKS):
    """Phase 13: ``plan_dft_c2c_1d_dist`` on a loopback world of
    ``ranks`` at each DIST1D length, both orders and directions, under
    ``alltoall`` and ``ppermute``: the forward against torch.fft in
    complex128 (the transposed order read back to natural), the backward
    by round trip, and ``ppermute`` equal to ``alltoall`` bit for bit.
    Returns the 2^28 plans, for the times."""
    from distributedfft_tpu_torch.ops import cuda_fft as cf

    world = dfft.make_world(ranks)
    keep = {}
    for n in DIST1D:
        x = seeded(torch, (n,), dev)
        ref = torch.fft.fft(x.to(torch.complex128))
        for order in ("transposed", "natural"):
            plans = {(alg, d): dfft.plan_dft_c2c_1d_dist(
                n, world, direction=d, order=order, algorithm=alg,
                device=dev)
                for alg in ("alltoall", "ppermute") for d in (-1, 1)}
            f, b = plans[("alltoall", -1)], plans[("alltoall", 1)]
            y = f(x)
            torch.cuda.synchronize()
            if tuple(y.shape) != (n,) or not bool(torch.isfinite(
                    torch.view_as_real(y)).all()):
                fail(f"dist 1D n={n} {order}: output not finite or of "
                     f"shape {tuple(y.shape)}")
            nat = (y if order == "natural" else
                   y.reshape(f.spec.a, f.spec.b).t().reshape(-1))
            errs = rel_err(torch, nat, ref)[:2]
            del nat
            r = b(y)
            errs += rel_err(torch, r, x)[:2]
            same = (torch.equal(plans[("ppermute", -1)](x), y)
                    and torch.equal(plans[("ppermute", 1)](y), r))
            del y, r
            print(f"dist 1D n={n} ({f.spec.a} x {f.spec.b}) P={ranks} "
                  f"(routes: s1 {cf.route(f.spec.a)}, s4 "
                  f"{cf.route(f.spec.b)}) "
                  f"{order}: forward vs torch.fft (complex128) max rel err="
                  f"{errs[0]:.3e} l2 rel err={errs[1]:.3e}; roundtrip max "
                  f"rel err={errs[2]:.3e} l2 rel err={errs[3]:.3e}; "
                  f"ppermute vs alltoall: "
                  f"{'bit-identical' if same else 'DIFFERENT'}", flush=True)
            if not max(errs) <= TOL or not same:
                fail(f"dist 1D n={n} {order}: errors {errs}, ppermute "
                     f"bit-identical {same}")
            if n == DIST1D[0]:
                keep[order] = plans
            torch.cuda.empty_cache()
        del x, ref
        torch.cuda.empty_cache()
    return keep


def time_dist1d(torch, timing, dev, card, rates, kept):
    """The 2^28 plans' forward and backward ms per order and transport
    (median of 10 under alltoall, of 5 under ppermute: a call takes
    ~0.4 s) and their stages (median of 3 per stage), beside one
    torch.fft call on the card and one read and write of the vector."""
    n = DIST1D[0]
    x = seeded(torch, (n,), dev)
    lib_ms = timing.cuda_time_ms(lambda: torch.fft.fft(x))
    print(f"dist 1D n={n}: library_ms={lib_ms:.4f} (one torch.fft.fft on "
          f"one card) bound_ms={2 * n * 8 / rates[0] * 1e3:.4f} (bytes) "
          f"[{card}]", flush=True)
    for order, plans in kept.items():
        for alg in ("alltoall", "ppermute"):
            f, b = plans[(alg, -1)], plans[(alg, 1)]
            y = f(x)
            reps = 10 if alg == "alltoall" else 5
            t_f = timing.cuda_time_ms(lambda: f(x), iters=reps, warmup=1)
            t_b = timing.cuda_time_ms(lambda: b(y), iters=reps, warmup=1)
            print(f"dist 1D n={n} P={SLAB_RANKS} {order} {alg}: "
                  f"forward_ms={t_f:.3f} backward_ms={t_b:.3f} (median of "
                  f"{reps}) [{card}]", flush=True)
            for what, plan, inp in (("forward", f, x), ("backward", b, y)):
                runs = []
                for _ in range(3):
                    timer = timing.StageTimer(dev)
                    plan(inp, timer=timer)
                    runs.append(timer.times())
                med = {k: sorted(r[k] for r in runs)[len(runs) // 2]
                       for k in runs[0]}
                print(f"dist 1D n={n} {order} {alg} {what} stages (CUDA "
                      f"events, median of 3, ms): " + " ".join(
                          f"{k}={v * 1e3:.3f}" for k, v in med.items()),
                      flush=True)
            del y
            torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()


def check_concurrent(torch, dfft, dev, n=512):
    """Phase 14: two slab plans on a loopback world of SLAB_RANKS, and a
    slab (hierarchical) and a pencil plan on the 2x2 hybrid world,
    through ``schedule_concurrent``, each output equal to its plan called
    alone bit for bit; then a WaveSchedule of 4 waves of width 2 (depth
    2), each wave's outputs the same bits. Returns the pairs and inputs."""
    shape = (n, n, n)
    world = dfft.make_world(SLAB_RANKS)
    hybrid = dfft.make_world(PENCIL_GRID, dfft.HYBRID_AXES)
    pairs = {
        f"slab+slab P={SLAB_RANKS}": [
            dfft.plan_dft_c2c_3d(shape, world, device=dev) for _ in range(2)],
        "slab+pencil 2x2 hybrid": [
            dfft.plan_dft_c2c_3d(shape, hybrid, algorithm="hierarchical",
                                 device=dev),
            dfft.plan_dft_c2c_3d(shape, hybrid, decomposition="pencil",
                                 device=dev)]}
    xs = [seeded(torch, shape, dev, SEED + 1), seeded(torch, shape, dev,
                                                       SEED + 2)]
    for label, plans in pairs.items():
        ys = dfft.schedule_concurrent(plans)(*xs)
        same = [torch.equal(y, p(x)) for p, x, y in zip(plans, xs, ys)]
        del ys
        print(f"concurrent {label} {n}^3: outputs vs the plans called one "
              f"after another: {same}", flush=True)
        if not all(same):
            fail(f"concurrent {label}: not bit-identical ({same})")
    plans = pairs[f"slab+slab P={SLAB_RANKS}"]
    want = [p(x) for p, x in zip(plans, xs)]
    ws = dfft.WaveSchedule(max_width=2, depth=2)
    for _ in range(4):
        outs = ws.dispatch(plans, xs)
        if ws.inflight > 2:
            fail(f"wave schedule: {ws.inflight} waves in flight at depth 2")
        if not all(torch.equal(o, w) for o, w in zip(outs, want)):
            fail("wave schedule: a wave's outputs differ from the plans'")
        del outs
    ws.drain()
    print("wave schedule (4 waves of width 2, depth 2) records: "
          + "; ".join(f"index={r['index']} width={r['width']} interleaved="
                      f"{r['interleaved']} duration_s={r['duration_s']:.6f}"
                      for r in ws.records), flush=True)
    if [r["index"] for r in ws.records] != [0, 1, 2, 3]:
        fail(f"wave schedule retired {[r['index'] for r in ws.records]}")
    del want
    torch.cuda.empty_cache()
    return pairs, xs


def time_concurrent(torch, dfft, timing, card, pairs, xs, n=512):
    """Each pair's schedule against the two calls one after another
    (CUDA events, median of 10), and 4 waves through a WaveSchedule
    against 4 pairs of calls (host clock, each from an idle card)."""
    for label, plans in pairs.items():
        cp = dfft.schedule_concurrent(plans)
        t_cc = timing.cuda_time_ms(lambda: cp(*xs), iters=10)
        t_seq = timing.cuda_time_ms(lambda: seq_pair(plans, xs), iters=10)
        print(f"concurrent {label} {n}^3: schedule_ms={t_cc:.3f} "
              f"sequential_ms={t_seq:.3f} (ratio {t_cc / t_seq:.3f}; one "
              f"card, loopback world: the exchanges are copies on the "
              f"compute stream, so no gain is expected) [{card}]",
              flush=True)
    plans = pairs[f"slab+slab P={SLAB_RANKS}"]
    for label, run in (
            ("wave schedule", lambda: _waves(dfft, plans, xs)),
            ("sequential", lambda: [seq_pair(plans, xs) for _ in range(4)])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        print(f"concurrent 4 waves of slab+slab {n}^3 {label}: "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms host clock "
              f"[{card}]", flush=True)


def _waves(dfft, plans, xs, waves=4):
    ws = dfft.WaveSchedule(max_width=2, depth=2)
    for _ in range(waves):
        ws.dispatch(plans, xs)
    ws.drain()


def seq_pair(plans, xs):
    return [p(x) for p, x in zip(plans, xs)]


# ------------------------------------------------------- the dd tier

def dd_data(shape, real=False, seed=SEED):
    """Seeded numpy float64 data: complex128, or float64 when ``real``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    return x if real else x + 1j * rng.standard_normal(shape)


def dd_rel(torch, ddfft, pair, ref) -> float:
    """max |value of the pair - ref| / max |ref|, on the pair's device."""
    return float((ddfft.join(*pair) - ref).abs().max() / ref.abs().max())


def dd_worlds():
    grid = f"{PENCIL_GRID[0]}x{PENCIL_GRID[1]}"
    return {"single": None, f"slab P={SLAB_RANKS}": SLAB_RANKS,
            f"pencil {grid}": PENCIL_GRID}


def check_dd(torch, dfft, dev, n=512):
    """Phase 15: the dd tier at n^3 (counts from 0): the C2C plans on one
    card, a slab of SLAB_RANKS loopback ranks and the PENCIL_GRID pencil,
    forward against scipy.fft.fftn in float64 on the host and backward
    by round trip; the R2C/C2R plans against scipy.fft.rfftn and by
    round trip; a brick plan (Z-slabs in, X-pencils out) against the
    slab plan; batch = 2 against two calls (bits reported, the tier
    held). Every error <= 1e-11; every dd plan runs its chains on the
    ``torch`` engine (the ``_dd`` executor: no kernel launch, no
    fallback). Returns what the timing phase times."""
    import scipy.fft

    from distributedfft_tpu_torch.ops import cuda_fft as cf, ddfft

    shape = (n, n, n)
    x = dd_data(shape)
    pair = dfft.dd_from_host(x, device=dev)
    t0 = time.perf_counter()
    want = torch.from_numpy(scipy.fft.fftn(x, workers=-1)).to(dev)
    host_s = time.perf_counter() - t0
    xt = torch.from_numpy(x).to(dev)
    del x
    before = dict(cf.FALLBACKS)
    cf.reset_launches()
    plans, outs = {}, {}
    for label, w in dd_worlds().items():
        f = dfft.plan_dd_dft_c2c_3d(shape, w, device=dev)
        b = dfft.plan_dd_dft_c2c_3d(shape, w, direction=dfft.BACKWARD,
                                    device=dev)
        for p in (f, b):
            if p.graph is not None and p.graph.executor != ddfft.PLAN_EXECUTOR:
                fail(f"dd {label}: not on the torch engine")
        y = f(*pair)
        e_f = dd_rel(torch, ddfft, y, want)
        e_rt = dd_rel(torch, ddfft, b(*y), xt)
        print(f"dd c2c {label} {n}^3: forward vs scipy.fft.fftn (float64, "
              f"host) max rel err={e_f:.3e}; roundtrip max rel err="
              f"{e_rt:.3e}", flush=True)
        if not max(e_f, e_rt) <= TOL128:
            fail(f"dd c2c {label}: error over {TOL128}")
        plans[label] = (f, b)
        outs[label] = y
    print(f"scipy.fft.fftn at {n}^3 on the host (workers=-1): "
          f"{host_s:.1f} s", flush=True)
    # bricks: Z-slabs in, X-pencils out, around the slab chain
    slab = f"slab P={SLAB_RANKS}"
    wbox = dfft.geometry.world_box(shape)
    ins = dfft.geometry.make_slabs(wbox, SLAB_RANKS, axis=2)
    bouts = dfft.geometry.make_pencils(wbox, PENCIL_GRID, 0)
    bp = dfft.plan_dd_brick_dft_c2c_3d(shape, SLAB_RANKS, ins, bouts,
                                       device=dev)
    stacks = tuple(dfft.scatter_bricks(c, ins) for c in pair)
    yb = bp(*stacks)
    got = tuple(dfft.gather_bricks(c, bouts) for c in yb)
    e_b = dd_rel(torch, ddfft, got, want)
    same = all(torch.equal(a, c) for a, c in zip(got, outs[slab]))
    print(f"dd brick c2c (Z-slabs in, X-pencils out) {slab} {n}^3: vs "
          f"scipy max rel err={e_b:.3e}; equal to the slab plan bit for "
          f"bit: {same}", flush=True)
    if not e_b <= TOL128:
        fail(f"dd brick plan: error over {TOL128}")
    del got, yb, outs
    # batch = 2: the pair and half of it, against two calls
    pb = dfft.plan_dd_dft_c2c_3d(shape, SLAB_RANKS, batch=2, device=dev)
    items = [pair, tuple(c * 0.5 for c in pair)]
    bh, bl = pb(*(torch.stack([it[k] for it in items]) for k in (0, 1)))
    f = plans[slab][0]
    for i, it in enumerate(items):
        one = f(*it)
        bits = torch.equal(bh[i], one[0]) and torch.equal(bl[i], one[1])
        e_i = dd_rel(torch, ddfft, (bh[i], bl[i]), ddfft.join(*one))
        print(f"dd batch = 2 {slab} {n}^3 item {i}: equal to one call bit "
              f"for bit: {bits}; max rel diff={e_i:.3e}", flush=True)
        if not e_i <= TOL128:
            fail(f"dd batch item {i}: over the tier against one call")
    del bh, bl, items, want
    # real plans
    xr = dd_data(shape, real=True, seed=SEED + 1)
    rpair = dfft.dd_from_host(xr, device=dev)
    want_r = torch.from_numpy(scipy.fft.rfftn(xr, workers=-1)).to(dev)
    xrt = torch.from_numpy(xr).to(dev)
    del xr
    rplans = {}
    for label, w in dd_worlds().items():
        f = dfft.plan_dd_dft_r2c_3d(shape, w, device=dev)
        b = dfft.plan_dd_dft_c2r_3d(shape, w, device=dev)
        y = f(*rpair)
        e_f = dd_rel(torch, ddfft, y, want_r)
        e_rt = dd_rel(torch, ddfft, b(*y), xrt)
        print(f"dd r2c/c2r {label} {n}^3: forward vs scipy.fft.rfftn max "
              f"rel err={e_f:.3e}; roundtrip max rel err={e_rt:.3e}",
              flush=True)
        if not max(e_f, e_rt) <= TOL128:
            fail(f"dd r2c/c2r {label}: error over {TOL128}")
        rplans[label] = (f, b)
        del y
    del want_r, xrt
    launched = cf.launches()
    print(f"kernel launches on the dd path: {launched}; fallbacks added: "
          f"{ {k: v for k, v in cf.FALLBACKS.items() if before.get(k) != v} }",
          flush=True)
    if any(launched.values()):
        fail("a dd plan launched a complex64 kernel")
    if dict(cf.FALLBACKS) != before:
        fail(f"the dd path took a fallback: {dict(cf.FALLBACKS)}")
    return dict(pair=pair, rpair=rpair, plans=plans, rplans=rplans,
                brick=(bp, stacks), batch=pb)


def extra_gib(torch, fn) -> float:
    """Device memory (GiB) ``fn`` needs over what is allocated before it
    runs (:func:`peak_gib` less the memory held)."""
    sys.modules["distributedfft_tpu_torch"].clear_plan_cache()
    held = torch.cuda.memory_allocated() / 2**30
    return peak_gib(torch, fn) - held


def time_dd(torch, dfft, timing, dev, card, kept, n=512):
    """Phase 15b: the dd plans' forward and backward ms (median of 10)
    beside the complex128 plan on the ``torch`` executor and the
    complex64 exact plan of the same world, the join and split alone,
    and the device memory each forward call needs over the data held."""
    from distributedfft_tpu_torch.ops import ddfft

    shape = (n, n, n)
    pair = kept["pair"]
    xc = ddfft.join(*pair)
    t_js = timing.cuda_time_ms(lambda: ddfft.split(ddfft.join(*pair)),
                               iters=10)
    print(f"dd join + split alone {n}^3 (complex64 pair -> complex128 -> "
          f"pair): {t_js:.3f} ms [{card}]", flush=True)
    for label, w in dd_worlds().items():
        f, b = kept["plans"][label]
        y = f(*pair)
        t_f = timing.cuda_time_ms(lambda: f(*pair), iters=10)
        t_b = timing.cuda_time_ms(lambda: b(*y), iters=10)
        mem = extra_gib(torch, lambda: f(*pair))
        del y
        c128 = dict(dtype=torch.complex128, executor="torch", device=dev)
        cf_ = dfft.plan_dft_c2c_3d(shape, w, **c128)
        cb_ = dfft.plan_dft_c2c_3d(shape, w, direction=dfft.BACKWARD, **c128)
        yc = cf_(xc)
        c_f = timing.cuda_time_ms(lambda: cf_(xc), iters=10)
        c_b = timing.cuda_time_ms(lambda: cb_(yc), iters=10)
        mem_c = extra_gib(torch, lambda: cf_(xc))
        del yc
        sf = dfft.plan_dft_c2c_3d(shape, w, device=dev)
        sb = dfft.plan_dft_c2c_3d(shape, w, direction=dfft.BACKWARD,
                                  device=dev)
        ys = sf(pair[0])
        s_f = timing.cuda_time_ms(lambda: sf(pair[0]), iters=10)
        s_b = timing.cuda_time_ms(lambda: sb(ys), iters=10)
        del ys
        print(f"dd c2c {label} {n}^3: forward_ms={t_f:.3f} backward_ms="
              f"{t_b:.3f} +{mem:.2f} GiB; c128 torch plan {c_f:.3f} / "
              f"{c_b:.3f} +{mem_c:.2f} GiB; c64 exact plan {s_f:.3f} / "
              f"{s_b:.3f} [{card}]", flush=True)
        torch.cuda.empty_cache()
    rpair = kept["rpair"]
    for label, (f, b) in kept["rplans"].items():
        y = f(*rpair)
        t_f = timing.cuda_time_ms(lambda: f(*rpair), iters=10)
        t_b = timing.cuda_time_ms(lambda: b(*y), iters=10)
        mem = extra_gib(torch, lambda: f(*rpair))
        del y
        print(f"dd r2c/c2r {label} {n}^3: forward_ms={t_f:.3f} "
              f"backward_ms={t_b:.3f} +{mem:.2f} GiB [{card}]",
              flush=True)
    bp, stacks = kept["brick"]
    t_br = timing.cuda_time_ms(lambda: bp(*stacks), iters=10)
    print(f"dd brick c2c slab P={SLAB_RANKS} {n}^3: forward_ms={t_br:.3f} "
          f"+{extra_gib(torch, lambda: bp(*stacks)):.2f} GiB [{card}]",
          flush=True)
    pb = kept["batch"]
    xb = tuple(torch.stack([c, c]) for c in pair)
    t_bt = timing.cuda_time_ms(lambda: pb(*xb), iters=10)
    f = kept["plans"][f"slab P={SLAB_RANKS}"][0]
    t_two = timing.cuda_time_ms(lambda: (f(*pair), f(*pair)), iters=10)
    print(f"dd batch = 2 slab P={SLAB_RANKS} {n}^3: {t_bt:.3f} ms against "
          f"two calls {t_two:.3f} ms [{card}]", flush=True)


def dd_metrics_line(torch, dfft, dev, pair, n=512):
    """One planned pass with the metrics registry on: the slab dd plan
    and the slab complex64 plan, each planned twice (a build, then a
    cache hit) and called once. Prints the counters as one line."""
    from distributedfft_tpu_torch.utils import metrics

    shape = (n, n, n)
    dfft.clear_plan_cache()
    metrics.metrics_reset()
    metrics.enable_metrics()
    try:
        for _ in range(2):
            dd = dfft.plan_dd_dft_c2c_3d(shape, SLAB_RANKS, device=dev)
            c64 = dfft.plan_dft_c2c_3d(shape, SLAB_RANKS, device=dev)
        dd(*pair)
        c64(pair[0])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        snap = metrics.metrics_snapshot()
    finally:
        metrics.enable_metrics(False)
        metrics.metrics_reset()
    c = snap["counters"]
    print("metrics after one planned pass: " + json.dumps({
        "plan_builds": c.get("plan_builds", {}),
        "plan_cache_hits": c.get("plan_cache_hits", {}),
        "plan_cache_misses": c.get("plan_cache_misses", {}),
        "executes": c.get("executes", {}),
        "exchange_true_bytes": c.get("exchange_true_bytes", {}),
        "exchange_wire_bytes": c.get("exchange_wire_bytes", {}),
        "plan_build_seconds": {
            k: v["total"] for k, v in snap["histograms"].get(
                "plan_build_seconds", {}).items()}}), flush=True)


# ------------------------------------------------- measured planning

#: The error budget of the phase's budgeted tournaments (compressed wire
#: and reduced tiers admitted under it).
TUNE_BUDGET = 1e-2
#: The phase's tuner settings: each candidate timed 3 calls a batch, best
#: of 2 batches; the width tournament armed the same way.
TUNE_ENV = {"DFFT_TUNE_ITERS": "3x2", "DFFT_WIDTH_TOURNAMENT": "3x2"}


def tune_cases(n, ranks=SLAB_RANKS):
    """The kernel cases the measured-planning phase adds at n^3 beyond
    the other paths' (the overlap cases at K = 2k come from
    overlap_cases): the op's inverse t_mid chunk, the R2C t3 and C2R bwd
    t3 chunks at the auto K and twice it (the half-spectrum axis cut
    into chunks of two widths), and the unfused side of calibrate's
    fuse_speedup."""
    from distributedfft_tpu_torch.parallel.exchange import (
        overlap_chunk_bounds)
    from distributedfft_tpu_torch.plan_logic import auto_overlap_chunks

    q, h = n // ranks, n // 2 + 1
    auto = auto_overlap_chunks((n, n, n), ranks)
    ks = (auto, 2 * auto)
    out = [("fft_axis0", False, (1, n, q * n // k),
            f"K={k} op t_mid inverse chunk") for k in ks]
    widths = sorted({hi - lo for k in ks
                     for lo, hi in overlap_chunk_bounds(h, k)})
    out += [("fft_axis0", True, (1, n, q * c),
             f"r2c t3 chunk of {c} columns (K={auto}, {2 * auto})")
            for c in widths]
    out += [("fft_axis0", False, (q, n, c),
             f"c2r bwd t3 chunk of {c} columns (K={auto}, {2 * auto})")
            for c in widths]
    out += [("fft_axis0", True, (1, 512, 256),
             "calibrate fuse_speedup, unfused")]
    return out


@contextlib.contextmanager
def recording_tournaments(tuner):
    """Yield a list that receives each tournament run inside the block:
    its ``what``, candidate names, winner, built candidates and times
    (``tuner.measured_select`` wrapped; ``executor="auto"``, the tuned
    planners and the width tournament all call it)."""
    seen = []
    orig = tuner.measured_select

    def record(names, build, measure, **kw):
        out = orig(names, build, measure, **kw)
        seen.append(dict(what=kw.get("what", "candidate"), names=list(names),
                         winner=out[0], built=out[1], times=out[2]))
        return out

    tuner.measured_select = record
    try:
        yield seen
    finally:
        tuner.measured_select = orig


def _executor_of(name: str) -> str:
    """The executor of a tournament entry: a tuned candidate's label
    (``slab/alltoall/cuda/ov1``) or an auto candidate's executor."""
    return name.split("/")[2] if "/" in name else name


def _families(names) -> set:
    """Which of the ``cuda`` and ``cuda+fuse`` families the names hold."""
    out = set()
    for nm in names:
        mods = _executor_of(nm).split(":")
        if mods[0] == "cuda":
            out.add("cuda+fuse" if "fuse" in mods[1:] else "cuda")
    return out


def check_tournament(t, label, need, card):
    """Print a tournament's candidates (each one's time and, for a tuned
    one, its model seconds) and winner; fail on a candidate that did not
    build, a non-finite time, or a family of ``need`` missing from its
    candidates."""
    missing = [nm for nm in t["names"] if nm not in t["built"]]
    if missing:
        fail(f"{label}: candidates that did not build: {missing}")
    bad = {nm: t["times"].get(nm) for nm in t["names"]
           if not math.isfinite(t["times"].get(nm, math.inf))}
    if bad:
        fail(f"{label}: candidates without a finite time: {bad}")
    lacking = set(need) - _families(t["names"])
    if lacking:
        fail(f"{label}: no {sorted(lacking)} candidate among "
             f"{t['names']}")
    for nm in t["names"]:
        model = t.get("model", {}).get(nm)
        print(f"  {label} candidate {nm}: measured_ms="
              f"{t['times'][nm] * 1e3:.4f}"
              + ("" if model is None else f" model_s={model:.6g}")
              + (" (winner)" if nm == t["winner"] else ""), flush=True)
    print(f"{label}: winner {t['winner']} of {len(t['names'])} [{card}]",
          flush=True)


def survivor_cap(tuner, shape, world, budget, wires, tiers, need, dev,
                 real=False):
    """The least survivor cap (DFFT_TUNE_MAX, from the default 8 up to
    32) whose pruned set holds a candidate of each family in ``need``,
    pruned as the tuned planner prunes now (the profile's corrections
    included; ``real``: an R2C or C2R plan)."""
    import torch

    ndev, dims = tuner._mesh_context(world)
    cands = tuner.enumerate_candidates(
        shape, ndev, mesh_dims=dims,
        executors=tuner._default_executors(dev), itemsize=8,
        wire_dtypes=wires, mm_tiers=tiers, real=real)
    for cap in range(tuner.DEFAULT_MAX_CANDIDATES, 33):
        kept = tuner.prune_candidates(cands, shape, world, itemsize=8,
                                      limit=cap, max_err=budget,
                                      dtype=torch.complex64, device=dev)
        if set(need) <= _families(c.label for c in kept):
            return cap
    fail(f"no survivor cap up to 32 holds {need} for {shape}")


def tuned_gate(label, err, twin, tier_err):
    """The accuracy gate of PERF.md section 2 for a tuned winner, and its
    bound: 5e-4 on an exact or split wire at an exact tier; else within
    10% of ``twin`` (the error of the unfused ``cuda`` plan on the same
    wire, transport and K), plus ``tier_err`` (the measured round-trip
    error of a reduced matmul tier, which the budget admitted)."""
    wire = label.split("+w")[1] if "+w" in label else None
    if wire in (None, "split") and not tier_err:
        return err <= TOL, TOL
    bound = 1.1 * twin + tier_err + 1e-7
    return err <= bound, bound


def twin_error(torch, plan_fn, label, inp, ref, dev):
    """The error against ``ref`` of the plan ``plan_fn`` builds with a
    tuned winner's transport, K and wire on the unfused ``cuda``
    executor."""
    decomp, alg, _, k, wire = _cand_fields(label)
    twin = plan_fn(executor="cuda", decomposition=decomp, algorithm=alg,
                   overlap_chunks=k, wire_dtype=wire or "none", device=dev)
    return rel_err(torch, twin(inp), ref)[0]


def check_tuner(torch, dfft, cf, cfu, dev, card, n=512):
    """Phase 16: measured planning at n^3 on one card, with a wisdom
    store and profile of the run's own: calibrate() (every field a card
    can give must be measured), after which the launch counts restart
    from 0; executor="auto" on the single and 4-rank slab C2C plans;
    tune="measure" on the slab C2C plan and its wisdom replay (same
    winner, no timing execution, the same bits); tune="measure" with
    max_roundtrip_err on the slab R2C and C2R plans and the slab Poisson
    op, their survivor cap the least that holds a cuda and a cuda+fuse
    candidate (the C2R tournament's fused candidates must launch the
    encode kernel); tune_concurrent_width on two slab plans. Every
    tournament fails on a candidate that did not build or has no finite
    time. Returns the tournaments, calibrate()'s launches and the path of
    the calibrated profile (the explain phase reads it)."""
    import tempfile

    import functools

    from distributedfft_tpu_torch import calibrate, tuner
    from distributedfft_tpu_torch import operators as dop
    from distributedfft_tpu_torch.ops.executors import (
        executor_roundtrip_error)
    from distributedfft_tpu_torch.parallel.exchange import WIRE_DTYPES
    from distributedfft_tpu_torch.utils import metrics

    shape = (n, n, n)
    world = dfft.make_world(SLAB_RANKS)
    store = tempfile.mkdtemp(prefix="dfft_tune_")
    saved = {k: os.environ.get(k) for k in
             list(TUNE_ENV) + ["DFFT_WISDOM", "DFFT_HW_PROFILE",
                               "DFFT_TUNE_MAX"]}
    os.environ.update(TUNE_ENV, DFFT_WISDOM=os.path.join(store, "w.jsonl"),
                      DFFT_HW_PROFILE=os.path.join(store, "hw.json"))
    os.environ.pop("DFFT_TUNE_MAX", None)
    metrics.metrics_reset()
    metrics.enable_metrics()
    out = {}
    try:
        prof = calibrate.calibrate(iters=10, device=dev)
        print(f"calibrated profile [{card}]:\n"
              + calibrate.format_profile(prof), flush=True)
        print("calibrated profile JSON: " + json.dumps(prof, sort_keys=True),
              flush=True)
        need = ("hbm_gbps", "peak_tflops", "launch_seconds", "fuse_speedup",
                "mm_bf16_tflops", "mm_f32_tflops", "mm_highest_tflops")
        nulls = [f for f in need if prof.get(f) is None]
        if nulls:
            fail(f"calibrate() left fields a card can measure null: {nulls}")
        calibrate.write_profile(prof)
        cal = {**cf.launches(), **cfu.launches()}
        print(f"launches of calibrate(): {cal}", flush=True)
        cf.reset_launches()
        cfu.reset_launches()

        def launched(label, before):
            now = {**cf.launches(), **cfu.launches()}
            diff = {k: v - before.get(k, 0) for k, v in now.items()
                    if v != before.get(k, 0)}
            print(f"{label}: the tournament launched {diff}", flush=True)
            return diff

        x = seeded(torch, shape, dev)
        ref = torch.fft.fftn(x)
        with recording_tournaments(tuner) as seen:
            for label, w in (("single", None),
                             (f"slab P={SLAB_RANKS}", world)):
                plan = dfft.plan_dft_c2c_3d(shape, w, executor="auto",
                                            device=dev)
                err = rel_err(torch, plan(x), ref)[0]
                check_tournament(seen[-1], f"auto {label} {n}^3",
                                 ("cuda",), card)
                print(f"auto {label} {n}^3: winner {plan.executor} forward "
                      f"vs torch.fft.fftn max rel err={err:.3e}", flush=True)
                if not err <= TOL:
                    fail(f"auto {label}: error {err:.3e} over {TOL}")
                out[f"auto {label}"] = seen[-1]

            label = f"tune=measure slab P={SLAB_RANKS} c2c {n}^3"
            plan = dfft.plan_dft_c2c_3d(shape, world, tune="measure",
                                        device=dev)
            t = with_model(seen[-1], tuner, shape, world)
            check_tournament(t, label, ("cuda",), card)
            y = plan(x)
            err = rel_err(torch, y, ref)[0]
            win = tuner.tuned_label(plan)
            print(f"{label}: winner {win} forward vs torch.fft.fftn max rel "
                  f"err={err:.3e}", flush=True)
            if not err <= TOL:
                fail(f"{label}: error {err:.3e} over {TOL}")
            out["tune c2c"] = t
            timed = metrics.counter_total("tune_timing_executions")
            dfft.clear_plan_cache()
            again = dfft.plan_dft_c2c_3d(shape, world, tune="wisdom",
                                         device=dev)
            same = torch.equal(again(x), y)
            print(f"tune=wisdom replay: winner {tuner.tuned_label(again)}, "
                  f"timing executions {timed:.0f} before and "
                  f"{metrics.counter_total('tune_timing_executions'):.0f} "
                  f"after, output bit-identical: {same}", flush=True)
            if (tuner.tuned_label(again) != win or not same
                    or metrics.counter_total("tune_timing_executions")
                    != timed):
                fail("the wisdom replay differs from the measured winner")
            del y, ref

            xr = seeded_real(torch, shape, dev)
            cap = survivor_cap(tuner, shape, world, TUNE_BUDGET,
                               tuple(WIRE_DTYPES), (None, "bf16", "f32"),
                               ("cuda", "cuda+fuse"), dev, real=True)
            os.environ["DFFT_TUNE_MAX"] = str(cap)
            label = (f"tune=measure max_roundtrip_err={TUNE_BUDGET} slab "
                     f"P={SLAB_RANKS} r2c {n}^3 (DFFT_TUNE_MAX={cap})")
            before = {**cf.launches(), **cfu.launches()}
            plan = dfft.plan_dft_r2c_3d(shape, world, tune="measure",
                                        max_roundtrip_err=TUNE_BUDGET,
                                        device=dev)
            launched(label, before)
            t = with_model(seen[-1], tuner, shape, world)
            check_tournament(t, label, ("cuda", "cuda+fuse"), card)
            win = tuner.tuned_label(plan)
            spec = torch.fft.rfftn(xr)
            err = rel_err(torch, plan(xr), spec)[0]
            twin = twin_error(torch, functools.partial(
                dfft.plan_dft_r2c_3d, shape, world), win, xr, spec, dev)
            tier = executor_roundtrip_error(_executor_of(win),
                                            torch.complex64, device=dev)
            ok, bound = tuned_gate(win, err, twin, tier)
            print(f"{label}: winner {win} forward vs torch.fft.rfftn max rel "
                  f"err={err:.3e} (gate {bound:.3e}: the unfused cuda plan "
                  f"on its wire {twin:.3e}, its tier {tier:.3e})",
                  flush=True)
            if not ok:
                fail(f"{label}: error {err:.3e} over {bound:.3e}")
            out["tune r2c"] = t

            cap = survivor_cap(tuner, shape, world, TUNE_BUDGET,
                               tuple(WIRE_DTYPES), (None, "bf16", "f32"),
                               ("cuda", "cuda+fuse"), dev, real=True)
            os.environ["DFFT_TUNE_MAX"] = str(cap)
            label = (f"tune=measure max_roundtrip_err={TUNE_BUDGET} slab "
                     f"P={SLAB_RANKS} c2r {n}^3 (DFFT_TUNE_MAX={cap})")
            before = {**cf.launches(), **cfu.launches()}
            plan = dfft.plan_dft_c2r_3d(shape, world, tune="measure",
                                        max_roundtrip_err=TUNE_BUDGET,
                                        device=dev)
            if launched(label, before).get("fft_encode", 0) <= 0:
                fail(f"{label}: its cuda+fuse candidates launched no "
                     f"encode kernel")
            t = with_model(seen[-1], tuner, shape, world)
            check_tournament(t, label, ("cuda", "cuda+fuse"), card)
            win = tuner.tuned_label(plan)
            back = torch.fft.irfftn(spec, s=shape)
            err = rel_err(torch, plan(spec), back)[0]
            twin = twin_error(torch, functools.partial(
                dfft.plan_dft_c2r_3d, shape, world), win, spec, back, dev)
            tier = executor_roundtrip_error(_executor_of(win),
                                            torch.complex64, device=dev)
            ok, bound = tuned_gate(win, err, twin, tier)
            print(f"{label}: winner {win} vs torch.fft.irfftn max rel "
                  f"err={err:.3e} (gate {bound:.3e}: the unfused cuda plan "
                  f"on its wire {twin:.3e}, its tier {tier:.3e})",
                  flush=True)
            if not ok:
                fail(f"{label}: error {err:.3e} over {bound:.3e}")
            out["tune c2r"] = t
            del xr, spec, back

            exact = dop.plan_spectral_op(shape, world, op=dop.poisson(),
                                         device=dev)(x)
            cap = survivor_cap(tuner, shape, world, TUNE_BUDGET,
                               (None, "bf16"), (None,),
                               ("cuda", "cuda+fuse"), dev)
            os.environ["DFFT_TUNE_MAX"] = str(cap)
            label = (f"tune=measure max_roundtrip_err={TUNE_BUDGET} "
                     f"Poisson op slab P={SLAB_RANKS} {n}^3 "
                     f"(DFFT_TUNE_MAX={cap})")
            plan = dop.plan_spectral_op(shape, world, op=dop.poisson(),
                                        tune="measure",
                                        max_roundtrip_err=TUNE_BUDGET,
                                        device=dev)
            t = with_model(seen[-1], tuner, shape, world)
            check_tournament(t, label, ("cuda", "cuda+fuse"), card)
            win = tuner.tuned_label(plan)
            err = rel_err(torch, plan(x), exact)[0]
            twin = twin_error(torch, functools.partial(
                dop.plan_spectral_op, shape, world, op=dop.poisson()), win,
                x, exact, dev)
            ok, bound = tuned_gate(win, err, twin, 0.0)
            print(f"{label}: winner {win} vs the exact op plan max rel "
                  f"err={err:.3e} (gate {bound:.3e}: the unfused cuda op "
                  f"on its wire {twin:.3e})", flush=True)
            if not ok or not err <= OP_WIRE_BOUND:
                fail(f"{label}: error {err:.3e} over {bound:.3e} or "
                     f"{OP_WIRE_BOUND}")
            out["tune op"] = t
            del exact
            os.environ.pop("DFFT_TUNE_MAX", None)

            pair = [dfft.plan_dft_c2c_3d(shape, world, device=dev)
                    for _ in range(2)]
            width = tuner.tune_concurrent_width(pair, [1, 1])
            check_tournament(seen[-1], f"concurrent width slab+slab {n}^3",
                             (), card)
            print(f"tune_concurrent_width(two slab plans): width {width}",
                  flush=True)
            out["width"] = seen[-1]
        snap = metrics.metrics_snapshot()
        hist = snap["histograms"]
        print("tuner metrics: " + json.dumps({
            "tune_timing_executions": metrics.counter_total(
                "tune_timing_executions"),
            "tune_tournaments": snap["counters"].get("tune_tournaments"),
            "tune_wisdom_hits": snap["counters"].get("tune_wisdom_hits"),
            "tune_wisdom_misses": snap["counters"].get(
                "tune_wisdom_misses"),
            "tune_build_seconds_total": sum(
                v["total"] for v in hist.get("tune_build_seconds",
                                             {}).values()),
            "tune_measure_seconds_total": sum(
                v["total"] for v in hist.get("tune_measure_seconds",
                                             {}).values()),
            "tune_model_measured_ratio": snap["gauges"].get(
                "tune_model_measured_ratio")}, sort_keys=True), flush=True)
    finally:
        metrics.enable_metrics(False)
        metrics.metrics_reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        dfft.clear_plan_cache()
        torch.cuda.empty_cache()
    return out, cal, os.path.join(store, "hw.json")


def with_model(t, tuner, shape, world):
    """A tuned tournament with each candidate's model seconds."""
    t["model"] = {c: tuner.model_cost(tuner.Candidate(*_cand_fields(c)),
                                      shape, world) for c in t["names"]}
    return t


def _cand_fields(label: str) -> tuple:
    """A tuned candidate's label back into Candidate's fields."""
    body, _, wire = label.partition("+w")
    decomp, alg, ex, ov = body.split("/")
    return decomp, alg, ex, int(ov.removeprefix("ov")), wire or None


# ------------------------------------------------- explain and attribution

#: Measured passes of each explain record (its device samples per stage).
EXPLAIN_ITERS = 5
#: Device stage medians may exceed the host brackets' by this factor at
#: most: a synchronised stage's device time lies inside its bracket.
DEVICE_OVER_HOST = 1.05


def explain_rows(rec) -> list[str]:
    """One line per stage of an explain record: model, host-bracket and
    device ms, device / model and the divergence verdict."""
    host = rec["timing"].get("host_stage_seconds") or {}
    rows = []
    for key, st in rec["stages"].items():
        m = st["model"].get("seconds", 0.0)
        dev_s = st["measured"]["seconds"]
        h = host.get(key)
        ratio = dev_s / m if dev_s and m else None
        rows.append(
            f"  {key:<5} model {m * 1e3:.4f} ms | host "
            + ("-" if h is None else f"{h * 1e3:.4f}") + " ms | device "
            + ("-" if dev_s is None else f"{dev_s * 1e3:.4f}") + " ms | "
            + ("-" if ratio is None else f"x{ratio:.2f}")
            + f" | diverged {st['divergence'].get('diverged')}")
    return rows


def check_explain_record(label, rec, need, secs, card, n=512):
    """Print one explain record (per-stage rows, memory view, overlap and
    fusion blocks) and fail unless its stages come from the device
    timeline, each stage in ``need`` has device time in every pass, the
    device medians sum to at most 1.05x the host brackets' and the
    memory view has a peak."""
    timing, comp = rec["timing"], rec["compiled"] or {}
    tot = rec["totals"]
    print(f"explain {label} {n}^3 ({secs:.1f} s; timing {timing['source']}"
          f" (pads of {timing.get('device_pad_launches')} launches)"
          f"; peak_hbm_bytes {comp.get('peak_hbm_bytes')}, argument "
          f"{comp.get('argument_bytes')}, output {comp.get('output_bytes')}"
          f", temp {comp.get('temp_bytes')}; model total "
          f"{tot['model_seconds'] * 1e3:.4f} ms, device stages "
          f"{(tot['measured_stage_seconds'] or 0.0) * 1e3:.4f} ms; diverged "
          f"{rec['divergence']['stages']}) [{card}]:\n"
          + "\n".join(explain_rows(rec)), flush=True)
    for key in ("overlap", "fusion"):
        if rec.get(key) is not None:
            print(f"  {key}: {json.dumps(rec[key], sort_keys=True)}",
                  flush=True)
    if timing["source"] != "device":
        fail(f"explain {label}: timing from {timing['source']} "
             f"({timing.get('fallback_reason')})")
    # a pass with no device time under a stage is a pass the trace lost
    missing = [k for k in need
               if not rec["stages"][k]["measured"]["samples"]
               or min(rec["stages"][k]["measured"]["samples"]) <= 0.0]
    if missing:
        fail(f"explain {label}: a pass without device samples for "
             f"{missing}")
    host = timing.get("host_stage_seconds") or {}
    dev_sum = sum(st["measured"]["seconds"] or 0.0
                  for st in rec["stages"].values())
    host_sum = sum(v for v in host.values() if v)
    if not dev_sum <= DEVICE_OVER_HOST * host_sum:
        fail(f"explain {label}: device stage medians {dev_sum * 1e3:.4f} ms "
             f"over {DEVICE_OVER_HOST}x the host brackets' "
             f"{host_sum * 1e3:.4f} ms")
    if comp.get("peak_hbm_bytes") is None:
        fail(f"explain {label}: no peak_hbm_bytes")


def check_explain(torch, dfft, dev, here, card, hw_path, n=512):
    """Phase 17: ``dfft.explain`` at n^3 (``iters=5``,
    ``device_timing=True``) on the single plan, the slab C2C forward (with
    ``concurrent=2``) and backward on 4 loopback ranks, the slab R2C, the
    2x2 pencil, the slab Poisson op, the slab C2C at K = 2 and the split
    fused 2x2 pencil, under the measured-planning phase's calibrated
    profile (``hw_path``); each record checked by
    :func:`check_explain_record`, the slab forward's table printed. Fails
    unless the profile is the card's calibrated one, the two overlap
    blocks are there and the fused plan's fusion is active. The records
    go to chiprun_out/explain_records.jsonl."""
    from distributedfft_tpu_torch import operators as dop
    from distributedfft_tpu_torch.explain import device_profile, format_explain

    shape = (n, n, n)
    world = dfft.make_world(SLAB_RANKS)
    slab, pencil = ("t0", "t2", "t3"), ("t0", "t1", "t2", "t3")
    slab_fwd = f"slab fwd P={SLAB_RANKS}"
    slab_k2 = f"slab fwd K=2 P={SLAB_RANKS}"
    cases = [
        ("single", dfft.plan_dft_c2c_3d(shape, None, device=dev), {},
         ("t0", "t3")),
        (slab_fwd, dfft.plan_dft_c2c_3d(shape, world, device=dev),
         {"concurrent": 2}, slab),
        (f"slab bwd P={SLAB_RANKS}",
         dfft.plan_dft_c2c_3d(shape, world, direction=dfft.BACKWARD,
                              device=dev), {}, slab),
        (f"slab r2c P={SLAB_RANKS}",
         dfft.plan_dft_r2c_3d(shape, world, device=dev), {}, slab),
        ("pencil 2x2", dfft.plan_dft_c2c_3d(shape, PENCIL_GRID, device=dev),
         {}, pencil),
        (f"poisson op slab P={SLAB_RANKS}",
         dop.plan_spectral_op(shape, world, op=dop.poisson(), device=dev),
         {}, slab + ("t_mid",)),
        (slab_k2, dfft.plan_dft_c2c_3d(shape, world, overlap_chunks=2,
                                       device=dev), {}, slab),
        ("pencil 2x2 split fused",
         dfft.plan_dft_c2c_3d(shape, PENCIL_GRID, wire_dtype="split",
                              fuse=True, device=dev), {}, pencil),
    ]
    saved = os.environ.get("DFFT_HW_PROFILE")
    os.environ["DFFT_HW_PROFILE"] = hw_path
    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    records = {}
    try:
        hw = device_profile()
        print(f"explain hw profile: {json.dumps(hw, sort_keys=True)} "
              f"[{card}]", flush=True)
        if (hw["source"], hw["device_kind"]) != (
                "calibrated", torch.cuda.get_device_name(0)):
            fail(f"explain: the profile is {hw['source']} for "
                 f"{hw['device_kind']!r}, not the calibrated card's")
        with open(os.path.join(out_dir, "explain_records.jsonl"), "w") as f:
            for label, plan, kw, need in cases:
                t = time.perf_counter()
                rec = dfft.explain(plan, iters=EXPLAIN_ITERS,
                                   device_timing=True, **kw)
                secs = time.perf_counter() - t
                f.write(json.dumps(dict(rec, label=label)) + "\n")
                records[label] = rec
                check_explain_record(label, rec, need, secs, card, n)
    finally:
        if saved is None:
            os.environ.pop("DFFT_HW_PROFILE", None)
        else:
            os.environ["DFFT_HW_PROFILE"] = saved
    for label, kind in ((slab_fwd, "concurrent"), (slab_k2, "overlap_k")):
        ov = records[label]["overlap"]
        if ov is None or ov["kind"] != kind:
            fail(f"explain {label}: no {kind} overlap block ({ov})")
    fu = records["pencil 2x2 split fused"]["fusion"]
    if not (fu and fu["active"] and fu["sites"]):
        fail(f"explain pencil split fused: fusion block {fu}")
    print(format_explain(records[slab_fwd]), flush=True)
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()
    return records


#: Phase 18's sizes: the batched C2C, R2C and shadow-audit queues at
#: SERVE_N^3, the streaming and robustness queues at STREAM_N^3.
SERVE_N = 512
STREAM_N = 256
#: The streaming queue's batch quantum and the phase's time limit (s).
STREAM_BATCH = 8
SERVE_PHASE_LIMIT_S = 90.0
#: The streaming queue's two tenants (a DFFT_QOS spec).
STREAM_QOS = "rt:class=realtime,weight=1,slo=5;bulk:class=batch,weight=1"


def serving_cases(m, max_b=STREAM_BATCH, ranks=SLAB_RANKS):
    """The kernel cases the streaming and robustness queues launch at
    m^3 on ``ranks`` ranks: the slab C2C forward and backward at every
    batch 1..max_b a wave can take (the streaming loop takes whatever a
    group holds when it wakes)."""
    q = m // ranks
    out = []
    for b in range(1, max_b + 1):
        out += [("fft2_last", True, (b * q, m, m), f"serve b={b} slab fwd t0"),
                ("fft_axis0", True, (b, m, q * m), f"serve b={b} slab fwd t3"),
                ("fft_axis0", False, (b, m, q * m),
                 f"serve b={b} slab bwd t0"),
                ("fft_last", False, (b * q * m, m),
                 f"serve b={b} slab bwd t0 rows"),
                ("fft_axis0", False, (b * q, m, m),
                 f"serve b={b} slab bwd t3")]
    return out


def serving_fused_cases(n, b=2, grid=PENCIL_GRID):
    """The fused-kernel cases the shadow-audited queue adds: the split
    fused 2x2 pencil C2C at batch b (the batch a leading axis of each
    fused stage's block)."""
    m = n // grid[0]
    return [
        ("fft_encode", "split", True, (b, m, m, n), 3, 2,
         f"serve b={b} pencil fwd t0_fft_z, cols=1"),
        ("decode_fft", "split", True, (b, m, n, m), 2, 2,
         f"serve b={b} pencil fwd t1_fft_y"),
        ("decode_fft", "split", True, (b, n, m, m), 1, 2,
         f"serve b={b} pencil fwd t3_fft_x"),
        ("fft_encode", "split", False, (b, n, m, m), 1, 2,
         f"serve b={b} pencil bwd t0_fft_x"),
        ("decode_fft", "split", False, (b, m, n, m), 2, 2,
         f"serve b={b} pencil bwd t1_fft_y"),
        ("decode_fft", "split", False, (b, m, m, n), 3, 2,
         f"serve b={b} pencil bwd t3_fft_z, cols=1"),
    ]


def _counter(snap, name, **labels) -> float:
    """The metrics snapshot's counter ``name`` summed over the label sets
    that hold every ``labels`` pair."""
    want = [f"{k}={v}" for k, v in labels.items()]
    return sum(v for lbl, v in snap["counters"].get(name, {}).items()
               if all(w in lbl.split(",") for w in want))


def _hist(snap, name) -> dict:
    return snap["histograms"].get(name, {}).get("kind=c2c", {})


RECOVERY = ("serving_retries", "serving_degraded",
            "serving_isolated_failures")


def _result(h, what):
    """``h.result(timeout=60)``, failing the phase on a timeout."""
    try:
        return h.result(timeout=60)
    except TimeoutError:
        fail(f"serving {what}: result() timed out")


def _within_tier(torch, got, want, what, tol=TOL):
    err, l2, _ = rel_err(torch, got, want)
    if not max(err, l2) <= tol:
        fail(f"serving {what}: rel err max {err:.3e} l2 {l2:.3e} > {tol}")
    return err, l2


def _fallbacks(metrics):
    return (metrics.counter_total("pallas_fallback"),
            metrics.counter_total("fusion_fallback"))


def _guard_clean(metrics, what, fallbacks0=None):
    """Fail when ``what`` counted a retry, a degraded rebuild, an
    isolated failure, or (``fallbacks0``: the counts before it) a kernel
    or fusion fallback."""
    snap = metrics.metrics_snapshot()
    moved = {k: _counter(snap, k) for k in RECOVERY if _counter(snap, k)}
    if moved:
        fail(f"serving {what}: recovery ran outside the robustness case: "
             f"{moved}")
    if fallbacks0 is not None:
        now = _fallbacks(metrics)
        if now != fallbacks0:
            fail(f"serving {what}: pallas_fallback/fusion_fallback moved "
                 f"{fallbacks0} -> {now}")


def serve_c2c(torch, dfft, metrics, dev, card, n=SERVE_N):
    """Phase 18a: a C2C queue (cuda, max_batch=2) on the slab world at
    n^3: 4 forward then 4 backward requests, two batched flushes of each
    direction, each result against the unbatched plan (bit equality
    printed, 5e-4 enforced) and torch.fft; then 8 requests through the
    queue against 8 direct plan calls (median of 5)."""
    shape = (n, n, n)
    world = dfft.make_world(SLAB_RANKS)
    fb0 = _fallbacks(metrics)
    q = dfft.CoalescingQueue(world, max_batch=2, device=dev)
    fwd = dfft.plan_dft_c2c_3d(shape, world, device=dev)
    bwd = dfft.plan_dft_c2c_3d(shape, world, direction=dfft.BACKWARD,
                               device=dev)
    xs = [seeded(torch, shape, dev, SEED + 180 + i) for i in range(4)]
    hf = [q.submit(x) for x in xs]
    mid = _hist(metrics.metrics_snapshot(), "serving_batch_size")
    hb = [q.submit(x, direction=dfft.BACKWARD) for x in xs]
    q.flush()
    snap = metrics.metrics_snapshot()
    bs = _hist(snap, "serving_batch_size")
    if (mid.get("count"), bs.get("count"), bs.get("min"), bs.get("max")) \
            != (2, 4, 2.0, 2.0):
        fail(f"serving c2c: expected two batch-2 flushes per direction, "
             f"serving_batch_size after the forward {mid}, after all {bs}")
    bits = []
    for label, hs, plan, lib in (("fwd", hf, fwd, torch.fft.fftn),
                                 ("bwd", hb, bwd, torch.fft.ifftn)):
        for i, (x, h) in enumerate(zip(xs, hs)):
            y = _result(h, f"c2c {label} #{i}")
            ref = plan(x)
            bits.append(torch.equal(y, ref))
            e_plan = _within_tier(torch, y, ref,
                                  f"c2c {label} #{i} vs unbatched plan")
            e_lib = _within_tier(torch, y, lib(x),
                                 f"c2c {label} #{i} vs torch.fft")
            print(f"serving c2c {n}^3 P={SLAB_RANKS} {label} #{i}: "
                  f"bit-equal to the unbatched plan: {bits[-1]}; vs plan "
                  f"max/l2 {e_plan[0]:.3e}/{e_plan[1]:.3e}; vs torch.fft "
                  f"max/l2 {e_lib[0]:.3e}/{e_lib[1]:.3e}", flush=True)
            del y, ref
    del hf, hb
    _guard_clean(metrics, "c2c", fb0)
    # 8 requests through the queue against 8 direct calls
    x0 = xs[0]
    del xs
    torch.cuda.empty_cache()

    def through_queue():
        hs = [q.submit(x0) for _ in range(8)]
        return [_result(h, "c2c timing") for h in hs]

    def direct():
        ys = [fwd(x0) for _ in range(8)]
        torch.cuda.synchronize()
        return ys

    times = {}
    metrics.metrics_reset()
    for label, fn in (("queue", through_queue), ("direct", direct)):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            t = time.perf_counter()
            ys = fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
            del ys
        times[label] = sorted(ts)[2]
    ratio = times["queue"] / times["direct"]
    wait = _hist(metrics.metrics_snapshot(), "serving_wait_seconds")
    print(f"serving c2c {n}^3 P={SLAB_RANKS} 8 requests (max_batch=2, 4 "
          f"flushes): queue_ms={times['queue'] * 1e3:.3f} "
          f"({8 / times['queue']:.2f} transforms/s) direct_ms="
          f"{times['direct'] * 1e3:.3f} ({8 / times['direct']:.2f} "
          f"transforms/s) queue/direct={ratio:.4f} (median of 5); "
          f"serving_wait_seconds over the 48 timed requests p50="
          f"{wait['p50'] * 1e3:.3f} ms p99={wait['p99'] * 1e3:.3f} ms "
          f"[{card}]", flush=True)
    _guard_clean(metrics, "c2c timing", fb0)
    q.close()
    return dict(bit_equal=all(bits), queue_s=times["queue"],
                direct_s=times["direct"])


def serve_r2c(torch, dfft, metrics, dev, n=SERVE_N):
    """Phase 18b: an R2C queue (max_batch=2) on the slab world at n^3:
    two forward requests against torch.fft.rfftn."""
    world = dfft.make_world(SLAB_RANKS)
    fb0 = _fallbacks(metrics)
    q = dfft.CoalescingQueue(world, kind="r2c", max_batch=2, device=dev)
    xs = [seeded_real(torch, (n, n, n), dev, SEED + 190 + i)
          for i in range(2)]
    hs = [q.submit(x) for x in xs]
    for i, (x, h) in enumerate(zip(xs, hs)):
        y = _result(h, f"r2c #{i}")
        err = _within_tier(torch, y, torch.fft.rfftn(x),
                           f"r2c #{i} vs torch.fft.rfftn")
        print(f"serving r2c {n}^3 P={SLAB_RANKS} #{i}: shape "
              f"{list(y.shape)} vs torch.fft.rfftn max/l2 "
              f"{err[0]:.3e}/{err[1]:.3e}", flush=True)
        del y
    _guard_clean(metrics, "r2c", fb0)
    q.close()


def serve_streaming(torch, dfft, metrics, dev, card, hw_path, m=STREAM_N):
    """Phase 18c: the streaming drain loop at m^3 on the slab world
    (max_batch=8, concurrent_groups="auto" priced by the calibrated
    profile, a realtime and a batch tenant): two threads submit 32
    requests, forward and backward mixed, twice (a cold round that
    builds each batch size's plan, then a warm one); every result within
    the tier of torch.fft, stop() within 10 s; then a round at a fixed
    width of 2 (:func:`serve_width2`), after the monitored round
    (:func:`serve_monitored`); the same 32 transforms as direct calls of
    the unbatched plans for the ratio."""
    from distributedfft_tpu_torch import qos

    world = dfft.make_world(SLAB_RANKS)
    saved = {k: os.environ.get(k) for k in ("DFFT_HW_PROFILE",
                                            "DFFT_WIDTH_TOURNAMENT")}
    os.environ.pop("DFFT_WIDTH_TOURNAMENT", None)
    if hw_path:
        os.environ["DFFT_HW_PROFILE"] = hw_path
    try:
        pol = dfft.QosPolicy.from_spec(STREAM_QOS)
        q = dfft.CoalescingQueue(world, max_batch=STREAM_BATCH,
                                 concurrent_groups="auto", policy=pol,
                                 device=dev)
        xs = [seeded(torch, (m, m, m), dev, SEED + 200 + i)
              for i in range(4)]
        refs = {(i, d): (torch.fft.fftn if d == dfft.FORWARD
                         else torch.fft.ifftn)(x)
                for i, x in enumerate(xs)
                for d in (dfft.FORWARD, dfft.BACKWARD)}
        reqs = [((k + j) % 4, dfft.FORWARD if j % 2 == 0 else dfft.BACKWARD)
                for k in range(2) for j in range(16)]
        torch.cuda.synchronize()

        q.serve()
        rounds = {}
        warm = {}
        for label in ("cold", "warm"):
            metrics.metrics_reset()
            t0 = time.perf_counter()
            got = stream_round(q, xs, reqs, "streaming")
            worst = 0.0
            for tenant, hs in got.items():
                for j, (i, d, h) in enumerate(hs):
                    y = _result(h, f"streaming {tenant}")
                    worst = max(worst, *_within_tier(
                        torch, y, refs[(i, d)], f"streaming {tenant} #{i}"))
                    if label == "warm":
                        warm[(tenant, j)] = y
            secs = time.perf_counter() - t0
            snap = metrics.metrics_snapshot()
            _guard_clean(metrics, f"streaming {label}", (0.0, 0.0))
            rounds[label] = (secs, worst, _hist(snap, "serving_wait_seconds"),
                             _counter(snap, "serving_flushes"))
        t_stop = time.perf_counter()
        q.stop(timeout=10)
        stop_s = time.perf_counter() - t_stop
        if stop_s > 10 or q._serve_thread is not None:
            fail(f"serving streaming: stop() took {stop_s:.1f} s")
        plans = {d: dfft.plan_dft_c2c_3d((m, m, m), world, direction=d,
                                         device=dev)
                 for d in (dfft.FORWARD, dfft.BACKWARD)}
        for _ in range(2):             # the second pass is warm
            t = time.perf_counter()
            for i, d in reqs:
                plans[d](xs[i])
            torch.cuda.synchronize()
            direct_s = time.perf_counter() - t
        for label, (secs, worst, wait, flushes) in rounds.items():
            print(f"serving streaming {m}^3 P={SLAB_RANKS} {label} round (2 "
                  f"threads, 32 requests, max_batch={STREAM_BATCH}): "
                  f"{32 / secs:.2f} transforms/s ({secs * 1e3:.1f} ms, "
                  f"submit to the last result; the same 32 as direct calls "
                  f"{direct_s * 1e3:.1f} ms, ratio {secs / direct_s:.4f}), "
                  f"flushes {flushes:.0f}, serving_wait_seconds p50="
                  f"{wait['p50'] * 1e3:.3f} ms p99={wait['p99'] * 1e3:.3f} "
                  f"ms, worst rel err vs torch.fft {worst:.3e} [{card}]",
                  flush=True)
        widths = sorted(set(q._auto_widths.values()))
        print(f"serving streaming: widths chosen {widths}, stop() "
              f"{stop_s:.3f} s; waves of both rounds: "
              f"{json.dumps(q._wave_stats.snapshot(), sort_keys=True)}",
              flush=True)
        print(f"serving streaming slo_report: "
              f"{json.dumps(pol.slo_report(), sort_keys=True)}", flush=True)
        qos.write_ledger(pol, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), QOS_LEDGER))
        q.close()
        monitored = serve_monitored(torch, dfft, metrics, world, xs, reqs,
                                    warm, 32 / rounds["warm"][0], dev, card,
                                    m)
        del warm
        serve_width2(torch, dfft, metrics, world, xs, refs, dev, card, m)
        return dict(rates={k: 32 / v[0] for k, v in rounds.items()},
                    widths=widths, monitored=monitored)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def stream_round(q, xs, reqs, what):
    """One streaming round: two client threads (tenants ``rt`` and
    ``bulk``) each submit their 16 requests of ``reqs`` to ``q``;
    returns ``{tenant: [(i, direction, handle), ...]}`` in submit
    order."""
    import threading

    got = {"rt": [], "bulk": []}

    def client(tenant, seed):
        for j in range(16):
            i, d = reqs[16 * seed + j]
            got[tenant].append((i, d, q.submit(xs[i], direction=d,
                                               tenant=tenant)))

    threads = [threading.Thread(target=client, args=(t, k))
               for k, t in enumerate(("rt", "bulk"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        if t.is_alive():
            fail(f"serving {what}: a client thread did not finish its "
                 f"submits within 10 s")
    return got


#: Phase 18f's sampling interval (s) and series file (under the
#: checkout's chiprun_out/).
MONITOR_INTERVAL_S = 0.05
MONITOR_SERIES = os.path.join("chiprun_out", "monitor.jsonl")
#: Phase 18c's QoS ledger (``qos.write_ledger`` after the warm round).
QOS_LEDGER = os.path.join("chiprun_out", "qos_ledger.json")
#: Phase 18f's sampler-cost blocks on one queue: MONITOR_PAIRS pairs of
#: blocks, the sampler on then off and off then on in turn, each block
#: at least MONITOR_BLOCK_S of back-to-back rounds. The rate drifts from
#: block to block (it fell by a third over six blocks on the H100, in
#: both states), so the cost is read within each pair.
MONITOR_PAIRS = 10
MONITOR_BLOCKS = tuple(st for p in range(MONITOR_PAIRS)
                       for st in (("on", "off") if p % 2 == 0
                                  else ("off", "on")))
MONITOR_BLOCK_S = 1.0


def _monitored_block(torch, q, xs, reqs, warm, min_s):
    """Streaming rounds on ``q`` back to back, one at least, until their
    summed time (each from the first submit to its last result) reaches
    ``min_s``;
    each result is compared with the unmonitored warm round's for the
    same request after its round's clock stopped. Returns (rounds,
    seconds, results not bit-equal)."""
    rounds, secs, unequal = 0, 0.0, 0
    while rounds == 0 or secs < min_s:
        t0 = time.perf_counter()
        got = stream_round(q, xs, reqs, "monitored")
        ys = {(tenant, j): _result(h, f"monitored {tenant}")
              for tenant, hs in got.items()
              for j, (_i, _d, h) in enumerate(hs)}
        secs += time.perf_counter() - t0
        rounds += 1
        unequal += sum(not torch.equal(y, warm[k]) for k, y in ys.items())
        del got, ys
    return rounds, secs, unequal


def serve_monitored(torch, dfft, metrics, world, xs, reqs, warm, warm_rate,
                    dev, card, m):
    """Phase 18f: (c)'s rounds again on a queue made under
    ``DFFT_MONITOR=0.05,chiprun_out/monitor.jsonl`` (same tenants, width
    rule, threads and requests): a cold and a warm round, then the
    sampler's cost as MONITOR_BLOCKS, blocks of rounds with the sampler
    thread started or stopped on this one queue. Every result equal to
    the unmonitored warm round's for the same request bit for bit; the
    sampler thread itself (not ``stop()``'s final samples) took at least
    on_s / 0.05 / 2 samples (on_s: the time it ran) and failed none
    (``Monitor.errors`` 0); the series holds every sample of schema 4
    with a ``waves`` block and ``load_series`` reads it back;
    ``health_from_samples`` fires no alert; ``serving_stalls`` is 0;
    kernels 1-3 launched, no fallback and no recovery. Prints the warm
    round's transforms/s beside the unmonitored warm round's, and the
    medians of the blocks with the sampler on and off, the on/off
    ratio within each pair and the host time of one ``sample()`` (the
    sampler's host cost; printed, not gated). Returns the figures."""
    from distributedfft_tpu_torch import monitor
    from distributedfft_tpu_torch.ops import cuda_fft as cf

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        MONITOR_SERIES)
    if os.path.exists(path):
        os.remove(path)
    metrics.metrics_reset()
    before, fb0 = cf.launches(), dict(cf.FALLBACKS)
    saved = os.environ.get("DFFT_MONITOR")
    os.environ["DFFT_MONITOR"] = f"{MONITOR_INTERVAL_S:g},{path}"
    try:
        q = dfft.CoalescingQueue(world, max_batch=STREAM_BATCH,
                                 concurrent_groups="auto",
                                 policy=dfft.QosPolicy.from_spec(STREAM_QOS),
                                 device=dev)
    finally:
        if saved is None:
            os.environ.pop("DFFT_MONITOR", None)
        else:
            os.environ["DFFT_MONITOR"] = saved
    t_on, seq_on = time.perf_counter(), 0
    mon = q._monitor
    if mon is None or q._wave_stats is None or mon._thread is None:
        fail(f"serving monitored: DFFT_MONITOR armed no running monitor "
             f"({mon}) or no wave stats ({q._wave_stats})")
    on_s, by_thread, stops = 0.0, 0, 0

    def sampler_off():
        nonlocal on_s, by_thread, stops
        by_thread += mon._seq - seq_on
        on_s += time.perf_counter() - t_on
        mon.stop()                     # takes one final sample
        stops += 1

    q.serve()
    secs, unequal = {}, 0
    for label in ("cold", "warm"):
        _, secs[label], bad = _monitored_block(torch, q, xs, reqs, warm, 0.0)
        unequal += bad
    blocks = []
    for state in MONITOR_BLOCKS:
        if state == "on" and mon._thread is None:
            mon.start()
            t_on, seq_on = time.perf_counter(), mon._seq
        elif state == "off" and mon._thread is not None:
            sampler_off()
        rounds, block_s, bad = _monitored_block(torch, q, xs, reqs, warm,
                                                MONITOR_BLOCK_S)
        unequal += bad
        blocks.append((state, rounds, block_s, 32 * rounds / block_s))
    if mon._thread is not None:
        sampler_off()
    sample_s = []
    for _ in range(20):                # on the idle queue, sampler off
        t0 = time.perf_counter()
        mon.sample()
        sample_s.append(time.perf_counter() - t0)
    q.stop(timeout=10)
    if q._serve_thread is not None:
        fail("serving monitored: stop() did not end the loop")
    q.close()
    if mon._thread is not None:
        fail("serving monitored: close() left the sampler running")
    n_results = 32 * (2 + sum(b[1] for b in blocks))
    if unequal:
        fail(f"serving monitored: {unequal} of {n_results} results differ "
             f"from the unmonitored warm round's")
    samples = monitor.load_series(path)
    need = on_s / MONITOR_INTERVAL_S / 2
    bad = [s.get("seq") for s in samples
           if s.get("schema") != monitor.MONITOR_SCHEMA
           or not isinstance((s.get("queue") or {}).get("waves"), dict)]
    if by_thread < need or mon.errors or len(samples) < by_thread or bad:
        fail(f"serving monitored: the sampler thread took {by_thread} "
             f"samples in {on_s:.3f} s (need >= {need:.1f}) and failed "
             f"{mon.errors}; the series holds {len(samples)}; samples "
             f"without schema {monitor.MONITOR_SCHEMA} or a waves block: "
             f"{bad}")
    verdict = monitor.health_from_samples(samples)
    stalls = metrics.counter_total("serving_stalls")
    if verdict["status"] == "alert" or stalls \
            or samples[-1]["queue"]["stalls_total"]:
        fail(f"serving monitored: health {verdict['status']} "
             f"{verdict['alerts']}, serving_stalls {stalls}")
    _guard_clean(metrics, "monitored", (0.0, 0.0))
    if dict(cf.FALLBACKS) != fb0:
        fail(f"serving monitored: a kernel fallback {dict(cf.FALLBACKS)}")
    launched = {k: v - before[k] for k, v in cf.launches().items()}
    for k in ("fft2_last", "fft_axis0", "fft_last"):
        if launched[k] <= 0:
            fail(f"serving monitored: kernel {k} was not launched")
    rate = 32 / secs["warm"]
    on = statistics.median(b[3] for b in blocks if b[0] == "on")
    off = statistics.median(b[3] for b in blocks if b[0] == "off")
    pairs = [{st: v for st, _r, _t, v in blocks[i:i + 2]}
             for i in range(0, len(blocks), 2)]
    ratios = [p["on"] / p["off"] for p in pairs]
    slower = sum(r < 1 for r in ratios)
    q1, _, q3 = statistics.quantiles(
        [b[3] for b in blocks if b[0] == "off"], n=4)
    print(f"serving monitored {m}^3 P={SLAB_RANKS} rounds (DFFT_MONITOR="
          f"{MONITOR_INTERVAL_S:g}, 2 threads, 32 requests each, max_batch="
          f"{STREAM_BATCH}): warm {rate:.2f} transforms/s "
          f"({secs['warm'] * 1e3:.1f} ms) against the unmonitored warm "
          f"round's {warm_rate:.2f} (monitored/unmonitored "
          f"{rate / warm_rate:.4f}), cold {32 / secs['cold']:.2f} "
          f"({secs['cold'] * 1e3:.1f} ms); all {n_results} results "
          f"bit-equal to the unmonitored warm round's; {by_thread} samples "
          f"taken by the sampler thread in {on_s:.3f} s (need >= "
          f"{need:.1f}), {stops} at stop(), {len(samples)} in the series, "
          f"schema {monitor.MONITOR_SCHEMA}, sampler errors {mon.errors}; "
          f"health {verdict['status']} {verdict['alerts']}; serving_stalls "
          f"{stalls:.0f}; kernel launches {launched}; last sample's waves "
          f"{json.dumps(samples[-1]['queue']['waves'], sort_keys=True)} "
          f"[{card}]", flush=True)
    print(f"serving monitored: the sampler's host cost on one queue, "
          f"blocks of >= {MONITOR_BLOCK_S:g} s of rounds (state, rounds, "
          f"seconds, transforms/s): "
          + "; ".join(f"{st} {r} {t:.3f} {v:.2f}" for st, r, t, v in blocks)
          + f"; median on {on:.2f}, off {off:.2f} (off quartiles {q1:.2f} "
          f"- {q3:.2f}); on/off within each pair "
          + " ".join(f"{r:.4f}" for r in ratios)
          + f", median {statistics.median(ratios):.4f}, on slower in "
          f"{slower} of {len(ratios)} pairs; one sample() on the idle "
          f"queue {statistics.median(sample_s) * 1e3:.3f} ms of host time "
          f"(median of 20) [{card}]", flush=True)
    return dict(rate=rate, cold_rate=32 / secs["cold"], warm_rate=warm_rate,
                samples=len(samples), by_thread=by_thread, on_s=on_s,
                blocks=blocks, median_on=on, median_off=off,
                pair_ratios=ratios, sample_s=statistics.median(sample_s),
                launches=launched)


def serve_width2(torch, dfft, metrics, world, xs, refs, dev, card, m):
    """Phase 18c's fixed-width round: a queue with ``concurrent_groups=2``
    and the same two tenants holds four groups (each tenant's forward
    and backward pair) before its loop starts, so the loop runs two
    waves of two groups, each through the concurrent schedule, the
    second launched before the first's events are awaited. The results
    are read once the loop has taken every group. Every result within
    the tier of torch.fft; two waves of width 2 and two concurrent
    dispatches (no sequential fallback) are checked."""
    metrics.metrics_reset()
    q = dfft.CoalescingQueue(world, max_batch=STREAM_BATCH,
                             concurrent_groups=2,
                             policy=dfft.QosPolicy.from_spec(STREAM_QOS),
                             device=dev)
    got = [(i, d, q.submit(xs[i], direction=d, tenant=t))
           for t in ("rt", "bulk") for d in (dfft.FORWARD, dfft.BACKWARD)
           for i in (0, 1)]
    t0 = time.perf_counter()
    q.serve()
    # result() on a handle still queued would flush its group from this
    # thread: let the loop take every group first
    while q.pending() and time.perf_counter() - t0 < 10:
        time.sleep(0.01)
    worst = 0.0
    for i, d, h in got:
        y = _result(h, "streaming width 2")
        worst = max(worst, *_within_tier(torch, y, refs[(i, d)],
                                         f"streaming width 2 #{i}"))
    secs = time.perf_counter() - t0
    q.stop(timeout=10)
    if q._serve_thread is not None:
        fail("serving streaming width 2: stop() did not end the loop")
    waves = q._wave_stats.snapshot()
    conc = _counter(metrics.metrics_snapshot(),
                    "serving_concurrent_dispatches")
    if (waves["waves"], waves["width_max"], waves["width_mean"], conc) \
            != (2, 2.0, 2.0, 2.0):
        fail(f"serving streaming width 2: expected two waves of two groups "
             f"through the concurrent schedule, waves {waves}, "
             f"serving_concurrent_dispatches {conc}")
    _guard_clean(metrics, "streaming width 2", (0.0, 0.0))
    print(f"serving streaming {m}^3 P={SLAB_RANKS} width 2 (4 groups of 2, "
          f"queued before serve()): {len(got)} results in "
          f"{secs * 1e3:.1f} ms, worst rel err vs torch.fft {worst:.3e}; "
          f"waves {json.dumps(waves, sort_keys=True)} [{card}]", flush=True)
    q.close()


def serve_robustness(torch, dfft, metrics, faults, dev, m=STREAM_N):
    """Phase 18d: the recovery chain at m^3 (max_batch=4, retry_max=2):
    a transient ``execute:once`` fault retried once; a deterministic
    fault on every ``cuda`` execution, recovered by one degraded rebuild
    of the group on ``matmul``; a batch with one NaN input, delivered as
    it is while the cohort completes. Faults disarmed afterwards."""
    world = dfft.make_world(SLAB_RANKS)
    shape = (m, m, m)
    xs = [seeded(torch, shape, dev, SEED + 210 + i) for i in range(4)]
    refs = [torch.fft.fftn(x) for x in xs]
    saved = {k: os.environ.get(k) for k in ("DFFT_FAULT_INJECT",
                                            "DFFT_SHADOW_RATE")}

    def flush_group(q, inputs):
        hs = [q.submit(x) for x in inputs]
        q.flush()
        return hs

    try:
        for spec, label in (
                ("execute:once", "transient"),
                ("execute:every=1,kind=deterministic,match=cuda",
                 "deterministic")):
            metrics.metrics_reset()
            os.environ["DFFT_FAULT_INJECT"] = spec
            faults.reset()
            q = dfft.CoalescingQueue(world, max_batch=4, retry_max=2,
                                     device=dev)
            hs = flush_group(q, xs)
            ys = [_result(h, f"robustness {label}") for h in hs]
            snap = metrics.metrics_snapshot()
            counts = {k: _counter(snap, k) for k in RECOVERY}
            counts["fault_injected"] = _counter(snap, "fault_injected")
            degraded = [h.degraded for h in hs]
            for i, (y, ref) in enumerate(zip(ys, refs)):
                _within_tier(torch, y, ref, f"robustness {label} #{i}")
            want = ({"serving_retries": 1.0, "serving_degraded": 0.0,
                     "serving_isolated_failures": 0.0}
                    if label == "transient" else
                    {"serving_retries": 0.0, "serving_degraded": 4.0,
                     "serving_isolated_failures": 0.0})
            if ({k: counts[k] for k in want} != want
                    or any(degraded) != (label != "transient")):
                fail(f"serving robustness {label}: counters {counts}, "
                     f"handles degraded {degraded}")
            print(f"serving robustness {m}^3 {spec!r}: {counts}, "
                  f"degraded rebuilds "
                  f"{counts['serving_degraded'] / len(xs):.0f} (of the "
                  f"group of {len(xs)}; serving_degraded counts its "
                  f"transforms), handles degraded {degraded}, every "
                  f"result within {TOL} of torch.fft", flush=True)
            del ys
            q.close()
        os.environ.pop("DFFT_FAULT_INJECT", None)
        faults.reset()
        metrics.metrics_reset()
        os.environ["DFFT_SHADOW_RATE"] = "0"   # the sentinels alone
        q = dfft.CoalescingQueue(world, max_batch=4, retry_max=2,
                                 device=dev)
        bad = xs[1].clone()
        bad.view(-1)[12345] = complex(float("nan"), 0.0)
        hs = flush_group(q, [xs[0], bad, xs[2], xs[3]])
        ys = [_result(h, "robustness nan") for h in hs]
        snap = metrics.metrics_snapshot()
        nan_in = _counter(snap, "numerics_nonfinite", site="input")
        nan_out = _counter(snap, "numerics_nonfinite", site="output")
        if nan_in != 1 or nan_out != 0 or bool(torch.isfinite(ys[1]).all()):
            fail(f"serving robustness nan: numerics_nonfinite input "
                 f"{nan_in} output {nan_out}, poisoned output finite: "
                 f"{bool(torch.isfinite(ys[1]).all())}")
        for i in (0, 2, 3):
            if not bool(torch.isfinite(ys[i]).all()):
                fail(f"serving robustness nan: cohort member #{i} is not "
                     f"finite")
            _within_tier(torch, ys[i], refs[i], f"robustness nan #{i}")
        _guard_clean(metrics, "nan")
        print(f"serving robustness {m}^3 one NaN input in a batch of 4: "
              f"numerics_nonfinite{{site=input}} {nan_in:.0f}, output "
              f"{nan_out:.0f}; the poisoned output delivered as it is, the "
              f"cohort finite and within {TOL} of torch.fft", flush=True)
        q.close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reset()
    metrics.metrics_reset()


def _with_shadow_rate(rate, build):
    """``build()`` with ``DFFT_SHADOW_RATE`` set to ``rate`` (read when a
    queue is made), the variable restored after."""
    saved = os.environ.get("DFFT_SHADOW_RATE")
    os.environ["DFFT_SHADOW_RATE"] = rate
    try:
        return build()
    finally:
        if saved is None:
            os.environ.pop("DFFT_SHADOW_RATE", None)
        else:
            os.environ["DFFT_SHADOW_RATE"] = saved


def serve_audit(torch, dfft, metrics, numerics, dev, card, n=SERVE_N):
    """Phase 18e: the shadow audit at n^3 (``DFFT_SHADOW_RATE=1,0``,
    max_batch=2) on a queue of split fused plans (``cuda:fuse``) over the
    2x2 pencil world, whose sites run the fused encode and decode (the
    slab C2C's sender is a two-axis stage, so its encode is unfused):
    every request audited against the exact cuda plan, no bucket
    drifting, and each realized error held to the plane's own drift rule
    one audit at a time: at most DEFAULT_SLACK times the admitted budget
    (or the drift floor). The admitted figure is one wire cast's max
    error on a seeded block; the realized one is the L2 error of a whole
    plan with two exchanges, several times larger (the JAX package's
    plans give the same realized errors). The audit's cost is the
    difference of the median batch-2 flush (submit to the last result)
    of this queue and of the same queue with the sentinels alone
    (``DFFT_SHADOW_RATE=0``); returned in seconds."""
    fb0 = _fallbacks(metrics)
    numerics.reset_numerics()

    def make():
        return dfft.CoalescingQueue(PENCIL_GRID, max_batch=2,
                                    executor="cuda:fuse", wire_dtype="split",
                                    device=dev)

    q = _with_shadow_rate("1,0", make)
    q0 = _with_shadow_rate("0", make)
    shape = (n, n, n)
    xs = [seeded(torch, shape, dev, SEED + 220 + i) for i in range(2)]
    for d in (dfft.FORWARD, dfft.BACKWARD):
        hs = [q.submit(x, direction=d) for x in xs]
        got = [_result(h, "audit") for h in hs]
        # each result against the unfused twin (the batch-2 plan of the
        # same wire without fusion), bit for bit: the fused sites run
        # their twins' passes, the last-axis ones in the row form
        twin = dfft.plan_dft_c2c_3d(shape, PENCIL_GRID, wire_dtype="split",
                                    batch=2, direction=d, device=dev)
        report = twin_report(torch, got, list(twin(torch.stack(xs))))
        print(f"serving audit {n}^3 {'fwd' if d == dfft.FORWARD else 'bwd'}:"
              f" the queue's results vs the unfused twin: {report}",
              flush=True)
        if report != "bit-identical":
            fail(f"serving audit: results differ from the unfused twin's: "
                 f"{report}")
        del hs, got, twin
    snap = numerics.numerics_snapshot()
    plan = q._plan(((n, n, n), "complex64", dfft.FORWARD), 2, False)
    admitted = q._admitted_err(plan)
    floor = numerics.drift_floor(torch.complex64)
    limit = numerics.DEFAULT_SLACK * max(admitted, floor)
    rows = list(snap["plans"].values())
    if snap["audited"] != 4 or snap["audit_failures"] or len(rows) != 2:
        fail(f"serving audit: {snap['audited']} audits, "
             f"{snap['audit_failures']} failures, buckets {len(rows)}")
    for row in rows:
        worst = max(row["errors"])
        if row["drifting"] or worst > limit:
            fail(f"serving audit: bucket {row['plan']} realized "
                 f"{row['errors']} against {numerics.DEFAULT_SLACK} x "
                 f"admitted {admitted:.3e} = {limit:.3e}; drifting "
                 f"{row['drifting']}")
        print(f"serving audit {n}^3 {PENCIL_GRID[0]}x{PENCIL_GRID[1]} "
              f"{row['plan']}: n={row['n']} realized "
              f"{[f'{e:.3e}' for e in row['errors']]} admitted "
              f"{admitted:.3e} floor {floor:.3e} realized/(admitted+floor)"
              f"={worst / (admitted + floor):.3f} drift_ratio "
              f"{row['drift_ratio']:.3f} (slack "
              f"{numerics.DEFAULT_SLACK}) drifting {row['drifting']}",
              flush=True)

    def flush_s(queue):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for h in [queue.submit(x) for x in xs]:
            _result(h, "audit timing")
        torch.cuda.synchronize()
        return time.perf_counter() - t

    flush_s(q0)                        # q's plans and reference are warm
    ts = {"audited": [], "sentinels": []}
    for _ in range(5):
        ts["audited"].append(flush_s(q))
        ts["sentinels"].append(flush_s(q0))
    med = {k: sorted(v)[2] for k, v in ts.items()}
    audit_s = med["audited"] - med["sentinels"]
    print(f"serving audit: a batch-2 flush {med['audited'] * 1e3:.3f} ms "
          f"audited (2 exact reference calls and the two norms) against "
          f"{med['sentinels'] * 1e3:.3f} ms with the sentinels alone "
          f"(median of 5 each, interleaved): the audit "
          f"{audit_s * 1e3:.3f} ms a flush [{card}]", flush=True)
    _guard_clean(metrics, "audit", fb0)
    q.close()
    q0.close()
    return audit_s


def check_serving(torch, dfft, dev, card, hw_path, n=SERVE_N, m=STREAM_N):
    """Phase 18: the serving tier on the card (metrics on, counts from 0
    in the caller): the batched C2C queue (a) and its timing, the R2C
    queue (b), the streaming loop (c), the recovery chain (d) and the
    shadow audit (e). Fails past SERVE_PHASE_LIMIT_S. Returns the
    measured figures."""
    from distributedfft_tpu_torch import faults, numerics
    from distributedfft_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    metrics.enable_metrics()
    metrics.metrics_reset()
    out = {"c2c": serve_c2c(torch, dfft, metrics, dev, card, n)}
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()
    serve_r2c(torch, dfft, metrics, dev, n)
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()
    metrics.metrics_reset()
    out["streaming"] = serve_streaming(torch, dfft, metrics, dev, card,
                                       hw_path, m)
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()
    serve_robustness(torch, dfft, metrics, faults, dev, m)
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()
    out["audit"] = serve_audit(torch, dfft, metrics, numerics, dev, card, n)
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()
    metrics.enable_metrics(False)
    secs = time.perf_counter() - t_phase
    print(f"serving phase: {secs:.1f} s", flush=True)
    if secs > SERVE_PHASE_LIMIT_S:
        fail(f"the serving phase took {secs:.1f} s > {SERVE_PHASE_LIMIT_S}")
    return out


#: Phase 19: the load generator's fleet (two workers on the card, their
#: single-device queues at FLEET_SHAPES), the ramp checks at RAMP_N^3
#: (complex64) and the layout check at LAYOUT_N^3 (complex128).
FLEET_SHAPES = ((256, 256, 256), (256, 256, 128))
FLEET_ARGS = ("--procs", "2", "--device", "cuda",
              "--shapes", ",".join("x".join(map(str, s)) for s in FLEET_SHAPES),
              "--dtypes", "complex64", "--ops", "fft,ifft", "--rate", "100",
              "--duration", "5", "--max-batch", "8", "--json", "--gate")
FLEET_FAULT = "execute:every=1,kind=deterministic"
RAMP_N = 256
LAYOUT_N = 512
FLEET_PHASE_LIMIT_S = 120.0


def fleet_cases(shapes=FLEET_SHAPES, max_b=STREAM_BATCH):
    """The kernel cases a load-generator worker launches: a single-device
    C2C plan of each shape at every batch 1..max_b, forward and backward
    (the plane over the last two axes, then axis 0 over the flattened
    rest)."""
    out = []
    for n0, n1, n2 in shapes:
        for b in range(1, max_b + 1):
            for fwd in (True, False):
                d = "fwd" if fwd else "bwd"
                out += [("fft2_last", fwd, (b * n0, n1, n2),
                         f"fleet b={b} {n0}x{n1}x{n2} {d} yz"),
                        ("fft_axis0", fwd, (b, n0, n1 * n2),
                         f"fleet b={b} {n0}x{n1}x{n2} {d} x")]
    return out


def ramp_cases(n=RAMP_N, ranks=SLAB_RANKS, grid=PENCIL_GRID):
    """The kernel cases of phase 19's ramp round trips at n^3: the slab
    on ``ranks`` ranks and the pencil on ``grid``, forward and
    backward."""
    q, m = n // ranks, n // grid[0]
    return [("fft2_last", True, (q, n, n), "ramp slab fwd t0"),
            ("fft_axis0", True, (1, n, q * n), "ramp slab/pencil fwd t3"),
            ("fft_axis0", False, (1, n, q * n), "ramp slab/pencil bwd t0"),
            ("fft_axis0", False, (q, n, n), "ramp slab bwd t3"),
            ("fft_last", False, (q * n, n), "ramp slab bwd rows, pencil t3"),
            ("fft_last", True, (m * m, n), "ramp pencil fwd t0"),
            ("fft_axis0", True, (m, n, m), "ramp pencil fwd t1"),
            ("fft_axis0", False, (m, n, m), "ramp pencil bwd t1")]


def run_loadgen(here, label, extra, env_extra, limit_s=90.0):
    """``python -m distributedfft_tpu_torch.loadgen`` with FLEET_ARGS plus
    ``extra``, into ``chiprun_out/fleet/<label>``; returns (exit code, the
    verdict document, wall seconds)."""
    dir_ = os.path.join(here, "chiprun_out", "fleet", label)
    shutil.rmtree(dir_, ignore_errors=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("DFFT_FAULT_INJECT", "DFFT_MONITOR",
                        "DFFT_MONITOR_DIR", "DFFT_QOS", "PYTHONPATH")}
    env["PYTHONPATH"] = here
    env.update(env_extra)
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [sys.executable, "-m", "distributedfft_tpu_torch.loadgen",
             *FLEET_ARGS, *extra, "--dir", dir_], cwd=here, env=env,
            capture_output=True, text=True, timeout=limit_s)
    except subprocess.TimeoutExpired:
        fail(f"fleet {label}: loadgen ran past {limit_s} s")
    wall = time.perf_counter() - t0
    try:
        doc = json.loads(r.stdout)
    except ValueError:
        fail(f"fleet {label}: loadgen exited {r.returncode} without a "
             f"verdict; stdout {r.stdout[-2000:]!r} stderr "
             f"{r.stderr[-2000:]!r}")
    for w in doc.get("workers", []):
        print(f"fleet {label} worker: {json.dumps(w, sort_keys=True)}",
              flush=True)
    rcs = doc.get("worker_rcs")
    if rcs != [0, 0] or len(doc.get("workers", [])) != 2:
        fail(f"fleet {label}: worker exit codes {rcs}, stats lines "
             f"{doc.get('workers')}; loadgen stderr {r.stderr[-2000:]!r}")
    return r.returncode, doc, wall


def _worker_cases(label, w):
    """The kernel cases a loadgen worker's stats line reports (its
    ``cuda_fft.CASES``), as the keys of :func:`recording_cases`; fails
    unless their counts add up to the worker's launches of each
    kernel."""
    cases = Counter()
    for *key, v in w["cases"]:
        cases[tuple(tuple(e) if isinstance(e, list) else e
                    for e in key)] += v
    by_kernel = Counter()
    for key, v in cases.items():
        by_kernel[key[0]] += v
    launched = {k: v for k, v in w["launches"].items() if v}
    if dict(by_kernel) != launched:
        fail(f"fleet {label}: worker {w['rank']} reports cases adding up to "
             f"{dict(by_kernel)} launches, its counts say {launched}")
    return cases


def _stream_of(doc, rank):
    """The stream id of worker ``rank`` in a loadgen verdict (by pid)."""
    pid = next(w["pid"] for w in doc["workers"] if w["rank"] == rank)
    return next(s for s in doc["procs"]
                if s.split(":")[1].split("#")[0] == str(pid))


def check_fleet(torch, dfft, dev, here, card):
    """Phase 19: the fleet on the card. (a) The healthy streaming fleet
    (FLEET_ARGS and ``--streaming``) exits 0 with status ok or warn, two
    streams, no alert, ``executes`` in both streams' newest metrics and
    no ``pallas_fallback`` / ``fusion_fallback``. (b) The fault drill in
    flush mode (``--flush-every 0.25``, FLEET_FAULT forwarded to rank 0
    only) exits 1 with status alert, worker 0 wedged, a stall or
    fleet_stall on rank 0's stream and no alert of rank 1's own. (c) The
    ramp round trips of the slab and the pencil at RAMP_N^3 within TOL,
    and the slab forward's output at LAYOUT_N^3 complex128 checked
    against its out_boxes, with elements of each block of the round trip
    decoding into that block's box. Returns the workers' summed kernel
    launches, the cases they reported launching (``cases``: their
    ``cuda_fft.CASES``, each worker's adding up to its launches) and the
    figures."""
    from distributedfft_tpu_torch import fleet
    from distributedfft_tpu_torch.utils import debug

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches, cases = Counter(), Counter()
    out = {}

    rc, doc, wall = run_loadgen(here, "healthy", ("--streaming",), {})
    alerts = [a for a in doc["alerts"] if a["severity"] == "alert"]
    if rc != 0 or doc["status"] not in ("ok", "warn") or alerts \
            or len(doc["procs"]) != 2:
        fail(f"fleet healthy: exit {rc}, status {doc['status']}, "
             f"{len(doc['procs'])} streams, alerts {doc['alerts']}")
    streams = fleet.load_fleet(doc["dir"])
    for sid, samples in streams.items():
        counters = samples[-1]["metrics"]["counters"]
        ex = sum(counters.get("executes", {}).values())
        fb = {k: sum(counters.get(k, {}).values())
              for k in ("pallas_fallback", "fusion_fallback")}
        if ex <= 0 or any(fb.values()):
            fail(f"fleet healthy: stream {sid} executes {ex}, fallbacks "
                 f"{fb}")
        print(f"fleet healthy stream {sid}: {len(samples)} samples, "
              f"executes {ex:.0f}, fallbacks {fb}", flush=True)
    for w in doc["workers"]:
        launches.update(w["launches"])
        cases.update(_worker_cases("healthy", w))
        for k in ("fft2_last", "fft_axis0"):
            if w["launches"].get(k, 0) <= 0:
                fail(f"fleet healthy: worker {w['rank']} launched no {k}")
    print(fleet.format_fleet(doc), flush=True)
    submitted = sum(w["submitted"] for w in doc["workers"])
    print(f"fleet healthy (streaming, 2 workers x 100 arrivals/s x 5 s at "
          f"{FLEET_SHAPES}): gate {rc}, status {doc['status']}, "
          f"{submitted} submitted, loadgen wall {wall:.1f} s [{card}]",
          flush=True)
    out["healthy"] = dict(status=doc["status"], wall_s=wall,
                          submitted=submitted)

    rc, doc, wall = run_loadgen(here, "fault", ("--flush-every", "0.25"),
                                {"DFFT_FAULT_INJECT": FLEET_FAULT})
    by_rank = {w["rank"]: w for w in doc["workers"]}
    s0, s1 = _stream_of(doc, 0), _stream_of(doc, 1)
    on0 = [a for a in doc["alerts"]
           if a["name"] in ("stall", "fleet_stall")
           and (a.get("proc") in (None, s0))]
    crossed = [a for a in doc["alerts"] if a.get("proc") == s1]
    own0 = [a["name"] for a in doc["procs"][s0]["alerts"]]
    if rc != 1 or doc["status"] != "alert" or not by_rank[0]["wedged"] \
            or by_rank[1]["wedged"] or not on0 or "stall" not in own0 \
            or crossed or doc["procs"][s1]["alerts"]:
        fail(f"fleet fault drill: exit {rc}, status {doc['status']}, wedged "
             f"{[by_rank[r]['wedged'] for r in (0, 1)]}, alerts "
             f"{doc['alerts']}, rank 0's own {own0}, rank 1's own "
             f"{doc['procs'][s1]['alerts']}")
    for w in doc["workers"]:
        launches.update(w["launches"])
        cases.update(_worker_cases("fault drill", w))
    print(fleet.format_fleet(doc), flush=True)
    print(f"fleet fault drill (flush every 0.25 s, {FLEET_FAULT} on rank "
          f"0): gate {rc}, status {doc['status']}, worker 0 wedged, alerts "
          f"{[(a['name'], a.get('proc')) for a in doc['alerts']]}, loadgen "
          f"wall {wall:.1f} s [{card}]", flush=True)
    out["fault"] = dict(status=doc["status"], wall_s=wall,
                        alerts=[a["name"] for a in doc["alerts"]],
                        streams=(s0, s1))

    n = RAMP_N
    for label, world in (("slab", SLAB_RANKS), ("pencil", PENCIL_GRID)):
        f = dfft.plan_dft_c2c_3d((n,) * 3, world, device=dev)
        b = dfft.plan_dft_c2c_3d((n,) * 3, world, direction=dfft.BACKWARD,
                                 device=dev)
        err = debug.ramp_roundtrip_check(f, b)
        if not err <= TOL:
            fail(f"ramp roundtrip {label} {n}^3: {err:.3e} > {TOL}")
        print(f"ramp roundtrip {label} {n}^3 complex64: rel err {err:.3e} "
              f"(<= {TOL})", flush=True)
        out[f"ramp_{label}"] = err
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()

    n = LAYOUT_N
    kw = dict(dtype=torch.complex128, device=dev)
    f = dfft.plan_dft_c2c_3d((n,) * 3, SLAB_RANKS, **kw)
    b = dfft.plan_dft_c2c_3d((n,) * 3, SLAB_RANKS, direction=dfft.BACKWARD,
                             **kw)
    x = torch.from_numpy(debug.ramp_world((n,) * 3)).to(dev)
    debug.check_layout(x, f.in_boxes, f.world)
    y = f(x)
    debug.check_layout(y, f.out_boxes, f.world)
    if not bool(torch.isfinite(torch.view_as_real(y)).all()):
        fail(f"layout {n}^3: the slab forward's output is not finite")
    r = b(y)
    del y
    decoded = 0
    for rank, box in enumerate(f.in_boxes):
        lo, hi = box.low, box.high
        picks = [tuple(lo), tuple(h - 1 for h in hi),
                 tuple((a + c) // 2 for a, c in zip(lo, hi))]
        for p in picks:
            got = debug.decode_ramp(float(r[p].real), (n,) * 3)
            if not all(a <= g < c for a, g, c in zip(lo, got, hi)) \
                    or got != p:
                fail(f"layout {n}^3: rank {rank}'s element {p} decodes to "
                     f"{got}, outside its box {box}")
            decoded += 1
    del x, r
    print(f"layout {n}^3 complex128 slab P={SLAB_RANKS}: check_layout of "
          f"the input against in_boxes and of the forward's output against "
          f"out_boxes passed; {decoded} elements of the round trip (low, "
          f"high and middle corner of each rank's box) decode into their "
          f"box", flush=True)
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print(f"fleet phase: {secs:.1f} s [{card}]", flush=True)
    if secs > FLEET_PHASE_LIMIT_S:
        fail(f"the fleet phase took {secs:.1f} s > {FLEET_PHASE_LIMIT_S}")
    out["launches"] = dict(launches)
    out["cases"] = cases
    out["seconds"] = secs
    return out


# ------------------------------------------- the regression loop (phase 20)

#: Phase 20's time limit (s) and its files under chiprun_out/.
REGRESS_PHASE_LIMIT_S = 45.0
REGRESS_DIR = os.path.join("chiprun_out", "phase20")
REGRESS_METRIC = "fft3d_c2c_512_forward_gflops"
#: The flagship's timed runs: CUDA-event medians of REGRESS_ITERS calls.
REGRESS_RUNS = 6
REGRESS_ITERS = 5


def run_report(report, here, argv, want, seconds):
    """``report.main(argv)`` in this process, its stdout and stderr
    captured; prints the argv (paths relative to the checkout), the exit
    code and the seconds, and fails unless the exit code is ``want``.
    Returns (stdout, stderr)."""
    import io

    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = report.main([str(a) for a in argv])
    secs = time.perf_counter() - t
    shown = " ".join(os.path.relpath(a, here) if os.path.isabs(str(a))
                     else str(a) for a in argv)
    seconds.append((shown, secs))
    print(f"report {shown}: exit {rc} (want {want}), {secs:.3f} s",
          flush=True)
    if rc != want:
        fail(f"report {shown}: exit {rc}, want {want}; stdout "
             f"{out.getvalue()[-1500:]!r} stderr {err.getvalue()[-1500:]!r}")
    return out.getvalue(), err.getvalue()


def merged_counts(out):
    """{span name: count} of a ``report merge`` aggregate table."""
    lines = out.splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.startswith("stage "))
    return {ln.rsplit(None, 5)[0]: int(ln.rsplit(None, 5)[1])
            for ln in lines[head + 1:] if ln.strip()
            and not ln.startswith("merged timeline")}


def check_merged(label, out, want):
    """Fail unless the merge table holds the t0..t3 spans the traced
    calls recorded (``want``: a Counter of span names), each as often."""
    from distributedfft_tpu_torch.utils.trace import stage_key

    got = merged_counts(out)
    stages = {k: v for k, v in want.items()
              if stage_key(k) in ("t0", "t1", "t2", "t3")}
    keys = {stage_key(k) for k in stages}
    wrong = {k: (got.get(k), v) for k, v in stages.items()
             if got.get(k) != v}
    print(f"merge {label}: t0..t3 spans {dict(sorted(stages.items()))} "
          f"recorded, table {dict(sorted((k, got.get(k)) for k in stages))}",
          flush=True)
    if wrong or not {"t0", "t2", "t3"} <= keys:
        fail(f"merge {label}: table counts (got, recorded) {wrong}, stage "
             f"keys {sorted(keys)}")


def bench_line(name, seconds, stages, snap, cost, n=512, **extra):
    """One result line in ``bench.py``'s schema for the slab C2C forward
    at n^3 on SLAB_RANKS loopback ranks."""
    nn = n ** 3
    return {"metric": REGRESS_METRIC,
            "value": 5.0 * nn * math.log2(nn) / seconds / 1e9,
            "unit": "GFlops/s", "seconds": seconds, "executor": "cuda",
            "backend": "gpu", "device_kind": name, "dtype": "complex64",
            "devices": SLAB_RANKS, "decomposition": "slab",
            "stages": stages,
            "telemetry": {"metrics": snap, "cost": cost,
                          "status": {"gpu_available": True}},
            **extra}


def wisdom_row(out, label, want):
    """Fail unless ``report wisdom``'s table has one c2c row at n^3 for
    the winner ``label`` and that row holds ``want``."""
    rows = [ln for ln in out.splitlines() if ln.startswith("c2c ")
            and f"->  {label} " in ln]
    if len(rows) != 1 or want not in rows[0]:
        fail(f"report wisdom: the c2c row of {label} is not one row "
             f"holding {want!r}: {out!r}")


def write_lines(path, lines):
    with open(path, "w") as f:
        for line in lines:
            f.write(json.dumps(line, sort_keys=True) + "\n")


def check_regression_loop(torch, dfft, dev, here, card, hw_path, log_spans,
                          fleet_streams, n=512):
    """Phase 20: the regression loop and the report CLI on the card,
    every subcommand through ``report.main`` in this process but
    ``history``, which runs once as ``python -m`` under a timeout.
    (b) ``explain --plan`` of the slab C2C forward at n^3 on SLAB_RANKS
    loopback ranks with the card's timeline, held as phase 17 holds its
    records; (a) that plan timed REGRESS_RUNS times (CUDA events), each
    time a line in ``bench.py``'s schema (the newest with (b)'s record as
    its explain block) recorded into a fresh history: ``history`` and
    ``compare --gate`` exit 0; a doctored copy of the newest line (value
    halved, t2 tripled) makes ``compare --gate`` exit 1 with t2 the
    stage it names; then ``explain --record`` of phase 17's records and
    ``explain --trend`` of the history. (c) One traced call of the plan
    in chrome format, merged alone, with phase 9's text log, and with
    ``--align start``: the t0..t3 counts equal what the two sessions
    recorded (``log_spans``: phase 9's). (d) ``wisdom --gate`` on phase
    16's store with runs of its tuned winner (the exit their verdict
    gives) and with runs at 1 and 1.5 times its stored time (exit 0 and
    1), ``qos`` on phase 18's
    ledger, ``health`` / ``live`` on phase 18 (f)'s series, ``numerics``
    on that series (dark: (f) ran before the plane was armed, exit 2)
    and on a sample taken now, after 18 (e)'s audit (exit 0), ``fleet``
    on phase 19's two runs (``fleet_streams``: the drill's rank 0 and 1
    stream ids). (e) ``calibrate`` on the card, dry run. Fails past
    REGRESS_PHASE_LIMIT_S."""
    from distributedfft_tpu_torch import monitor, regress, report, tuner
    from distributedfft_tpu_torch.explain import compiled_summary
    from distributedfft_tpu_torch.utils import metrics, timing, trace

    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    out_dir = os.path.join(here, REGRESS_DIR)
    os.makedirs(out_dir, exist_ok=True)
    hist = os.path.join(out_dir, "history.jsonl")
    if os.path.exists(hist):
        os.remove(hist)
    secs = []
    shape = (n, n, n)
    world = SLAB_RANKS
    label = f"slab c2c fwd {n}^3 P={SLAB_RANKS}"

    # (b) live explain of the flagship plan
    t = time.perf_counter()
    got, _ = run_report(report, here, [
        "explain", "--plan", f"{n},{n},{n}", "-n", str(SLAB_RANKS),
        "--device", "cuda", "--device-timing", "--json"], 0, secs)
    live = json.loads(got)
    check_explain_record(f"report explain --plan ({label})", live,
                         ("t0", "t2", "t3"), time.perf_counter() - t, card,
                         n)

    # (a) the timed runs, recorded
    plan = dfft.plan_dft_c2c_3d(shape, world, executor="cuda", device=dev)
    x = seeded(torch, shape, dev)
    metrics.metrics_reset()
    metrics.enable_metrics()
    try:
        cost = compiled_summary(plan, x)
        lines = []
        for i in range(REGRESS_RUNS):
            ms = timing.cuda_time_ms(lambda: plan(x), iters=REGRESS_ITERS)
            timer = timing.StageTimer(dev)
            plan(x, timer=timer)
            extra = {"explain": live} if i == REGRESS_RUNS - 1 else {}
            lines.append(bench_line(name, ms / 1e3, timer.times(),
                                    metrics.metrics_snapshot(), cost,
                                    n, **extra))
        runs = os.path.join(out_dir, "runs.jsonl")
        write_lines(runs, lines)
        run_report(report, here, ["record", runs, "--history", hist], 0,
                   secs)

        env = {k: v for k, v in os.environ.items()
               if k not in ("DFFT_BENCH_HISTORY", "PYTHONPATH")}
        env["PYTHONPATH"] = here
        t = time.perf_counter()
        try:
            r = subprocess.run(
                [sys.executable, "-m", "distributedfft_tpu_torch.report",
                 "history", "--history", hist], cwd=here, env=env,
                capture_output=True, text=True, timeout=120)
        except subprocess.TimeoutExpired:
            fail("python -m distributedfft_tpu_torch.report history ran "
                 "past 120 s")
        sub_s = time.perf_counter() - t
        shown = f"history --history {os.path.relpath(hist, here)}"
        secs.append((f"{shown} (python -m)", sub_s))
        print(f"python -m distributedfft_tpu_torch.report {shown}: exit "
              f"{r.returncode} (want 0), {sub_s:.3f} s:\n{r.stdout}",
              flush=True)
        if r.returncode != 0 or REGRESS_METRIC not in r.stdout \
                or name not in r.stdout:
            fail(f"report history: exit {r.returncode}; stdout "
                 f"{r.stdout[-1500:]!r} stderr {r.stderr[-1500:]!r}")

        got, _ = run_report(report, here, ["compare", "--history", hist,
                                           "--gate", "--json"], 0, secs)
        (res,) = json.loads(got)
        base = res["baseline"]
        values = [ln["value"] for ln in lines]
        print(f"phase 20 runs ({label}, CUDA events, median of "
              f"{REGRESS_ITERS} calls each) [{card}]: GFlop/s {values}; "
              f"newest {res['value']} against the previous "
              f"{base['n']}: median {base.get('median')}, MAD "
              f"{base.get('mad')}, band +/-{base.get('band')} "
              f"({res.get('delta_pct')}%), verdict {res['verdict']}; "
              f"stages (s) {[ln['stages'] for ln in lines]}", flush=True)
        if res["verdict"] not in ("within-noise", "improved") \
                or base["n"] != REGRESS_RUNS - 1:
            fail(f"compare of unchanged code: {res}")

        bad = json.loads(json.dumps(lines[-1]))
        bad["value"] /= 2.0
        bad["stages"]["t2"] *= 3.0
        doctored = os.path.join(out_dir, "doctored.json")
        write_lines(doctored, [bad])
        run_report(report, here, ["record", doctored, "--history", hist], 0,
                   secs)
        got, _ = run_report(report, here, ["compare", "--history", hist,
                                           "--gate"], 1, secs)
        print(got, flush=True)
        rows = got.splitlines()
        if not (rows[0].startswith("regressed") and len(rows) > 1
                and rows[1].split()[0] == "t2" and "REGRESSED" in rows[1]):
            fail(f"compare of the doctored line does not name t2 first: "
                 f"{got!r}")
    finally:
        metrics.enable_metrics(False)
        metrics.metrics_reset()

    run_report(report, here, ["explain", "--record", os.path.join(
        here, "chiprun_out", "explain_records.jsonl")], 0, secs)
    got, _ = run_report(report, here, ["explain", "--trend", "--history",
                                       hist], 0, secs)
    print(got, flush=True)

    # (c) one traced call in chrome format, merged three ways
    plan(x)
    torch.cuda.synchronize()
    trace.init_tracing(os.path.join(out_dir, "trace"), format="chrome")
    with trace.capture_events() as ev:
        plan(x)
        torch.cuda.synchronize()
    chrome = trace.finalize_tracing()
    chrome_spans = Counter(e[0] for e in ev)
    log = os.path.join(here, "chiprun_out", "chip_smoke_trace_0.log")
    both = chrome_spans + log_spans
    got, _ = run_report(report, here, ["merge", chrome], 0, secs)
    check_merged("chrome alone", got, chrome_spans)
    got, _ = run_report(report, here, ["merge", chrome, log], 0, secs)
    check_merged("chrome + phase 9's text log", got, both)
    merged = os.path.join(out_dir, "merged_trace.json")
    got, _ = run_report(report, here, ["merge", chrome, log, "--align",
                                       "start", "-o", merged], 0, secs)
    check_merged("--align start", got, both)
    print(got, flush=True)
    del x
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()

    # (d) the other readers
    store = os.path.join(os.path.dirname(hw_path), "w.jsonl")
    saved = os.environ.get("DFFT_WISDOM")
    os.environ["DFFT_WISDOM"] = store
    try:
        tuned = dfft.plan_dft_c2c_3d(shape, dfft.make_world(SLAB_RANKS),
                                     tune="wisdom", device=dev)
    finally:
        if saved is None:
            os.environ.pop("DFFT_WISDOM", None)
        else:
            os.environ["DFFT_WISDOM"] = saved
    want = tuner.tuned_label(tuned)
    entries, _ = tuner.load_wisdom(store)
    key = next((k for k, e in entries.items()
                if e["key"].get("kind") == "c2c"
                and e["key"].get("shape") == [n] * 3
                and e["key"].get("err_budget") is None
                and report._winner_label(e["winner"]) == want), None)
    if key is None:
        fail(f"wisdom replay: {want} is no c2c {n}^3 winner of phase 16's "
             f"store ({len(entries)} entries)")
    x = seeded(torch, shape, dev)
    iters, repeats = (int(v) for v in TUNE_ENV["DFFT_TUNE_ITERS"].split("x"))
    tuned_lines = []
    for _ in range(3):
        s, _ = timing.time_fn_amortized(tuned, x, iters=iters,
                                        repeats=repeats)
        tuned_lines.append(bench_line(name, s, {}, None, None, n,
                                      tuned=want))
    del x, tuned
    runs = os.path.join(out_dir, "tuned_runs.jsonl")
    write_lines(runs, tuned_lines)
    run_report(report, here, ["record", runs, "--history", hist], 0, secs)
    # The stored time and the replays are host-clock readings taken
    # minutes apart on a host shared with other machines, so whether they
    # agree within the band is the host's noise, not the code's: the
    # gate's exit on them must follow their verdict, and two histories
    # made from the stored time pin each exit code.
    stored = float(entries[key]["seconds"])
    real = regress.wisdom_verdict(stored,
                                  [ln["seconds"] for ln in tuned_lines])
    got, _ = run_report(report, here, [
        "wisdom", "--gate", "--wisdom", store, "--history", hist],
        1 if real["verdict"] == "regressed" else 0, secs)
    print(f"wisdom --gate on phase 16's store ({len(entries)} entries; the "
          f"c2c winner {want} stored at {stored:.6f} s, replayed "
          f"{[round(ln['seconds'], 6) for ln in tuned_lines]} s, verdict "
          f"{real['verdict']} {real.get('delta_pct', 0.0):+.1f}%) "
          f"[{card}]:\n{got}", flush=True)
    wisdom_row(got, want, f"[{real['verdict']}")
    for factor, verdict, rc in ((1.0, "within-noise", 0),
                                (1.5, "regressed", 1)):
        pinned = os.path.join(out_dir, f"wisdom_x{factor}.jsonl")
        if os.path.exists(pinned):
            os.remove(pinned)
        fixed = [dict(ln, seconds=stored * factor) for ln in tuned_lines]
        runs = os.path.join(out_dir, f"tuned_runs_x{factor}.jsonl")
        write_lines(runs, fixed)
        run_report(report, here, ["record", runs, "--history", pinned], 0,
                   secs)
        got, _ = run_report(report, here, [
            "wisdom", "--gate", "--wisdom", store, "--history", pinned], rc,
            secs)
        wisdom_row(got, want, f"[{verdict} {100.0 * (factor - 1.0):+.1f}%, "
                   f"fresh n={len(fixed)}]")

    ledger = os.path.join(here, QOS_LEDGER)
    got, _ = run_report(report, here, ["qos", "--ledger", ledger], 0, secs)
    print(got, flush=True)
    series = os.path.join(here, MONITOR_SERIES)
    got, _ = run_report(report, here, ["health", "--series", series], 0,
                        secs)
    print(got, flush=True)
    run_report(report, here, ["health", "--series", series, "--gate"], 0,
               secs)
    got, _ = run_report(report, here, ["live", "--series", series,
                                       "--prom"], 0, secs)
    if "dfft_queue_depth" not in got:
        fail(f"live --prom: no dfft_queue_depth in {got[:500]!r}")
    run_report(report, here, ["numerics", "--series", series], 2, secs)
    nseries = os.path.join(out_dir, "numerics.jsonl")
    if os.path.exists(nseries):
        os.remove(nseries)
    monitor.Monitor(None, path=nseries).sample()
    got, _ = run_report(report, here, ["numerics", "--series", nseries,
                                       "--gate"], 0, secs)
    print(got, flush=True)

    fleet_dir = os.path.join(here, "chiprun_out", "fleet")
    run_report(report, here, ["fleet", "--dir", os.path.join(
        fleet_dir, "healthy"), "--gate"], 0, secs)
    got, _ = run_report(report, here, ["fleet", "--dir", os.path.join(
        fleet_dir, "fault"), "--gate"], 1, secs)
    print(got, flush=True)
    doc = json.loads(run_report(report, here, ["fleet", "--dir", os.path.join(
        fleet_dir, "fault"), "--json"], 0, secs)[0])
    s0, _ = fleet_streams
    own0 = [a["name"] for a in doc["procs"][s0]["alerts"]]
    named = [a for a in doc["alerts"]
             if a["name"] == "fleet_stall" and a.get("proc") == s0]
    if doc["status"] != "alert" or "stall" not in own0 or not named:
        fail(f"report fleet on the drill: status {doc['status']}, rank 0's "
             f"stream {s0} alerts {own0}, fleet alerts {doc['alerts']}")

    # (e) calibrate on the card, beside phase 16's profile
    got, _ = run_report(report, here, ["calibrate", "--device", "cuda",
                                       "--dry-run", "--json", "--no-wire"],
                        0, secs)
    prof = json.loads(got)["profile"]
    with open(hw_path) as f:
        before = json.load(f)
    print(f"report calibrate: hbm {prof['hbm_gbps']} GB/s, bf16 peak "
          f"{prof['peak_tflops']} TFlop/s; phase 16's calibrate(): hbm "
          f"{before['hbm_gbps']} GB/s, bf16 peak {before['peak_tflops']} "
          f"TFlop/s [{card}]", flush=True)
    if prof["device_kind"] != name or not prof["hbm_gbps"]:
        fail(f"report calibrate: profile {prof}")

    total = time.perf_counter() - t_phase
    print("phase 20 subcommand seconds: " + "; ".join(
        f"{a}: {s:.3f}" for a, s in secs), flush=True)
    print(f"regression-loop phase: {total:.1f} s [{card}]", flush=True)
    if total > REGRESS_PHASE_LIMIT_S:
        fail(f"the regression-loop phase took {total:.1f} s > "
             f"{REGRESS_PHASE_LIMIT_S}")


# ------------------------------------------------ the C ABI (phase 21)

#: Phase 21's time limit (s), its world shape and its files.
CAPI_PHASE_LIMIT_S = 60.0
CAPI_N = 512
CAPI_DIR = os.path.join("chiprun_out", "phase21")
CAPI_TIMED = 10


def capi_cases(n=CAPI_N, ranks=SLAB_RANKS, grid=PENCIL_GRID):
    """The kernel cases phase 21 launches at n^3: the single-device C2C
    and R2C/C2R pairs (every r2c_axis: the cube's swapped view has the
    same shapes), the slab and the pencil forward."""
    h, q = n // 2 + 1, n // ranks
    rows, cols = grid
    cases = []
    for fwd in (True, False):
        cases += [("fft2_last", fwd, (n, n, n), "C ABI single c2c"),
                  ("fft_axis0", fwd, (1, n, n * n), "C ABI single c2c"),
                  ("fft_last", fwd, (n * n, n // 2), "C ABI single r2c z"),
                  ("fft_axis0", fwd, (n, n, h), "C ABI single r2c y"),
                  ("fft_axis0", fwd, (1, n, n * h), "C ABI single r2c x")]
    return cases + [
        ("fft2_last", True, (q, n, n), "C ABI slab fwd t0"),
        ("fft_axis0", True, (1, n, q * n), "C ABI slab fwd t3"),
        ("fft_last", True, (n * n // (rows * cols), n), "C ABI pencil t0"),
        ("fft_axis0", True, (n // rows, n, n // cols), "C ABI pencil t1"),
        ("fft_axis0", True, (1, n, n * n // (rows * cols)),
         "C ABI pencil t3")]


def _c_entries(lib):
    """The ctypes bindings a C caller would use (fresh function objects,
    so the package's own bindings stay as they are)."""
    import ctypes

    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int

    def fn(name, restype, argtypes):
        f = lib[name]
        f.restype, f.argtypes = restype, argtypes
        return f

    return {"plan": fn("dfft_plan_c2c_3d", ll, [ll] * 3 + [i]),
            "execute": fn("dfft_execute_c2c", i, [ll, vp, vp]),
            "upload": fn("dfft_upload", i, [ll, vp]),
            "run": fn("dfft_execute_resident", i, [ll]),
            "download": fn("dfft_download", i, [ll, vp]),
            "destroy": fn("dfft_destroy_plan_c", None, [ll])}


def capi_selftests(torch, capi, card, n=CAPI_N):
    """Phase 21 (b): the four selftests of the library, driven from
    compiled C at n^3 on the card; fails on a negative value (a C-side
    failure) or one over its tier."""
    shape = (n, n, n)
    runs = [("c_selftest c64", lambda: capi.c_selftest(shape), TOL)]
    runs += [(f"c_selftest_r2c r2c_axis={a}",
              lambda a=a: capi.c_selftest_r2c(shape, r2c_axis=a), TOL)
             for a in (0, 1, 2)]
    runs += [("c_selftest_z2z (dd)", lambda: capi.c_selftest_z2z(shape),
              TOL128),
             ("c_selftest_resident repeats=10",
              lambda: capi.c_selftest_resident(shape, repeats=10), TOL)]
    for label, run, tol in runs:
        t0 = time.perf_counter()
        err = run()
        secs = time.perf_counter() - t0
        print(f"phase 21 (b) {label} at {n}^3: round trip max rel err "
              f"{err:.3e} (tier {tol:g}), {secs:.2f} s [{card}]", flush=True)
        if not 0 <= err <= tol:
            fail(f"phase 21 (b) {label}: {err} (negative: a C-side failure; "
                 f"else over {tol})")


def capi_execute(torch, capi, c, x, xh, world, label):
    """Phase 21 (c): ``dfft_plan_c2c_3d`` / ``dfft_execute_c2c`` through
    ctypes on ``world``: the C output against the same port plan's
    direct output on the card (bit for bit) and ``torch.fft.fftn``
    (5e-4). Returns the plan id (destroyed in (e))."""
    import numpy as np

    shape = tuple(x.shape)
    capi.install_c_api(world, device=x.device)
    pid = c["plan"](*shape, -1)
    if pid < 0:
        fail(f"phase 21 (c) {label}: dfft_plan_c2c_3d returned {pid}")
    out = np.empty_like(xh)
    rc = c["execute"](pid, xh.ctypes.data, out.ctypes.data)
    if rc != 0:
        fail(f"phase 21 (c) {label}: dfft_execute_c2c returned {rc}")
    plan = capi._plans[pid].plan
    direct = plan(x)
    got = torch.from_numpy(out).to(x.device)
    same = bool(torch.equal(got, direct))
    del direct
    ref = torch.fft.fftn(x)
    errs = rel_err(torch, got, ref)[:2]
    del ref, got, out
    print(f"phase 21 (c) {label} {shape}: executor {plan.executor}, "
          f"{plan.decomposition}; C output bit-equal to the plan's direct "
          f"output: {same}; vs torch.fft.fftn max rel err {errs[0]:.3e} l2 "
          f"rel err {errs[1]:.3e}", flush=True)
    if not same:
        fail(f"phase 21 (c) {label}: the C output differs from the plan's")
    if not max(errs) <= TOL:
        fail(f"phase 21 (c) {label}: error over {TOL}")
    return pid


def capi_times(torch, timing, capi, c, x, xh, card, reps=CAPI_TIMED):
    """Phase 21 (d): at n^3 on one device, the medians of ``reps``
    host-to-host ``dfft_execute_c2c`` calls and ``dfft_execute_resident``
    calls (host clock around the ctypes call), the plan call alone (CUDA
    events), and the two pageable copies the host-to-host call makes.
    Returns the plan ids (destroyed in (e))."""
    import numpy as np

    capi.install_c_api(None, device=x.device)
    pid = c["plan"](*x.shape, -1)
    out = np.empty_like(xh)

    def wall(fn):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            rc = fn()
            ts.append((time.perf_counter() - t0) * 1e3)
            if rc != 0:
                fail(f"phase 21 (d): a C call returned {rc}")
        return statistics.median(ts)

    c["execute"](pid, xh.ctypes.data, out.ctypes.data)        # warm
    h2h = wall(lambda: c["execute"](pid, xh.ctypes.data, out.ctypes.data))
    if c["upload"](pid, xh.ctypes.data) != 0 or c["run"](pid) != 0:
        fail("phase 21 (d): upload or the first resident run failed")
    res = wall(lambda: c["run"](pid))
    plan = capi._plans[pid].plan
    plan_ms = timing.cuda_time_ms(lambda: plan(x), iters=reps)
    y = plan(x)
    host = torch.from_numpy(out)

    def h2d():
        torch.from_numpy(xh).to(x.device)
        return 0

    def d2h():
        host.copy_(y)
        return 0

    up, down = wall(h2d), wall(d2h)
    del y, host
    gib = xh.nbytes / 2 ** 30
    print(f"phase 21 (d) {tuple(x.shape)} c64 forward, median of {reps}: "
          f"host-to-host dfft_execute_c2c {h2h:.3f} ms; "
          f"dfft_execute_resident {res:.3f} ms (host clock around the "
          f"ctypes call); the plan call alone {plan_ms:.3f} ms (CUDA "
          f"events); bridge cost per call: resident - plan "
          f"{res - plan_ms:.3f} ms, host-to-host - resident "
          f"{h2h - res:.3f} ms; pageable copies of {gib:.2f} GiB: to the "
          f"card {up:.3f} ms ({gib / up * 1e3:.2f} GiB/s), back "
          f"{down:.3f} ms ({gib / down * 1e3:.2f} GiB/s) [{card}]",
          flush=True)
    return [pid]


def capi_trace(torch, dfft, dev, here, n=CAPI_N):
    """Phase 21 (f): one slab C2C forward at n^3 on SLAB_RANKS loopback
    ranks in a ``log`` session of the C recorder, and one in a session of
    the Python recorder: the same t0..t3 spans by name and count."""
    from distributedfft_tpu_torch.utils import trace

    out_dir = os.path.join(here, CAPI_DIR)
    os.makedirs(out_dir, exist_ok=True)
    x = seeded(torch, (n, n, n), dev)
    plan = dfft.plan_dft_c2c_3d((n, n, n), dfft.make_world(SLAB_RANKS),
                                device=dev)
    plan(x)
    torch.cuda.synchronize()
    spans, old = {}, os.environ.get("DFFT_TRACE_NATIVE")
    try:
        for flag, rec in (("1", "C"), ("0", "Python")):
            os.environ["DFFT_TRACE_NATIVE"] = flag
            trace.init_tracing(os.path.join(out_dir, f"trace_{rec}"))
            if (trace._native_rec is not None) != (rec == "C"):
                fail(f"phase 21 (f): the {rec} recorder did not engage")
            plan(x)
            torch.cuda.synchronize()
            log = trace.finalize_tracing()
            lines = open(log).read().splitlines()
            if lines[0] != "process 0 of 1":
                fail(f"phase 21 (f): {rec} log header {lines[0]!r}")
            spans[rec] = Counter(ln.split()[-1] for ln in lines[1:]
                                 if trace.stage_key(ln.split()[-1]))
    finally:
        if old is None:
            os.environ.pop("DFFT_TRACE_NATIVE", None)
        else:
            os.environ["DFFT_TRACE_NATIVE"] = old
    print(f"phase 21 (f) slab {n}^3 P={SLAB_RANKS} forward: t0..t3 spans "
          f"of the C recorder's log {dict(spans['C'])}, of the Python "
          f"recorder's {dict(spans['Python'])}", flush=True)
    if spans["C"] != spans["Python"] or not spans["C"]:
        fail("phase 21 (f): the two recorders' t0..t3 spans differ")
    del x


def check_c_abi(torch, dfft, timing, dev, here, card, build_s, n=CAPI_N):
    """Phase 21: the C ABI on the card (counts from 0). (a) the port's
    host library, built with g++ at the script's start (its build time),
    and the bridge installed on the card; (b) the four selftests from
    compiled C at n^3; (c) ``dfft_plan_c2c_3d`` / ``dfft_execute_c2c``
    through ctypes on one device, a loopback World(SLAB_RANKS) slab and
    a PENCIL_GRID pencil, each bit-equal to the same plan's direct
    output and within 5e-4 of torch.fft.fftn; (d) the host-to-host call,
    the resident call and the plan call alone, medians of 10; (e) every
    plan destroyed and ``torch.cuda.memory_allocated()`` back to its
    level before (b); (f) the C and Python recorders' spans. Fails on a
    nonzero return code, a negative selftest, or past 60 s."""
    import gc

    from distributedfft_tpu_torch import capi, native

    t_phase = time.perf_counter()
    lib = os.path.relpath(native.library_path(), here)
    print(f"phase 21 (a) host library {lib}: g++ "
          f"{' '.join(native.CXX_FLAGS)}, built in "
          f"{build_s:.2f} s at the script's start; ABI version "
          f"{native._load().dfft_abi_version()}", flush=True)
    if not capi.install_c_api(device=dev) or not capi.c_api_installed():
        fail("phase 21 (a): install_c_api on the card failed")
    dfft.clear_plan_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    t_b = time.perf_counter()
    capi_selftests(torch, capi, card, n)
    print(f"phase 21 (b): {time.perf_counter() - t_b:.1f} s", flush=True)

    c = _c_entries(native._load())
    shape = (n, n, n)
    x = seeded(torch, shape, dev)
    xh = x.cpu().numpy()
    pids = [capi_execute(torch, capi, c, x, xh, None, "single")]
    pids.append(capi_execute(torch, capi, c, x, xh,
                             dfft.make_world(SLAB_RANKS),
                             f"slab loopback P={SLAB_RANKS}"))
    pids.append(capi_execute(torch, capi, c, x, xh, PENCIL_GRID,
                             f"pencil loopback {PENCIL_GRID}"))
    pids += capi_times(torch, timing, capi, c, x, xh, card)
    del x, xh

    for pid in pids:
        c["destroy"](pid)
    left = [p for p in pids if p in capi._plans]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem = torch.cuda.memory_allocated()
    print(f"phase 21 (e): {len(pids)} plans destroyed ({len(left)} left in "
          f"the registry); torch.cuda.memory_allocated() {mem} B against "
          f"{mem0} B before (b)", flush=True)
    if left or mem != mem0:
        fail(f"phase 21 (e): plans {left} left, or {mem - mem0} B not "
             f"returned")

    capi_trace(torch, dfft, dev, here, n)
    secs = time.perf_counter() - t_phase
    print(f"C ABI phase: {secs:.1f} s [{card}]", flush=True)
    if secs > CAPI_PHASE_LIMIT_S:
        fail(f"the C ABI phase took {secs:.1f} s > {CAPI_PHASE_LIMIT_S}")


def time_two_level_calls(torch, cf, timing, dev, card):
    """``--route-cases``: ``fft_along_axis`` at each TWO_LEVEL shape,
    forward and inverse (one call, CUDA events, median of 10; and back
    to back), on whichever package sits beside the script."""
    for batch, n in TWO_LEVEL:
        x = seeded(torch, (batch, n), dev, SEED + 7)
        for fwd in (True, False):
            call = lambda: cf.fft_along_axis(x, 1, fwd)
            print(f"two-level call [{batch},{n}] {'fwd' if fwd else 'inv'}: "
                  f"ms={timing.cuda_time_ms(call):.4f} steady_ms="
                  f"{steady_ms(torch, call):.4f} [{card}]", flush=True)
        del x
        torch.cuda.empty_cache()


def digest(torch, t) -> str:
    """Three sums over the bits of tensor ``t`` (its 32-, 16- or 8-bit
    words as int64: plain, weighted by position in a row of 4096, and
    the row sums weighted by row): equal bits give equal digests."""
    if t.is_complex():
        t = torch.view_as_real(t)
    b = t.contiguous().view(-1)
    word = {4: torch.int32, 2: torch.int16, 1: torch.uint8}[
        min(b.element_size(), 4)]
    v = b.view(word).to(torch.int64)
    v = torch.nn.functional.pad(v, (0, (-v.numel()) % 4096)).view(-1, 4096)
    w = torch.arange(1, 4097, device=v.device, dtype=torch.int64)
    rows = v.sum(1)
    at = torch.arange(1, rows.numel() + 1, device=v.device,
                      dtype=torch.int64)
    return (f"{int(rows.sum()) & (2**64 - 1):x}:"
            f"{int((v * w).sum()) & (2**64 - 1):x}:"
            f"{int((rows * at).sum()) & (2**64 - 1):x}")


def output_digests(torch, cf, cfu, wire_codec, dev):
    """``--route-cases``: the digest of the output of every kernel 1-5
    case phases 2 and 3 hold (KERNEL_CASES, FUSED_CASES), on their
    inputs, one line a case, so that two trees' runs compare bit for
    bit."""
    for i, case in enumerate(KERNEL_CASES):
        name, fwd, shape = case[:3]
        kw = {} if case_key(case) == tuple(case[:3]) else {"normalize": False}
        x = seeded(torch, shape, dev, SEED + i)
        y = getattr(cf, name)(x, fwd, **kw)
        print(f"digest {case_key(case)} {digest(torch, y)}", flush=True)
        del x, y
    for i, case in enumerate(FUSED_CASES):
        name, codec, fwd, shape, axis, tiles = case[:6]
        kw = dict(fft_axis=axis, forward=fwd, tile_axis=axis, tiles=tiles,
                  wire_dtype=codec)
        x = seeded(torch, shape, dev, SEED + 100 + i)
        if name == "fft_encode":
            got = cfu.fused_fft_encode(x, **kw)
        else:
            parts = wire_codec(codec).encode(x, tile_axis=axis, tiles=tiles)
            got = (cfu.fused_decode_fft(parts, torch.complex64, **kw),)
            del parts
        print(f"digest {case[:6]} "
              + " ".join(digest(torch, g) for g in got), flush=True)
        del x, got
    torch.cuda.empty_cache()
    print(f"digests: {len(KERNEL_CASES)} kernel 1-3 cases, "
          f"{len(FUSED_CASES)} kernel 4-5 cases", flush=True)


def extend_cases(cf):
    """Add every path's kernel cases to KERNEL_CASES, TWO_LEVEL_CASES
    and FUSED_CASES (once: each case is held once)."""
    from distributedfft_tpu_torch.plan_logic import resolve_overlap_chunks

    auto_k = resolve_overlap_chunks("auto", (512,) * 3, SLAB_RANKS)
    KERNEL_CASES.extend(overlap_cases(512, (2, auto_k, 2 * auto_k)))
    KERNEL_CASES.extend(batch_cases(512))
    KERNEL_CASES.extend(op_cases(512))
    from distributedfft_tpu_torch.parallel.fft1d import choose_split_1d

    one_d = long_cases(cf, choose_split_1d)
    KERNEL_CASES.extend(c for c in one_d if c[0] != "fft_last_big")
    TWO_LEVEL_CASES.extend(c for c in one_d if c[0] == "fft_last_big")
    KERNEL_CASES.extend(GENERIC_CASES)
    KERNEL_CASES.extend(generic_path_cases())
    held = {case_key(c) for c in KERNEL_CASES}
    KERNEL_CASES.extend(c for c in long_path_cases()
                        if case_key(c) not in held)
    held = {case_key(c) for c in KERNEL_CASES}
    KERNEL_CASES.extend(c for c in tune_cases(512)
                        if case_key(c) not in held)
    held = {case_key(c) for c in KERNEL_CASES}
    KERNEL_CASES.extend(c for c in serving_cases(STREAM_N)
                        if case_key(c) not in held)
    for c in fleet_cases() + ramp_cases() + capi_cases():
        if case_key(c) not in held:
            held.add(case_key(c))
            KERNEL_CASES.append(c)
    FUSED_CASES.extend(generic_fused_cases())
    FUSED_CASES.extend(serving_fused_cases(SERVE_N))
    held = {c[:6] for c in FUSED_CASES}
    FUSED_CASES.extend(c for c in long_fused_cases() if c[:6] not in held)


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "distributedfft_tpu_torch")):
        fail("distributedfft_tpu_torch/ is not beside chip_smoke.py")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, here)
    import distributedfft_tpu_torch as dfft
    from distributedfft_tpu_torch.ops import _build, cuda_fft as cf
    from distributedfft_tpu_torch.ops import cuda_fuse as cfu, radix
    from distributedfft_tpu_torch.ops.executors import get_executor
    from distributedfft_tpu_torch.parallel.exchange import wire_codec
    from distributedfft_tpu_torch.utils import timing

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    t_script = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; bound "
          f"figures: {rates[2]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32

    from distributedfft_tpu_torch import native

    t0 = time.perf_counter()
    if not native.is_available():
        fail(f"the host library did not build: {native.build_error()}")
    native_build_s = time.perf_counter() - t0
    print(f"host library build+load (g++): {native_build_s:.2f} s "
          f"({os.path.relpath(native.SOURCE, here)})", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build+load: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(os.path.relpath(p, here) for p in _build.sources())}"
          f"); seconds per unit, all started together: "
          f"{getattr(_build, 'BUILD_SECONDS', 'not measured')}", flush=True)

    if sys.argv[1:] == ["--real-rows"]:
        # the fused real rows passes alone, on whichever package sits
        # beside this script
        check_real_rows(torch, cf, timing, rates, card)
        print(f"chip_smoke.py --real-rows: "
              f"{time.perf_counter() - t_script:.1f} s [{card}]", flush=True)
        return

    if sys.argv[1:] == ["--plane-gate"]:
        records = check_kernels(torch, cf, radix, timing, rates,
                                PLANE_GATE_CASES)
        check_plane_gate(torch, cf, get_executor("cuda"), timing, rates, card)
        print(json.dumps({"kernels": list(records.values())}), flush=True)
        print(f"chip_smoke.py --plane-gate: "
              f"{time.perf_counter() - t_script:.1f} s [{card}]", flush=True)
        return

    if sys.argv[1:] == ["--route-cases"]:
        # the fused kernels' cases and paths at cols = 1 and past 8192
        # alone, on whichever package sits beside this script (a parent
        # commit's, to compare): the pencils' last-axis sites at 512 and
        # 608, the long cases, the 608^3 and long paths, the split fused
        # pencil at 512^3 beside its twin
        cases = [c for c in FUSED_CASES + generic_fused_cases()
                 if math.prod(c[3][c[4] + 1:]) == 1] + long_fused_cases()
        check_fused_kernels(torch, cf, cfu, wire_codec, timing, rates, cases)
        dev = torch.device("cuda", torch.cuda.current_device())
        for run in (run_generic_fused_paths, run_long_paths):
            plans = run(torch, dfft, cf, cfu, dev)
            time_generic_fused_paths(torch, timing, dev, plans)
            del plans
            dfft.clear_plan_cache()
            torch.cuda.empty_cache()
        time_fused_pencil(torch, dfft, timing, dev)
        time_two_level_calls(torch, cf, timing, dev, card)
        extend_cases(cf)
        output_digests(torch, cf, cfu, wire_codec, dev)
        print(f"chip_smoke.py --route-cases: "
              f"{time.perf_counter() - t_script:.1f} s [{card}]", flush=True)
        return

    extend_cases(cf)
    records = check_kernels(torch, cf, radix, timing, rates)
    records.update(check_fused_kernels(torch, cf, cfu, wire_codec, timing,
                                       rates))
    records.update(check_real_rows(torch, cf, timing, rates, card))
    check_plane_gate(torch, cf, get_executor("cuda"), timing, rates, card)
    # the two-level route's record: its numbers are time_two_level's
    records["fft_last_big"] = dict(
        name="fft_last_big", route="cuda", source=TWO_LEVEL_SOURCE,
        replaces=REPLACES["fft_last_big"], launches=0, max_abs_err=0.0,
        ms=None, plain_ms=None, bound_ms=None, bound_by=None,
        library_ms=None)
    check_small(torch, dfft)

    # ---- the main path: counts from 0, single then slab, each once ----
    dev = torch.device("cuda", torch.cuda.current_device())
    fallbacks = dict(cf.FALLBACKS)   # no complex64 phase at 512 may add one
    with recording_cases(cf, cfu) as seen:
        cf.reset_launches()
        dfft.clear_plan_cache()
        torch.cuda.reset_peak_memory_stats()
        n = 512
        x = seeded(torch, (n, n, n), dev)
        single = run_plan_pair(torch, dfft, (n, n, n), None, x,
                               "single 512^3")
        after_single = cf.launches()
        routes_single = dict(cf.ROUTES)
        world = dfft.make_world(SLAB_RANKS)
        slab = run_plan_pair(torch, dfft, (n, n, n), world, x,
                             f"slab 512^3 loopback P={SLAB_RANKS}")
        after_slab = cf.launches()
        del x
        torch.cuda.empty_cache()
        uneven = (510, 510, 512)
        xu = seeded(torch, uneven, dev)
        run_plan_pair(torch, dfft, uneven, world, xu,
                      f"slab {uneven} loopback P={SLAB_RANKS}")
        del xu
    counts = cf.launches()
    print("launches on the main path (fwd+bwd each): single 512^3 "
          f"{after_single}; slab 512^3 "
          f"{ {k: after_slab[k] - after_single[k] for k in counts} }; "
          f"all {counts}", flush=True)
    check_routes(cf, "the main path", routes_single, dict(cf.ROUTES))
    check_covered(seen, "the main path")
    for k, v in counts.items():
        if v <= 0 and k not in NOT_EVERY_PATH:
            fail(f"kernel {k} was not launched on the main path")
        records[k]["launches"] = v
    print("exchange: loopback transports on one card (alltoall split/cat, "
          "alltoallv true slices, ppermute ring shifts, hierarchical legs: "
          "device copies on one stream, so no overlap to see); the NCCL "
          "process groups need >= 2 cards and are not run here (gloo is "
          "covered by the CPU tests, NCCL by the cuda-marked "
          "tests/test_torch_world.py and tests/test_torch_transports.py on "
          "a multi-card host)", flush=True)
    print(f"peak device memory of the main path: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # ---- times (after the counted run) ----
    x = seeded(torch, (n, n, n), dev)
    time_plans(torch, timing, *single, x, "single 512^3")
    time_plans(torch, timing, *slab, x, f"slab 512^3 loopback P={SLAB_RANKS}")
    stage_split(torch, timing, *slab, x, f"slab 512^3 loopback P={SLAB_RANKS}")
    del x
    torch.cuda.empty_cache()

    # ---- the non-smooth paths (608 = 2^5 * 19): counts from 0 ----
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.reset_peak_memory_stats()
    with recording_cases(cf, cfu) as seen:
        generic = check_generic_paths(torch, dfft, dev)
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on the non-smooth paths: {path}", flush=True)
    check_routes(cf, "the non-smooth paths", {}, dict(cf.ROUTES))
    check_covered(seen, "the non-smooth paths")
    print(f"peak device memory of the non-smooth paths: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for k in ("fft2_last", "fft_axis0", "fft_last"):
        if path[k] <= 0:
            fail(f"kernel {k} was not launched on the non-smooth paths")
    for k, v in path.items():
        records[k]["launches"] += v
    if dict(cf.FALLBACKS) != fallbacks:
        fail(f"the non-smooth paths took a fallback: {dict(cf.FALLBACKS)}")
    time_generic_paths(torch, timing, dev, generic)
    del generic
    torch.cuda.empty_cache()

    # ---- the 608^3 paths (kernels 1, 4 and 5 on the generic stage) ----
    generic = run_generic_fused_paths(torch, dfft, cf, cfu, dev, records)
    time_generic_fused_paths(torch, timing, dev, generic)
    del generic
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()

    # ---- the paths past 8192 (kernels 4 and 5 on the two-pass route) ----
    long = run_long_paths(torch, dfft, cf, cfu, dev, records)
    time_generic_fused_paths(torch, timing, dev, long)
    del long
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()

    # ---- the compressed and real path: counts from 0, each plan once ----
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.reset_peak_memory_stats()
    with recording_cases(cf, cfu) as seen:
        plans = check_fused_plans(torch, dfft, world)
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on the compressed and real path: {path}", flush=True)
    check_routes(cf, "the compressed and real path", {}, dict(cf.ROUTES))
    check_covered(seen, "the compressed and real path")
    print(f"peak device memory of the compressed and real path: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for k in cfu.KERNELS:
        if path[k] <= 0:
            fail(f"kernel {k} was not launched on the compressed path")
    for k, v in path.items():
        records[k]["launches"] += v

    # ---- times of the compressed and real plans ----
    x = seeded(torch, (n, n, n), dev)
    c2c_f, c2c_b, _ = plans.pop("c2c split fused")
    time_plans(torch, timing, c2c_f, c2c_b, x,
               f"c2c split fused 512^3 loopback P={SLAB_RANKS}")
    stage_split(torch, timing, c2c_f, c2c_b, x,
                f"c2c split fused 512^3 loopback P={SLAB_RANKS}")
    del x
    torch.cuda.empty_cache()
    xr = seeded_real(torch, (n, n, n), dev)
    for label, (f, b, _) in plans.items():
        time_real(torch, timing, f, b, xr, f"{label} 512^3"
                  + ("" if "single" in label else f" loopback P={SLAB_RANKS}"))
    spec = plans["r2c/c2r exact"][0](xr)
    for label in ("r2c/c2r exact", "r2c/c2r split fused"):
        f, b, _ = plans[label]
        stage_split(torch, timing, f, b, xr,
                    f"{label} 512^3 loopback P={SLAB_RANKS}", x_bwd=spec)
    del xr, spec
    torch.cuda.empty_cache()

    # ---- the pencil path: counts from 0, each plan once ----
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.reset_peak_memory_stats()
    with recording_cases(cf, cfu) as seen:
        pencil = check_pencil(torch, dfft, dev)
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on the pencil path: {path}", flush=True)
    check_routes(cf, "the pencil path", {}, dict(cf.ROUTES))
    check_covered(seen, "the pencil path")
    print(f"peak device memory of the pencil path: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for k in ("fft_last", "fft_axis0", "fft_encode", "decode_fft"):
        if path[k] <= 0:
            fail(f"kernel {k} was not launched on the pencil path")
    for k in ("fft_encode", "decode_fft"):   # t0_fft_z, bwd t3_fft_z
        if cf.ROUTES[(k, "radix_rows")] <= 0:
            fail(f"kernel {k} did not take its row form on the pencil path")
    for k, v in path.items():
        records[k]["launches"] += v
    if dict(cf.FALLBACKS) != fallbacks:
        fail(f"a complex64 phase at 512 took a fallback: "
             f"{dict(cf.FALLBACKS)} (before: {fallbacks})")
    print(f"fallbacks on the complex64 paths at 512: none "
          f"({dict(cf.FALLBACKS)} before and after)", flush=True)

    # ---- times of the pencil plans ----
    x = seeded(torch, (n, n, n), dev)
    xr = seeded_real(torch, (n, n, n), dev)
    grid = f"{PENCIL_GRID[0]}x{PENCIL_GRID[1]}"
    for label, (f, b, kind) in pencil.items():
        inp = x if kind == "c2c" else xr
        y = f(inp)
        t_f = timing.cuda_time_ms(lambda: f(inp), iters=10)
        t_b = timing.cuda_time_ms(lambda: b(y), iters=10)
        print(f"{label} 512^3 {grid}: forward_ms={t_f:.3f} "
              f"({timing.gflops((n, n, n), t_f / 1e3):.1f} GFlop/s) "
              f"backward_ms={t_b:.3f}", flush=True)
        stage_medians(torch, timing, f, inp, f"{label} 512^3 {grid} forward")
        stage_medians(torch, timing, b, y, f"{label} 512^3 {grid} backward")
        del y
        torch.cuda.empty_cache()
    del x, xr, pencil
    torch.cuda.empty_cache()

    # ---- the transports, overlap and staged path: counts from 0 ----
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.reset_peak_memory_stats()
    with recording_cases(cf, cfu) as seen:
        transport = check_transports(torch, dfft, dev)
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on the transport path: {path}", flush=True)
    check_routes(cf, "the transport path", {}, dict(cf.ROUTES))
    check_covered(seen, "the transport path")
    print(f"peak device memory of the transport path: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for k in ("fft2_last", "fft_axis0", "fft_last", "fft_encode",
              "decode_fft"):
        if path[k] <= 0:
            fail(f"kernel {k} was not launched on the transport path")
    for k, v in path.items():
        records[k]["launches"] += v
    if dict(cf.FALLBACKS) != fallbacks:
        fail(f"the transport path took a fallback: {dict(cf.FALLBACKS)}")
    with recording_cases(cf, cfu) as seen:
        check_staged(torch, dfft, timing, dev)
        log_spans = traced_run(torch, dfft, dev, here)
    check_covered(seen, "the staged and traced runs")
    time_transport_plans(torch, timing, dev, transport)
    del transport
    torch.cuda.empty_cache()

    # ---- the brick, batched, layout and r2c_axis path: counts from 0 ----
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.reset_peak_memory_stats()
    with recording_cases(cf, cfu) as seen:
        bricks = check_bricks(torch, dfft, dev)
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on the brick path: {path}", flush=True)
    check_routes(cf, "the brick path", {}, dict(cf.ROUTES))
    check_covered(seen, "the brick path")
    batch_keys = {c[:3]: c[3] for c in batch_cases(512)}
    batch_keys.update({("r2c_half" if fwd else "c2r_half", fwd, shape): where
                       for fwd, shape, where in REAL_ROWS_CASES
                       if where.startswith("batch=2")})
    # the real wrappers' launches are in CASES alone (recording_cases does
    # not see them), the others' in both
    print("launches on the brick path at the batch = 2 shapes: " + "; ".join(
        f"{k[0]} {'fwd' if k[1] else 'inv'} {list(k[2])} ({batch_keys[k]}):"
        f" {max(seen[k], cf.CASES[k])}" for k in batch_keys), flush=True)
    print(f"peak device memory of the brick path: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for k in ("fft2_last", "fft_axis0", "fft_last"):
        if path[k] <= 0:
            fail(f"kernel {k} was not launched on the brick path")
    for k, v in path.items():
        records[k]["launches"] += v
    if dict(cf.FALLBACKS) != fallbacks:
        fail(f"the brick path took a fallback: {dict(cf.FALLBACKS)}")
    time_bricks(torch, dfft, timing, dev, bricks)
    del bricks
    torch.cuda.empty_cache()

    # ---- the spectral-operator path: counts from 0 ----
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.reset_peak_memory_stats()
    with recording_cases(cf, cfu) as seen:
        ops = check_operators(torch, dfft, dev, card)
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on the operator path: {path}", flush=True)
    check_routes(cf, "the operator path", {}, dict(cf.ROUTES))
    check_covered(seen, "the operator path")
    op_keys = {c[:3]: c[3] for c in op_cases(512)}
    print("launches on the operator path at its own shapes: " + "; ".join(
        f"{k[0]} {'fwd' if k[1] else 'inv'} {list(k[2])} ({op_keys[k]}):"
        f" {seen[k]}" for k in op_keys), flush=True)
    print(f"peak device memory of the operator path: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for k in ("fft2_last", "fft_axis0", "fft_last", "fft_encode",
              "decode_fft"):
        if path[k] <= 0:
            fail(f"kernel {k} was not launched on the operator path")
    for k, v in path.items():
        records[k]["launches"] += v
    if dict(cf.FALLBACKS) != fallbacks:
        fail(f"the operator path took a fallback: {dict(cf.FALLBACKS)}")
    with recording_cases(cf, cfu) as seen:
        check_op_staged_and_traced(torch, dfft, timing, dev, here, card, ops)
    check_covered(seen, "the staged and traced operator runs")
    time_operators(torch, dfft, timing, dev, card, ops)
    del ops
    torch.cuda.empty_cache()

    # ---- the long 1D paths: two-level axes, then the distributed plan ----
    for label, drive, used, unused in (
            ("the two-level path", lambda: check_two_level(torch, cf, dev),
             ("fft_last_big",), ("fft_axis0", "fft_last")),
            ("the distributed 1D path",
             lambda: check_dist1d(torch, dfft, dev),
             ("fft_axis0", "fft_last"), ("fft_last_big",))):
        cf.reset_launches()
        cfu.reset_launches()
        dfft.clear_plan_cache()
        torch.cuda.reset_peak_memory_stats()
        with recording_cases(cf, cfu) as seen:
            kept = drive()
        path = {**cf.launches(), **cfu.launches()}
        print(f"launches on {label}: {path}", flush=True)
        check_routes_by_length(cf, seen, label)
        check_covered(seen, label)
        print(f"peak device memory of {label}: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        for k in used:
            if path[k] <= 0:
                fail(f"kernel {k} was not launched on {label}")
        for k in unused:
            if path[k]:
                fail(f"kernel {k} was launched on {label}: {path}")
        for k, v in path.items():
            records[k]["launches"] += v
        if dict(cf.FALLBACKS) != fallbacks:
            fail(f"{label} took a fallback: {dict(cf.FALLBACKS)}")
    time_two_level(torch, cf, timing, dev, card, rates, records)
    time_dist1d(torch, timing, dev, card, rates, kept)
    del kept
    torch.cuda.empty_cache()

    # ---- the concurrent scheduler: counts from 0 ----
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.reset_peak_memory_stats()
    with recording_cases(cf, cfu) as seen:
        pairs, xs = check_concurrent(torch, dfft, dev)
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on the concurrent path: {path}", flush=True)
    check_routes(cf, "the concurrent path", {}, dict(cf.ROUTES))
    check_covered(seen, "the concurrent path")
    print(f"peak device memory of the concurrent path: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for k in ("fft2_last", "fft_axis0", "fft_last"):
        if path[k] <= 0:
            fail(f"kernel {k} was not launched on the concurrent path")
    for k, v in path.items():
        records[k]["launches"] += v
    time_concurrent(torch, dfft, timing, card, pairs, xs)
    del pairs, xs
    torch.cuda.empty_cache()

    # ---- complex128 and the matmul tiers ----
    before = dict(cf.FALLBACKS)
    for label, (f, b, x) in check_complex128(torch, dfft, dev).items():
        y = f(x)
        print(f"{label}: forward_ms="
              f"{timing.cuda_time_ms(lambda: f(x), iters=5):.3f} "
              f"backward_ms={timing.cuda_time_ms(lambda: b(y), iters=5):.3f}",
              flush=True)
        del y
    routed = {k: v - before.get(k, 0) for k, v in cf.FALLBACKS.items()
              if v != before.get(k, 0)}
    print(f"c128 fallbacks to dft_matmul, (axis, reason): {routed}",
          flush=True)
    torch.cuda.empty_cache()
    check_matmul_tiers(torch, timing, dev)

    # ---- the dd tier: counts from 0, then times and one metrics pass ----
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_dd = time.perf_counter()
    kept = check_dd(torch, dfft, dev)
    print(f"peak device memory of the dd path: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    time_dd(torch, dfft, timing, dev, card, kept)
    dd_metrics_line(torch, dfft, dev, kept["pair"])
    print(f"dd phase: {time.perf_counter() - t_dd:.1f} s", flush=True)
    del kept
    dfft.clear_plan_cache()
    torch.cuda.empty_cache()

    # ---- measured planning: counts from 0 ----
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(cf.FALLBACKS)      # the complex128 phase adds its own
    t_tune = time.perf_counter()
    with recording_cases(cf, cfu) as seen:
        _, cal, hw_path = check_tuner(torch, dfft, cf, cfu, dev, card)
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on the measured-planning path after calibrate(): "
          f"{path}", flush=True)
    check_routes(cf, "the measured-planning path", {}, dict(cf.ROUTES))
    check_covered(seen, "the measured-planning path")
    for k, v in path.items():
        if v <= 0 and k not in NOT_EVERY_PATH:
            fail(f"kernel {k} was not launched on the measured-planning "
                 f"path after calibrate()")
        records[k]["launches"] += v + cal.get(k, 0)
    if dict(cf.FALLBACKS) != before:
        fail(f"the measured-planning path took a fallback: "
             f"{dict(cf.FALLBACKS)} (before: {before})")
    print(f"peak device memory of the measured-planning path: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"measured-planning phase: {time.perf_counter() - t_tune:.1f} s",
          flush=True)

    # ---- explain and attribution: counts from 0 ----
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(cf.FALLBACKS)
    t_explain = time.perf_counter()
    with recording_cases(cf, cfu) as seen:
        check_explain(torch, dfft, dev, here, card, hw_path)
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on the explain path: {path}", flush=True)
    check_routes(cf, "the explain path", {}, dict(cf.ROUTES))
    check_covered(seen, "the explain path")
    for k, v in path.items():
        if v <= 0 and k not in NOT_EVERY_PATH:
            fail(f"kernel {k} was not launched on the explain path")
        records[k]["launches"] += v
    if dict(cf.FALLBACKS) != before:
        fail(f"the explain path took a fallback: {dict(cf.FALLBACKS)} "
             f"(before: {before})")
    print(f"explain phase: {time.perf_counter() - t_explain:.1f} s",
          flush=True)

    # ---- the serving tier: counts from 0 ----
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(cf.FALLBACKS)
    with recording_cases(cf, cfu) as seen:
        check_serving(torch, dfft, dev, card, hw_path)
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on the serving path: {path}", flush=True)
    check_routes(cf, "the serving path", {}, dict(cf.ROUTES))
    check_covered(seen, "the serving path")
    q, n = SERVE_N // SLAB_RANKS, SERVE_N
    batched = [("fft2_last", True, (2 * q, n, n)),
               ("fft_axis0", True, (2, n, q * n)),
               ("fft_axis0", False, (2, n, q * n)),
               ("fft_last", False, (2 * q * n, n))]
    fused = [c[:6] for c in serving_fused_cases(SERVE_N)]
    print("launches on the serving path at the batch = 2 cases: " + "; ".join(
        f"{k}: {seen[k]}" for k in batched + fused), flush=True)
    for k in batched + fused:
        if seen[k] <= 0:
            fail(f"the serving path did not launch {k}")
    for k in ("fft_encode", "decode_fft"):   # the audited pencil queue's
        if cf.ROUTES[(k, "radix_rows")] <= 0:
            fail(f"kernel {k} did not take its row form on the serving "
                 f"path")
    for k, v in path.items():
        if v <= 0 and k not in NOT_EVERY_PATH:
            fail(f"kernel {k} was not launched on the serving path")
        records[k]["launches"] += v
    if dict(cf.FALLBACKS) != before:
        fail(f"the serving path took a fallback: {dict(cf.FALLBACKS)} "
             f"(before: {before})")
    print(f"peak device memory of the serving path: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # ---- the fleet: counts from 0 (this process), plus the workers' ----
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.reset_peak_memory_stats()
    with recording_cases(cf, cfu) as seen:
        fleet = check_fleet(torch, dfft, dev, here, card)
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on the fleet path: this process {path}; the workers "
          f"(other processes, counted by their own wrappers) "
          f"{fleet['launches']} at {len(fleet['cases'])} cases", flush=True)
    check_routes(cf, "the fleet path", {}, dict(cf.ROUTES))
    check_covered(seen, "the fleet path (this process and the workers)",
                  fleet["cases"])
    for k in ("fft2_last", "fft_axis0", "fft_last"):
        if path[k] <= 0:
            fail(f"kernel {k} was not launched on the fleet path")
    for k, v in path.items():
        records[k]["launches"] += v + fleet["launches"].get(k, 0)

    # ---- the regression loop and the report CLI: counts from 0 ----
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(cf.FALLBACKS)
    with recording_cases(cf, cfu) as seen:
        check_regression_loop(torch, dfft, dev, here, card, hw_path,
                              log_spans, fleet["fault"]["streams"])
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on the regression-loop path: {path}", flush=True)
    check_routes(cf, "the regression-loop path", {}, dict(cf.ROUTES))
    check_covered(seen, "the regression-loop path")
    for k in ("fft2_last", "fft_axis0"):
        if path[k] <= 0:
            fail(f"kernel {k} was not launched on the regression-loop path")
    for k, v in path.items():
        records[k]["launches"] += v
    if dict(cf.FALLBACKS) != before:
        fail(f"the regression-loop path took a fallback: "
             f"{dict(cf.FALLBACKS)} (before: {before})")
    shutil.rmtree(os.path.dirname(hw_path), ignore_errors=True)

    # ---- the C ABI: counts from 0 ----
    cf.reset_launches()
    cfu.reset_launches()
    dfft.clear_plan_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(cf.FALLBACKS)
    with recording_cases(cf, cfu) as seen:
        check_c_abi(torch, dfft, timing, dev, here, card, native_build_s)
    path = {**cf.launches(), **cfu.launches()}
    print(f"launches on the C ABI path: {path}", flush=True)
    check_routes(cf, "the C ABI path", {}, dict(cf.ROUTES))
    check_covered(seen, "the C ABI path")
    for k in ("fft2_last", "fft_axis0", "fft_last"):
        if path[k] <= 0:
            fail(f"kernel {k} was not launched on the C ABI path")
    for k, v in path.items():
        records[k]["launches"] += v
    if dict(cf.FALLBACKS) != before:
        fail(f"the C ABI path took a fallback: {dict(cf.FALLBACKS)} "
             f"(before: {before})")
    print(f"peak device memory of the C ABI path: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"chip_smoke.py: {time.perf_counter() - t_script:.1f} s [{card}]",
          flush=True)

    if records["fft_last_big"]["ms"] is None:
        fail("the two-level route's record was not timed")
    print(json.dumps({"kernels": [
        {k: rec[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms",
                             "bound_ms", "bound_by", "library_ms")}
        for rec in records.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
