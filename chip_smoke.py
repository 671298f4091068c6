#!/usr/bin/env python3
"""Smoke test of distributedfft_tpu_torch on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit and builds the CUDA kernels
   from ``distributedfft_tpu_torch/csrc`` (nvcc, sm_90a);
2. holds each kernel against its plain PyTorch version at every shape
   the main path gives it (complex64, zero-mean seeded data; max-norm
   and L2 relative error each <= 5e-4), and against the torch.fft call
   that computes the same function, whose arithmetic is independent of
   the kernel's; times the kernel, the plain version and that call (a
   yardstick only) beside the least time the card could take;
3. checks the port on a small uneven input against numpy's float64 fftn
   (single device and the 4-rank slab; the repo's seeded world data);
4. drives the main path: the single-device plan at 512^3 forward and
   backward, then the slab chain on a loopback world of 4 ranks at 512^3
   and at (510, 510, 512), each checked against torch.fft.fftn and by a
   round trip; every kernel must have been launched in that run;
5. prints one JSON line of the kernels and, last, the device line.

Any failed check exits nonzero before the last line. Without a CUDA
device, or without the package beside it, it exits nonzero at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

TOL = 5e-4          # complex64 tier of distributedfft_tpu/testing.py
SEED = 4242
SLAB_RANKS = 4
SOURCE = "distributedfft_tpu_torch/csrc/four_step.cu"
REPLACES = {
    "fft2_last": "distributedfft_tpu/ops/pallas_fft.py:488",
    "fft_axis0": "distributedfft_tpu/ops/pallas_fft.py:580",
    "fft_last": "distributedfft_tpu/ops/pallas_fft.py:406",
}


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


# Every (kernel, direction, shape) the main path launches, and where:
# the slab chain at 512^3 and (510, 510, 512) on 4 ranks, the single
# device at 512^3. The first case of each kernel is its record's shape.
# Three more (marked "also") are the other direction at a slab shape.
KERNEL_CASES = [
    ("fft2_last", True, (128, 512, 512), "slab fwd t0"),
    ("fft2_last", False, (128, 512, 512), "also"),
    ("fft2_last", True, (128, 510, 512), "uneven slab fwd t0"),
    ("fft2_last", True, (512, 512, 512), "single fwd"),
    ("fft2_last", False, (512, 512, 512), "single bwd"),
    ("fft_axis0", True, (1, 512, 65536), "slab fwd t3"),
    ("fft_axis0", False, (1, 512, 65536), "slab bwd t0"),
    ("fft_axis0", True, (128, 512, 512), "also"),
    ("fft_axis0", False, (128, 512, 512), "slab bwd t3"),
    ("fft_axis0", True, (1, 510, 65536), "uneven slab fwd t3"),
    ("fft_axis0", False, (1, 510, 65536), "uneven slab bwd t0"),
    ("fft_axis0", False, (128, 510, 512), "uneven slab bwd t3"),
    ("fft_axis0", True, (1, 512, 262144), "single fwd"),
    ("fft_axis0", False, (1, 512, 262144), "single bwd"),
    ("fft_last", False, (65536, 512), "slab bwd t0"),
    ("fft_last", True, (65536, 512), "also"),
    ("fft_last", False, (65280, 512), "uneven slab bwd t0"),
]


def library_call(torch, name, fwd):
    """The torch.fft call that computes what kernel ``name`` does."""
    if name == "fft2_last":
        return torch.fft.fft2 if fwd else torch.fft.ifft2
    dim = 1 if name == "fft_axis0" else -1
    f = torch.fft.fft if fwd else torch.fft.ifft
    return lambda x: f(x, dim=dim)


def check_kernels(torch, cf, timing, rates):
    """Phase 2: each kernel against its plain version at every shape the
    main path gives it. Returns one record per kernel."""
    hbm, fp32, _ = rates
    dev = torch.device("cuda", torch.cuda.current_device())
    records = {}
    for i, (name, fwd, shape, where) in enumerate(KERNEL_CASES):
        kernel = getattr(cf, name)
        plain = getattr(cf, f"{name}_plain")
        lib = library_call(torch, name, fwd)
        label = (f"{'fwd' if fwd else 'inv'} [{','.join(map(str, shape))}]"
                 f" ({where})")
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
        numel = math.prod(shape)
        if name == "fft2_last":
            n = shape[1] * shape[2]
            facs = cf.split_for(shape[1]) + cf.split_for(shape[2])
        else:
            n = shape[1] if name == "fft_axis0" else shape[-1]
            facs = cf.split_for(n)
        model_flops = 5.0 * numel * math.log2(n)
        kernel_flops = 8.0 * numel * sum(facs)   # 8 n (n1 + n2) per row
        bytes_moved = 2 * numel * 8               # read once, write once
        t_bytes, t_ops = bytes_moved / hbm * 1e3, model_flops / fp32 * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"kernel {name:9s} {label:40s} max_rel_err={err:.3e} "
              f"l2_rel_err={l2:.3e} max_abs_err={abs_err:.3e} "
              f"vs_torch_fft_max_rel={lib_err:.3e} "
              f"vs_torch_fft_l2_rel={lib_l2:.3e} "
              f"kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) "
              f"kernel_gflop={kernel_flops / 1e9:.3f} "
              f"kernel_gflops_rate={kernel_flops / ms / 1e6:.1f}", flush=True)
        rec = records.setdefault(name, dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
        rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
        del x
        torch.cuda.empty_cache()
    return records


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


def stage_split(torch, timing, fwd, bwd, x, label):
    """t0..t3 of one forward and one backward run of a slab plan."""
    for plan, what in ((fwd, "forward"), (bwd, "backward")):
        plan(x)  # warm
        timer = timing.StageTimer(x.device)
        y = plan(x, timer=timer)
        times = timer.times()
        del y
        print(f"{label} {what} stages (CUDA events, ms): " + " ".join(
            f"{k}={v * 1e3:.3f}" for k, v in times.items()), flush=True)


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
    from distributedfft_tpu_torch.utils import timing

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; bound "
          f"figures: {rates[2]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build+load: {time.perf_counter() - t0:.1f} s "
          f"({_build.SOURCE})", flush=True)

    records = check_kernels(torch, cf, timing, rates)
    check_small(torch, dfft)

    # ---- the main path: counts from 0, single then slab, each once ----
    dev = torch.device("cuda", torch.cuda.current_device())
    cf.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    n = 512
    x = seeded(torch, (n, n, n), dev)
    single = run_plan_pair(torch, dfft, (n, n, n), None, x,
                           "single 512^3")
    after_single = cf.launches()
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
    for k, v in counts.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the main path")
        records[k]["launches"] = v
    print("exchange: loopback all-to-all (split/cat on one card); NCCL "
          "all_to_all_single needs >= 2 cards and is not run here (the "
          "gloo process group is covered by the CPU tests, NCCL by the "
          "cuda-marked tests/test_torch_world.py on a multi-card host)",
          flush=True)
    print(f"peak device memory of the main path: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # ---- times (after the counted run) ----
    x = seeded(torch, (n, n, n), dev)
    time_plans(torch, timing, *single, x, "single 512^3")
    time_plans(torch, timing, *slab, x, f"slab 512^3 loopback P={SLAB_RANKS}")
    stage_split(torch, timing, *slab, x, f"slab 512^3 loopback P={SLAB_RANKS}")
    del x
    torch.cuda.empty_cache()

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
