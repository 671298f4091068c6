"""Calibrated hardware profiles: measured per-card constants.

The port of ``distributedfft_tpu/calibrate.py``. The tuner's pruning
model (:func:`.tuner.model_cost`) prices candidates with hardware
constants; a profile replaces its ranking constants by short
microbenchmarks on the running card:

- **HBM bandwidth**: a streamed ``v + 1`` over a 1 GiB float32 block
  (one read and one write a pass), timed amortised.
- **Matmul rates**, one per precision tier of the port's matmul
  products (:mod:`.ops.dft_matmul`): ``bf16`` (operands rounded to
  bfloat16, products in fp32), ``f32`` (TF32) and ``highest`` (fp32,
  TF32 off), each ``2 n^3`` flops of one square product over its time;
  and ``peak_tflops``, one bfloat16 product on the card (float32 on the
  CPU).
- **Wire bandwidth**: a one-hop ring shift (``dist.batch_isend_irecv``)
  over the ranks of a process group: every rank ships its block to its
  neighbour, so the time is one link's. Null in one process, as the JAX
  package's is on one device. Across several processes ``ici_gbps`` and
  ``dcn_gbps`` come from the two axes of the hybrid world
  (:func:`.parallel.multihost.make_hybrid_world`); ``dcn_gbps`` is null
  on one node.
- **Fuse speedup**: the fused encode kernel
  (:func:`.ops.cuda_fuse.fused_fft_encode`) against the strided kernel
  followed by the ``split`` codec's encode, on the card only (off the
  card both run their plain versions and the ratio would measure
  PyTorch on the CPU).
- **Launch floor**: a tiny op, synchronised per call.

The profile is JSON next to the tuner's wisdom store
(``<compile cache dir>/hwprofile.json``; ``DFFT_HW_PROFILE`` overrides,
empty or ``0`` disables). Its identity is ``(device_kind, platform)``:
``(torch.cuda.get_device_name(), "gpu")`` on the card, ``("cpu", "cpu")``
otherwise; a profile of other hardware is never read.
:func:`.tuner.model_cost` applies its per-transport ``model_correction``
(the persisted measured / modelled ratios of earlier tournaments).
"""

from __future__ import annotations

import json
import math
import os
import time

import torch

__all__ = [
    "PROFILE_SCHEMA",
    "default_profile_path",
    "load_profile",
    "matching_profile",
    "write_profile",
    "update_model_correction",
    "model_correction",
    "calibrate",
    "format_profile",
]

PROFILE_SCHEMA = 1

#: The JAX package's HBM block and matmul side, chosen for a TPU, and
#: the larger ones :func:`size_check` holds them against: a size is kept
#: where its rates reach within ``_SIZE_TOLERANCE`` of the larger size's.
_JAX_HBM_BYTES = 64 * 1024 * 1024
_JAX_MM_N = 1024
_LARGE_HBM_BYTES = 1 << 30
_LARGE_MM_N = 8192
_SIZE_TOLERANCE = 0.10

#: The HBM block and the matmul side of the microbenchmarks, and the
#: per-rank block of the wire ring. Both are the larger sizes: in two
#: runs of ``python -m distributedfft_tpu_torch.calibrate --sizes`` on an
#: NVIDIA H100 80GB HBM3 at 700.00 W, the 64 MiB block read 0.880x and
#: 0.914x of the 1 GiB block's rate, and at n = 1024 the matmul tiers
#: read 9-69% and the bf16 peak 11-16% of their n = 8192 rates.
_HBM_BYTES = _LARGE_HBM_BYTES
_MM_N = _LARGE_MM_N
_WIRE_BYTES = 8 * 1024 * 1024

#: The fused-encode block: JAX's (rows, n, tiles) with the DFT axis
#: leading, the axis the fused kernel runs as a column pass.
_FUSE_BLOCK = (256, 512, 8)


def default_profile_path() -> str | None:
    """``DFFT_HW_PROFILE`` when set (empty or ``0``: no profile, None),
    else ``hwprofile.json`` under :func:`.utils.cache.compile_cache_dir`,
    the wisdom store's home."""
    env = os.environ.get("DFFT_HW_PROFILE")
    if env is not None:
        env = env.strip()
        return None if env in ("", "0") else env
    from .utils.cache import compile_cache_dir

    return os.path.join(compile_cache_dir(), "hwprofile.json")


# The loaded profile, keyed (path, mtime), so the per-candidate
# model_cost calls of one pruning pass read the file once.
_cache: tuple[str, float, dict | None] | None = None


def load_profile(path: str | None = None) -> dict | None:
    """The stored profile document, or None (no store, a missing or
    malformed file; never a raise). Cached by the file's mtime."""
    global _cache
    if path is None:
        path = default_profile_path()
    if path is None:
        return None
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    if _cache is not None and _cache[0] == path and _cache[1] == mtime:
        return _cache[2]
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        doc = None
    if not isinstance(doc, dict):
        doc = None
    _cache = (path, mtime, doc)
    return doc


def _current_identity() -> tuple[str, str]:
    """(device_kind, platform) of this process: the card's name and
    ``"gpu"``, or ``("cpu", "cpu")`` without CUDA."""
    try:
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(), "gpu"
    except Exception:  # noqa: BLE001 -- identity must work without a card
        pass
    return "cpu", "cpu"


def matching_profile(path: str | None = None) -> dict | None:
    """The stored profile when it was calibrated on this hardware (device
    kind and platform both match), else None."""
    prof = load_profile(path)
    if prof is None:
        return None
    kind, platform = _current_identity()
    if prof.get("device_kind") != kind or prof.get("platform") != platform:
        return None
    return prof


def write_profile(profile: dict, path: str | None = None) -> str | None:
    """Replace the profile document (temp file and rename, so a reading
    ``model_cost`` never sees half of it); the path, or None when the
    store is disabled."""
    global _cache
    if path is None:
        path = default_profile_path()
    if path is None:
        return None
    from .utils.atomicio import replace_file

    replace_file(path, json.dumps(profile, sort_keys=True, indent=1) + "\n")
    _cache = None
    return path


def update_model_correction(ratios: dict[str, float],
                            path: str | None = None) -> dict | None:
    """Merge measured / modelled ratios per transport into the profile's
    ``model_correction`` block, each blended 50/50 with the stored one.
    A profile of other hardware (or none) is replaced by a
    correction-only stub; a matching one keeps every measured field."""
    ratios = {str(k): float(v) for k, v in ratios.items()
              if isinstance(v, (int, float)) and math.isfinite(v) and v > 0}
    if not ratios:
        return None
    if path is None:
        path = default_profile_path()
    if path is None:
        return None
    kind, platform = _current_identity()
    prof = load_profile(path)
    if (prof is None or prof.get("device_kind") != kind
            or prof.get("platform") != platform):
        prof = {"schema": PROFILE_SCHEMA, "device_kind": kind,
                "platform": platform}
    corr = dict(prof.get("model_correction") or {})
    for alg, r in ratios.items():
        old = corr.get(alg)
        corr[alg] = (0.5 * (float(old) + r)
                     if isinstance(old, (int, float)) and old > 0 else r)
    prof["model_correction"] = corr
    prof["correction_updated_at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    write_profile(prof, path)
    return prof


def model_correction(algorithm: str, path: str | None = None) -> float:
    """The pruning model's correction factor for ``algorithm`` on this
    hardware (measured / modelled seconds), clamped to [0.1, 10]; 1.0
    without a matching profile or a stored ratio."""
    prof = matching_profile(path)
    if prof is None:
        return 1.0
    corr = prof.get("model_correction")
    if not isinstance(corr, dict):
        return 1.0
    r = corr.get(str(algorithm))
    if not isinstance(r, (int, float)) or not math.isfinite(r) or r <= 0:
        return 1.0
    return min(10.0, max(0.1, float(r)))


# -------------------------------------------------------- microbenchmarks

def _device(device=None) -> torch.device:
    """The device to measure on (:func:`.api.resolve_device`): the card
    unless ``device`` names another; raises without a card."""
    from .api import resolve_device

    return resolve_device(device)


def _measure_hbm_gbps(iters: int, nbytes: int | None = None, *,
                      device=None) -> float | None:
    """Streamed ``v + 1``: one pass reads and writes the block once."""
    from .utils.timing import time_fn_amortized

    nbytes = _HBM_BYTES if nbytes is None else int(nbytes)
    x = torch.zeros(nbytes // 4, dtype=torch.float32,
                    device=_device(device))
    t, _ = time_fn_amortized(lambda v: v + 1.0, x, iters=iters, repeats=2)
    return (2.0 * nbytes / t) / 1e9 if t > 0 else None


def _mm_tflops(iters: int, product, dtype=torch.float32,
               n: int | None = None, *, device=None) -> float | None:
    """TFlop/s of ``product(a, a)`` on one square ``n x n`` block of
    ``dtype``: ``2 n^3`` flops over the amortised time."""
    from .utils.timing import time_fn_amortized

    n = _MM_N if n is None else int(n)
    a = torch.ones((n, n), dtype=dtype, device=_device(device))
    t, _ = time_fn_amortized(product, a, a, iters=iters, repeats=2)
    return (2.0 * n ** 3 / t) / 1e12 if t > 0 else None


def _measure_peak_tflops(iters: int, *, device=None) -> float | None:
    """One square matmul in bfloat16 on the card (its tensor cores'
    native feed), float32 on the CPU."""
    dev = _device(device)
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    return _mm_tflops(iters, torch.matmul, dt, device=dev)


def _tier_product(tier: str):
    """The real product the matmul executors run at ``tier`` (the port's
    :func:`.ops.dft_matmul._real_product` inside the tier's scope)."""
    from .ops import dft_matmul
    from .ops.executors import TIER_PRECISION

    prec = TIER_PRECISION[tier]

    def product(a, b):
        with dft_matmul.mm_scope(precision=prec):
            return dft_matmul._real_product("ij,jk->ik", a, b)

    return product


def _measure_mm_tier_tflops(iters: int, n: int | None = None, *,
                            device=None
                            ) -> tuple[float | None, float | None,
                                       float | None]:
    """``(mm_bf16_tflops, mm_f32_tflops, mm_highest_tflops)``: the rate
    of each matmul tier as the port runs it, the three points the
    tuner's precision-tier model prices candidates with
    (:func:`.tuner.mm_tier_tflops`)."""
    return tuple(_mm_tflops(iters, _tier_product(t), n=n, device=device)
                 for t in ("bf16", "f32", "highest"))


def _ring_gbps(iters: int, world, axis, nbytes: int | None = None
               ) -> float | None:
    """Per-link bandwidth along one axis of a process-group world: every
    rank ships its block one hop along its ring of ``axis`` with
    ``dist.batch_isend_irecv``, so the seconds are one link's. None when
    the axis has one member. Every rank of the world must call it."""
    import torch.distributed as dist

    from .utils.timing import time_fn_amortized

    nbytes = _WIRE_BYTES if nbytes is None else int(nbytes)
    members = next(m for m in world.axis_members(axis) if world.rank in m)
    parts = len(members)
    if parts < 2:
        return None
    group = world.group if world.group is not None else dist.group.WORLD
    glob = [dist.get_global_rank(group, r) for r in members]
    me = members.index(world.rank)
    to, frm = glob[(me + 1) % parts], glob[(me - 1) % parts]
    dev = torch.device("cuda", torch.cuda.current_device()) if (
        dist.get_backend(group) == "nccl") else torch.device("cpu")
    send = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)
    recv = torch.empty_like(send)

    def shift(s):
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, s, to),
                                       dist.P2POp(dist.irecv, recv, frm)])
        for r in reqs:
            r.wait()
        return recv

    t, _ = time_fn_amortized(shift, send, iters=iters, repeats=2)
    return (nbytes / t) / 1e9 if t > 0 else None


def _process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _measure_wire_gbps(iters: int) -> float | None:
    """The flat per-link figure: one ring over every process of the
    default group. None in one process."""
    if _process_count() < 2:
        return None
    from .parallel.mesh import process_group_world

    world = process_group_world()
    return _ring_gbps(iters, world, world.combined_axis)


def _measure_leg_gbps(iters: int) -> tuple[float | None, float | None]:
    """``(ici_gbps, dcn_gbps)``: with several processes, a ring along
    each axis of the hybrid world (the cards of a node, then the nodes);
    in one process the flat figure and None."""
    if _process_count() < 2:
        return _measure_wire_gbps(iters), None
    from .parallel.multihost import make_hybrid_world

    world = make_hybrid_world()
    dcn_axis, ici_axis = world.axis_names
    return (_ring_gbps(iters, world, ici_axis),
            _ring_gbps(iters, world, dcn_axis))


def _measure_fuse_speedup(iters: int, *, device=None) -> float | None:
    """The fused encode kernel's speedup over the unfused pair (the
    strided kernel to memory, then the ``split`` codec's encode reading
    it back) on one block: ``> 1`` means the fused tier's saved pass is
    real on this card. The card only: off it both run their plain
    versions (None)."""
    dev = _device(device)
    if dev.type != "cuda":
        return None
    from .ops import cuda_fft, cuda_fuse
    from .parallel.exchange import wire_codec
    from .utils.timing import time_fn_amortized

    rows, n, tiles = _FUSE_BLOCK
    if cuda_fuse.kernel_ineligible((n, rows), 0, 0, tiles, torch.complex64,
                                   "split") is not None:
        return None
    x = torch.ones((n, rows), dtype=torch.complex64, device=dev)
    codec = wire_codec("split")

    def unfused(v):
        y = cuda_fft.fft_along_axis(v, 0, True)
        return codec.encode(y, tile_axis=0, tiles=tiles)

    def fused(v):
        return cuda_fuse.fused_fft_encode(v, fft_axis=0, forward=True,
                                          tile_axis=0, tiles=tiles,
                                          wire_dtype="split")

    tu, _ = time_fn_amortized(unfused, x, iters=iters, repeats=2)
    tf, _ = time_fn_amortized(fused, x, iters=iters, repeats=2)
    return tu / tf if tu > 0 and tf > 0 else None


def _measure_launch_seconds(iters: int, *, device=None) -> float | None:
    """The fixed cost of one dispatch: a tiny op, synchronised per
    call."""
    from .utils.timing import sync

    x = torch.zeros(8, dtype=torch.float32, device=_device(device))
    sync(x + 1.0)
    best = math.inf
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        sync(x + 1.0)
        best = min(best, time.perf_counter() - t0)
    return best if math.isfinite(best) else None


def calibrate(iters: int = 10, *, wire: bool = True, device=None) -> dict:
    """Run the microbenchmarks on ``device`` (the card unless
    ``device="cpu"``; raises without a card) and return a profile
    document (nothing is written: pair with :func:`write_profile`). A
    field a benchmark cannot produce (wire in one process, DCN on one
    node, the fuse speedup off the card) or whose benchmark failed is
    None. With several processes every process must call it (the wire
    rings are collective)."""
    dev = _device(device)
    kind, platform = (_current_identity() if dev.type == "cuda"
                      else ("cpu", "cpu"))
    prof: dict = {
        "schema": PROFILE_SCHEMA,
        "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "device_kind": kind,
        "platform": platform,
        "ndev": _process_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    for field, fn in (
        ("hbm_gbps", lambda: _measure_hbm_gbps(iters, device=dev)),
        ("peak_tflops", lambda: _measure_peak_tflops(iters, device=dev)),
        ("wire_gbps", (lambda: _measure_wire_gbps(iters)) if wire
         else (lambda: None)),
        ("launch_seconds",
         lambda: _measure_launch_seconds(iters, device=dev)),
        ("fuse_speedup", lambda: _measure_fuse_speedup(iters, device=dev)),
    ):
        try:
            prof[field] = fn()
        except Exception:  # noqa: BLE001 -- one sick benchmark nulls its
            prof[field] = None  # field, never the whole calibration
    try:
        bf16, f32, highest = _measure_mm_tier_tflops(iters, device=dev)
    except Exception:  # noqa: BLE001
        bf16 = f32 = highest = None
    prof["mm_bf16_tflops"] = bf16
    prof["mm_f32_tflops"] = f32
    prof["mm_highest_tflops"] = highest
    try:
        if not wire:
            ici = dcn = None
        elif _process_count() < 2:
            ici, dcn = prof.get("wire_gbps"), None
        else:
            ici, dcn = _measure_leg_gbps(iters)
    except Exception:  # noqa: BLE001
        ici = dcn = None
    prof["ici_gbps"] = ici
    prof["dcn_gbps"] = dcn
    # calibration refreshes the constants; the tournaments' corrections
    # on this hardware carry over
    prev = matching_profile()
    if prev is not None and isinstance(prev.get("model_correction"), dict):
        prof["model_correction"] = prev["model_correction"]
    return prof


def format_profile(prof: dict) -> str:
    """One line per field of a profile document."""
    def num(v, unit):
        return "-" if v is None else f"{v:.6g} {unit}"

    lines = [
        f"device: {prof.get('device_kind')} ({prof.get('platform')}, "
        f"{prof.get('ndev', '?')} process(es))",
        f"hbm bandwidth:  {num(prof.get('hbm_gbps'), 'GB/s')}",
        f"wire bandwidth: {num(prof.get('wire_gbps'), 'GB/s')}"
        + ("" if prof.get("wire_gbps") is not None
           else "  (one process: not measurable)"),
        f"matmul peak:    {num(prof.get('peak_tflops'), 'TFlop/s')}",
        f"matmul bf16:    {num(prof.get('mm_bf16_tflops'), 'TFlop/s')}",
        f"matmul f32:     {num(prof.get('mm_f32_tflops'), 'TFlop/s')}",
        f"matmul highest: {num(prof.get('mm_highest_tflops'), 'TFlop/s')}",
        f"launch floor:   {num(prof.get('launch_seconds'), 's')}",
        f"fuse speedup:   {num(prof.get('fuse_speedup'), 'x')}"
        + ("" if prof.get("fuse_speedup") is not None
           else "  (the card only: fused tier unmeasured)"),
        f"ici leg:        {num(prof.get('ici_gbps'), 'GB/s')}",
        f"dcn leg:        {num(prof.get('dcn_gbps'), 'GB/s')}"
        + ("" if prof.get("dcn_gbps") is not None
           else "  (one node: no inter-node link)"),
    ]
    corr = prof.get("model_correction")
    if isinstance(corr, dict) and corr:
        pairs = ", ".join(f"{k}={v:.3g}x" for k, v in sorted(corr.items()))
        lines.append(f"model correction: {pairs}")
    if prof.get("recorded_at"):
        lines.append(f"calibrated at: {prof['recorded_at']}")
    return "\n".join(lines)


def size_check(iters: int = 10, *, device=None) -> dict:
    """The HBM and matmul microbenchmarks at the JAX package's sizes (a
    64 MiB block; n = 1024) and at larger ones (1 GiB; n = 8192), each
    small size's rates as a share of the large size's, and whether each
    small size holds within ``_SIZE_TOLERANCE`` (``keep_jax_hbm``,
    ``keep_jax_mm``: every tier and the bf16 peak). ``device`` as in
    :func:`calibrate`."""
    dev = _device(device)
    hbm = {str(b): _measure_hbm_gbps(iters, b, device=dev)
           for b in (_JAX_HBM_BYTES, _LARGE_HBM_BYTES)}
    peak = torch.bfloat16 if dev.type == "cuda" else torch.float32
    mm = {}
    for n in (_JAX_MM_N, _LARGE_MM_N):
        mm[str(n)] = {tier: _mm_tflops(iters, _tier_product(tier), n=n,
                                       device=dev)
                      for tier in ("bf16", "f32", "highest")}
        mm[str(n)]["peak"] = _mm_tflops(iters, torch.matmul, peak, n=n,
                                        device=dev)

    def share(small, large):
        return small / large if small and large else None

    hbm_share = share(hbm[str(_JAX_HBM_BYTES)], hbm[str(_LARGE_HBM_BYTES)])
    mm_share = {k: share(v, mm[str(_LARGE_MM_N)][k])
                for k, v in mm[str(_JAX_MM_N)].items()}
    floor = 1.0 - _SIZE_TOLERANCE
    return {
        "hbm_gbps": hbm, "mm_tflops": mm,
        "hbm_share": hbm_share, "mm_share": mm_share,
        "keep_jax_hbm": hbm_share is not None and hbm_share >= floor,
        "keep_jax_mm": all(v is not None and v >= floor
                           for v in mm_share.values()),
    }


def main(argv=None) -> int:
    """``python -m distributedfft_tpu_torch.calibrate [--iters N]
    [--sizes] [--write] [--device D]``: print the card's name and power
    limit (``nvidia-smi``), the calibrated profile and its JSON;
    ``--sizes`` adds :func:`size_check`; ``--write`` stores the profile
    at :func:`default_profile_path`; ``--device cpu`` measures the CPU
    (default: the card, and without one it raises)."""
    import argparse
    import subprocess

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sizes", action="store_true")
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = _device(args.device)
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip().splitlines()[0] if smi.stdout else
              torch.cuda.get_device_name(), flush=True)
    prof = calibrate(iters=args.iters, device=dev)
    print(format_profile(prof), flush=True)
    print(json.dumps(prof, sort_keys=True), flush=True)
    if args.sizes:
        print(json.dumps({"size_check": size_check(args.iters,
                                                   device=dev)},
                         sort_keys=True), flush=True)
    if args.write:
        print(f"written: {write_profile(prof)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
