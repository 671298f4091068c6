"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It fails, and prints no result, without as
many NVIDIA cards as the cell asks for. On one card the run is this
process; on more, one spawned process per card over NCCL, meeting at a
``file://`` store under ``$TMPDIR``, the kernel library built here first
so that the ranks only load it. The last line of standard output is the
result; the last lines of standard error are the numbers the check
compared, each beside its limit.

``--cpu`` rehearses a cell on the CPU (gloo between processes) and
``--root`` reads ``BENCHMARK.json`` and the cell's files from another
directory; the tests use both, at tiny sizes. A rehearsal's line says
``"platform": "cpu"`` and carries no device number.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CODE_ROOT = Path(__file__).resolve().parent.parent

#: Every build and kernel cache a run's processes could write, at fixed
#: paths inside the checkout.
CACHES = {"PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
          "TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (no device numbers)")
    ap.add_argument("--root", default=str(CODE_ROOT),
                    help="where BENCHMARK.json and the cell's files are")
    return ap.parse_args(argv)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def main(argv=None, entry=None) -> int:
    """Run the cell; 0 and a result line, or another code and none.
    ``entry`` replaces the spawned ranks' function (the tests break the
    timed path with it)."""
    args = _args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(CODE_ROOT / "h100bench" / "_cache" / sub)
        os.makedirs(os.environ[var], exist_ok=True)
    import torch

    from h100bench import bench, check

    cell = bench.load_cell(args.root, args.workload)
    if not args.cpu and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} NVIDIA cards; this machine "
              f"has {have}", file=sys.stderr)
        return 2
    spec = bench.RunSpec(args.seed, args.seconds, bool(args.trace),
                         args.cpu, T_START)
    if cell.chips == 1:
        try:
            line = bench.run_rank(0, 1, cell, spec)
        except bench.ForbiddenLoaded as e:
            print(e, file=sys.stderr)
            return 3
    else:
        if not args.cpu:
            from distributedfft_tpu_torch.ops import _build

            _build.library()
        line = bench.spawn(entry or bench.rank_entry, cell.chips, cell, spec)
    found = bench.forbidden_loaded()
    if found:
        print(f"loaded in the process that prints: {', '.join(found)}",
              file=sys.stderr)
        return 3
    if not args.cpu:
        line["device"]["power_limit"] = _power_limit()
    nums = {k: v["value"] for k, v in line["checks"].items()}
    lims = {k: v["limit"] for k, v in line["checks"].items()}
    for text in check.lines(nums, lims):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
