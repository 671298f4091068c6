"""Debug aids: per-rank data dumps and layout validation. The port of
``distributedfft_tpu/utils/debug.py``.

The reference ships two debug tools instead of unit tests:
``outputPlanInfo`` writes each rank's plan and exchange tables to a file
per rank, and ``debugLocalData`` dumps device buffers to CSV, with a
mode that decodes linear-ramp values back into (x, y, z) coordinates to
verify layouts. These are their equivalents, plus a validator that
checks a tensor's per-rank blocks against a plan's boxes.

A tensor of the port carries no sharding, so a *block* (the JAX
package's addressable shard) is defined by the world: on a loopback
world (or none) the tensor is the global array and rank r's block is
the global array cut by ``boxes[r]``; on a world over a process group
the tensor is this rank's own block, at ``boxes[world.rank]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import Box3

__all__ = ["ramp_world", "decode_ramp", "dump_local_data", "check_layout",
           "write_plan_info", "ramp_roundtrip_check"]


def ramp_world(shape, dtype=np.complex128) -> np.ndarray:
    """Linear-ramp world data v[i,j,k] = flat index (the reference's init
    pattern): every value names its own global coordinate, so any
    misplaced element is detectable after a reshape. Exact in complex128
    up to 2^53 elements, in complex64 only below 2^24 (256^3 is the
    largest such cube)."""
    n = int(np.prod(shape))
    return np.arange(n, dtype=dtype).reshape(tuple(shape))


def decode_ramp(value: float, shape) -> tuple[int, int, int]:
    """Invert the ramp: flat value -> (x, y, z) world coordinate (the
    type-0 decode of ``debugLocalData``)."""
    v = int(round(float(value)))
    _, n1, n2 = (int(s) for s in shape)
    return v // (n1 * n2), (v // n2) % n1, v % n2


def _own_rank(world) -> int | None:
    """This process's rank on a world over a process group; None on a
    loopback world or without one."""
    if world is None or world.loopback or world.size == 1:
        return None
    return int(world.rank)


def _window(b: Box3) -> tuple:
    return tuple((int(lo), int(hi)) for lo, hi in zip(b.low, b.high))


def _cut(x: torch.Tensor, b: Box3) -> torch.Tensor:
    return x[tuple(slice(lo, hi) for lo, hi in zip(b.low, b.high))]


def _blocks(x: torch.Tensor, boxes, world) -> list[tuple]:
    """``[(rank, window, block), ...]`` of ``x`` on ``world``: every
    rank's on a loopback world, this rank's alone on a process group;
    the whole tensor as rank 0 without ``boxes``."""
    own = _own_rank(world)
    if boxes is None:
        return [(own or 0, tuple((0, int(d)) for d in x.shape), x)]
    if own is not None:
        return [(own, _window(boxes[own]), x)]
    return [(r, _window(b), _cut(x, b)) for r, b in enumerate(boxes)]


def dump_local_data(x, prefix: str = "dfft_debug", *, boxes=None,
                    world=None) -> list[str]:
    """Write one CSV per block of ``x`` (see the module docstring; the
    whole tensor when ``boxes`` is None): ``<prefix>_shard<i>.csv`` with
    rows ``local_index,value`` under a header naming the device, the
    rank and the block's index window (the ``debugLocalData`` dump).
    Returns the paths written."""
    paths = []
    for i, (rank, window, block) in enumerate(_blocks(x, boxes, world)):
        path = f"{prefix}_shard{i}.csv"
        data = block.detach().cpu().numpy().ravel()
        with open(path, "w") as f:
            f.write(f"# device={x.device} rank={rank} window={window}\n")
            f.write("local_index,value\n")
            for j, v in enumerate(data):
                f.write(f"{j},{v}\n")
        paths.append(path)
    return paths


def check_layout(x, boxes: list[Box3], world=None) -> None:
    """Validate the blocks of ``x`` on ``world`` against ``boxes`` (a
    plan's ``in_boxes`` / ``out_boxes``): one box per rank, the boxes
    disjoint and covering the world (the global tensor's shape on a
    loopback world), and each held block at its box's extent. Raises
    ``AssertionError`` naming the first rank that does not match."""
    boxes = list(boxes)
    own = _own_rank(world)
    nranks = 1 if world is None else int(world.size)
    if len(boxes) != nranks:
        raise AssertionError(f"{nranks} rank(s) but {len(boxes)} boxes")
    for r, b in enumerate(boxes):
        if any(hi < lo for lo, hi in zip(b.low, b.high)):
            raise AssertionError(f"rank {r}: box {_window(b)} is inverted")
    if own is None:
        world_hi = tuple(int(d) for d in x.shape[-3:])
    else:
        world_hi = tuple(max(int(b.high[a]) for b in boxes)
                         for a in range(3))
    for r, b in enumerate(boxes):
        if any(lo < 0 or hi > n for lo, hi, n in zip(b.low, b.high,
                                                     world_hi)):
            raise AssertionError(
                f"rank {r}: box {_window(b)} leaves the world "
                f"{tuple((0, n) for n in world_hi)}")
        for s, o in enumerate(boxes):
            if s != r and all(max(b.low[a], o.low[a])
                              < min(b.high[a], o.high[a])
                              for a in range(3)):
                raise AssertionError(
                    f"rank {r}: box {_window(b)} overlaps rank {s}'s "
                    f"{_window(o)}")
    covered = sum(int(np.prod(b.shape)) for b in boxes)
    total = int(np.prod(world_hi))
    if covered != total:
        raise AssertionError(
            f"the boxes cover {covered} of the world's {total} elements")
    for rank, window, block in _blocks(x, boxes, world):
        got = tuple(int(d) for d in block.shape[-3:])
        want = tuple(hi - lo for lo, hi in window)
        if got != want:
            raise AssertionError(
                f"rank {rank}: block extent {got} != plan box {window}")


def write_plan_info(plan, prefix: str = "dfft_plan") -> str:
    """Write the plan dump to ``<prefix>_<process>.txt`` (the
    ``outputPlanInfo`` per-rank file), ``<process>`` this process's rank
    in the ``torch.distributed`` group, else 0."""
    from ..monitor import _process_index
    from .trace import plan_info

    path = f"{prefix}_{_process_index() or 0}.txt"
    with open(path, "w") as f:
        f.write(plan_info(plan) + "\n")
    return path


def ramp_roundtrip_check(plan_fwd, plan_bwd,
                         tol: float | None = None) -> float:
    """Plan-pair self-check on ramp data: max |x - IFFT(FFT(x))| relative
    to the ramp's magnitude (the reference's inline validation). The
    ramp is made in complex128 on the host and cast to the plan's input
    dtype on its device (on a process group, this rank's block; the
    error is then the group's maximum). Returns the relative error;
    raises when a tolerance is given and exceeded."""
    world = plan_fwd.world
    ramp = ramp_world(plan_fwd.shape, np.complex128)
    own = _own_rank(world)
    if own is not None:
        ramp = ramp[tuple(slice(lo, hi) for lo, hi in
                          zip(plan_fwd.in_boxes[own].low,
                              plan_fwd.in_boxes[own].high))]
    if not plan_fwd.in_dtype.is_complex:
        ramp = ramp.real
    x = torch.from_numpy(np.ascontiguousarray(ramp)).to(
        device=plan_fwd.device, dtype=plan_fwd.in_dtype)
    r = plan_bwd(plan_fwd(x))
    num = torch.max(torch.abs(r - x)).to(torch.float64)
    den = torch.max(torch.abs(x)).to(torch.float64)
    if own is not None:
        import torch.distributed as dist

        group = world.group if world.group is not None else dist.group.WORLD
        pair = torch.stack([num, den]).to(
            x.device if dist.get_backend(group) == "nccl" else "cpu")
        dist.all_reduce(pair, op=dist.ReduceOp.MAX, group=group)
        num, den = pair[0], pair[1]
    err = float(num / den)
    if tol is not None and not err < tol:
        raise AssertionError(f"ramp roundtrip error {err} exceeds {tol}")
    return err
