"""Distributed 1D FFT of one long sequence over a world of ranks.

The port of ``distributedfft_tpu/parallel/fft1d.py``: the four-step
identity with its two DFT stages on different ranks and the reorder
between them as all-to-alls (j = j1*B + j2, k = k1 + A*k2, n = A*B):

    X[k1 + A*k2] = sum_j2 w_B^{j2 k2} * w_n^{j2 k1}
                   * (sum_j1 w_A^{j1 k1} x[j1*B + j2])

over P ranks, the input the [A, B] row-major view of x cut by rows:

    s0  exchange:  rows -> columns              ([A, B/P] per rank)
    s1  executor FFT over axis 0 (length A)
    s2  twiddle w_n^{k1 * j2}                   (exact integer phase)
    s3  exchange:  columns -> rows              ([A/P, B] per rank)
    s4  executor FFT over axis 1 (length B)

The result is the spectrum in **transposed order** (element [k1, k2] of
the output's [A, B] view is X[k1 + A*k2], FFTW-MPI's ``TRANSPOSED_OUT``);
``order="natural"`` adds one more exchange and a local transpose
(``s5``) to return X in index order. Backward runs the mirror pipeline
from the same layout back to the natural-order sequence (1/n, numpy
convention).

The twiddle's phase k1*(rank*Bl + c) is reduced in integers: the
per-rank factor w_n^(k1*rank*Bl) through :func:`_mulmod` (binary
doubling, intermediates < 2n; int32 below n = 2^30, int64 from there, as
in the JAX package), times the rank-independent host table w_n^(k1*c),
c < Bl = B/P, built in float64. Both are made once per plan on its
device.

Exchanges run :func:`.exchange.exchange_uneven` over the world's
combined axis (all ranks in rank order), so every transport the world
takes works (``hierarchical`` on a hybrid world). A loopback world takes
and returns the global length-n vector; a process-group world each
rank's contiguous block of n/P. Each stage runs under a trace span
``fft1d_<stage>`` and, given a :class:`..utils.timing.StageTimer`, is
timed under its key (``s0`` .. ``s5``).
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.executors import get_executor, run_donated
from ..utils.trace import add_trace
from .exchange import check_algorithm, exchange_uneven
from .mesh import World, make_world

__all__ = ["Dist1DSpec", "DistPlan1D", "build_dist_fft1d",
           "choose_split_1d", "plan_dft_c2c_1d_dist"]

#: The stages' span suffixes by key.
STAGE_NAMES = {"s0": "s0_exchange", "s1": "s1_fft_a", "s2": "s2_twiddle",
               "s3": "s3_exchange", "s4": "s4_fft_b", "s5": "s5_transpose"}


def _find_split(n: int, p: int) -> tuple[int, int] | None:
    best = None
    for a in range(int(math.isqrt(n)), 0, -1):
        if n % a:
            continue
        b = n // a
        for big, small in ((a, b), (b, a)):
            if big % p == 0 and small % p == 0:
                if best is None or abs(big - small) < abs(best[0] - best[1]):
                    best = (big, small)
        if best is not None and best[0] == a:
            break
    return best


def choose_split_1d(n: int, p: int) -> tuple[int, int]:
    """Balanced divisor pair (A, B) of n with both divisible by ``p`` (both
    exchange axes must split evenly across the ranks). Raises when no
    such pair exists -- pad the sequence to a friendlier length."""
    best = _find_split(n, p)
    if best is None:
        raise ValueError(
            f"length {n} has no factor pair with both factors divisible by "
            f"{p}; pad the sequence (e.g. to {_suggest_length(n, p)})"
        )
    return best


def _suggest_length(n: int, p: int) -> int:
    m = n
    while _find_split(m, p) is None:
        m += 1
    return m


def _mulmod(a: torch.Tensor, b: int, n: int, idt) -> torch.Tensor:
    """(a * b) % n elementwise with intermediates < 2n (binary doubling
    over the static multiplier ``b``); exact where a float product would
    not be."""
    a = (a % n).to(idt)
    acc = torch.zeros_like(a)
    cur = a
    for s in range(max(1, b.bit_length())):
        if (b >> s) & 1:
            acc = (acc + cur) % n
        cur = (cur * 2) % n
    return acc


def _mulmod_traced(a: torch.Tensor, b: torch.Tensor, n: int,
                   idt) -> torch.Tensor:
    """Same, for a multiplier held in a tensor (a bit budget of n's)."""
    a = (a % n).to(idt)
    b = b.to(idt)
    acc = torch.zeros_like(a)
    cur = a
    for s in range(max(1, (n - 1).bit_length())):
        bit = (b >> s) & 1
        acc = torch.where(bit == 1, (acc + cur) % n, acc)
        cur = (cur * 2) % n
    return acc


@functools.lru_cache(maxsize=8)
def _local_twiddle_np(n: int, a: int, bl: int, forward: bool) -> np.ndarray:
    """Rank-independent twiddle factor w_n^{k1*c} for local columns
    c < bl, exact host f64 (complex128; cast to the working dtype on
    use)."""
    sign = -2j if forward else 2j
    kc = np.outer(np.arange(a, dtype=np.int64), np.arange(bl, dtype=np.int64))
    return np.exp(sign * np.pi * (kc % n) / n)


def _index_dtype(n: int) -> torch.dtype:
    return torch.int32 if n < (1 << 30) else torch.int64


def _rank_rotation(n: int, a: int, bl: int, rank: int, forward: bool,
                  dtype: torch.dtype, device) -> torch.Tensor:
    """The per-rank twiddle factor w_n^(k1 * rank*bl) over k1 < a: the
    phase reduced by :func:`_mulmod`, the angle formed in the working
    dtype's real type as the JAX package forms it."""
    idt = _index_dtype(n)
    ps = _mulmod(torch.full((1,), rank, dtype=idt, device=device), bl, n,
                 idt)[0]
    rows = _mulmod_traced(torch.arange(a, dtype=idt, device=device), ps, n,
                          idt)
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    sign = -2.0 if forward else 2.0
    ang = (sign * math.pi / n) * rows.to(rdt)
    return torch.complex(torch.cos(ang), torch.sin(ang))


@dataclass
class Dist1DSpec:
    """Static geometry of a distributed 1D plan."""

    n: int
    a: int  # rows    (first-stage DFT length)
    b: int  # columns (second-stage DFT length)
    parts: int
    axis_name: object
    order: str  # "transposed" | "natural"


def _world_of(world) -> World | None:
    if world is None or isinstance(world, World):
        return world
    return make_world(world)


def build_dist_fft1d(world: World, n: int, *, forward: bool = True,
                     executor: str = "cuda", order: str = "transposed",
                     algorithm: str = "alltoall", donate: bool = False,
                     dtype: torch.dtype = torch.complex64,
                     device=None) -> tuple:
    """Build the distributed 1D C2C transform of length ``n`` over
    ``world``: ``(fn, spec)``, ``fn(x, timer=None)`` the transform.

    Forward maps the length-``n`` vector (each rank holding a contiguous
    block) to its spectrum in transposed order ([A, B]-view element
    [k1, k2] = X[k1 + A*k2]) or natural order. Backward inverts exactly
    that layout back to the natural-order sequence (1/n scaling).
    ``donate``: the first FFT stage's output is written into the input's
    storage (its contents afterwards unspecified), the result the same
    bits. Runs on the card unless ``device`` names another."""
    from ..api import resolve_device

    if order not in ("transposed", "natural"):
        raise ValueError("order must be 'transposed' or 'natural'")
    check_algorithm(algorithm)
    device = resolve_device(device)
    mesh_axis = world.combined_axis
    p = world.size
    a, b = choose_split_1d(n, p)
    bl = b // p
    ex = get_executor(executor)
    spec = Dist1DSpec(n, a, b, p, mesh_axis, order)
    w_local = torch.from_numpy(_local_twiddle_np(n, a, bl, forward)).to(
        device=device, dtype=dtype)
    rots = {r: _rank_rotation(n, a, bl, r, forward, dtype, device)[:, None]
            for r in world.ranks}
    kw = dict(mesh_axis=mesh_axis, algorithm=algorithm,
              axis_sizes=world.grid if algorithm == "hierarchical" else None)

    def exchange(blocks, split, concat):
        return exchange_uneven(blocks, world, split_axis=split,
                               concat_axis=concat, **kw)

    def fft(blocks, axis, into=None):
        if into is None:
            return [ex(g, (axis,), forward) for g in blocks]
        # the donated input's storage takes the stage's output
        return [s.view(g.shape).copy_(g) for s, g in
                zip(into, (ex(g, (axis,), forward) for g in blocks))]

    def twiddle(blocks):
        return [g * rots[r] * w_local for r, g in zip(world.ranks, blocks)]

    def transpose_in(blocks):
        """[rows/P, cols] blocks of a [rows, cols] view -> the [cols/P,
        rows] blocks of its transpose: an exchange and a local
        transpose."""
        return [g.t().contiguous() for g in exchange(blocks, 1, 0)]

    def fn(x: torch.Tensor, timer=None) -> torch.Tensor:
        stage = _stage(timer)
        held = x.reshape(-1) if donate else None
        if forward:
            blocks = _scatter(world, x, a, b)
            with stage("s0"):
                blocks = exchange(blocks, 1, 0)          # [a, bl]
            with stage("s1"):
                blocks = fft(blocks, 0, _donated(held, world, blocks))
            with stage("s2"):
                blocks = twiddle(blocks)
            with stage("s3"):
                blocks = exchange(blocks, 0, 1)          # [a/p, b]
            with stage("s4"):
                blocks = fft(blocks, 1)
            if order == "natural":                       # [b/p, a]
                with stage("s5"):
                    blocks = transpose_in(blocks)
        else:
            if order == "natural":
                blocks = _scatter(world, x, b, a)
                with stage("s5"):
                    blocks = transpose_in(blocks)  # [a/p, b]
            else:
                blocks = _scatter(world, x, a, b)
            with stage("s4"):
                blocks = fft(blocks, 1, _donated(held, world, blocks))
            with stage("s3"):
                blocks = exchange(blocks, 1, 0)          # [a, bl]
            with stage("s2"):
                blocks = twiddle(blocks)
            with stage("s1"):
                blocks = fft(blocks, 0)
            with stage("s0"):
                blocks = exchange(blocks, 0, 1)          # [a/p, b]
        return torch.cat([g.reshape(-1) for g in blocks])

    return fn, spec


def _scatter(world: World, x: torch.Tensor, rows: int,
             cols: int) -> list[torch.Tensor]:
    """The held blocks of the [rows, cols] view of the input: every
    rank's row block on a loopback world, this rank's on a process
    group (whose input is its block)."""
    if world.loopback:
        return list(x.reshape(rows, cols).tensor_split(world.size, dim=0))
    return [x.reshape(rows // world.size, cols)]


def _donated(held, world: World, blocks) -> list | None:
    """Each held block's slice of the donated input's storage, or None."""
    if held is None:
        return None
    per = held.numel() // len(world.ranks)
    return [held[i * per:(i + 1) * per] for i in range(len(blocks))]


def _stage(timer):
    """The stage context: a trace span ``fft1d_<name>``, timed under its
    key by ``timer`` when given."""

    @contextlib.contextmanager
    def stage(key):
        with add_trace(f"fft1d_{STAGE_NAMES[key]}"):
            if timer is None:
                yield
            else:
                with timer.stage(key):
                    yield

    return stage


@dataclass
class DistPlan1D:
    """Callable distributed 1D plan (the cross-rank sibling of
    :class:`~..local.LocalPlan`). ``in_shape`` is what a call takes:
    ``(n,)`` on a loopback world or one device, each rank's ``(n/P,)``
    on a process group."""

    spec: Dist1DSpec
    direction: int
    dtype: torch.dtype
    executor: str
    fn: object
    device: torch.device
    world: World | None = None
    in_shape: tuple = field(default=())

    def __call__(self, x, *, timer=None) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if tuple(x.shape) != self.in_shape:
            raise ValueError(
                f"plan input shape is {self.in_shape}, got {tuple(x.shape)}")
        return self.fn(x.contiguous(), timer)

    def flops(self) -> float:
        return 5.0 * self.spec.n * math.log2(self.spec.n)


def plan_dft_c2c_1d_dist(n: int, world=None, *, direction: int = -1,
                         executor: str = "cuda", order: str = "transposed",
                         algorithm: str = "alltoall",
                         dtype: torch.dtype = torch.complex64,
                         donate: bool = False, device=None) -> DistPlan1D:
    """Plan a distributed 1D C2C FFT of one length-``n`` sequence over
    ``world`` (a :class:`~.mesh.World`, or an int for a loopback world of
    that many ranks). With ``world=None`` (or one rank) the plan is a
    plain local transform; ``order`` then has no effect (output is always
    natural). Runs on the card unless ``device`` names another."""
    from ..api import resolve_device

    if direction not in (-1, 1):
        raise ValueError("direction must be FORWARD (-1) or BACKWARD (+1)")
    if dtype not in (torch.complex64, torch.complex128):
        raise ValueError(
            f"dtype must be torch.complex64 or torch.complex128, got {dtype}")
    forward = direction == -1
    device = resolve_device(device)
    world = _world_of(world)
    if world is None or world.size == 1:
        ex = get_executor(executor)
        if donate:
            fn = lambda x, timer=None: run_donated(executor, x, (0,), forward)
        else:
            fn = lambda x, timer=None: ex(x, (0,), forward)
        spec = Dist1DSpec(n, n, 1, 1, "", "natural")
        return DistPlan1D(spec, direction, dtype, executor, fn, device,
                          world, (n,))
    fn, spec = build_dist_fft1d(
        world, n, forward=forward, executor=executor, order=order,
        algorithm=algorithm, donate=donate, dtype=dtype, device=device)
    in_shape = (n,) if world.loopback else (n // world.size,)
    return DistPlan1D(spec, direction, dtype, executor, fn, device, world,
                      in_shape)
