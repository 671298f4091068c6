"""The spectral operators' chains, stages, pins and process groups.

- ``multiplier_grid`` against the JAX package's: bit for bit at
  complex128 and complex64 for every op but the Gaussian's, whose
  ``exp`` (torch's against XLA's) may differ in the last place or below
  the normal range.
- The collective pins of ``tests/test_a2h_operators.py`` as
  ``parallel.exchange.ROUNDS`` counts them: 2 rounds for a slab op call
  at K = 1 (a forward plan, a multiply and a backward plan in the
  caller's layout take 4), 2K at K, 2(P - 1) on the ring, 4 on a 2x2
  pencil; batch and chaining add none; ``SHIPPED`` is twice one
  transform's.
- ``build_slab_op_stages``: JAX's stage names, and its composition
  within 1e-12 of the fused plan at complex128.
- The operator menu (Poisson inverts the Laplacian, the gradient is
  numpy's, a delta convolution is the identity and a shifted one a
  roll, the Gaussian keeps the mean), ``donate``, the plan's metadata,
  spans and ``plan_info``, ``op_from_reference`` /
  ``plan_from_reference``, and the JAX package's refusals with the same
  error classes.
- A 4-rank gloo process group (``file://`` store under the test's
  temporary directory): the slab ``gradient(1)`` at K = 2 on an uneven
  world and the 2x2 pencil ``gradient(2)``, each rank's box equal to the
  loopback plan's bit for bit; the same over NCCL on four cards is the
  ``cuda``-marked twin.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import operators as top, testing
from distributedfft_tpu_torch.parallel import exchange as tex
from distributedfft_tpu_torch.parallel.mesh import process_group_world
from distributedfft_tpu_torch.utils import trace as ttr

SHAPE = (16, 16, 16)
UNEVEN = (12, 10, 9)
C128 = torch.complex128


def _x(shape, dtype=np.complex128, seed=7, batch=None):
    rng = np.random.default_rng(seed)
    full = tuple(shape) if batch is None else (batch,) + tuple(shape)
    return (rng.standard_normal(full)
            + 1j * rng.standard_normal(full)).astype(dtype)


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(got) - ref))
                 / max(float(np.max(np.abs(ref))), 1e-300))


def _plan(shape, world, op, **kw):
    kw.setdefault("dtype", C128)
    return top.plan_spectral_op(shape, world, op=op, device="cpu", **kw)


# ------------------------------------------------------ multiplier pins

def _menu(shape):
    from distributedfft_tpu import operators as jop

    k = np.zeros(shape)
    k[2, 1, 3] = 1.0
    return [jop.poisson(), jop.biharmonic(), jop.helmholtz(2.5),
            jop.helmholtz(0.0), jop.gradient(0), jop.gradient(1),
            jop.gradient(2), jop.convolve(k), jop.gaussian(0.3),
            jop.chain([jop.gaussian(0.4), jop.gradient(1)])]


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("index", range(10))
def test_multiplier_grid_is_jax(index, dtype):
    import jax.numpy as jnp

    from distributedfft_tpu import operators as jop

    op = _menu(UNEVEN)[index]
    want = np.asarray(jop.multiplier_grid(op, UNEVEN, getattr(jnp, dtype)))
    got = top.multiplier_grid(top.op_from_reference(op), UNEVEN,
                              getattr(torch, dtype), device="cpu").numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if op.kind in ("gaussian", "chain"):
        # exp: within two units in the last place, and below the normal
        # range (where one library flushes to zero) within its least
        # normal value
        fi = np.finfo(want.real.dtype)
        np.testing.assert_allclose(got, want, rtol=2 * fi.eps, atol=fi.tiny)
    else:
        assert np.array_equal(got, want)


def test_biharmonic_and_helmholtz_multipliers():
    """JAX's parity pins: ``biharmonic == poisson**2``, ``(shift + |k|^2)
    * helmholtz == 1``, ``helmholtz(0) == -poisson``."""
    m = lambda op: top.multiplier_grid(op, SHAPE, C128, device="cpu")
    assert torch.allclose(m(top.biharmonic()), m(top.poisson()) ** 2,
                          rtol=1e-13, atol=0)
    f = torch.fft.fftfreq(16, dtype=torch.float64) * 16 * 2 * np.pi
    ksq = f[:, None, None] ** 2 + f[None, :, None] ** 2 + f[None, None] ** 2
    assert torch.allclose(m(top.helmholtz(2.5)) * (2.5 + ksq),
                          torch.ones(SHAPE, dtype=torch.float64), rtol=1e-12)
    assert torch.equal(m(top.helmholtz(0.0)), -m(top.poisson()))


# -------------------------------------------------- collectives and bytes

def _rounds(plan, x) -> int:
    before = sum(tex.ROUNDS.values())
    plan(x)
    return sum(tex.ROUNDS.values()) - before


@pytest.mark.parametrize("world,kw,want", [
    (4, {}, 2), (4, dict(overlap_chunks=2), 4),
    (4, dict(algorithm="ppermute"), 6), (2, dict(algorithm="ppermute"), 2),
    ((2, 2), {}, 4), ((2, 2), dict(overlap_chunks=2), 8),
    ((2, 2), dict(algorithm="ppermute"), 4),
    (4, dict(batch=3), 2), ((2, 2), dict(batch=3), 4),
])
def test_collective_rounds(world, kw, want):
    """JAX's collective pins (``test_a2h_operators.py:248-310``), counted
    by ``ROUNDS``; a chained op takes what a single op takes."""
    x = torch.from_numpy(_x(SHAPE, batch=kw.get("batch")))
    assert _rounds(_plan(SHAPE, world, top.poisson(), **kw), x) == want
    assert _rounds(_plan(SHAPE, world, [top.gaussian(0.4), top.gradient(1)],
                         **kw), x) == want


def test_unfused_pair_takes_twice_the_rounds():
    """A forward plan, a multiply in the caller's X-slab layout and a
    backward plan, X-slabs on both ends: four rounds (each plan's
    exchange and the edge back to X-slabs), the op plan's two; the same
    result within the tier."""
    x = torch.from_numpy(_x(SHAPE))
    xs = tdfft.Spec("slab")
    kw = dict(dtype=C128, device="cpu")
    fwd = tdfft.plan_dft_c2c_3d(SHAPE, 4, out_spec=xs, **kw)
    bwd = tdfft.plan_dft_c2c_3d(SHAPE, 4, direction=tdfft.BACKWARD,
                                in_spec=xs, out_spec=xs, **kw)
    m = top.multiplier_grid(top.poisson(), SHAPE, C128, device="cpu")
    before = sum(tex.ROUNDS.values())
    pair = bwd(m * fwd(x))
    assert sum(tex.ROUNDS.values()) - before == 4
    op = _plan(SHAPE, 4, top.poisson())
    assert _rounds(op, x) == 2
    assert _rel(op(x).numpy(), pair.numpy()) < 1e-11


def test_shipped_bytes_are_twice_a_transform():
    x = torch.from_numpy(_x(SHAPE))
    fwd = tdfft.plan_dft_c2c_3d(SHAPE, 4, dtype=C128, device="cpu")
    op = _plan(SHAPE, 4, top.poisson())

    def shipped(plan):
        before = tex.SHIPPED["alltoall"]
        plan(x)
        return tex.SHIPPED["alltoall"] - before

    assert shipped(op) == 2 * shipped(fwd) > 0


# ---------------------------------------------------------------- staged

@pytest.mark.parametrize("kw", [{}, dict(overlap_chunks=2),
                                dict(algorithm="ppermute"), dict(batch=2)])
def test_staged_op_pipeline_matches_fused(kw):
    from distributedfft_tpu_torch.parallel.staged import build_slab_op_stages

    batch = kw.get("batch")
    plan = _plan(UNEVEN, 4, top.gradient(1), **kw)
    stages, _ = build_slab_op_stages(
        plan.world, UNEVEN, plan.multiplier, executor=plan.executor, **kw)
    assert [n for n, _ in stages] == ["t0_fft_yz", "t2_exchange_out",
                                      "t_mid", "t2_exchange_back",
                                      "t3_ifft_yz"]
    x = torch.from_numpy(_x(UNEVEN, batch=batch))
    cur = x
    for _, fn in stages:
        cur = fn(cur)
    assert _rel(cur.numpy(), plan(x).numpy()) < 1e-12


def test_staged_names_are_jax():
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.operators import _multiplier_fn, poisson
    from distributedfft_tpu.parallel import staged as jstaged

    from distributedfft_tpu_torch.parallel import staged

    theirs, _ = jstaged.build_slab_op_stages(
        jdfft.make_mesh(4), SHAPE,
        _multiplier_fn(poisson(), SHAPE, np.complex128))
    mine, _ = staged.build_slab_op_stages(tdfft.make_world(4), SHAPE, None)
    assert [n for n, _ in mine] == [n for n, _ in theirs]


def test_stage_timer_and_spans():
    """The op plan's stages time under t0, t1, t2, t_mid and t3, its span
    is ``execute_op_poisson_slab``, ``t_mid_pointwise`` nests in
    ``t_mid`` and maps to no stage key."""
    from distributedfft_tpu_torch.utils.timing import StageTimer

    plan = _plan(SHAPE, 4, top.poisson())
    timer = StageTimer("cpu")
    with ttr.capture_events() as ev:
        plan(torch.from_numpy(_x(SHAPE)), timer=timer)
    assert set(timer.times()) == {"t0", "t1", "t2", "t_mid", "t3"}
    names = [e[0] for e in ev]
    assert names[-1] == "execute_op_poisson_slab"
    assert "t_mid_pointwise" in names and "t_mid" in names
    assert ttr.stage_key("t_mid_pointwise") is None
    assert ttr.stage_key("t_mid") == "t_mid"


@pytest.mark.parametrize("key,k", [(4, 1), (4, 2), ((2, 2), 1)])
def test_spans_match_jax(key, k):
    """The span names and their order are the JAX plan's (its spans
    recorded as its program traces, the port's as it runs, less the
    port's pass spans inside its stages), the port's loopback world
    running one ``t_mid_pointwise`` per held rank."""
    import jax.numpy as jnp

    import distributedfft_tpu as jdfft
    from distributedfft_tpu import operators as jop
    from distributedfft_tpu.utils import trace as jtr

    shape = (16, 12, 8 + k)          # a shape no other test caches
    x = _x(shape, np.complex64, seed=2)
    with jtr.capture_events() as ev:
        jplan = jop.plan_spectral_op(shape, jdfft.make_mesh(key),
                                     op=jop.gradient(2),
                                     dtype=jnp.complex64, overlap_chunks=k)
        jplan(x)
    want = [e[0] for e in ev]
    plan = top.plan_spectral_op(shape, key, op=top.gradient(2),
                                device="cpu", overlap_chunks=k)
    with ttr.capture_events() as ev:
        plan(torch.from_numpy(x))
    names = [e[0] for e in ev if not testing.pass_span(e[0])]
    assert names.count("t_mid_pointwise") == 4 * k
    assert [n for i, n in enumerate(names) if n != "t_mid_pointwise"
            or names[i - 1] != n] == want


# ------------------------------------------------------- operator menu

def test_solve_poisson_inverts_the_laplacian():
    x = _x(SHAPE)
    u = tdfft.solve_poisson(SHAPE, 4, dtype=C128, device="cpu")(
        torch.from_numpy(x)).numpy()
    f = np.fft.fftfreq(16) * 16 * 2 * np.pi
    k2 = f[:, None, None] ** 2 + f[None, :, None] ** 2 + f[None, None] ** 2
    assert _rel(np.fft.ifftn(-k2 * np.fft.fftn(u)), x - x.mean()) < 1e-9


@pytest.mark.parametrize("world", [None, 4, (2, 2)])
def test_spectral_gradient_matches_numpy(world):
    x = _x(UNEVEN)
    for axis in range(3):
        got = tdfft.spectral_gradient(UNEVEN, world, axis=axis, dtype=C128,
                                      device="cpu")(torch.from_numpy(x))
        ik = 1j * 2 * np.pi * np.fft.fftfreq(UNEVEN[axis]) * UNEVEN[axis]
        shape = [1, 1, 1]
        shape[axis] = -1
        ref = np.fft.ifftn(ik.reshape(shape) * np.fft.fftn(x))
        assert _rel(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("world", [4, (2, 2)])
def test_fft_convolve_delta_and_shift(world):
    x = _x(UNEVEN)
    k0 = np.zeros(UNEVEN)
    k0[0, 0, 0] = 1.0
    p0 = tdfft.fft_convolve(UNEVEN, world, kernel=k0, dtype=C128,
                            device="cpu")
    assert _rel(p0(torch.from_numpy(x)).numpy(), x) < 1e-11
    k1 = np.zeros(UNEVEN)
    k1[2, 1, 3] = 1.0
    p1 = tdfft.fft_convolve(UNEVEN, world, kernel=torch.from_numpy(k1),
                            dtype=C128, device="cpu")
    assert p1.op_spec != p0.op_spec
    assert _rel(p1(torch.from_numpy(x)).numpy(),
                np.roll(x, (2, 1, 3), axis=(0, 1, 2))) < 1e-11


def test_gaussian_filter_and_unit_multiplier():
    x = _x(SHAPE)
    y = tdfft.gaussian_filter(SHAPE, 4, sigma=0.2, dtype=C128,
                              device="cpu")(torch.from_numpy(x)).numpy()
    assert abs(y.mean() - x.mean()) < 1e-12
    assert np.linalg.norm(y) < np.linalg.norm(x)
    unit = top.custom("unit", lambda i0, i1, i2: 1.0)
    assert _rel(_plan(SHAPE, (2, 2), unit)(torch.from_numpy(x)).numpy(),
                x) < 1e-11


def test_named_ops_and_chain_identity():
    assert top.named_op("biharm") == top.biharmonic()
    assert top.named_op("helmholtz", shift=3.0) == top.helmholtz(3.0)
    assert top.named_op("grad", axis=2) == top.gradient(2)
    assert top.named_op(" Gauss ", sigma=0.5) == top.gaussian(0.5)
    assert top.OP_NAMES == ("poisson", "grad", "gauss", "biharm",
                            "helmholtz")
    ops = [top.gaussian(0.4), top.gradient(1)]
    assert top.chain(ops) == top.chain([top.gaussian(0.4), top.gradient(1)])
    assert top.chain(ops) != top.chain(ops[::-1])
    assert top.chain([top.poisson()]) == top.poisson()
    assert top.chain(ops).name == "chain(gaussian+gradient1)"
    assert top.helmholtz(2.5).name == "helmholtz2.5"


# ------------------------------------------------- plan, donate, errors

@pytest.mark.parametrize("world", [None, 4, (2, 2)])
def test_donate_equals_keep(world):
    x = _x(SHAPE, np.complex64)
    keep = top.plan_spectral_op(SHAPE, world, op=top.gradient(0),
                                device="cpu")
    give = top.plan_spectral_op(SHAPE, world, op=top.gradient(0),
                                device="cpu", donate=True)
    assert give.donate and give.options.donate
    assert torch.equal(give(torch.from_numpy(x.copy())),
                       keep(torch.from_numpy(x)))


def test_op_plan_metadata():
    plan = tdfft.solve_poisson(UNEVEN, (2, 2), device="cpu", batch=2)
    assert isinstance(plan, tdfft.OpPlan3D)
    assert plan.op == "poisson" and plan.op_spec == top.poisson()
    assert plan.logic.op == "poisson"
    assert plan.in_boxes == plan.out_boxes
    assert plan.in_shape == plan.out_shape == (2,) + UNEVEN
    assert plan.dtype == torch.complex64 and plan.direction == tdfft.FORWARD
    assert plan.describe()["op"] == "poisson"
    info = tdfft.plan_info(plan)
    assert "operator: fused poisson" in info and "batch: 2" in info
    y = plan(torch.from_numpy(_x(UNEVEN, np.complex64, batch=2)))
    assert y.dtype == torch.complex64 and tuple(y.shape) == (2,) + UNEVEN


def test_plan_from_reference_op():
    """A port plan built from a JAX op plan's description and op: the
    same boxes, the same op, JAX's output within the tier."""
    import jax.numpy as jnp

    import distributedfft_tpu as jdfft
    from distributedfft_tpu import operators as jop

    k = np.zeros(SHAPE)
    k[1, 2, 3] = 2.0
    op = jop.chain([jop.convolve(k), jop.gradient(0)])
    jplan = jop.plan_spectral_op(SHAPE, jdfft.make_mesh((2, 2)), op=op,
                                 dtype=jnp.complex128, overlap_chunks=2)
    box = lambda b: (tuple(b.low), tuple(b.high))
    desc = dict(shape=SHAPE, world_size=4, grid=(2, 2),
                direction=jplan.direction, dtype="complex128",
                executor="xla", overlap_chunks=2, op=jplan.op,
                op_spec=jplan.op_spec,
                in_boxes=[box(b) for b in jplan.in_boxes],
                out_boxes=[box(b) for b in jplan.out_boxes])
    plan = tdfft.plan_from_reference(desc, device="cpu")
    assert plan.op == jplan.op and plan.decomposition == "pencil"
    x = _x(SHAPE)
    assert _rel(plan(torch.from_numpy(x)).numpy(),
                np.asarray(jplan(x))) < 1e-11
    with pytest.raises(ValueError, match="op_spec"):
        tdfft.plan_from_reference(dict(desc, op_spec=None), device="cpu")
    with pytest.raises(ValueError, match="op differs"):
        tdfft.plan_from_reference(dict(desc, op="poisson"), device="cpu")
    with pytest.raises(ValueError, match="custom op"):
        top.op_from_reference(jop.custom("c", lambda a, b, c: 1.0))


def _refusals(ops, **grid_kw):
    """The JAX package's refusals, as thunks over an operators module."""
    return [
        lambda: ops.gradient(3),
        lambda: ops.named_op("bogus"),
        lambda: ops.gaussian(0.0),
        lambda: ops.helmholtz(-1.0),
        lambda: ops.chain([]),
        lambda: ops.chain([ops.poisson(), "nope"]),
        lambda: ops.custom("x", 3),
        lambda: ops.multiplier_grid(ops.convolve(np.zeros((4, 4, 4))),
                                    (4, 4, 8), **grid_kw),
    ]


def test_refusals_raise_jax_classes():
    from distributedfft_tpu import operators as jop

    for mine, theirs in zip(_refusals(top, device="cpu"), _refusals(jop)):
        with pytest.raises(Exception) as want:
            theirs()
        with pytest.raises(want.type):
            mine()
    with pytest.raises(TypeError, match="SpectralOp"):
        top.plan_spectral_op(SHAPE, 4, op="poisson", device="cpu")
    with pytest.raises(ValueError, match="3D"):
        top.plan_spectral_op((4, 4), 4, op=top.poisson(), device="cpu")
    with pytest.raises(ValueError, match="not compatible"):
        top.plan_spectral_op(SHAPE, (2, 2), op=top.poisson(), device="cpu",
                             decomposition="pencil",
                             algorithm="hierarchical")


@pytest.mark.parametrize("kw", [dict(tune="measure"),
                                dict(tune="measure", max_roundtrip_err=1e-3)])
def test_tuned_poisson_op_matches_jax(kw, tmp_path, monkeypatch):
    """The tuned op tier (once refused) on the CPU: a measured Poisson
    op plan on 4 loopback ranks agrees with the JAX package's Poisson
    op on its 4-device mesh within the complex64 tier, records one
    ``op:poisson`` wisdom entry, and replays it with no timing."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu import operators as jop
    from distributedfft_tpu_torch import tuner
    from distributedfft_tpu_torch.utils import metrics

    monkeypatch.setenv("DFFT_WISDOM", str(tmp_path / "wisdom.jsonl"))
    monkeypatch.setenv("DFFT_TUNE_ITERS", "1x1")
    monkeypatch.setenv("DFFT_TUNE_MAX", "3")
    tdfft.clear_plan_cache()
    metrics.metrics_reset()
    metrics.enable_metrics()
    try:
        plan = top.plan_spectral_op(SHAPE, 4, op=top.poisson(),
                                    device="cpu", **kw)
        assert metrics.counter_total("tune_tournaments") == 1
        rng = np.random.default_rng(11)
        x = (rng.standard_normal(SHAPE)
             + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)
        want = np.asarray(jop.plan_spectral_op(
            SHAPE, jdfft.make_mesh(4), op=jop.poisson(), executor="xla",
            dtype=np.complex64)(x))
        got = plan(torch.from_numpy(x)).numpy()
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 5e-4
        entries, dropped = tuner.load_wisdom(str(tmp_path / "wisdom.jsonl"))
        assert dropped == 0 and [e["key"]["kind"] for e in
                                 entries.values()] == ["op:poisson"]
        tdfft.clear_plan_cache()
        metrics.metrics_reset()
        again = top.plan_spectral_op(SHAPE, 4, op=top.poisson(),
                                     device="cpu", **kw)
        assert metrics.counter_total("tune_timing_executions") == 0
        assert tuner.tuned_label(again) == tuner.tuned_label(plan)
    finally:
        metrics.enable_metrics(False)
        metrics.metrics_reset()
        tdfft.clear_plan_cache()


@pytest.mark.parametrize("budget", [None, 1e-2])
def test_tuned_op_tier_runs_the_transform_tournament(budget, tmp_path,
                                                     monkeypatch):
    """The op tier is :func:`tuner.tuned_plan` under the wisdom kind
    ``op:poisson``: one tournament whose candidates carry the exact wire
    and, under a budget, ``bf16`` (the JAX op tier's wire axis) and no
    reduced matmul tier; its winner is the candidate the stubbed
    measurement ranks first."""
    from distributedfft_tpu_torch import tuner

    monkeypatch.setenv("DFFT_WISDOM", str(tmp_path / "wisdom.jsonl"))
    monkeypatch.setenv("DFFT_TUNE_ITERS", "1x1")
    monkeypatch.setenv("DFFT_AUTO_EXECUTORS", "torch,matmul")
    seen = []
    orig = tuner.measured_select

    def record(names, build, measure, **kw):
        seen.append((list(names), kw["what"]))
        last = names[-1]
        return orig(names, build, lambda plan: 0.0 if tuner.tuned_label(
            plan) == last else 1.0, **kw)

    monkeypatch.setattr(tuner, "measured_select", record)
    tdfft.clear_plan_cache()
    try:
        plan = top.plan_spectral_op(SHAPE, 4, op=top.poisson(),
                                    device="cpu", tune="measure",
                                    max_roundtrip_err=budget)
    finally:
        tdfft.clear_plan_cache()
    (names, what), = seen
    assert what == "op:poisson tune candidate"
    assert tuner.tuned_label(plan) == names[-1]
    wires = {n.partition("+w")[2] or None for n in names}
    assert wires <= ({None, "bf16"} if budget else {None})
    assert not any(":bf16" in n.split("/")[2] or ":f32" in n.split("/")[2]
                   for n in names)
    entries, _ = tuner.load_wisdom(str(tmp_path / "wisdom.jsonl"))
    assert [e["key"]["kind"] for e in entries.values()] == ["op:poisson"]


def test_midpoint_hooks():
    """The builders' ``midpoint=`` hook is the spectral chain, in the
    canonical forward orientation only (JAX's text)."""
    from distributedfft_tpu_torch.parallel.pencil import build_pencil_general
    from distributedfft_tpu_torch.parallel.slab import build_slab_general
    from distributedfft_tpu_torch.stagegraph import gather, run_graph, scatter

    mult = top._multiplier_fn(top.gradient(1), SHAPE, C128)
    graph, _ = build_slab_general(tdfft.make_world(4), SHAPE, in_axis=0,
                                  out_axis=1, executor="torch",
                                  midpoint=mult)
    assert [n.name for n in graph.nodes][3] == "t_mid"
    x = torch.from_numpy(_x(SHAPE))
    want = _plan(SHAPE, 4, top.gradient(1), executor="torch")(x)
    assert torch.equal(gather(graph, run_graph(graph, scatter(graph, x))),
                       want)
    with pytest.raises(ValueError, match="canonical"):
        build_slab_general(tdfft.make_world(4), SHAPE, in_axis=1,
                           out_axis=0, midpoint=mult)
    with pytest.raises(ValueError, match="canonical"):
        build_pencil_general(tdfft.make_world((2, 2)), SHAPE,
                             perm=(1, 2, 0), order="row_first",
                             forward=False, midpoint=mult)


# ------------------------------------------------------ process groups

PG_CASES = (("slab", None, UNEVEN, top.gradient(1), 2),
            ("pencil", (2, 2), SHAPE, top.gradient(2), 1))


def _pg_rank(rank, size, backend, init, out_dir):
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=size)
    try:
        out = {}
        for label, grid, shape, op, k in PG_CASES:
            world = process_group_world(grid=grid)
            plan = top.plan_spectral_op(shape, world, op=op, device=device,
                                        overlap_chunks=k)
            x = _x(shape, np.complex64, seed=5)[plan.in_boxes[rank].slices()]
            out[label] = plan(torch.from_numpy(x.copy()).to(device)).cpu()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: v.numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def _spawn(tmp, backend):
    init = f"file://{tmp / 'store'}"
    mp.start_processes(_pg_rank, args=(4, backend, init, str(tmp)),
                       nprocs=4, join=True, start_method="spawn")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


def _check_pg(results, exact):
    for label, grid, shape, op, k in PG_CASES:
        plan = top.plan_spectral_op(shape, 4 if grid is None else grid,
                                    op=op, device="cpu", overlap_chunks=k)
        want = plan(torch.from_numpy(_x(shape, np.complex64, seed=5)))
        for rank, box in enumerate(plan.out_boxes):
            got = results[rank][label]
            assert got.shape == box.shape, label
            if exact:
                assert np.array_equal(got, want[box.slices()].numpy()), label
            else:
                assert _rel(got, want[box.slices()].numpy()) < 5e-4, label


def test_process_group_ops_match_loopback(tmp_path):
    _check_pg(_spawn(tmp_path, "gloo"), exact=True)


@pytest.mark.cuda
def test_process_group_ops_over_nccl(tmp_path):
    """The same ranks over NCCL on four cards, each rank's box within the
    complex64 tier of the CPU loopback plan. On the cards: ``python -m
    pytest --noconftest -m cuda tests/test_torch_operator_chains.py``."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA cards")
    _check_pg(_spawn(tmp_path, "nccl"), exact=False)
