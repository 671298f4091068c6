"""distributedfft_tpu_torch -- the PyTorch/CUDA port of distributedfft_tpu.

The slab- and pencil-decomposed distributed 3D C2C and real-to-complex
FFTs, forward and backward, complex64 and complex128, on an NVIDIA H100,
with an optional compressed exchange (``wire_dtype`` bf16/int8/split)
whose codec can be fused into the stages beside it (``fuse=True``), and
batched local 1D/2D/3D plans (:mod:`.local`). The ``cuda`` executor's
local transforms run through three kernels written in CUDA C++ for
``sm_90a`` (``csrc/four_step.cu``), the fused stage+codec pairs through
two more (``csrc/fuse.cu``), all built with ``nvcc`` at first use; what
the kernels do not take (complex128, short or prime lengths) runs the
DFT by matmuls of :mod:`.ops.dft_matmul`, as in the JAX package. The
``matmul`` and ``torch`` (``torch.fft``) executors run beside it.

The exchange has four transports (``algorithm``: ``alltoall``,
``alltoallv``, ``ppermute``, and ``hierarchical`` over a hybrid (nodes x
cards) world, :mod:`.parallel.multihost`), an overlap-K pipeline of t2
under t3 (``overlap_chunks``), staged pipelines for per-stage times
(:mod:`.parallel.staged`, :func:`.utils.timing.time_staged`) and trace
spans around every stage (:mod:`.utils.trace`).

Plans take the caller's data layout: ``in_spec`` / ``out_spec``
(:class:`~.parallel.mesh.Spec` layouts, absorbed into the chain or
reshaped at its edges), any per-rank boxes with a storage order (the
brick planners, :func:`plan_brick_dft_c2c_3d` and the real pair, over
the overlap-map edges of :mod:`.parallel.bricks`), the halved axis of a
real plan (``r2c_axis``), B transforms through one chain (``batch=B``)
and the input as workspace (``donate=True``).

Spectral operators (:mod:`.operators`): a Poisson solve, a spectral
derivative, a Gaussian filter, a convolution or any pointwise multiplier
as one plan, FFT -> multiply at the transposed midpoint (``t_mid``) ->
inverse FFT, half the exchanges of a forward plan, a multiply and a
backward plan in the caller's layout.

Long 1D transforms: an axis past one kernel's reach (65536) whose length
splits into two kernel lengths runs two kernel passes with a twiddle
between them (any local plan, e.g. ``plan_dft_c2c_1d(1 << 24)``), and
:func:`plan_dft_c2c_1d_dist` cuts one sequence over a world's ranks
(the four-step identity, its reorders as exchanges; transposed or
natural output order). Several plans over one world run as one
interleaved program (:func:`schedule_concurrent`: one transform's
exchange issued while another's FFTs run), rolled wave by wave with at
most ``depth`` waves in flight by :class:`WaveSchedule`.

Quick start::

    import torch
    import distributedfft_tpu_torch as dfft

    plan = dfft.plan_dft_c2c_3d((512, 512, 512), dfft.make_world(4))
    x = torch.randn(512, 512, 512, dtype=torch.complex64, device="cuda")
    y = plan(x)                                    # X-slabs in, Y-slabs out
    pencil = dfft.plan_dft_c2c_3d((512, 512, 512), (2, 2))  # 2x2 world
    ring = dfft.plan_dft_c2c_3d((512, 512, 512), 4, algorithm="ppermute",
                                overlap_chunks="auto")
    hier = dfft.plan_dft_c2c_3d((512, 512, 512),
                                dfft.make_world((2, 2), dfft.HYBRID_AXES),
                                algorithm="hierarchical")
    real = dfft.plan_dft_r2c_3d((512, 512, 512), 4, wire_dtype="split",
                                fuse=True)
    h = real(torch.randn(512, 512, 512, device="cuda"))   # [512, 512, 257]
    w = dfft.geometry.world_box((512, 512, 512))
    ins = dfft.geometry.make_slabs(w, 4, axis=2)            # Z-slabs in
    outs = dfft.geometry.make_pencils(w, (2, 2), 0)         # X-pencils out
    brick = dfft.plan_brick_dft_c2c_3d((512, 512, 512), 4, ins, outs)
    y = brick(dfft.scatter_bricks(x, ins))                  # [4, *pad] stacks
    u = dfft.solve_poisson((512, 512, 512), 4)(x)           # X-slabs in/out
    v = torch.randn(1 << 28, dtype=torch.complex64, device="cuda")
    s = dfft.plan_dft_c2c_1d_dist(1 << 28, 4, order="natural")(v)
    long = dfft.plan_dft_c2c_1d(5 ** 11)(v[:5 ** 11][None])  # two levels
    a, b = plan, dfft.plan_dft_c2c_3d((512, 512, 512), dfft.make_world(4))
    ya, yb = dfft.schedule_concurrent([a, b])(x, x)         # interleaved
    waves = dfft.WaveSchedule(max_width=2)
    outs = waves.dispatch([a, b], [x, x])                  # in flight
    waves.drain()                                          # retired

Measured planning: ``tune="measure"`` / ``"wisdom"`` (:mod:`.tuner`, its
winners kept in a wisdom store), ``executor="auto"`` and the calibrated
hardware profile the tuner's model reads (:mod:`.calibrate`)::

    tuned = dfft.plan_dft_c2c_3d((512, 512, 512), 4, tune="measure")
    auto = dfft.plan_dft_c2c_3d((512, 512, 512), 4, executor="auto")
    prof = dfft.calibrate.calibrate()
    dfft.calibrate.write_profile(prof)

Explain and attribution (:mod:`.explain`): per stage the model, the
memory one call holds and the measured time (host brackets, or the
card's ``torch.profiler`` timeline with ``device_timing=True``), with a
divergence flag where the model misses::

    rec = dfft.explain(plan, iters=5, device_timing=True)
    print(dfft.explain_mod.format_explain(rec))

Serving (:mod:`.serving`): requests coalesced into batched plan calls,
with QoS (:mod:`.qos`), fault injection and recovery (:mod:`.faults`),
the numerics plane (:mod:`.numerics`) and a live monitor
(:mod:`.monitor`, armed by ``DFFT_MONITOR`` / ``DFFT_MONITOR_DIR``)
whose per-process series the fleet view (:mod:`.fleet`) merges and
judges; ``python -m distributedfft_tpu_torch.loadgen`` drives a fleet
of monitored queues with seeded traffic::

    q = dfft.CoalescingQueue(4, max_batch=8, retry_max=2)
    hs = [q.submit(x) for _ in range(8)]                    # one flush
    ys = [h.result() for h in hs]
    q.serve()                                               # drain loop
    q.close()
    v = dfft.monitor.health_from_samples(dfft.monitor.load_series(p))

Entry points run on the card; ``device="cpu"`` runs the kernels' plain
PyTorch versions instead. This package imports neither JAX nor
``distributedfft_tpu``.
"""

__version__ = "0.1.0"

# Name rule (the JAX package's): ``dfft.explain`` is the function of
# ``api``, ``dfft.explain_mod`` the module. The module is imported here,
# before ``api``'s import below binds ``explain`` to the function, so a
# later ``import distributedfft_tpu_torch.explain`` cannot replace the
# function with the module.
from . import explain as explain_mod  # noqa: F401
from . import calibrate, operators, tuner  # noqa: F401
from .api import (  # noqa: F401
    BACKWARD,
    FORWARD,
    DDPlan3D,
    OpPlan3D,
    Plan3D,
    alloc_local,
    clear_plan_cache,
    destroy_plan,
    execute,
    explain,
    plan_brick_dft_c2c_3d,
    plan_brick_dft_c2r_3d,
    plan_brick_dft_r2c_3d,
    plan_dd_brick_dft_c2c_3d,
    plan_dd_brick_dft_c2r_3d,
    plan_dd_brick_dft_r2c_3d,
    plan_dd_dft_c2c_3d,
    plan_dd_dft_c2r_3d,
    plan_dd_dft_r2c_3d,
    plan_dft_c2c_3d,
    plan_dft_c2r_3d,
    plan_dft_r2c_3d,
    plan_from_reference,
)
from .geometry import Box3  # noqa: F401
from .local import (LocalPlan, plan_dft_c2c, plan_dft_c2c_1d,  # noqa: F401
                    plan_dft_c2c_2d)
from .operators import (fft_convolve, gaussian_filter,  # noqa: F401
                        plan_spectral_op, solve_poisson, spectral_gradient)
from .ops.ddfft import dd_from_host, dd_to_host  # noqa: F401
from .ops.executors import Scale  # noqa: F401
from .parallel.bricks import gather_bricks, scatter_bricks  # noqa: F401
from .parallel.exchange import ALGORITHMS  # noqa: F401
from .parallel.fft1d import (DistPlan1D, build_dist_fft1d,  # noqa: F401
                             choose_split_1d, plan_dft_c2c_1d_dist)
from .parallel.mesh import (HYBRID_AXES, Spec, World,  # noqa: F401
                            make_world, process_group_world)
from .plan_logic import (PlanOptions, choose_decomposition,  # noqa: F401
                         default_options)
from .stagegraph import (ConcurrentPlan, WaveSchedule,  # noqa: F401
                         graph_of, schedule_concurrent, schedule_waves)
from .utils.metrics import (enable_metrics, metrics_enabled,  # noqa: F401
                            metrics_reset, metrics_snapshot)
from .utils.trace import plan_info  # noqa: F401
from .serving import (CoalescingQueue, DeadlineExceeded,  # noqa: F401
                      Handle, QueueFull, submit, warm_pool)
# The serving tier's modules are their API surface (dfft.qos.parse_qos,
# dfft.faults.inject, dfft.numerics.numerics_snapshot,
# dfft.monitor.health_from_samples, dfft.fleet.fleet_health); the policy
# and tenant types and the errors a handle can carry are lifted beside
# them.
from . import faults, fleet, monitor, numerics, qos  # noqa: F401,E402
from .faults import InjectedFault  # noqa: F401,E402
from .numerics import NonFiniteResult  # noqa: F401,E402
from .qos import QosPolicy, QuotaExceeded, Tenant  # noqa: F401,E402
