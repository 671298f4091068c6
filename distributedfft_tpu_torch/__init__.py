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

Quick start::

    import torch
    import distributedfft_tpu_torch as dfft

    plan = dfft.plan_dft_c2c_3d((512, 512, 512), dfft.make_world(4))
    x = torch.randn(512, 512, 512, dtype=torch.complex64, device="cuda")
    y = plan(x)                                    # X-slabs in, Y-slabs out
    pencil = dfft.plan_dft_c2c_3d((512, 512, 512), (2, 2))  # 2x2 world
    real = dfft.plan_dft_r2c_3d((512, 512, 512), 4, wire_dtype="split",
                                fuse=True)
    h = real(torch.randn(512, 512, 512, device="cuda"))   # [512, 512, 257]

Entry points run on the card; ``device="cpu"`` runs the kernels' plain
PyTorch versions instead. This package imports neither JAX nor
``distributedfft_tpu``.
"""

from .api import (  # noqa: F401
    BACKWARD,
    FORWARD,
    Plan3D,
    execute,
    plan_dft_c2c_3d,
    plan_dft_c2r_3d,
    plan_dft_r2c_3d,
    plan_from_reference,
)
from .local import (LocalPlan, plan_dft_c2c, plan_dft_c2c_1d,  # noqa: F401
                    plan_dft_c2c_2d)
from .ops.executors import Scale  # noqa: F401
from .parallel.mesh import World, make_world, process_group_world  # noqa: F401
from .plan_logic import choose_decomposition  # noqa: F401
