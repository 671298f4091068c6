"""distributedfft_tpu_torch -- the PyTorch/CUDA port of distributedfft_tpu.

The slab-decomposed distributed 3D C2C FFT, forward and backward,
complex64, on an NVIDIA H100. Its local transforms run through three
four-step kernels written in CUDA C++ for ``sm_90a``
(``csrc/four_step.cu``), built with ``nvcc`` at first use.

Quick start::

    import torch
    import distributedfft_tpu_torch as dfft

    plan = dfft.plan_dft_c2c_3d((512, 512, 512), dfft.make_world(4))
    x = torch.randn(512, 512, 512, dtype=torch.complex64, device="cuda")
    y = plan(x)                                    # X-slabs in, Y-slabs out

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
    plan_from_reference,
)
from .ops.executors import Scale  # noqa: F401
from .parallel.mesh import World, make_world, process_group_world  # noqa: F401
