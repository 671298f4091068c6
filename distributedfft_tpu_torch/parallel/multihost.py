"""The multi-node tier: process bootstrap, hybrid worlds, host/global data.

The port of ``distributedfft_tpu/parallel/multihost.py``. The reference
runs one MPI rank per card, peer copies within a node and MPI across
nodes (``fft_mpi_3d_api.cpp:610-699``). Here a job is one process per
card started by ``torchrun`` (or any launcher that sets its
environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), joined by ``torch.distributed``: NCCL
on the cards, gloo on the CPU. A hybrid world lays the job out as
(nodes, cards per node): its ``"ici"`` axis is the cards of a node, its
``"dcn"`` axis the nodes, so the hierarchical transport's first leg
stays within a node.

With one process every helper degrades to the local behaviour.

Example, two nodes of four cards::

    torchrun --nnodes 2 --nproc-per-node 4 --rdzv-endpoint HOST:PORT \\
        my_driver.py
    # in my_driver.py
    from distributedfft_tpu_torch.parallel import multihost
    multihost.init_multihost()
    world = multihost.make_hybrid_world()          # 2 x 4, dcn x ici
    plan = dfft.plan_dft_c2c_3d(shape, world, algorithm="hierarchical")
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import HYBRID_AXES, World, make_world, process_group_world


def _env_int(name: str) -> int | None:
    v = os.environ.get(name, "").strip()
    return int(v) if v else None


def init_multihost(init_method: str | None = None,
                   world_size: int | None = None, rank: int | None = None,
                   backend: str | None = None, **kw) -> bool:
    """Initialize ``torch.distributed`` from the launcher's environment
    (``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``, or the
    arguments given), NCCL when CUDA is available and gloo otherwise,
    and on the card bind this process to card ``LOCAL_RANK``. Returns
    True when a multi-process group is (or already was) up, False when
    nothing configures one (a single process). Safe to call twice."""
    if dist.is_initialized():
        return True
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and (world_size is None or rank is None
                                or "MASTER_ADDR" not in os.environ):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)
    return True


def local_world_size() -> int:
    """Processes per node: ``LOCAL_WORLD_SIZE`` (set by ``torchrun``),
    else every process of the job on one node."""
    n = _env_int("LOCAL_WORLD_SIZE")
    if n is None:
        return dist.get_world_size() if dist.is_initialized() else 1
    return n


def make_hybrid_world(axis_names: tuple[str, str] = HYBRID_AXES,
                      *, per_node: int | None = None) -> World:
    """The 2D (nodes x cards per node) world of the running job, axes
    ``axis_names`` (``("dcn", "ici")``): rank ``d * I + e`` is card e of
    node d, as ``torchrun`` numbers them. ``per_node`` defaults to
    :func:`local_world_size`. Every process must call it (it makes the
    row and column sub-groups). Without a process group it is a loopback
    world of (1, ``per_node``)."""
    if not dist.is_initialized():
        return make_world((1, per_node or 1), axis_names)
    size = dist.get_world_size()
    per = per_node or local_world_size()
    if per < 1 or size % per:
        raise ValueError(
            f"{size} processes do not divide into nodes of {per}")
    return process_group_world(grid=(size // per, per),
                               axis_names=axis_names)


def is_hybrid_world(world) -> bool:
    """True for a 2D world whose first axis is ``"dcn"`` (what
    :func:`make_hybrid_world` builds and the hierarchical transport
    takes)."""
    return isinstance(world, World) and world.hybrid


def is_hybrid_mesh(world) -> bool:
    """The JAX package's name for :func:`is_hybrid_world` (its mesh is
    the port's :class:`~.mesh.World`): a 2D world whose axis 0 is
    ``"dcn"``, the shape the hierarchical transport and the tuner's
    hierarchical candidates take."""
    return is_hybrid_world(world)


def fft_world_for(ndev_total: int | None = None, *, device=None) -> World:
    """The default world of this job (JAX: ``fft_mesh_for``): a hybrid
    world over the process group when ``torch.distributed`` runs more
    than one process, else a loopback 1D world of ``ndev_total`` ranks.
    Without ``ndev_total`` the ranks are the cards of ``device``'s kind
    (:func:`..api.resolve_device`: the card unless ``device="cpu"``,
    and raising without one), one on the CPU."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return make_hybrid_world()
    n = ndev_total
    if n is None:
        from ..api import resolve_device

        n = (torch.cuda.device_count()
             if resolve_device(device).type == "cuda" else 1)
    return make_world(n) if n > 1 else World(1)


#: The JAX package's name of :func:`fft_world_for`.
fft_mesh_for = fft_world_for


def host_local_to_global(world: World, local: np.ndarray):
    """This process's block as a tensor of the world: on a process-group
    world the block itself (each rank holds its own box), on a loopback
    world the global array. The ingest direction of the reference's
    per-rank init."""
    return torch.as_tensor(np.ascontiguousarray(local))


def global_to_host_local(world: World, x: torch.Tensor,
                         dim: int = 0) -> np.ndarray:
    """Every rank's block of ``x`` joined along ``dim`` on every process
    (``all_gather``; blocks may differ in extent along ``dim``), as
    numpy. A loopback world's ``x`` is global already."""
    if world.loopback or world.size == 1:
        return x.detach().cpu().numpy()
    cplx = x.is_complex()
    if cplx:                  # gloo gathers real tensors only
        x = torch.view_as_real(x)
    group = world.axis_group(world.combined_axis)
    ext = torch.tensor([x.shape[dim]], device=x.device)
    exts = [torch.zeros_like(ext) for _ in range(world.size)]
    dist.all_gather(exts, ext, group=group)
    top = int(max(int(e) for e in exts))
    pad = list(x.shape)
    pad[dim] = top - x.shape[dim]
    xp = torch.cat([x, x.new_zeros(pad)], dim=dim).contiguous()
    got = [torch.empty_like(xp) for _ in range(world.size)]
    dist.all_gather(got, xp, group=group)
    out = torch.cat([g.narrow(dim, 0, int(e)) for g, e in zip(got, exts)],
                    dim=dim)
    return (torch.view_as_complex(out) if cplx else out).cpu().numpy()


def sync_global_devices(tag: str = "dfft") -> None:
    """A barrier across every process (the reference's ``MPI_Barrier``
    between timed sections); a no-op in one process."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
