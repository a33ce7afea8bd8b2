"""The spatial device mesh of one process a device (port of
``repro/launch/mesh.py``'s ``make_abm_mesh``).

    init_process_mesh()                        # under torchrun
    mesh = make_abm_mesh((2, 2))               # a DeviceMesh (sx, sy)
    sim = make_sim(behavior, mesh_shape=(2, 2), mesh=mesh)

:func:`init_process_mesh` joins the default process group, from
``torchrun``'s environment or from an explicit ``init_method``, rank and
world size, always with a timeout, so that a rank that is lost fails the
run instead of hanging it.  :func:`make_abm_mesh` lays that group's ranks
out row-major over the mesh, with the reference's axis names.
:func:`spawn_ranks` starts the ranks of a mesh as processes of this host
and joins them against a deadline (the tests and ``chip_smoke.py`` run a
mesh through it).  The reference's production mesh and its TPU hardware
model are not carried over: neither describes a GPU.
"""

from __future__ import annotations

import datetime
import math
import os
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.domain import spatial_axis_names

# Default bound on any one wait of the group (a collective, a message).
DEFAULT_TIMEOUT_S = 300.0


def init_process_mesh(backend: str = "gloo", *,
                      init_method: Optional[str] = None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the default process group and return this process's rank.

    Without ``rank`` the group comes from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); otherwise
    from ``init_method`` (e.g. ``file:///path`` on one host), ``rank`` and
    ``world_size``.  Every wait of the group times out after
    ``timeout_s``.  Gloo carries CUDA tensors through host memory
    (:class:`~repro_torch.core.halo.ProcessMeshComm` stages them)."""
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=float(timeout_s))
    if rank is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        if init_method is None or world_size is None:
            raise ValueError("an explicit rank needs init_method and "
                             "world_size")
        dist.init_process_group(backend, init_method=init_method,
                                rank=int(rank), world_size=int(world_size),
                                timeout=timeout)
    return dist.get_rank()


def make_abm_mesh(mesh_shape: Sequence[int],
                  axes: Optional[Tuple[str, ...]] = None,
                  device_type: str = "cuda"):
    """The spatial ``DeviceMesh`` over every rank of the default group,
    row-major (rank ``r`` at mesh coordinates ``unravel(r, mesh_shape)``,
    the reference's ``linear_rank``), with axis names ``(sx, sy[, sz])``
    unless ``axes`` names them.  ``device_type`` is the engine's
    (``"cuda"``, or ``"cpu"`` on a CPU run)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    mesh_shape = tuple(int(m) for m in mesh_shape)
    n = math.prod(mesh_shape)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {mesh_shape} has {n} devices; the process "
                         f"group has {world} ranks")
    if axes is None:
        axes = spatial_axis_names(len(mesh_shape))
    ranks = torch.arange(n, dtype=torch.int64).reshape(mesh_shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def _rank_main(rank: int, fn: Callable, world: int, store: str,
               timeout_s: float, args: tuple) -> None:
    init_process_mesh("gloo", init_method=f"file://{store}", rank=rank,
                      world_size=world, timeout_s=timeout_s)
    import torch.distributed as dist
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, store: str, args: tuple = (),
                timeout_s: float = 120.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes of this
    host (start method ``spawn``), each joined to one gloo group over the
    file store at ``store`` (a path that does not exist yet) before ``fn``
    runs.  Waits at most ``timeout_s`` seconds; on a timeout or any rank's
    failure every rank still running is killed and this raises.  Gloo
    goes over the loopback interface unless ``GLOO_SOCKET_IFNAME`` says
    otherwise: every rank is on this host."""
    import torch.multiprocessing as mp

    if os.path.exists(store):
        raise ValueError(f"file store {store} exists: one store a spawn")
    saved = os.environ.get("GLOO_SOCKET_IFNAME")
    os.environ["GLOO_SOCKET_IFNAME"] = saved or "lo"   # the ranks inherit it
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, store, timeout_s, args),
            nprocs=world, join=False, start_method="spawn")
    finally:
        if saved is None:
            del os.environ["GLOO_SOCKET_IFNAME"]
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world} ranks still running after {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
