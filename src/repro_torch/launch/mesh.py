"""The device meshes of one process a device (port of
``repro/launch/mesh.py``): the ABM's spatial mesh (``make_abm_mesh``) and
the LM's named-axis mesh (``make_mesh``, ``make_production_mesh``).

    init_process_mesh()                        # under torchrun
    mesh = make_abm_mesh((2, 2))               # a DeviceMesh (sx, sy)
    sim = make_sim(behavior, mesh_shape=(2, 2), mesh=mesh)
    ...
    close_process_mesh()                       # at the rank's end

:func:`init_process_mesh` joins the default process group, from
``torchrun``'s environment or from an explicit ``init_method``, rank and
world size, always with a timeout, so that a rank that is lost fails the
run instead of hanging it.  :func:`make_abm_mesh` lays that group's ranks
out row-major over the mesh, with the reference's axis names, or a subset
of them in a group of their own (a degraded run's survivors,
:func:`survivor_ranks`).
:func:`close_process_mesh` leaves the group with its threads joined.
:func:`spawn_ranks` starts the ranks of a mesh as processes of this host
and joins them against a deadline (the tests and ``chip_smoke.py`` run a
mesh through it).  
:func:`make_mesh` lays the default group's ranks out row-major over an LM
mesh, ``("data", "model")`` or ``("pod", "data", "model")``, as a
:class:`~repro_torch.distributed.collectives.Mesh` holding a group for
every set of its axes; the LM stack's collectives
(``distributed/collectives.py``) run over those groups.
:func:`make_production_mesh` is the H100 cluster's layout in place of the
reference's TPU pod.  The reference's TPU hardware model (``HW``) is not
carried over: an H100 model comes with the roofline.
"""

from __future__ import annotations

import datetime
import itertools
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


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device="cuda"):
    """An LM mesh of ``shape`` with axis names ``axes`` over every rank of
    the default group, row-major (rank ``r`` at ``unravel(r, shape)``),
    this process's tensors on ``device``.  Every rank builds, in the same
    order, a group for each set of axes of more than one device (the
    whole mesh is the default group), so a collective over any named
    axes has its group.  With no process group (or one of one rank) a
    mesh of one device is returned, whose collectives are identities;
    any other shape then raises."""
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.distributed.collectives import Mesh

    shape = tuple(int(n) for n in shape)
    axes = tuple(axes)
    n = math.prod(shape)
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"mesh {shape} needs {n} processes and no process group is "
                "initialized (run under torchrun, or init_process_mesh)")
        return Mesh(axes, shape, rank=0, device=dev)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {shape} has {n} devices; the process group "
                         f"has {world} ranks")
    mesh = Mesh(axes, shape, rank=dist.get_rank(), device=dev,
                backend=str(dist.get_backend()))
    for k in range(1, len(axes) + 1):
        for subset in itertools.combinations(axes, k):
            size = math.prod(mesh.shape[a] for a in subset)
            if size == 1:
                continue
            if size == world:
                mesh.groups[subset] = None
                continue
            # one group for each setting of the other axes, all ranks in
            # the same order
            others = [a for a in axes if a not in subset]
            for vals in itertools.product(*(range(mesh.shape[a])
                                            for a in others)):
                coords = dict(zip(others, vals))
                coords.update({a: 0 for a in subset})
                ranks = list(mesh.members(subset, coords))
                g = dist.new_group(ranks=ranks)
                if mesh.rank in ranks:
                    mesh.groups[subset] = g
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production LM mesh: H100 nodes of 8 NVLink-joined cards, the
    ``model`` axis over the 8 cards of a node (its all-to-alls and gathers
    stay on NVLink) and ``data`` over 32 nodes, 256 cards ``(32, 8)``; two
    such pods ``(2, 32, 8)`` with ``("pod", "data", "model")``.  It takes
    the place of the reference's TPU pod ``(16, 16)``.  On a group of that
    many ranks it is a process mesh (:func:`make_mesh`); elsewhere a
    layout only, which gives the specs and blocks of that mesh."""
    import torch.distributed as dist

    from repro_torch.distributed.collectives import Mesh

    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        return make_mesh(shape, axes, device)
    return Mesh(axes, shape)


def make_abm_mesh(mesh_shape: Sequence[int],
                  axes: Optional[Tuple[str, ...]] = None,
                  device_type: str = "cuda",
                  ranks: Optional[Sequence[int]] = None):
    """The spatial ``DeviceMesh`` over every rank of the default group,
    row-major (rank ``r`` at mesh coordinates ``unravel(r, mesh_shape)``,
    the reference's ``linear_rank``), with axis names ``(sx, sy[, sz])``
    unless ``axes`` names them.  ``device_type`` is the engine's
    (``"cuda"``, or ``"cpu"`` on a CPU run).

    ``ranks`` lays out a subset of the default group instead, row-major in
    ascending order: the mesh of the devices a degraded run keeps
    (:func:`survivor_ranks`).  Its ranks get a group of their own
    (:func:`mesh_group`), built by every rank of the default group at
    this call; a rank outside gets a mesh whose ``get_coordinate()`` is
    None.  A later mesh of the same ranks (:func:`relayout_mesh`) takes
    that group again, so the ranks that left need not take part."""
    import torch.distributed as dist

    mesh_shape = tuple(int(m) for m in mesh_shape)
    n = math.prod(mesh_shape)
    world = dist.get_world_size()
    if axes is None:
        axes = spatial_axis_names(len(mesh_shape))
    if ranks is None or sorted(int(r) for r in ranks) == list(range(world)):
        if n != world:
            raise ValueError(f"mesh {mesh_shape} has {n} devices; the "
                             f"process group has {world} ranks")
        return _mesh(mesh_shape, axes, device_type, range(n), None)
    members = sorted(int(r) for r in ranks)
    if len(members) != n or len(set(members)) != n or \
            not 0 <= members[0] <= members[-1] < world:
        raise ValueError(f"mesh {mesh_shape} has {n} devices; ranks "
                         f"{members} are not {n} distinct ranks of the "
                         f"{world} of the process group")
    return _mesh(mesh_shape, axes, device_type, members,
                 dist.new_group(ranks=members))


def _mesh(mesh_shape, axes, device_type, members, group):
    """A mesh over ``members`` (ascending, row-major) joined by ``group``
    (None: the default group), which the mesh carries.  The port reads
    only its layout, coordinates and that group, so the ``DeviceMesh``
    builds no groups of its own: one it held would keep its gloo threads
    running past :func:`close_process_mesh`."""
    from torch.distributed.device_mesh import DeviceMesh

    layout = torch.tensor(list(members), dtype=torch.int64).reshape(
        mesh_shape)
    mesh = DeviceMesh(device_type, layout, mesh_dim_names=tuple(axes),
                      _init_backend=False)
    mesh.abm_group = group
    return mesh


def mesh_group(mesh):
    """The process group of a process mesh: None (the default group) for
    a mesh over every rank, else the group of its subset."""
    return getattr(mesh, "abm_group", None)


def relayout_mesh(mesh, mesh_shape: Sequence[int]):
    """The mesh of ``mesh_shape`` over the ranks of the process mesh
    ``mesh``, in its group (a re-shard's new shape); only those ranks call
    it."""
    shape = tuple(int(m) for m in mesh_shape)
    group = mesh_group(mesh)
    if group is None:
        return make_abm_mesh(shape, device_type=mesh.device_type)
    members = sorted(int(r) for r in mesh.mesh.reshape(-1).tolist())
    if math.prod(shape) != len(members):
        raise ValueError(f"mesh {shape} over the {len(members)} ranks of "
                         f"mesh {tuple(mesh.mesh.shape)}")
    return _mesh(shape, spatial_axis_names(len(shape)), mesh.device_type,
                 members, group)


def close_process_mesh() -> None:
    """Leave the process group and join the gloo threads of this
    process's groups.  ``destroy_process_group`` shuts a group down, but
    its threads (``gloo_tcp_loop``, ``pt_gloo_runloop``) are joined only
    when its last reference goes; a group still referenced in the
    interpreter's teardown can have a thread destroyed while joinable,
    which aborts a process whose work was done ("terminate called without
    an active exception", SIGABRT).  So this drops the re-shard's cached
    meshes, collects what is unreachable and destroys every group.  A
    mesh of :func:`make_abm_mesh` over every rank holds no group; a
    subset's mesh holds its group until the caller drops it."""
    import gc

    import torch.distributed as dist

    from repro_torch.core import reshard

    reshard._MESHES.clear()
    gc.collect()
    if dist.is_initialized():
        dist.destroy_process_group()


def survivor_ranks(mesh, n: int) -> Tuple[int, ...]:
    """The ranks of the ``n`` devices a run on ``mesh`` keeps when it
    loses the rest: the first ``n`` of its row-major order, as the
    reference's restore keeps ``jax.devices()[:n]`` (``jax.make_mesh``
    takes the leading devices)."""
    order = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
    if not 0 < n <= len(order):
        raise ValueError(f"{n} survivors of a mesh of {len(order)} devices")
    return tuple(sorted(order[:n]))


def _rank_main(rank: int, fn: Callable, world: int, store: str,
               timeout_s: float, args: tuple) -> None:
    """One rank of :func:`spawn_ranks`: joins the group, runs ``fn`` and
    leaves through :func:`close_process_mesh`."""
    init_process_mesh("gloo", init_method=f"file://{store}", rank=rank,
                      world_size=world, timeout_s=timeout_s)
    try:
        fn(rank, world, *args)
    finally:
        close_process_mesh()


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
