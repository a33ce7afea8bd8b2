"""Re-shard runtime: dynamic load balancing wired into the live engine
(port of ``repro/core/reshard.py``; paper section 2.4.5).

1. :func:`occupancy_histogram` reduces a :class:`SimState` to the small
   host-side per-box weight map the planners consume: live agents per
   partitioning box, optionally scaled by per-device runtimes.  The
   per-cell counts are summed on the device and only that count grid
   crosses to the host.  On a process mesh each rank counts its own
   block and one ``all_reduce`` of the grid gives every rank the same
   histogram, so every rank computes the same plan.
2. :class:`Rebalancer` checks ``imbalance()`` at a cadence inside
   ``Engine.drive`` and the ``Simulation`` facade; past a threshold it
   consults the planners (``choose_partition`` for the realizable plan,
   equal split or box-granular uneven per ``ownership``; ``plan_rcb`` and
   ``plan_diffusive`` as reported bounds) and re-shards.
3. The mass migration is paid once per re-shard.  On an unchanged device
   count :func:`reshard_state` takes the device transport
   (:func:`reshard_state_device`): on the virtual mesh one global re-bin
   on the card; on a process mesh each rank routes its agents and moves
   them with one ``all_to_all_single``.  Otherwise (a restore onto another
   device count, one device) the host transport flattens every live agent
   to the host (:func:`flatten_state`) and re-initialises through
   ``Engine.init_state``.  Both keep the global agent ids, the spawn
   counters' floors, the iteration counter, the RNG lineage and the
   cumulative drops, and give the same state bit for bit.  The aura
   references restart at zero, so the next exchange must be a full
   refresh (the drivers force it).  ``Rebalancer(defer=True)`` copies the
   count grid to pinned host memory behind a CUDA event and plans one
   step later, while the old mesh keeps stepping.

The slot order is the reference's canonical interleaved order
``(c0, i0, c1, i1, ..., slot)`` over the owned interior cells: both
transports enumerate agents in it, and one stable sort over (new device,
local cell) assigns slots as the host path's per-device binning does.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.agent_soa import AgentSoA, GID_COUNT, GID_RANK, POS
from repro_torch.core.domain import Domain, Partition
from repro_torch.core.engine import (
    NUM_GUARDS, Engine, SimState, _global_it, _pick,
)
from repro_torch.core.grid import mesh_owned_mask, running_max
from repro_torch.core.halo import init_refs
from repro_torch.core.load_balance import (
    choose_partition,
    device_loads,
    equal_split_loads,
    imbalance,
    partition_loads,
    plan_diffusive,
    plan_rcb,
    widths_to_ownership,
)

TRANSPORTS = ("auto", "host", "device")


def _comm_of(engine: Engine, mesh):
    """The process comm of ``mesh`` (None on the virtual mesh)."""
    return None if mesh is None else engine._comm(mesh)


def process_mesh(mesh_shape: Tuple[int, ...], like):
    """The process mesh of ``mesh_shape`` over the ranks of the process
    mesh ``like``: ``like`` itself when the shapes agree, else a
    ``DeviceMesh`` built once a shape and set of ranks (every rank of
    ``like`` builds it at the same call, so the group's collectives stay
    in step)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import relayout_mesh

    shape = tuple(int(m) for m in mesh_shape)
    if tuple(like.mesh.shape) == shape:
        return like
    ranks = tuple(sorted(int(r) for r in like.mesh.reshape(-1).tolist()))
    key = (shape, like.device_type, ranks, id(dist.group.WORLD))
    held = _MESHES.get(key)
    if held is None:
        held = relayout_mesh(like, shape)
        _MESHES[key] = held
    return held


_MESHES: Dict[Tuple, Any] = {}


# ---------------------------------------------------------------------------
# 1. Occupancy histogram extraction
# ---------------------------------------------------------------------------

def _interleaved_shape(geom: Domain) -> Tuple[int, ...]:
    """(m0, i0, m1, i1, ...) device-block/interior interleave."""
    out: Tuple[int, ...] = ()
    for m, i in zip(geom.mesh_shape, geom.interior):
        out += (m, i)
    return out


def _interior_axes(geom: Domain) -> Tuple[int, ...]:
    """Axes of the interleaved layout holding per-device interior cells."""
    return tuple(range(1, 2 * geom.ndim, 2))


def _cell_mask(geom: Domain, device, comm=None) -> torch.Tensor:
    """``lead + local_shape`` mask of the owned interior cells of the
    comm's blocks (every device of the virtual mesh, or a process's own):
    the aura ring and, on an uneven cut, the padding are False."""
    if geom.uneven:
        own = mesh_owned_mask(geom, device)
    else:
        own = torch.zeros(geom.local_shape, dtype=torch.bool, device=device)
        own[tuple(slice(1, -1) for _ in range(geom.ndim))] = True
        own = own.expand(geom.mesh_shape + geom.local_shape)
    return own if comm is None else _pick(own, comm)


def device_counts(geom: Domain, valid: torch.Tensor, comm=None
                  ) -> torch.Tensor:
    """Live agents of each owned interior cell, summed on the device:
    ``lead + interior`` int32 (the comm's blocks)."""
    nd = geom.ndim
    own = _cell_mask(geom, valid.device, comm)
    isl = (slice(None),) * nd + (slice(1, -1),) * nd
    return (valid.sum(dim=-1, dtype=torch.int32) * own)[isl]


def _counts_to_host(geom: Domain, counts: torch.Tensor, comm=None
                    ) -> np.ndarray:
    """:func:`device_counts` of the comm's blocks -> the whole mesh's
    interleaved ``(m0, i0, m1, i1, ...)`` int64 count grid on the host (on
    a process mesh: each rank's block placed at its coordinates, then one
    ``all_reduce``)."""
    nd = geom.ndim
    c = counts.cpu().numpy().astype(np.int64)
    if comm is not None:
        full = np.zeros(geom.mesh_shape + geom.interior, np.int64)
        full[comm.coords()] = c[(0,) * nd]
        c = comm.sum_over_all_ranks(torch.from_numpy(full)).numpy()
    perm = [ax for a in range(nd) for ax in (a, nd + a)]
    # C order, as the reference's: float sums below run in memory order
    return np.ascontiguousarray(c.transpose(perm))


def owned_counts(geom: Domain, state: SimState, comm=None) -> np.ndarray:
    """The interleaved per-cell live-agent counts of every device's owned
    interior cells (the reference's ``_owned_valid_blocks(...).sum(-1)``)."""
    return _counts_to_host(geom, device_counts(geom, state.soa.valid, comm),
                           comm)


def _assemble_global(geom: Domain, interleaved: np.ndarray) -> np.ndarray:
    """Interleaved per-device owned data -> the true global cell grid.  On
    the equal split this is a contiguous reshape; under uneven ownership
    each device's owned slab lands at its cut positions (padding is
    dropped), so downstream box reductions respect the cuts."""
    nd = geom.ndim
    trailing = interleaved.shape[2 * nd:]
    if not geom.uneven:
        return interleaved.reshape(geom.global_cells + trailing)
    part = geom.partition
    out = np.zeros(geom.global_cells + trailing, dtype=interleaved.dtype)
    for coords in np.ndindex(*geom.mesh_shape):
        src: Tuple = ()
        dst: Tuple = ()
        for a in range(nd):
            lo, hi = part.cuts[a][coords[a]], part.cuts[a][coords[a] + 1]
            src += (coords[a], slice(0, hi - lo))
            dst += (slice(lo, hi),)
        out[dst] = interleaved[src]
    return out


def _per_device_sums(geom: Domain, arr: np.ndarray) -> np.ndarray:
    """Global cell grid -> per-device sums (``mesh_shape``), respecting
    cut positions under uneven ownership."""
    if not geom.uneven:
        return np.asarray(arr).reshape(_interleaved_shape(geom)).sum(
            axis=_interior_axes(geom))
    part = geom.partition
    out = np.zeros(geom.mesh_shape, dtype=np.float64)
    for coords in np.ndindex(*geom.mesh_shape):
        sl = tuple(
            slice(part.cuts[a][coords[a]], part.cuts[a][coords[a] + 1])
            for a in range(geom.ndim))
        out[coords] = np.asarray(arr)[sl].sum()
    return out


def realized_loads(geom: Domain, hist: np.ndarray) -> np.ndarray:
    """Per-device loads of the live ownership over a box histogram: the
    equal-split blocks, or the Domain's Partition cuts when uneven."""
    if geom.uneven:
        bf = geom.box_factor
        cuts = geom.partition.cuts
        if any(v % bf for c in cuts for v in c):
            raise ValueError(
                f"partition cuts {cuts} are not aligned to box_factor {bf}")
        return partition_loads(
            hist, Partition(cuts=tuple(tuple(v // bf for v in c)
                                       for c in cuts)))
    return equal_split_loads(hist, geom.mesh_shape)


def occupancy_histogram(geom: Domain, state: SimState,
                        runtimes: Optional[np.ndarray] = None,
                        comm=None) -> np.ndarray:
    """Per-partitioning-box weight map (the Domain's ``box_grid`` shape)
    for the planners.

    The base weight is the live-agent count per box.  With ``runtimes``
    (a ``mesh_shape`` array of per-device step times) each device's boxes
    are scaled by its time per agent, the paper's runtime-weighted box
    loads.  ``comm``: a process mesh's comm (every rank gets the whole
    mesh's histogram)."""
    return histogram_from_counts(geom, owned_counts(geom, state, comm),
                                 runtimes)


def histogram_from_counts(geom: Domain, counts: np.ndarray,
                          runtimes: Optional[np.ndarray] = None
                          ) -> np.ndarray:
    """:func:`occupancy_histogram`'s body over an interleaved count grid
    (:func:`owned_counts`): the deferred plan feeds it a snapshot taken
    one step earlier."""
    nd = geom.ndim
    if runtimes is not None:
        rt = np.asarray(runtimes, np.float64).reshape(geom.mesh_shape)
        dev_counts = counts.sum(axis=_interior_axes(geom))
        total = float(counts.sum())
        per_agent = rt / np.maximum(dev_counts, 1.0)
        expand: Tuple[int, ...] = ()
        for m in geom.mesh_shape:
            expand += (m, 1)
        counts = counts * per_agent.reshape(expand)
        # renormalise so the histogram's total still reads as an agent
        # count (empty devices contribute nothing to the scale)
        if counts.sum() > 0:
            counts = counts * (total / counts.sum())
    cells = _assemble_global(geom, counts)
    bf = geom.box_factor
    boxed: Tuple[int, ...] = ()
    for b in geom.box_grid:
        boxed += (b, bf)
    return cells.reshape(boxed).sum(
        axis=tuple(range(1, 2 * nd, 2))).astype(np.float64)


def current_imbalance(geom: Domain, state: SimState,
                      runtimes: Optional[np.ndarray] = None,
                      comm=None) -> float:
    """``imbalance()`` of the live ownership (equal split or the Domain's
    uneven Partition)."""
    hist = occupancy_histogram(geom, state, runtimes, comm)
    return imbalance(realized_loads(geom, hist))


def estimate_device_runtimes(geom: Domain, state: SimState, wall_s: float,
                             comm=None) -> np.ndarray:
    """Split one measured step time into per-device runtimes by each
    device's share of the pair work: per cell, ``occupancy * (3^D
    neighbourhood occupancy)`` counts the pairs the sweep evaluates.  The
    3^D sum uses closed (zero-padded) edges, as the reference.  Returns a
    ``mesh_shape`` float array for ``Rebalancer.runtimes``."""
    nd = geom.ndim
    occ = owned_counts(geom, state, comm)
    cells = _assemble_global(geom, occ).astype(np.float64)
    padded = np.pad(cells, 1)
    nbhd = sum(
        padded[tuple(slice(1 + o, 1 + o + s)
                     for o, s in zip(off, cells.shape))]
        for off in itertools.product((-1, 0, 1), repeat=nd))
    work = _per_device_sums(geom, cells * nbhd)
    total = work.sum()
    if total <= 0:
        return np.full(geom.mesh_shape, float(wall_s) / geom.n_devices)
    return float(wall_s) * work / total


# ---------------------------------------------------------------------------
# 2. Planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """Outcome of one planning pass over the occupancy histogram."""

    mesh_shape: Tuple[int, ...]        # realizable equal-split target
    imbalance: float                   # planned imbalance of mesh_shape
    current: float                     # imbalance of the live partition
    rcb_bound: Optional[float]         # box-granular RCB imbalance
    diffusive_bound: Optional[float]   # 1-D diffusive-step imbalance
    partition: Optional[Partition] = None   # uneven plan, cuts in cells
    partition_imbalance: Optional[float] = None


def plan_reshard(hist: np.ndarray, geom: Domain,
                 n_devices: Optional[int] = None,
                 runtimes: Optional[np.ndarray] = None) -> ReshardPlan:
    """Run every applicable planner over a box histogram: the equal-split
    and the uneven rectilinear ``choose_partition`` plans, the
    ``plan_rcb`` bound (power-of-two counts), and on a chain mesh one
    ``plan_diffusive`` step (measured runtimes when given, else the column
    loads)."""
    mesh = geom.mesh_shape
    n = n_devices if n_devices is not None else geom.n_devices
    if geom.uneven:
        cur = imbalance(realized_loads(geom, hist))
    else:
        divisible = all(b % m == 0 for b, m in zip(hist.shape, mesh))
        cur = imbalance(equal_split_loads(hist, mesh)) if divisible \
            else float("inf")

    # Either planner alone may have no valid plan; only when both fail is
    # there nothing realizable to report.
    eq_err = None
    target = None
    planned = float("inf")
    try:
        eq_plan = choose_partition(hist, n, ownership="equal")
        target = eq_plan.mesh_shape
        planned = eq_plan.imbalance
    except ValueError as e:
        eq_err = e

    part_cells = None
    part_imb = None
    try:
        uneven_plan = choose_partition(hist, n, ownership="rcb")
        part_cells = uneven_plan.partition.scale(geom.box_factor)
        part_imb = uneven_plan.imbalance
    except ValueError:
        pass
    if eq_err is not None:
        if part_cells is None:
            raise eq_err
        if target is None:
            target = part_cells.mesh_shape

    rcb_bound = None
    if n & (n - 1) == 0:
        own = plan_rcb(hist, n)
        rcb_bound = imbalance(device_loads(own, hist, n))

    diff_bound = None
    is_chain = n > 1 and sum(m > 1 for m in mesh) == 1
    if (is_chain and n == geom.n_devices and not geom.uneven
            and cur != float("inf")):
        chain = int(np.argmax(mesh))
        d = mesh[chain]
        col_w = hist.sum(axis=tuple(a for a in range(hist.ndim)
                                    if a != chain))
        if col_w.size % d == 0:
            widths = np.full((d,), col_w.size // d, np.int64)
            loads0 = equal_split_loads(hist, mesh)
            rt = (np.asarray(runtimes, np.float64).ravel()
                  if runtimes is not None else loads0)
            new_w = plan_diffusive(widths, col_w, rt)
            own_1d = widths_to_ownership(new_w)
            loads = device_loads(own_1d[:, None], col_w[:, None], d)
            diff_bound = imbalance(loads)

    return ReshardPlan(mesh_shape=target, imbalance=planned, current=cur,
                       rcb_bound=rcb_bound, diffusive_bound=diff_bound,
                       partition=part_cells, partition_imbalance=part_imb)


# ---------------------------------------------------------------------------
# 3. Mass migration through the host: flatten -> re-init
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlatAgents:
    """Host-side flattened simulation state: the unit of mass migration
    and of the logical ABM checkpoint (``distributed.checkpoint``)."""

    positions: np.ndarray              # (N, ndim) float32
    attrs: Dict[str, np.ndarray]       # (N, ...) incl. gid_rank/gid_count
    it: int                            # iteration counter
    gid_counters: np.ndarray           # (old_n_ranks,) next spawn counter
    base_key: np.ndarray               # (2,) uint32 RNG lineage root
    dropped_total: int                 # cumulative overflow drops


def _live_slots(geom: Domain, state: SimState, comm=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The live owned slots of the comm's blocks, in the canonical
    interleaved order: ``(native, canon)`` int64 device tensors, the flat
    index of each slot in the state's own layout (``lead + local + (K,)``)
    and its index in the whole mesh's ``(c0, i0, c1, i1, ..., slot)``
    order."""
    nd = geom.ndim
    valid = state.soa.valid
    dev = valid.device
    own = _cell_mask(geom, dev, comm)
    native = torch.nonzero((valid & own[..., None]).reshape(-1)
                           ).squeeze(1)
    lead = tuple(valid.shape[:nd])
    local = geom.local_shape
    cap = geom.cap
    k = native % cap
    r = native // cap
    cell = [None] * nd
    for a in reversed(range(nd)):
        cell[a] = r % local[a] - 1
        r = r // local[a]
    if comm is None:
        coord = [None] * nd
        for a in reversed(range(nd)):
            coord[a] = r % lead[a]
            r = r // lead[a]
    else:
        coord = [torch.full_like(native, int(c)) for c in comm.coords()]
    canon = torch.zeros_like(native)
    for a in range(nd):
        canon = (canon * geom.mesh_shape[a] + coord[a]) * geom.interior[a] \
            + cell[a]
    canon = canon * cap + k
    canon, order = torch.sort(canon)
    return native[order], canon


def _flat_columns(state: SimState, native: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    nd = state.it.dim()
    return {n: a.reshape((-1,) + tuple(a.shape[2 * nd + 1:]))[native]
            for n, a in state.soa.attrs.items()}


def _root_key(state: SimState, comm=None) -> np.ndarray:
    """The RNG lineage root: device 0's key, as ``(2,)`` uint32."""
    nd = state.it.dim()
    if comm is None:
        return state.key[(0,) * nd].cpu().numpy().astype(np.uint32)
    mine = np.zeros(2, np.int64)
    if all(c == 0 for c in comm.coords()):
        mine[:] = state.key[(0,) * nd].cpu().numpy()
    return comm.sum_over_all_ranks(torch.from_numpy(mine)).numpy().astype(
        np.uint32)


def _mesh_counters(geom: Domain, state: SimState, comm=None) -> np.ndarray:
    """Every device's spawn counter, row-major over the mesh (int64)."""
    if comm is None:
        return state.gid_counter.cpu().numpy().astype(np.int64).ravel()
    full = np.zeros(geom.mesh_shape, np.int64)
    full[comm.coords()] = int(state.gid_counter.reshape(-1)[0])
    return comm.sum_over_all_ranks(torch.from_numpy(full)).numpy().ravel()


def _dropped_total(state: SimState, comm=None) -> int:
    total = state.dropped.sum().to(torch.int64).cpu()
    return int(total if comm is None else comm.sum_over_all_ranks(total))


def _gather_agents(canon: torch.Tensor, attrs: Dict[str, np.ndarray],
                   dst: Optional[int], comm
                   ) -> Optional[Dict[str, np.ndarray]]:
    """Every process's flat agents in the canonical order: on every rank
    of ``comm``'s group, or on its rank ``dst`` only (the others get
    None)."""
    import torch.distributed as dist

    mine = (canon.cpu().numpy(), attrs)
    world = dist.get_world_size(comm.group)
    if dst is None:
        parts = [None] * world
        dist.all_gather_object(parts, mine, group=comm.group)
    else:
        dst = comm.global_rank(dst)
        parts = [None] * world if dist.get_rank() == dst else None
        dist.gather_object(mine, parts, dst=dst, group=comm.group)
        if parts is None:
            return None
    order = np.argsort(np.concatenate([p[0] for p in parts]))
    return {n: np.concatenate([p[1][n] for p in parts])[order]
            for n in attrs}


def flatten_state(geom: Domain, state: SimState, comm=None,
                  dst: Optional[int] = None) -> Optional[FlatAgents]:
    """Gather every live agent (owned interior cells only: the aura ring
    and an uneven cut's padding hold copies or nothing) in the canonical
    interleaved order, plus the engine carry needed to re-initialise
    elsewhere.  On a process mesh (``comm``) each rank gives its own
    agents: every rank gets the whole mesh's, or only rank ``dst`` of the
    mesh's group when given (the others get None)."""
    native, canon = _live_slots(geom, state, comm)
    attrs = {n: a.cpu().numpy() for n, a in
             _flat_columns(state, native).items()}
    carry = dict(it=_global_it(state, comm),
                 gid_counters=_mesh_counters(geom, state, comm),
                 base_key=_root_key(state, comm),
                 dropped_total=_dropped_total(state, comm))
    if comm is not None:
        attrs = _gather_agents(canon, attrs, dst, comm)
        if attrs is None:
            return None
    positions = attrs.pop(POS)
    return FlatAgents(positions=positions, attrs=attrs, **carry)


def _add_dropped(state: SimState, total: int, comm=None) -> None:
    """Put the cumulative drop count on device 0, as the reference."""
    if not total:
        return
    nd = state.dropped.dim()
    if comm is None or all(c == 0 for c in comm.coords()):
        state.dropped[(0,) * nd] += total


def reshard_state(engine: Engine, state: SimState,
                  mesh_shape: Optional[Tuple[int, ...]] = None,
                  partition: Optional[Partition] = None,
                  transport: str = "auto", mesh=None
                  ) -> Tuple[Engine, SimState]:
    """Mass-migrate ``state`` onto a new device mesh: an equal split over
    ``mesh_shape``, or the uneven box-granular ``partition`` (cuts in
    cells; the per-device grids pad to the partition's largest slabs).

    Kept across the re-shard: global agent ids, the spawn counters' floors
    (future spawns never reuse an id), the iteration counter, the RNG
    lineage (new per-device keys split from the old root folded with the
    iteration) and the cumulative drop count.  Delta references restart
    at zero: run the next step with ``full_halo=True``.

    ``transport``: ``"host"`` flattens to the host and re-initialises;
    ``"device"`` re-bins on the devices (:func:`reshard_state_device`,
    an unchanged device count above 1); ``"auto"`` takes the device path
    whenever it is realizable.  With a process ``mesh`` every rank calls
    this alike; the new state's mesh is ``process_mesh(new mesh shape,
    mesh)``."""
    if (mesh_shape is None) == (partition is None):
        raise ValueError(
            "reshard_state takes exactly one of mesh_shape (equal split) "
            "or partition (uneven ownership)")
    if transport not in TRANSPORTS:
        raise ValueError(
            f"unknown transport {transport!r}; expected 'auto', 'host', "
            "or 'device'")
    n_new = math.prod(mesh_shape if mesh_shape is not None
                      else partition.mesh_shape)
    if transport == "device" or (
            transport == "auto" and n_new == engine.geom.n_devices
            and n_new > 1):
        # realizability is decided here, not by catching the device path's
        # errors: a real failure there (cell-capacity overflow) propagates
        return reshard_state_device(engine, state, mesh_shape=mesh_shape,
                                    partition=partition, mesh=mesh)
    comm = _comm_of(engine, mesh)
    flat = flatten_state(engine.geom, state, comm)
    new_engine, new_mesh = _new_engine(
        engine, _new_geom(engine.geom, mesh_shape, partition), mesh)
    new_state = new_engine.init_state(
        flat.positions, flat.attrs, gid_counters=flat.gid_counters,
        it0=flat.it, base_key=flat.base_key, mesh=new_mesh)
    _add_dropped(new_state, flat.dropped_total,
                 _comm_of(new_engine, new_mesh))
    return new_engine, new_state


def _new_geom(geom: Domain, mesh_shape, partition) -> Domain:
    if partition is not None:
        return geom.repartition(partition)
    return geom.with_mesh_shape(mesh_shape)


def _new_engine(engine: Engine, new_geom: Domain, mesh):
    """The engine on ``new_geom``, and its process mesh (or None)."""
    if mesh is not None and new_geom.n_devices != engine.geom.n_devices:
        raise ValueError(
            f"a process mesh keeps its {engine.geom.n_devices} processes; "
            f"{new_geom.n_devices} devices need a restore under a new "
            "process group")
    new_mesh = None if mesh is None \
        else process_mesh(new_geom.mesh_shape, mesh)
    return dataclasses.replace(engine, geom=new_geom), new_mesh


# ---------------------------------------------------------------------------
# 3b. Mass migration on the devices (no host round trip of the agents)
# ---------------------------------------------------------------------------

# Routing tables by (old geometry, new geometry, torch device): each
# device's origin and, on an uneven cut, the cut positions and owned
# widths, with the host path's float64 -> float32 rounding.
_ROUTES: Dict[Tuple, Dict[str, Any]] = {}


def _routing(old: Domain, new_geom: Domain, device) -> Dict[str, Any]:
    key = (old, new_geom, str(device))
    held = _ROUTES.get(key)
    if held is not None:
        return held
    nd = new_geom.ndim
    cs = float(new_geom.cell_size)
    part = new_geom.partition
    if part is None:
        lens = [i * cs for i in new_geom.interior]
        origins = [(np.arange(m, dtype=np.float64) * lens[a]
                    ).astype(np.float32)
                   for a, m in enumerate(new_geom.mesh_shape)]
        table = dict(lens=torch.tensor(np.asarray(lens, np.float32),
                                       device=device), cuts=None, owned=None)
    else:
        origins = [(np.asarray(part.cuts[a][:-1], np.float64) * cs
                    ).astype(np.float32) for a in range(nd)]
        table = dict(
            lens=None,
            cuts=[torch.tensor(part.cuts[a], dtype=torch.int64,
                               device=device) for a in range(nd)],
            owned=[torch.tensor(part.widths[a], dtype=torch.int64,
                                device=device) for a in range(nd)])
    table["origins"] = [torch.from_numpy(o).to(device) for o in origins]
    table["cs"] = torch.tensor(cs, dtype=torch.float32, device=device)
    if len(_ROUTES) >= 32:
        _ROUTES.pop(next(iter(_ROUTES)))
    _ROUTES[key] = table
    return table


def _route(new_geom: Domain, pos: torch.Tensor, table
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each agent's new device (row-major linear) and local cell (flat over
    ``local_shape``), by the arithmetic ``Engine.init_state`` and
    ``grid.cell_of`` run: equal-split floor division or a search of the
    partition cuts, then the local cell with the halo offset and the
    uneven clamp."""
    nd = new_geom.ndim
    mesh_to = new_geom.mesh_shape
    lshape = new_geom.local_shape
    cs = table["cs"]
    devlin = clocal = None
    for a in range(nd):
        x = pos[:, a]
        if table["cuts"] is None:
            d = torch.div(x, table["lens"][a], rounding_mode="floor").long()
        else:
            cell = torch.clamp(torch.div(x, cs, rounding_mode="floor").long(),
                               0, new_geom.global_cells[a] - 1)
            d = torch.searchsorted(table["cuts"][a], cell, right=True) - 1
        d = torch.clamp(d, 0, mesh_to[a] - 1)
        rel = (x - table["origins"][a][d]) / cs
        c = torch.floor(rel).to(torch.int32).long() + 1
        if table["owned"] is None:
            c = torch.clamp(c, 0, lshape[a] - 1)
        else:
            c = torch.minimum(torch.clamp(c, min=0), table["owned"][a][d] + 1)
        devlin = d if devlin is None else devlin * mesh_to[a] + d
        clocal = c if clocal is None else clocal * lshape[a] + c
    return devlin, clocal


def _to_all(send: Dict[str, torch.Tensor], dest: torch.Tensor,
            world: int, group=None) -> Dict[str, torch.Tensor]:
    """Move each row of the columns ``send`` to rank ``dest`` of the
    ``world`` ranks of ``group`` (None: the default group) with one
    ``all_to_all_single`` of one packed byte row an agent, its split sizes
    from an exchange of per-destination counts; a process receives its
    rows in source-rank order.  Through host memory (gloo)."""
    import torch.distributed as dist

    dev = dest.device
    order = torch.sort(dest, stable=True)[1]
    names = sorted(send)
    n = dest.shape[0]
    parts = []
    for name in names:
        v = send[name][order].contiguous()
        parts.append(v.reshape(n, math.prod(v.shape[1:])).view(torch.uint8))
    widths = [p.shape[1] for p in parts]
    packed = torch.cat(parts, dim=1).cpu()
    n_send = torch.bincount(dest, minlength=world).cpu()
    n_recv = torch.empty_like(n_send)
    dist.all_to_all_single(n_recv, n_send, group=group)
    out = torch.empty((int(n_recv.sum()), sum(widths)), dtype=torch.uint8)
    dist.all_to_all_single(out, packed, output_split_sizes=n_recv.tolist(),
                           input_split_sizes=n_send.tolist(), group=group)
    out = out.to(dev)
    got, off = {}, 0
    for name, w in zip(names, widths):
        v = send[name]
        got[name] = out[:, off:off + w].contiguous().view(v.dtype).reshape(
            (out.shape[0],) + tuple(v.shape[1:]))
        off += w
    return got


def reshard_state_device(engine: Engine, state: SimState,
                         mesh_shape: Optional[Tuple[int, ...]] = None,
                         partition: Optional[Partition] = None,
                         mesh=None) -> Tuple[Engine, SimState]:
    """The device transport of :func:`reshard_state`: ``flatten_state`` is
    never called and no agent crosses to the host on the virtual mesh (on
    a process mesh the packed rows go through gloo's host buffers).

    Each live owned slot, in the canonical interleaved order, is routed to
    its new device and local cell; one stable sort over (new device,
    local cell) gives each agent its slot, as the host path's per-device
    binning does, so the result is the host path's bit for bit.  On a
    process mesh each rank routes its own agents, moves them to their new
    processes with one ``all_to_all_single``, and orders what it receives
    by the same key and the canonical index: each block is the virtual
    mesh's.  Raises on a changed device count, on one device, and on
    cell-capacity overflow."""
    if (mesh_shape is None) == (partition is None):
        raise ValueError(
            "reshard_state_device takes exactly one of mesh_shape or "
            "partition")
    old = engine.geom
    new_geom = _new_geom(old, mesh_shape, partition)
    if new_geom.n_devices != old.n_devices:
        raise ValueError(
            f"device path needs an unchanged device count "
            f"({old.n_devices} -> {new_geom.n_devices}); use the host path")
    if new_geom.n_devices == 1:
        raise ValueError("single-device re-shard has no wire to avoid; "
                         "use the host path")
    new_engine, new_mesh = _new_engine(engine, new_geom, mesh)
    comm = _comm_of(engine, mesh)
    new_comm = _comm_of(new_engine, new_mesh)
    nd = new_geom.ndim
    cap = new_geom.cap
    dev = state.soa.valid.device
    n_local = math.prod(new_geom.local_shape)
    table = _routing(old, new_geom, dev)

    native, canon = _live_slots(old, state, comm)
    cols = _flat_columns(state, native)
    del native
    devlin, clocal = _route(new_geom, cols[POS], table)
    skey = devlin * n_local + clocal
    if comm is None:
        skey, order = torch.sort(skey, stable=True)
        cols = {n: v[order] for n, v in cols.items()}
        base = 0
    else:
        dest = new_comm.group_rank(
            torch.from_numpy(new_comm.ranks.reshape(-1)).to(dev)[devlin])
        got = _to_all(dict(cols, _key=skey, _canon=canon), dest,
                      old.n_devices, comm.group)
        # the virtual mesh's order: by key, ties in the canonical order
        order = torch.sort(got["_canon"])[1]
        skey, order2 = torch.sort(got["_key"][order], stable=True)
        order = order[order2]
        cols = {n: got[n][order] for n in cols}
        del got
        base = new_comm.linear_rank() * n_local    # this process's block
    del canon, devlin, clocal

    # rank of each agent within its (device, cell) run
    n = skey.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    is_start = torch.ones_like(skey, dtype=torch.bool)
    is_start[1:] = skey[1:] != skey[:-1]
    rank = idx - running_max(torch.where(is_start, idx, idx.new_tensor(-1)))
    over = (rank >= cap).sum()
    if new_comm is not None:
        over = new_comm.sum_over_all_ranks(over.cpu())
    if int(over) != 0:
        raise ValueError(
            f"cell capacity overflow during device re-shard: {int(over)} "
            "agents dropped; raise geom.cap")
    slot = (skey - base) * cap + rank
    lead = new_geom.mesh_shape if new_comm is None else (1,) * nd
    grid = lead + new_geom.local_shape + (cap,)
    total = math.prod(grid)
    attrs = {}
    for name, v in cols.items():
        tgt = torch.zeros((total,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=dev)
        tgt[slot] = v
        attrs[name] = tgt.reshape(grid + tuple(v.shape[1:]))
    valid = torch.zeros(total, dtype=torch.bool, device=dev)
    valid[slot] = True
    soa = AgentSoA(attrs=attrs, valid=valid.reshape(grid))

    # Engine carry: the spawn counters' floors (each rank past its largest
    # carried id and past the largest old counter), the iteration counter,
    # the RNG lineage and the drops on device 0.
    n_ranks = new_geom.n_devices
    g_rank = cols[GID_RANK].long()
    g_count = cols[GID_COUNT].long()
    ok = (g_rank >= 0) & (g_rank < n_ranks)
    counters = torch.zeros(n_ranks, dtype=torch.int64, device=dev)
    counters.scatter_reduce_(0, g_rank[ok], g_count[ok] + 1, "amax")
    if comm is not None:
        counters = comm.max_over_all_ranks(counters.cpu()).to(dev)
    floor = int(_mesh_counters(old, state, comm).max())
    counters = torch.clamp(counters, min=floor).to(torch.int32).reshape(
        new_geom.mesh_shape)
    it0 = _global_it(state, comm)
    root = prng.fold_in(torch.from_numpy(_root_key(state, comm)).to(dev), it0)
    keys = prng.split(root, n_ranks).reshape(new_geom.mesh_shape + (2,))
    dropped_total = _dropped_total(state, comm)
    blocks = new_comm or new_engine._comm()

    def scalar(v):
        return torch.full(lead, v, dtype=torch.int32, device=dev)

    new_state = SimState(
        soa=soa, refs=init_refs(new_geom, soa, lead=nd), it=scalar(it0),
        key=_pick(keys, blocks), gid_counter=_pick(counters, blocks),
        dropped=scalar(0),
        halo_bytes=scalar(0), codec_overflow=scalar(0),
        health=torch.zeros(lead + (NUM_GUARDS,), dtype=torch.int32,
                           device=dev))
    _add_dropped(new_state, dropped_total, new_comm)
    return new_engine, new_state


# ---------------------------------------------------------------------------
# 4. The runtime: cadence + threshold + trigger
# ---------------------------------------------------------------------------

def default_make_step(engine: Engine, mesh=None) -> Callable:
    """Step factory used after a re-shard: the engine's step on the
    virtual mesh, or of this process's device of a process ``mesh``."""
    return engine.make_local_step(mesh)


@dataclasses.dataclass
class Rebalancer:
    """Dynamic load balancing policy, evaluated inside the run loop.

    Every ``every`` iterations the occupancy histogram is taken; when the
    live partition's ``imbalance()`` exceeds ``threshold`` and the best
    realizable plan improves it by at least ``min_gain`` times, the state
    is re-sharded.  ``ownership``: ``"equal"`` (equal-split meshes) or
    ``"rcb"`` (box-granular rectilinear partitions on padded per-device
    grids).  ``transport``: :func:`reshard_state`'s.  ``defer=True``
    splits each check in two: at the due tick the device's count grid is
    copied to pinned host memory (``non_blocking``, behind a CUDA event)
    and the call returns; the histogram, threshold, plan and any
    migration run on the next tick against that one-step-old snapshot
    (the migration itself always moves the live state).  ``history``
    records every decision, applied and declined, with the reference's
    keys; ``engine`` is the engine of the latest state, and ``mesh`` its
    process mesh (None on the virtual mesh).
    """

    every: int = 10
    threshold: float = 0.5
    min_gain: float = 1.5
    ownership: str = "equal"
    transport: str = "auto"
    defer: bool = False
    make_step: Callable = default_make_step
    runtimes: Optional[np.ndarray] = None   # measured per-device times
    engine: Optional[Engine] = None
    mesh: Any = None
    history: List[dict] = dataclasses.field(default_factory=list)
    _pending: Optional[dict] = dataclasses.field(
        default=None, init=False, repr=False)

    def __post_init__(self):
        if self.ownership not in ("equal", "rcb"):
            raise ValueError(
                f"unknown ownership {self.ownership!r}; expected 'equal' "
                "or 'rcb'")
        if self.transport not in TRANSPORTS:
            raise ValueError(
                f"unknown transport {self.transport!r}; expected 'auto', "
                "'host', or 'device'")

    @property
    def pending(self) -> bool:
        """A deferred snapshot waits for its plan (lands next tick)."""
        return self._pending is not None

    def due(self, i: int) -> bool:
        if self._pending is not None:
            return True   # a deferred plan lands on the very next check
        return self.every > 0 and i % self.every == 0

    def maybe_reshard(self, engine: Engine, state: SimState
                      ) -> Tuple[Engine, SimState, bool]:
        self.engine = engine
        comm = _comm_of(engine, self.mesh)
        if (self.runtimes is not None
                and np.asarray(self.runtimes).shape != engine.geom.mesh_shape):
            self.runtimes = None  # measured on another mesh: stale
        snapshot = None
        if self.defer:
            if self._pending is None:
                # Phase 1: start the device-to-host copy of the count grid
                # and return; the next step runs on the old mesh meanwhile.
                counts = device_counts(engine.geom, state.soa.valid, comm)
                pinned = counts.is_cuda
                host = torch.empty(counts.shape, dtype=counts.dtype,
                                   pin_memory=pinned)
                host.copy_(counts, non_blocking=pinned)
                event = None
                if pinned:
                    event = torch.cuda.Event()
                    event.record()
                self._pending = {"counts": host, "event": event,
                                 "geom": engine.geom,
                                 "runtimes": self.runtimes}
                return engine, state, False
            pend, self._pending = self._pending, None
            if pend["geom"] == engine.geom:
                snapshot = pend   # else the geometry changed: replan
        if snapshot is not None:
            if snapshot["event"] is not None:
                snapshot["event"].synchronize()
            hist = histogram_from_counts(
                engine.geom,
                _counts_to_host(engine.geom, snapshot["counts"], comm),
                snapshot["runtimes"])
        else:
            hist = occupancy_histogram(engine.geom, state, self.runtimes,
                                       comm)
        mesh = engine.geom.mesh_shape
        # a box grid coarser than the mesh has no per-device load reading:
        # maximally imbalanced, and the planner looks for a factorization
        if engine.geom.uneven:
            cur = imbalance(realized_loads(engine.geom, hist))
        else:
            cur = (imbalance(equal_split_loads(hist, mesh))
                   if all(b % m == 0 for b, m in zip(hist.shape, mesh))
                   else float("inf"))
        it = state.it.max()
        if comm is not None:
            it = comm.max_over_all_ranks(it.cpu())
        record = {
            "it": int(it),
            "mesh_from": engine.geom.mesh_shape,
            "ownership": self.ownership,
            "imbalance_before": cur,
            "applied": False,
        }
        if snapshot is not None:
            record["deferred"] = True
        if cur <= self.threshold:
            self.history.append(record)
            return engine, state, False

        try:
            plan = plan_reshard(hist, engine.geom, runtimes=self.runtimes)
        except ValueError as e:
            record["declined"] = str(e)
            self.history.append(record)
            return engine, state, False
        record.update(
            mesh_to=plan.mesh_shape,
            imbalance_planned=plan.imbalance,
            rcb_bound=plan.rcb_bound,
            diffusive_bound=plan.diffusive_bound,
            partition_imbalance=plan.partition_imbalance,
        )
        uneven = self.ownership == "rcb" and plan.partition is not None
        if uneven:
            target_imb = plan.partition_imbalance
            new_geom = engine.geom.repartition(plan.partition)
            record.update(
                mesh_to=plan.partition.mesh_shape,
                partition_widths=plan.partition.widths,
                pad_fraction=plan.partition.pad_fraction(),
            )
            no_improvement = (new_geom == engine.geom
                              or cur < target_imb * self.min_gain)
        else:
            no_improvement = (
                plan.mesh_shape == engine.geom.mesh_shape
                and not engine.geom.uneven
            ) or cur < plan.imbalance * self.min_gain
        if no_improvement:
            self.history.append(record)
            return engine, state, False

        t0 = time.perf_counter()
        kw = dict(transport=self.transport, mesh=self.mesh)
        if uneven:
            new_engine, new_state = reshard_state(
                engine, state, partition=plan.partition, **kw)
        else:
            new_engine, new_state = reshard_state(
                engine, state, plan.mesh_shape, **kw)
        new_mesh = None if self.mesh is None \
            else process_mesh(new_engine.geom.mesh_shape, self.mesh)
        # rebalance plans keep the device count, so "auto" resolves to the
        # device transport on any mesh of several devices
        used = ("host" if self.transport == "host"
                or engine.geom.n_devices == 1 else "device")
        record.update(
            applied=True,
            transport=used,
            migration_s=time.perf_counter() - t0,
            imbalance_after=current_imbalance(
                new_engine.geom, new_state,
                comm=_comm_of(new_engine, new_mesh)),
        )
        self.history.append(record)
        self.engine = new_engine
        self.mesh = new_mesh
        # per-device times were measured on the old mesh
        self.runtimes = None
        return new_engine, new_state, True
