"""The simulation engine: one iteration = aura update -> neighbour
interaction -> agent update -> agent migration (port of
``repro/core/engine.py``, paper Figure 1).

The device mesh runs in one of two ways, chosen by the comm:

* virtual (no ``mesh``): all of it lives in one process on one card, as
  leading dims of every tensor (:class:`~repro_torch.core.halo.
  VirtualMeshComm`).  ``SimState.soa`` holds each device's block as
  ``mesh_shape + local_shape + (K, ...)``, so ``soa.attrs[n][c]`` is
  device ``c``'s contiguous ``(*local_grid, K, ...)`` block, the layout
  the kernels read; every per-device quantity carries the same leading
  mesh dims, as in the reference.  A single device is the all-ones mesh.
* one process a device (``mesh=``, a ``DeviceMesh`` from
  :func:`repro_torch.launch.mesh.make_abm_mesh`): each process holds its
  own device's block with ``ndim`` leading dims of size 1, the layout
  the reference's ``shard_map`` body sees, and the exchanges cross
  between processes (:class:`~repro_torch.core.halo.ProcessMeshComm`).
  Host reads that steer control flow (:func:`total_agents`,
  :func:`codec_overflow_count`) are all-reduces there, so every rank
  takes the same branch.

``repro_torch.bridge`` converts to and from the reference's
block-concatenated global layout, and assembles a process mesh's blocks.

One step runs the two exchanges (aura and migration) over the comm's
devices - per directed edge the slabs of every device are taken, encoded
in one kernel launch per float attribute, shifted, decoded and put - and
the per-device parts (sweep, update, spawn, clamp, binning) as a Python
loop over the comm's blocks (:meth:`~repro_torch.core.halo.Comm.blocks`:
every device of the virtual mesh, a process's own).  The segment runner
is a plain Python loop over :meth:`Engine.local_step` (CUDA-graph capture
is later work).

Uneven partitions run as in the reference: each device's owned widths
(host ints; a rectilinear cut varies them along one mesh axis each) mask
the aura rebuild (``mask_unowned``), the update's residents and the
binning clamp, and place each device's high faces and migration ring at
its owned extent.  ``overlap="on"`` runs the interior/boundary split of
the sweep (``sweep_accumulate_overlapped``).  :meth:`Engine.drive` runs
the dynamic load balancer (``core.reshard``): a re-shard re-enters
:meth:`Engine.init_state`'s carry (gid columns, spawn-counter floors, the
iteration and the RNG lineage), or moves the agents on the devices.
With ``guards`` enabled (a :class:`~repro_torch.core.guards.GuardConfig`)
the step adds the runtime health guards to ``SimState.health``: residency
at step entry, NaN/Inf right after the aura exchange, conservation after
migration (a sum over the virtual mesh's devices, one all-reduce on a
process mesh); :meth:`Engine.drive` reads them at its control points and
fires a fault plan's faults (``distributed.chaos``) at theirs.

RNG: the reference's ``jax.random`` lineage, bit for bit
(:mod:`repro_torch.core.prng`).  :meth:`Engine.init_state` splits
``PRNGKey(seed)`` (or ``fold_in(base_key, it0)``) into one key a device,
in row-major rank order (a process keeps its own row), and each device's
update draws from
``fold_in(fold_in(key, it), rank)``.  Spawned children go after the
interior agents into re-binning, with ``gid_rank`` the device's rank and
``gid_count`` counting on from the device's ``gid_counter``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.agent_soa import (
    AgentSoA,
    GID_COUNT,
    GID_RANK,
    POS,
    flat_view,
    numpy_dtype,
)
from repro_torch.core.behaviors import Behavior
from repro_torch.core.delta import (
    DeltaConfig, Slab, decode_migration, encode_migration,
)
from repro_torch.core.domain import Domain
from repro_torch.core.grid import (
    bin_agents, clear_ring, interior_mask, mask_unowned, mesh_owned_mask,
    set_plane, take_plane,
)
from repro_torch.core.halo import (
    Comm, ProcessMeshComm, VirtualMeshComm, halo_exchange, init_refs,
    take_slab,
)
from repro_torch.core.neighbors import (
    sweep_accumulate, sweep_accumulate_overlapped,
)
from repro_torch.core.guards import (
    GUARD_CONSERVATION, GUARD_DOMAIN, GUARD_NAN, GUARD_SLAB, NUM_GUARDS,
    GuardConfig, as_guard_config, check_health, health_counts, nan_count,
    residency_counts,
)
from repro_torch.device import resolve_device


def _jnp_mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.mod`` for floats: C ``fmod``, moved into the divisor's sign."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


@dataclasses.dataclass
class SimState:
    # Leading dims "mesh": mesh_shape on the virtual mesh, all ones on a
    # process of a process mesh.
    soa: AgentSoA                   # mesh + (*local grid, K, ...)
    refs: Dict[str, Slab]           # mesh + slab shape
    it: torch.Tensor                # mesh int32
    key: torch.Tensor               # mesh + (2,) uint32
    gid_counter: torch.Tensor       # mesh int32
    dropped: torch.Tensor           # mesh int32 cumulative overflow drops
    halo_bytes: torch.Tensor        # mesh int32 wire bytes of last aura
    codec_overflow: torch.Tensor    # mesh int32 cumulative clipped deltas
    health: torch.Tensor            # mesh + (NUM_GUARDS,) int32


def device_block(soa: AgentSoA, coords: Tuple[int, ...]) -> AgentSoA:
    """Device ``coords``' block of a mesh-layout SoA (contiguous views)."""
    return AgentSoA(attrs={n: a[coords] for n, a in soa.attrs.items()},
                    valid=soa.valid[coords])


def _pick(t: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The comm's blocks of a mesh-shaped tensor (``mesh_shape + rest``):
    all of it on the virtual mesh; on a process its own device's entry,
    behind all-ones leading dims."""
    if tuple(t.shape[:comm.lead]) == comm.lead_shape:
        return t
    ((_, g),) = comm.blocks()
    return t[g].reshape(comm.lead_shape + tuple(t.shape[comm.lead:]))


class _MeshSoA:
    """Assembles per-device blocks into a mesh-layout SoA.  A one-device
    mesh takes its block as a view (no copy); otherwise the mesh tensors
    are allocated at the first block and each block is copied in, so the
    caller can free it right away."""

    def __init__(self, mesh_shape: Tuple[int, ...]):
        self.mesh = tuple(mesh_shape)
        self.soa = None

    def put(self, coords: Tuple[int, ...], blk: AgentSoA) -> None:
        if math.prod(self.mesh) == 1:
            lead = (1,) * len(self.mesh)
            self.soa = AgentSoA(
                attrs={n: a.reshape(lead + a.shape)
                       for n, a in blk.attrs.items()},
                valid=blk.valid.reshape(lead + blk.valid.shape))
            return
        if self.soa is None:
            def alloc(a):
                return torch.empty(self.mesh + tuple(a.shape),
                                   dtype=a.dtype, device=a.device)
            self.soa = AgentSoA(
                attrs={n: alloc(a) for n, a in blk.attrs.items()},
                valid=alloc(blk.valid))
        for n, a in blk.attrs.items():
            self.soa.attrs[n][coords].copy_(a)
        self.soa.valid[coords].copy_(blk.valid)


@dataclasses.dataclass(frozen=True)
class _Frame:
    """The geometry's per-device constants on one torch device: each
    device's owned region (``origins`` and ``ends`` in world space,
    ``widths`` in cells, each ``mesh_shape + (ndim,)``) and, on an uneven
    cut, its owned cells (``owned``, ``mesh_shape + local_shape``; None on
    an equal split).  ``own_cells`` is ``owned``, or on an equal split the
    ``local_shape`` interior."""
    origins: torch.Tensor
    ends: torch.Tensor
    widths: torch.Tensor
    owned: Optional[torch.Tensor]
    own_cells: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Engine:
    """The step's configuration.  It compares and hashes by its fields, as
    the reference's frozen ``Engine``: two engines of one configuration
    are one cache key (``hash(engine) == hash(dataclasses.replace(
    engine))``, the step audit's ``cache-key`` contract); the behaviour
    compares by identity.  The per-instance caches below take no part."""

    geom: Domain
    behavior: Behavior
    delta_cfg: DeltaConfig = DeltaConfig(enabled=False)
    dt: float = 1.0
    # Dynamic load balancing (paper section 2.4.5, core.reshard): with
    # rebalance_every > 0, Engine.drive checks the occupancy imbalance at
    # that cadence and re-shards past imbalance_threshold.
    rebalance_every: int = 0
    imbalance_threshold: float = 0.5
    # "auto" resolves per SoA device: the CUDA kernel on the card, the
    # tiled sweep on the CPU; "reference" | "tiled" | "kernel" force one.
    sweep_backend: str = "auto"
    # Communication hiding needs a wire: on the virtual mesh there is none
    # to hide, so "auto" and "off" run the monolithic sweep; "on" runs the
    # interior/boundary split (1 + 2 * ndim sweeps a device), bit-equal to
    # it at every owned cell.
    overlap: str = "auto"
    # Runtime health guards (core.guards): a GuardConfig, a policy string
    # or None.  "off" (the default) computes none of them: the step then
    # launches exactly what an unguarded step launches.
    guards: Any = GuardConfig()
    device: Any = "cuda"
    # _frame's constants, built once per torch device and comm's blocks
    _frames: Dict[Any, _Frame] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False,
        hash=False)
    # _comm's process comms by mesh (their edge buffers live across steps)
    _comms: Dict[int, Tuple[Any, ProcessMeshComm]] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False,
        hash=False)

    def __post_init__(self):
        if self.overlap not in ("auto", "on", "off"):
            raise ValueError(
                f"overlap={self.overlap!r}; expected 'auto', 'on' or 'off'")
        object.__setattr__(self, "guards", as_guard_config(self.guards))
        object.__setattr__(self, "device", resolve_device(self.device))

    # ------------------------------------------------------------------
    # Initialization (host side, numpy-friendly)
    # ------------------------------------------------------------------
    def init_state(self, positions: np.ndarray,
                   attrs: Dict[str, np.ndarray], seed: int = 0, *,
                   gid_counters=None, it0: int = 0, base_key=None,
                   mesh=None) -> SimState:
        """Create every agent directly on the device whose block holds it
        (paper section 2.4.4): per-device blocks, ``gid_rank`` = the
        device's linear rank, ``gid_count`` counting from 0 on each device.

        The re-shard and restore paths (``core.reshard``,
        ``distributed.elastic``) re-enter here with the carry: ``attrs``
        holding ``gid_rank``/``gid_count`` columns keeps them as they are,
        and each rank's spawn counter resumes past the largest carried id
        of that rank and past the largest of the ``gid_counters`` floors
        (a floor without carried columns raises: fresh ids would collide
        with the ids it protects).  The per-device RNG keys are
        ``split(PRNGKey(seed), n_devices)``, or split from
        ``fold_in(base_key, it0)`` when a ``(2,)`` uint32 ``base_key`` is
        given; ``it0`` starts the iteration counter.

        With a process ``mesh`` every rank takes the same full
        ``positions`` and keeps its own device's agents, its key the row
        of its linear rank: its block is bit for bit the virtual mesh's
        block of that device.
        """
        geom = self.geom
        nd = geom.ndim
        mesh_shape = geom.mesh_shape
        comm = self._comm(mesh)
        lead_shape = comm.lead_shape
        dev = self.device
        schema = self.behavior.schema

        positions = np.asarray(positions)
        if positions.ndim != 2 or positions.shape[1] != nd:
            raise ValueError(
                f"positions have shape {positions.shape}; a {nd}-D domain "
                f"needs (N, {nd})")
        gsz = geom.domain_size
        if (positions < 0).any() or any(
                (positions[:, a] >= gsz[a]).any() for a in range(nd)):
            raise ValueError(
                f"initial positions outside the domain "
                f"{'x'.join(f'[0,{g})' for g in gsz)} - out-of-domain "
                "agents would land in the halo ring and be destroyed by "
                "the first aura rebuild")
        carried = GID_RANK in attrs and GID_COUNT in attrs
        if gid_counters is not None and not carried:
            raise ValueError(
                "gid_counters floors require carried gid_rank/gid_count "
                "columns in attrs - fresh ids would start at 0 and collide "
                "with the historical ids the floors protect")
        counters_next = np.zeros((geom.n_devices,), dtype=np.int64)
        if carried:
            g_rank = np.asarray(attrs[GID_RANK], np.int64)
            g_count = np.asarray(attrs[GID_COUNT], np.int64)
            in_range = (g_rank >= 0) & (g_rank < geom.n_devices)
            np.maximum.at(counters_next, g_rank[in_range],
                          g_count[in_range] + 1)
        if gid_counters is not None:
            floors = np.asarray(gid_counters, np.int64).ravel()
            if floors.size:
                # a counter exceeds every id its rank ever issued, so the
                # largest floor bounds them all: applied to every new rank
                # it keeps ids unique across any change of mesh
                counters_next = np.maximum(counters_next, floors.max())

        part = geom.partition
        if part is None:
            lens = [i * geom.cell_size for i in geom.interior]
            owner = [np.clip((positions[:, a] // lens[a]).astype(np.int64),
                             0, mesh_shape[a] - 1) for a in range(nd)]
        else:
            # each agent goes to the device whose cut slab holds its global
            # cell along every axis
            cell = [np.clip((positions[:, a] // geom.cell_size).astype(
                np.int64), 0, geom.global_cells[a] - 1) for a in range(nd)]
            owner = [np.clip(np.searchsorted(np.asarray(part.cuts[a]),
                                             cell[a], side="right") - 1,
                             0, mesh_shape[a] - 1) for a in range(nd)]
        blocks = _MeshSoA(lead_shape)
        counters = np.zeros(lead_shape, dtype=np.int32)
        for c, coords in comm.blocks():
            sel = np.ones(positions.shape[0], dtype=bool)
            for a in range(nd):
                sel &= owner[a] == coords[a]
            sel = np.flatnonzero(sel)
            n = sel.size
            lin = int(np.ravel_multi_index(coords, mesh_shape))
            flat: Dict[str, torch.Tensor] = {}
            for name, (shape, dtype) in schema.all_specs(nd).items():
                if name == POS:
                    a = positions[sel].astype(np.float32)
                elif name == GID_RANK and not carried:
                    a = np.full((n,), lin, dtype=np.int32)
                elif name == GID_COUNT and not carried:
                    a = np.arange(n, dtype=np.int32)
                else:
                    a = np.asarray(attrs[name], dtype=numpy_dtype(dtype))[sel]
                flat[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            valid = torch.ones((n,), dtype=torch.bool, device=dev)
            soa, dropped = bin_agents(geom, flat, valid,
                                      geom.device_origin(coords, dev),
                                      geom.owned_widths(coords))
            if int(dropped) != 0:
                raise ValueError(
                    f"cell capacity overflow at init on device {coords}: "
                    f"{int(dropped)} agents dropped; raise geom.cap")
            counters[c] = max(counters_next[lin], 0 if carried else n)
            blocks.put(c, soa)

        def scalar(v):
            return torch.full(lead_shape, v, dtype=torch.int32, device=dev)

        if base_key is not None:
            base = torch.from_numpy(np.array(base_key, np.uint32))
            root = prng.fold_in(base.to(dev), int(it0))
        else:
            root = prng.PRNGKey(seed, device=dev)
        keys = _pick(prng.split(root, geom.n_devices).reshape(
            mesh_shape + (2,)), comm)

        return SimState(
            soa=blocks.soa,
            refs=init_refs(geom, blocks.soa, lead=nd),
            it=scalar(it0),
            key=keys,
            gid_counter=torch.from_numpy(counters).to(dev),
            dropped=scalar(0),
            halo_bytes=scalar(0),
            codec_overflow=scalar(0),
            health=torch.zeros(lead_shape + (NUM_GUARDS,),
                               dtype=torch.int32, device=dev),
        )

    def _frame(self, dev: torch.device, comm: Comm) -> _Frame:
        """The geometry's per-device constants of ``comm``'s blocks on
        ``dev`` (built at the first call)."""
        key = (dev, comm.blocks())
        frame = self._frames.get(key)
        if frame is None:
            geom = self.geom
            mesh = geom.mesh_shape
            widths = [[geom.axis_widths[a][c[a]] for a in range(geom.ndim)]
                      for c in np.ndindex(*mesh)]
            owned = _pick(mesh_owned_mask(geom, dev), comm) \
                if geom.uneven else None
            frame = _Frame(
                origins=_pick(geom.device_origins(dev), comm),
                ends=_pick(geom.device_ends(dev), comm),
                widths=_pick(torch.tensor(
                    widths, dtype=torch.int32, device=dev).reshape(
                        mesh + (geom.ndim,)), comm),
                owned=owned,
                own_cells=owned if owned is not None else torch.from_numpy(
                    interior_mask(geom)).to(dev))
            self._frames[key] = frame
        return frame

    def _owned(self, comm: Comm) -> Tuple[Tuple[int, ...], ...]:
        """Per axis, the owned widths of the comm's devices along its mesh
        axis, one int a device: ``Domain.axis_widths`` on the virtual
        mesh, a one-element tuple of its own width on a process (whose
        leading dims are all ones)."""
        if comm.lead_shape == self.geom.mesh_shape:
            return self.geom.axis_widths
        ((_, g),) = comm.blocks()
        return tuple((w[c],) for w, c in zip(self.geom.axis_widths, g))

    # ------------------------------------------------------------------
    # One iteration
    # ------------------------------------------------------------------
    def _sweep(self, coords: Tuple[int, ...], blk: AgentSoA,
               pre: AgentSoA = None) -> Dict[str, torch.Tensor]:
        """2. Local interaction of one device's block (its aura filled):
        the backend-dispatched sweep of the behaviour's pair law; with
        ``overlap="on"`` the interior pass over ``pre`` (the block before
        the exchange) and the faces over ``blk``."""
        beh = self.behavior
        if self.overlap == "on":
            return sweep_accumulate_overlapped(
                self.geom, pre, blk, beh.pair_fn, beh.pair_attrs,
                beh.radius, beh.params, backend=self.sweep_backend,
                owned=self.geom.owned_widths(coords))
        return sweep_accumulate(
            self.geom, blk, beh.pair_fn, beh.pair_attrs, beh.radius,
            beh.params, backend=self.sweep_backend)

    def _device_finish(self, blk: AgentSoA, acc: Dict[str, torch.Tensor],
                       origin: torch.Tensor, key: torch.Tensor, lrank: int,
                       gidc: torch.Tensor, owned=None,
                       own: torch.Tensor = None, count: bool = False):
        """Pointwise update, spawn, clamp and re-binning of one device's
        block (its aura filled) from its sweep's accumulators ``acc``, with
        the step key ``key``, rank ``lrank``, spawn counter ``gidc``, owned
        widths ``owned`` and owned cells ``own`` (a ``local_shape`` mask;
        both None on an equal split).  Returns the binned block, the agents
        dropped for cell overflow, the advanced counter and, with
        ``count``, the live agents that entered the binning (spawns
        included; else None): the conservation guard's count."""
        geom = self.geom
        beh = self.behavior
        nd = geom.ndim
        tor = geom.toroidal
        dev = blk.valid.device

        # 3. Pointwise update on interior agents.
        isl = tuple(slice(1, h - 1) for h in geom.local_shape)
        int_attrs = {n: a[isl] for n, a in blk.attrs.items()}
        int_valid = blk.valid[isl]
        if own is not None:
            # the padded interior holds this device's aura ring at
            # owned[a] + 1: neighbour copies, not residents
            int_valid = int_valid & own[isl][..., None]
        new_attrs, alive, spawn, child_attrs = beh.update_fn(
            int_attrs, int_valid, acc, key, beh.params, self.dt)
        new_valid = int_valid & alive

        # Per-axis boundary condition on positions: closed axes clamp to
        # [eps, L - eps] (eps in float64, bounds rounded to float32, as the
        # reference); toroidal axes wrap inside the migration exchange.
        if not all(tor):
            eps = 1e-4 * geom.cell_size
            lo = np.asarray([-np.inf if t else eps for t in tor], np.float32)
            hi = np.asarray(
                [np.inf if t else L - eps
                 for t, L in zip(tor, geom.domain_size)], np.float32)
            new_attrs[POS] = torch.clamp(
                new_attrs[POS], min=torch.from_numpy(lo).to(dev),
                max=torch.from_numpy(hi).to(dev))

        # 4. Flatten the interior (+ children) for re-binning.  Children
        # go after the interior; their ids count on from the device's
        # counter in slot order.
        n_int = math.prod(geom.interior) * geom.cap

        def flatten(attrs):
            return {n: a.reshape((n_int,) + tuple(a.shape[nd + 1:]))
                    for n, a in attrs.items()}

        flat = flatten(new_attrs)
        fvalid = new_valid.reshape((n_int,))
        if beh.can_spawn:
            sflat = spawn.reshape((n_int,)) & fvalid
            child = flatten(child_attrs)
            order = torch.cumsum(sflat, dim=0, dtype=torch.int32) - 1
            child[GID_RANK] = torch.full((n_int,), lrank, dtype=torch.int32,
                                         device=dev)
            child[GID_COUNT] = gidc + order
            gidc = gidc + sflat.sum(dtype=torch.int32)
            flat = {n: torch.cat([flat[n], child[n]]) for n in flat}
            fvalid = torch.cat([fvalid, sflat])
        n_in = fvalid.sum(dtype=torch.int32) if count else None
        soa, dropped = bin_agents(geom, flat, fvalid, origin, owned)
        return soa, dropped, gidc, n_in

    def step_keys(self, state: SimState, n: int = 1,
                  comm: Comm = None) -> torch.Tensor:
        """The step key of each of ``comm``'s devices (default: every
        device of the virtual mesh) for the ``n`` iterations from
        ``state.it`` on, ``(n, *lead, 2)``: ``fold_in(fold_in(key, it),
        rank)`` as two batched hashes on the device."""
        if comm is None:
            comm = self._comm()
        dev = state.key.device
        mesh = self.geom.mesh_shape
        its = state.it + torch.arange(n, dtype=torch.int32, device=dev
                                      ).reshape((n,) + (1,) * len(mesh))
        ranks = _pick(torch.arange(self.geom.n_devices, dtype=torch.int32,
                                   device=dev).reshape(mesh), comm)
        return prng.fold_in(prng.fold_in(state.key, its), ranks)

    def local_step(self, state: SimState, comm: Comm, full_halo: bool,
                   step_keys: torch.Tensor = None) -> SimState:
        """One iteration of the comm's devices (the engine's
        :class:`VirtualMeshComm`: every device of the mesh; a
        :class:`ProcessMeshComm`: this process's), with their step keys
        ``step_keys`` (``(*lead, 2)``; derived here when not given).  The
        ensemble runner (``core.ensemble``) runs the same two halves,
        :meth:`_aura` and :meth:`_advance`, with its lanes' sweep in
        between."""
        aura = self._aura(state, comm, full_halo)
        return self._advance(state, aura, comm, step_keys, self._sweep)

    def _aura(self, state: SimState, comm: Comm, full_halo: bool,
              out: AgentSoA = None):
        """1. Aura update (rebuilt from scratch each iteration, section
        2.2.1), into ``out``'s tensors when given.  Returns
        :func:`~repro_torch.core.halo.halo_exchange`'s four results, the
        SoA before the exchange (its ring and padding invalidated: the
        overlapped sweep's interior pass reads it) and, with the guards
        on, this step's guard counts so far (``lead + (NUM_GUARDS,)``:
        residency at entry, NaN/Inf of the exchanged SoA, its received
        ring included; else None) as a list, which :meth:`_advance`
        empties."""
        geom = self.geom
        nd = geom.ndim
        if comm.lead != nd:
            raise ValueError(
                f"local_step needs a comm with {nd} leading mesh dims "
                f"(a VirtualMeshComm or ProcessMeshComm); got "
                f"lead={comm.lead}")
        gcfg = self.guards
        frame = self._frame(state.soa.valid.device, comm)
        g = None
        if gcfg.enabled:
            # residency is read at step entry: the previous migration has
            # settled, so an owned agent off its slab is corruption
            g = torch.zeros(comm.lead_shape + (NUM_GUARDS,),
                            dtype=torch.int32, device=frame.origins.device)
            if gcfg.domain or gcfg.slab:
                dom_bad, slab_bad = residency_counts(
                    geom, state.soa, frame.origins, frame.widths,
                    frame.own_cells, comm.lead)
                if gcfg.domain:
                    g[..., GUARD_DOMAIN] += dom_bad
                if gcfg.slab:
                    g[..., GUARD_SLAB] += slab_bad
        if geom.uneven:
            pre = mask_unowned(state.soa, geom, lead=comm.lead,
                               mask=frame.owned)
            owned = self._owned(comm)
        else:
            pre = clear_ring(state.soa, comm.lead)
            owned = None
        aura = list(halo_exchange(
            geom, pre, comm, state.refs, self.delta_cfg, full_halo, out=out,
            owned=owned))
        if gcfg.enabled and gcfg.nan:
            # right after the exchange, before any sweep (the overlapped
            # sweep's boundary pass included) reads the received ring
            g[..., GUARD_NAN] += nan_count(aura[0], comm.lead)
        return aura + [pre if self.overlap == "on" else None, g]

    def _advance(self, state: SimState, aura: list, comm: Comm,
                 step_keys: torch.Tensor, sweep) -> SimState:
        """2.-5. of an iteration from ``aura`` (:meth:`_aura`'s list):
        per device ``sweep(coords, block, pre)`` (the accumulators of the
        aura-filled block of the device at mesh coordinates ``coords``;
        ``pre`` is its block before the exchange, or None), the update
        drawing from the device's step key, spawn, clamp and re-binning;
        then migration."""
        geom = self.geom
        mesh = geom.mesh_shape
        lead_shape = comm.lead_shape
        soa, refs, hbytes, oflow, pre, g = aura
        aura.clear()   # the caller's reference: the SoA dies below
        dev = state.soa.valid.device
        frame = self._frame(dev, comm)
        lsz = torch.tensor(geom.domain_size, dtype=torch.float32, device=dev)
        coflow = state.codec_overflow + oflow

        # 2.-4. Per device: sweep, update (drawing from the device's step
        # key), spawn, clamp, re-bin.
        binned = _MeshSoA(lead_shape)
        drops: List[torch.Tensor] = []
        gidcs: List[torch.Tensor] = []
        entered: List[torch.Tensor] = []   # the conservation guard's
        cons = g is not None and self.guards.conservation
        if step_keys is None:
            step_keys = self.step_keys(state, comm=comm)[0]
        for c, gc in comm.blocks():
            lrank = int(np.ravel_multi_index(gc, mesh))
            blk = device_block(soa, c)
            acc = sweep(gc, blk,
                        None if pre is None else device_block(pre, c))
            blk, d1, gidc, n_in = self._device_finish(
                blk, acc, frame.origins[c], step_keys[c], lrank,
                state.gid_counter[c], geom.owned_widths(gc),
                None if frame.owned is None else frame.owned[c], cons)
            del acc
            binned.put(c, blk)
            drops.append(d1)
            gidcs.append(gidc)
            entered.append(n_in)
            del blk
        del soa, pre   # the aura-filled SoA is dead: free it before migrating
        dropped = state.dropped + torch.stack(drops).reshape(lead_shape)

        # 5. Agent migration: dimension-ordered ring exchange over all axes.
        soa3, d2, moflow = self._migrate(binned.soa, comm, frame, lsz)

        health = state.health
        if g is not None:
            if cons:
                # the global ledger balances up to this step's drops: one
                # sum over the virtual mesh's devices, one all-reduce
                # over a process mesh's ranks
                post = (soa3.valid & frame.own_cells[..., None]).sum(
                    dtype=torch.int32)
                lost = (dropped - state.dropped + d2).sum(dtype=torch.int32)
                ledger = torch.stack([
                    torch.stack(entered).sum(dtype=torch.int32), post, lost])
                if isinstance(comm, ProcessMeshComm):
                    ledger = comm.sum_over_all_ranks(ledger)
                g[..., GUARD_CONSERVATION] += (
                    ledger[0] - ledger[1] - ledger[2]).abs()
            health = health + g

        return SimState(
            soa=soa3,
            refs=refs,
            it=state.it + 1,
            key=state.key,
            gid_counter=torch.stack(gidcs).reshape(lead_shape),
            dropped=dropped + d2,
            halo_bytes=torch.full(lead_shape, hbytes, dtype=torch.int32,
                                  device=dev),
            codec_overflow=coflow + moflow,
            health=health,
        )

    def _migrate(self, soa: AgentSoA, comm: Comm, frame: _Frame,
                 lsz: torch.Tensor
                 ) -> Tuple[AgentSoA, torch.Tensor, torch.Tensor]:
        """Dimension-ordered emigrant routing with one-pass re-binning,
        mesh-wide.

        Axis-0 faces (incl. corner cells) are exchanged first; each later
        axis's payload widens with the ring cells of every previously
        received slab, carrying diagonal migrants forward, and everything
        (the face-cleared grid and all ``2 * ndim`` receives) re-bins in a
        single sort pass per device, as in the reference.

        With ``delta_cfg.migration`` set (and the codec enabled) emigrant
        positions cross as int16 offsets from the sender's box centre
        (:func:`~repro_torch.core.delta.encode_migration`), one kernel
        launch each way per hop for every device at once; the codec's
        minimum image and the receiver's ``mod L`` with the seam repair
        (``at_l``, in the decode's launch) take the place of
        ``wrap_pos``.  Returns ``(soa, dropped, codec overflow)``, the last
        two shaped like the mesh.

        Under uneven ownership the migration ring along axis ``a`` sits at
        each device's owned extent ``owned[a] + 1`` (one index a device
        along mesh axis ``a``), both for the emigrant faces taken here and
        for the forwarded ring cells of pending slabs (a slab received
        along another axis came from a device with the same coordinate
        along ``a``).  A forwarded block's embedding coordinate in a
        widened payload only places it (the final pass re-bins by
        position), so it stays at 1 or ``h - 2``.
        """
        geom = self.geom
        nd = geom.ndim
        mesh = geom.mesh_shape
        lead_shape = comm.lead_shape
        shape = geom.local_shape
        tor = geom.toroidal
        lead = comm.lead
        cfg = self.delta_cfg
        mig_q = cfg.migration if cfg.enabled else None
        dev = soa.valid.device
        moflow = torch.zeros(lead_shape, dtype=torch.int32, device=dev)
        lsz_np = np.asarray(geom.domain_size, np.float32)
        if mig_q is not None:
            # Static quantization frame: box centre at origin + half the
            # padded extent, range covering that extent plus two cells of
            # ring/rounding slack on each side.
            half_ext = np.asarray(
                [(s - 2) * geom.cell_size / 2.0 for s in shape], np.float32)
            half_rng = half_ext + 2.0 * np.float32(geom.cell_size)
            center = frame.origins + torch.from_numpy(half_ext).to(dev)

        # The per-axis mask, for mixed boundaries only (one host copy).
        tor_t = torch.tensor(tor, device=dev) \
            if any(tor) and not all(tor) else None

        # Where a wrapped position is exactly L (see seam): 0 on an axis of
        # one device; on an axis of several, the largest float32 below L.
        # Only a step down across 0 rounds to L, and it ships the agent to
        # the last device along the axis, which owns [L - L/M, L) and not 0.
        at_l_np = np.asarray(
            [0.0 if m == 1 else np.nextafter(np.float32(n), np.float32(0))
             for m, n in zip(mesh, lsz_np)], np.float32)
        at_l_pos = torch.from_numpy(at_l_np).to(dev)

        def seam(slab: Slab) -> Slab:
            """Wrapped (``mod L``) positions lie in [0, L], not [0, L): one
            within half an ulp of L below 0 rounds to exactly L, which bins
            into the halo ring, and the next aura rebuild would destroy
            the agent uncounted - as the reference does (ROADMAP C).  Such
            a position is put at its nearest point of [0, L) on the device
            that received it (``at_l_pos``)."""
            if not any(tor):
                return slab
            p = slab[POS]
            at_l = p == lsz
            if tor_t is not None:
                at_l &= tor_t
            return {**slab, POS: torch.where(at_l, at_l_pos, p)}

        def wrap_pos(slab: Slab) -> Slab:
            if not any(tor):
                return slab
            out = dict(slab)
            p = slab[POS]
            wrapped = _jnp_mod(p, lsz)
            out[POS] = wrapped if all(tor) else torch.where(tor_t, wrapped, p)
            return seam(out)

        def ship(slab: Slab, axis: int, dirn: int):
            """One ring hop of a widened face, through the position codec
            when configured."""
            if mig_q is None:
                return comm.shift(wrap_pos(slab), axis, dirn), 0
            enc, oflow = encode_migration(
                slab, POS, center, half_rng, cfg, lsz=lsz_np, toroidal=tor,
                lead=lead)
            return decode_migration(
                comm.shift(enc, axis, dirn), POS, half_rng, cfg,
                lsz=lsz_np, toroidal=tor, lead=lead, at_l=at_l_np), oflow

        # Received slabs still carrying cells that need later-axis hops:
        # (slab, axis it arrived along, its fixed cell index on that axis).
        pending = []
        widths = self._owned(comm)
        for a in range(nd):
            h = shape[a]
            # the migration ring along a: the padded edge on an equal
            # split, each device's owned extent + 1 on an uneven one
            hi_idx = h - 1 if not geom.uneven \
                else tuple(w + 1 for w in widths[a])
            grid_axes = [c for c in range(nd) if c != a]
            face_grid = tuple(shape[c] for c in grid_axes)

            out_m = take_slab(soa, a, 0, lead)
            out_p = take_slab(soa, a, hi_idx, lead)

            # Forward the axis-a ring cells of every pending slab inside
            # widened payloads, and invalidate them at their source.
            blocks_m, blocks_p, fwd = [], [], []
            for slab, b, fb in pending:
                p_axes = [c for c in range(nd) if c != b]
                ap = p_axes.index(a)
                lo = {n: take_plane(v, ap, 0, lead) for n, v in slab.items()}
                hi = {n: take_plane(v, ap, hi_idx, lead, mesh_axis=a)
                      for n, v in slab.items()}
                nv = slab["valid"].clone()
                set_plane(nv, ap, 0, False, lead)
                set_plane(nv, ap, hi_idx, False, lead, mesh_axis=a)
                fwd.append(({**slab, "valid": nv}, b, fb))
                bpos = grid_axes.index(b)
                blocks_m.append((lo, bpos, fb))
                blocks_p.append((hi, bpos, fb))
            pending = fwd

            def widen(face: Slab, blocks) -> Slab:
                if not blocks:
                    return face
                g = len(face_grid)
                out = {}
                for n, base in face.items():
                    trailing = tuple(base.shape[lead + g + 1:])
                    parts = [base]
                    for blk, bpos, fb in blocks:
                        v = blk[n]
                        z = torch.zeros(
                            lead_shape + face_grid + (v.shape[lead + g - 1],)
                            + trailing, dtype=base.dtype, device=base.device)
                        set_plane(z, bpos, fb, v, lead)
                        parts.append(z)
                    out[n] = torch.cat(parts, dim=lead + g)
                return out

            recv_p, of_p = ship(widen(out_p, blocks_p), a, +1)
            recv_m, of_m = ship(widen(out_m, blocks_m), a, -1)
            moflow = moflow + of_p + of_m

            v = soa.valid.clone()
            set_plane(v, a, 0, False, lead)
            set_plane(v, a, hi_idx, False, lead)
            soa = soa.replace(valid=v)
            # recv_p came from the -a neighbour -> sits at my a-cell 1;
            # recv_m from the +a neighbour -> my a-cell h-2.
            pending = pending + [(recv_p, a, 1), (recv_m, a, h - 2)]

        if mig_q is not None:
            # every hop is through: what the slabs hold stays here
            pending = [({**slab, POS: self._settle(
                slab[POS], frame.origins, frame.ends, frame.widths, lead)},
                        b, fb) for slab, b, fb in pending]

        def fl(slab: Slab, c):
            v = slab["valid"][c]
            return ({n: t[c].reshape((-1,) + tuple(t.shape[lead + v.dim():]))
                     for n, t in slab.items() if n != "valid"},
                    v.reshape((-1,)))

        out = _MeshSoA(lead_shape)
        drops: List[torch.Tensor] = []
        for c, g in comm.blocks():
            base_attrs, base_valid = flat_view(device_block(soa, c))
            parts = [fl(slab, c) for slab, _, _ in pending]
            cat = {n: torch.cat([base_attrs[n]] + [p[0][n] for p in parts])
                   for n in base_attrs}
            catv = torch.cat([base_valid] + [p[1] for p in parts])
            blk, d = bin_agents(geom, cat, catv, frame.origins[c],
                                geom.owned_widths(g))
            del cat, catv
            out.put(c, blk)
            drops.append(d)
        return out.soa, torch.stack(drops).reshape(lead_shape), moflow

    def _settle(self, pos: torch.Tensor, starts: torch.Tensor,
                ends: torch.Tensor, widths: torch.Tensor, lead: int
                ) -> torch.Tensor:
        """Received migrants' positions (``lead`` mesh dims first) moved
        onto their receiver's owned slab (per device and axis: its
        ``starts`` and ``ends`` in world space, ``widths`` in cells) where
        their cell would be a ring cell.  The position codec rounds an
        emigrant to its quantum (the sender's range / 32767) about the
        sender's box centre, which can put one that just crossed a cut
        back across it; binned into the receiver's ring, the next aura
        rebuild would delete it uncounted, as the reference does (ROADMAP
        C 6).  Such a position goes to the slab's nearest edge: its start,
        or the largest float32 below its end (on a toroidal axis the
        nearer one across the seam)."""
        geom = self.geom
        dev = pos.device
        shape = (pos.shape[:lead] + (1,) * (pos.dim() - lead - 1)
                 + (geom.ndim,))
        lo, hi = starts.reshape(shape), ends.reshape(shape)
        widths = widths.reshape(shape)
        cs = torch.tensor(geom.cell_size, dtype=torch.float32, device=dev)
        cell = torch.floor((pos - lo) / cs).to(torch.int32) + 1
        out = (cell < 1) | (cell > widths)
        to_lo = cell < 1
        if any(geom.toroidal):
            lsz = torch.tensor(geom.domain_size, dtype=torch.float32,
                               device=dev)
            nearer_lo = _jnp_mod(lo - pos, lsz) <= _jnp_mod(pos - hi, lsz)
            tor = torch.tensor(geom.toroidal, device=dev)
            to_lo = torch.where(tor, out & nearer_lo, to_lo)
        below_hi = torch.nextafter(hi, torch.full_like(hi, -math.inf))
        return torch.where(to_lo, lo, torch.where(out, below_hi, pos))

    # ------------------------------------------------------------------
    # Drivers
    # ------------------------------------------------------------------
    def _comm(self, mesh=None) -> Comm:
        """The virtual mesh's comm, or with a process ``mesh`` (a
        ``DeviceMesh`` shaped like the Domain's ``mesh_shape``) this
        process's :class:`ProcessMeshComm`, built once a mesh."""
        if mesh is None:
            return VirtualMeshComm(mesh_shape=self.geom.mesh_shape,
                                   toroidal=self.geom.toroidal)
        held = self._comms.get(id(mesh))
        if held is not None and held[0] is mesh:
            return held[1]
        if not hasattr(mesh, "get_coordinate"):
            raise TypeError(
                "mesh= takes a torch.distributed DeviceMesh (see "
                f"repro_torch.launch.mesh.make_abm_mesh); got "
                f"{type(mesh).__name__}")
        shape = tuple(mesh.mesh.shape)
        if shape != self.geom.mesh_shape:
            raise ValueError(
                f"mesh of shape {shape} for a Domain whose mesh_shape is "
                f"{self.geom.mesh_shape}")
        comm = ProcessMeshComm.from_mesh(mesh, self.geom.toroidal)
        self._comms[id(mesh)] = (mesh, comm)
        return comm

    def make_local_step(self, mesh=None):
        """``step(state, full_halo=True)``: one iteration on the virtual
        mesh, or of this process's device of a process ``mesh``."""
        comm = self._comm(mesh)

        def step(state: SimState, full_halo: bool = True) -> SimState:
            return self.local_step(state, comm, full_halo)

        return step

    def make_segment_runner(self, mesh=None):
        """``seg(state, n_steps, full_first=True)`` runs ``n_steps``
        iterations (on the virtual mesh, or of this process's device of a
        process ``mesh``): the first a full aura refresh when
        ``full_first``, the rest through the delta codec.  Without delta
        encoding every step is full and ``full_first`` is ignored."""
        comm = self._comm(mesh)
        delta_on = self.delta_cfg.enabled

        def seg(state: SimState, n_steps: int, full_first: bool = True
                ) -> SimState:
            # The segment's step keys at once: two hashes a segment, not
            # two a step.
            keys = self.step_keys(state, int(n_steps), comm)
            for i in range(int(n_steps)):
                full = (not delta_on) or (full_first and i == 0)
                state = self.local_step(state, comm, full, keys[i])
            return state

        return seg

    def drive(self, state: SimState, n_steps: int, step_fn=None,
              rebalancer=None, collect=None, mesh=None, fault_plan=None):
        """Low-level driver with the delta refresh schedule and dynamic
        load balancing: a full aura refresh at every ``i % refresh_interval
        == 0`` and after any step that clipped under a fixed codec scale.
        ``n_steps`` run through the segment runner (segments end at
        refresh ticks and at the rebalancer's cadence), or one ``step_fn``
        call per step when a ``step_fn`` or a per-step ``collect`` is
        given.  With a process ``mesh`` the state is this process's block
        (``init_state(..., mesh=mesh)``), and every rank calls ``drive``
        alike.

        At the ``rebalancer``'s due ticks (a :class:`~repro_torch.core.
        reshard.Rebalancer`; an engine with ``rebalance_every > 0`` builds
        its own) the occupancy imbalance is checked and, past the
        threshold, the state is mass-migrated onto a better mesh: the step
        is rebuilt for the new geometry (``rebalancer.make_step``) and the
        next aura exchange is a full refresh (the re-shard zeroed the
        references).  Returns ``(engine, state, series)``: the engine
        differs from ``self`` after a re-shard, and on a process mesh the
        new ``DeviceMesh`` is ``rebalancer.mesh``.

        With the guards on, the health word is read at every control
        point (:func:`~repro_torch.core.guards.check_health`).  A
        ``fault_plan`` (``distributed.chaos.FaultPlan``) fires its faults
        at their absolute iterations, from the control points: segments
        end at pending fault steps.  Neither adds a host read when the
        guards are off and no plan is given."""
        eng = self
        if rebalancer is None and self.rebalance_every > 0:
            from repro_torch.core.reshard import Rebalancer
            rebalancer = Rebalancer(every=self.rebalance_every,
                                    threshold=self.imbalance_threshold)
        if rebalancer is not None:
            rebalancer.mesh = mesh
        r = max(int(self.delta_cfg.refresh_interval), 1)
        force_full = False
        reduce = None if mesh is None else self._comm(mesh)
        # A fixed-scale codec can clip (the adaptive one never does): a
        # grown overflow count forces the next exchange to a full refresh.
        track_clip = self.delta_cfg.enabled and self.delta_cfg.scale is not None
        clip_mark = codec_overflow_count(state, reduce) if track_clip else 0
        # The health word is read at the same control points (the mark
        # follows counter resets of a re-shard down); fault plans key on
        # the absolute iteration.
        track_health = self.guards.enabled
        hmark = health_counts(state, reduce) if track_health else None
        it0 = _global_it(state, reduce) if fault_plan is not None else 0

        def after(state):
            nonlocal force_full, clip_mark, hmark
            force_full = False
            if track_clip:
                cnt = codec_overflow_count(state, reduce)
                if cnt > clip_mark:
                    force_full = True
                    clip_mark = cnt
            if track_health:
                hmark, _ = check_health(eng.guards, state, hmark,
                                        comm=reduce)

        def fire(i, state):
            nonlocal force_full
            if fault_plan is None:
                return state
            state, fired = fault_plan.fire(eng, state, it0 + i, comm=reduce)
            if fired:
                force_full = True
            return state

        def check(i, state):
            """The rebalancer's check at tick ``i``: True on a re-shard."""
            nonlocal eng, mesh, reduce
            if rebalancer is None or not rebalancer.due(i):
                return state, False
            eng, state, resharded = rebalancer.maybe_reshard(eng, state)
            if resharded:
                mesh = rebalancer.mesh
                reduce = None if mesh is None else eng._comm(mesh)
            return state, resharded

        if step_fn is None and collect is None:
            seg_fn = eng.make_segment_runner(mesh)
            i = 0
            while i < n_steps:
                state, resharded = check(i, state)
                if resharded:
                    seg_fn = eng.make_segment_runner(mesh)
                    force_full = True
                state = fire(i, state)
                nxt = n_steps
                if rebalancer is not None and rebalancer.every > 0:
                    e = rebalancer.every
                    nxt = min(nxt, (i // e + 1) * e)
                    if rebalancer.pending:
                        # a deferred snapshot lands on the next tick
                        nxt = min(nxt, i + 1)
                if eng.delta_cfg.enabled:
                    nxt = min(nxt, (i // r + 1) * r)
                if fault_plan is not None:
                    nf = fault_plan.next_step(after=it0 + i)
                    if nf is not None:
                        nxt = min(nxt, max(nf - it0, i + 1))
                full = force_full or (not eng.delta_cfg.enabled) \
                    or i % r == 0
                state = seg_fn(state, nxt - i, full_first=full)
                after(state)
                i = nxt
            return eng, state, []
        if step_fn is None:
            step_fn = eng.make_local_step(mesh)
        series = []
        for i in range(n_steps):
            state, resharded = check(i, state)
            if resharded:
                step_fn = rebalancer.make_step(eng) if mesh is None \
                    else rebalancer.make_step(eng, mesh)
                force_full = True
            state = fire(i, state)
            full = force_full or (not self.delta_cfg.enabled) or i % r == 0
            state = step_fn(state, full_halo=full)
            after(state)
            if collect is not None:
                series.append(collect(state))
        return eng, state, series


def _global_it(state: SimState, comm: ProcessMeshComm = None) -> int:
    """The iteration counter (the largest of every rank's on a process
    mesh)."""
    it = state.it.max()
    return int(it if comm is None else comm.max_over_all_ranks(it))


def total_agents(state: SimState, comm: ProcessMeshComm = None) -> int:
    """Live agents of ``state``; with a process mesh's ``comm``, of every
    rank (an all-reduce: each rank reads the same count)."""
    n = state.soa.valid.sum()
    if comm is not None:
        n = comm.sum_over_all_ranks(n)
    return int(n)


def codec_overflow_count(state: SimState,
                         comm: ProcessMeshComm = None) -> int:
    """Largest per-device cumulative clipped-delta count (a host read; each
    device counts only its own sends, so the max is the monotone 'did
    anyone clip since the mark' signal).  With a process mesh's ``comm``
    it is the largest of every rank's (an all-reduce), so every rank
    forces the same full refresh: ranks that branched apart would post
    mismatched messages."""
    m = state.codec_overflow.max()
    if comm is not None:
        m = comm.max_over_all_ranks(m)
    return int(m)
