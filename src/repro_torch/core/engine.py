"""The simulation engine: one iteration = aura update -> neighbour
interaction -> agent update -> agent migration (port of
``repro/core/engine.py``, paper Figure 1).

State layout is the reference's: the agent SoA in the local-grid layout
``(*local_grid, K, ...)`` and every per-device quantity with ``ndim``
leading (all-ones) mesh dims.  This slice runs one device through
:class:`LocalComm` with a full aura refresh every step; the segment runner
is a plain Python loop over :meth:`Engine.local_step` (CUDA-graph capture
of that loop is later work).  Options that need a later slice raise
``NotImplementedError`` naming its ROADMAP item: multi-device meshes,
uneven partitions, delta encoding and the overlapped sweep (A7), spawning
behaviours (A5), guards (A9), rebalancing (A8), fault plans (A9).

RNG: ``jax.random`` keys cannot be reproduced before the threefry port
(A5), so :meth:`Engine.init_state` fills ``key`` with zeros and
:meth:`Engine.local_step` passes ``key=None`` to the update, which the
ported behaviours never read.  A state carried over from the JAX package
keeps its keys unchanged (``repro_torch.bridge``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.agent_soa import (
    AgentSoA,
    GID_COUNT,
    GID_RANK,
    POS,
    flat_view,
    numpy_dtype,
)
from repro_torch.core.behaviors import Behavior
from repro_torch.core.delta import DeltaConfig, Slab
from repro_torch.core.domain import Domain
from repro_torch.core.grid import bin_agents, clear_ring, ring_index
from repro_torch.core.halo import Comm, LocalComm, halo_exchange, \
    init_refs, take_slab
from repro_torch.core.neighbors import sweep_accumulate
from repro_torch.device import resolve_device

# Number of runtime guard counters in SimState.health (the reference's
# core.guards.NUM_GUARDS); the guards themselves come with ROADMAP A9.
NUM_GUARDS = 5


def _bcast(x: torch.Tensor, mesh_shape: Tuple[int, ...]) -> torch.Tensor:
    """Give a per-device value the leading device-mesh dims."""
    return x.reshape((1,) * len(mesh_shape) + tuple(x.shape)).expand(
        tuple(mesh_shape) + tuple(x.shape))


def _jnp_mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.mod`` for floats: C ``fmod``, moved into the divisor's sign."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


@dataclasses.dataclass
class SimState:
    soa: AgentSoA                   # (*local grid, K, ...)
    refs: Dict[str, Slab]           # leading mesh_shape dims
    it: torch.Tensor                # mesh_shape int32
    key: torch.Tensor               # mesh_shape + (2,) uint32
    gid_counter: torch.Tensor       # mesh_shape int32
    dropped: torch.Tensor           # mesh_shape int32 cumulative overflow drops
    halo_bytes: torch.Tensor        # mesh_shape int32 wire bytes of last aura
    codec_overflow: torch.Tensor    # mesh_shape int32 cumulative clipped deltas
    health: torch.Tensor            # mesh_shape + (NUM_GUARDS,) int32


def _unported(what: str, value, item: str) -> None:
    if value is not None:
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP {item})")


@dataclasses.dataclass(frozen=True, eq=False)
class Engine:
    geom: Domain
    behavior: Behavior
    delta_cfg: DeltaConfig = DeltaConfig(enabled=False)
    dt: float = 1.0
    # "auto" resolves per SoA device: the CUDA kernel on the card, the
    # tiled sweep on the CPU; "reference" | "tiled" | "kernel" force one.
    sweep_backend: str = "auto"
    # Communication hiding needs a wire (ROADMAP A7): "auto" and "off" run
    # the monolithic sweep, "on" raises.
    overlap: str = "auto"
    device: Any = "cuda"

    def __post_init__(self):
        if self.overlap not in ("auto", "on", "off"):
            raise ValueError(
                f"overlap={self.overlap!r}; expected 'auto', 'on' or 'off'")
        if self.overlap == "on":
            raise NotImplementedError(
                "the overlapped interior/boundary sweep is not ported yet "
                "(ROADMAP A7)")
        if self.geom.n_devices > 1 or self.geom.uneven:
            raise NotImplementedError(
                f"mesh {self.geom.mesh_shape} / uneven partitions: the "
                "multi-device engine is not ported yet (ROADMAP A7)")
        if self.behavior.can_spawn:
            raise NotImplementedError(
                "spawning behaviours need the RNG and spawn path (ROADMAP "
                "A5)")
        object.__setattr__(self, "device", resolve_device(self.device))

    # ------------------------------------------------------------------
    # Initialization (host side, numpy-friendly)
    # ------------------------------------------------------------------
    def init_state(self, positions: np.ndarray,
                   attrs: Dict[str, np.ndarray], seed: int = 0) -> SimState:
        """Create the agents in their cells on the (single) device.

        ``seed`` only seeds the reference's RNG keys, which are not ported
        (ROADMAP A5): ``key`` is zeros here.
        """
        geom = self.geom
        nd = geom.ndim
        mesh = geom.mesh_shape
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
        if GID_RANK in attrs or GID_COUNT in attrs:
            raise NotImplementedError(
                "carried gid columns (the re-shard / restore path) are not "
                "ported yet (ROADMAP A8)")

        n = positions.shape[0]
        flat: Dict[str, torch.Tensor] = {}
        for name, (shape, dtype) in schema.all_specs(nd).items():
            if name == POS:
                a = positions.astype(np.float32)
            elif name == GID_RANK:
                a = np.zeros((n,), dtype=np.int32)   # linear rank 0
            elif name == GID_COUNT:
                a = np.arange(n, dtype=np.int32)
            else:
                a = np.asarray(attrs[name], dtype=numpy_dtype(dtype))
            flat[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
        origin = geom.device_origin((0,) * nd, dev)
        soa, dropped = bin_agents(geom, flat, valid, origin)
        if int(dropped) != 0:
            raise ValueError(
                f"cell capacity overflow at init: {int(dropped)} agents "
                "dropped; raise geom.cap")

        refs0 = init_refs(geom, soa)
        refs = {d: {f: _bcast(v, mesh) for f, v in slab.items()}
                for d, slab in refs0.items()}

        def scalar(v):
            return torch.full(mesh, v, dtype=torch.int32, device=dev)

        return SimState(
            soa=soa,
            refs=refs,
            it=scalar(0),
            key=torch.zeros(mesh + (2,), dtype=torch.uint32, device=dev),
            gid_counter=scalar(n),
            dropped=scalar(0),
            halo_bytes=scalar(0),
            codec_overflow=scalar(0),
            health=torch.zeros(mesh + (NUM_GUARDS,), dtype=torch.int32,
                               device=dev),
        )

    # ------------------------------------------------------------------
    # One iteration
    # ------------------------------------------------------------------
    def local_step(self, state: SimState, comm: Comm, full_halo: bool
                   ) -> SimState:
        geom = self.geom
        beh = self.behavior
        nd = geom.ndim
        shape = geom.local_shape
        k = geom.cap
        tor = geom.toroidal
        dev = state.soa.valid.device

        origin = geom.device_origin(comm.coords(), dev)
        idx0 = (0,) * nd
        refs = {d: {f: v[idx0] for f, v in slab.items()}
                for d, slab in state.refs.items()}
        it = state.it[idx0]
        gidc = state.gid_counter[idx0]
        dropped = state.dropped[idx0]
        coflow = state.codec_overflow[idx0]
        health = state.health[idx0]

        # 1. Aura update (rebuilt from scratch each iteration, §2.2.1).
        soa, refs, hbytes, oflow = halo_exchange(
            geom, clear_ring(state.soa), comm, refs, self.delta_cfg,
            full_halo)
        coflow = coflow + oflow

        # 2. Local interaction (backend-dispatched sweep).
        acc = sweep_accumulate(
            geom, soa, beh.pair_fn, beh.pair_attrs, beh.radius, beh.params,
            backend=self.sweep_backend)

        # 3. Pointwise update on interior agents.
        isl = tuple(slice(1, h - 1) for h in shape)
        int_attrs = {n: a[isl] for n, a in soa.attrs.items()}
        int_valid = soa.valid[isl]
        new_attrs, alive, _, _ = beh.update_fn(
            int_attrs, int_valid, acc, None, beh.params, self.dt)
        new_valid = int_valid & alive

        # Per-axis boundary condition on positions: closed axes clamp to
        # [eps, L - eps] (eps in float64, bounds rounded to float32, as the
        # reference); toroidal axes wrap inside the migration exchange.
        lsz = torch.tensor(geom.domain_size, dtype=torch.float32, device=dev)
        if not all(tor):
            eps = 1e-4 * geom.cell_size
            lo = np.asarray([-np.inf if t else eps for t in tor], np.float32)
            hi = np.asarray(
                [np.inf if t else L - eps
                 for t, L in zip(tor, geom.domain_size)], np.float32)
            new_attrs[POS] = torch.clamp(
                new_attrs[POS], min=torch.from_numpy(lo).to(dev),
                max=torch.from_numpy(hi).to(dev))

        # 4. Flatten the interior for re-binning.
        n_int = math.prod(geom.interior) * k
        flat = {n: a.reshape((n_int,) + tuple(a.shape[nd + 1:]))
                for n, a in new_attrs.items()}
        fvalid = new_valid.reshape((n_int,))
        soa2, d1 = bin_agents(geom, flat, fvalid, origin)
        dropped = dropped + d1

        # 5. Agent migration: dimension-ordered ring exchange over all axes.
        soa3, d2 = self._migrate(soa2, comm, origin, lsz)
        dropped = dropped + d2

        # 6. Repack per-device state.
        mesh = tuple(state.it.shape)

        def rep(x):
            return _bcast(torch.as_tensor(x, dtype=torch.int32, device=dev),
                          mesh)

        return SimState(
            soa=soa3,
            refs={d: {f: _bcast(v, mesh) for f, v in slab.items()}
                  for d, slab in refs.items()},
            it=rep(it + 1),
            key=state.key,
            gid_counter=rep(gidc),
            dropped=rep(dropped),
            halo_bytes=rep(hbytes),
            codec_overflow=rep(coflow),
            health=_bcast(health, mesh),
        )

    def _migrate(self, soa: AgentSoA, comm: Comm, origin: torch.Tensor,
                 lsz: torch.Tensor) -> Tuple[AgentSoA, torch.Tensor]:
        """Dimension-ordered emigrant routing with one-pass re-binning.

        Axis-0 faces (incl. corner cells) are exchanged first; each later
        axis's payload widens with the ring cells of every previously
        received slab, carrying diagonal migrants forward, and everything
        (the face-cleared grid and all ``2 * ndim`` receives) re-bins in a
        single sort pass, as in the reference.
        """
        geom = self.geom
        nd = geom.ndim
        shape = geom.local_shape
        tor = geom.toroidal

        def wrap_pos(slab: Slab) -> Slab:
            if not any(tor):
                return slab
            out = dict(slab)
            p = slab[POS]
            wrapped = _jnp_mod(p, lsz)
            out[POS] = wrapped if all(tor) else torch.where(
                torch.tensor(tor, device=p.device), wrapped, p)
            return out

        def fl(slab: Slab):
            slab = dict(slab)
            v = slab.pop("valid")
            return ({n: a.reshape((-1,) + tuple(a.shape[v.dim():]))
                     for n, a in slab.items()},
                    v.reshape((-1,)))

        # Received slabs still carrying cells that need later-axis hops:
        # (slab, axis it arrived along, its fixed cell index on that axis).
        pending = []
        for a in range(nd):
            h = shape[a]
            hi_idx = h - 1
            grid_axes = [c for c in range(nd) if c != a]
            face_grid = tuple(shape[c] for c in grid_axes)

            out_m = take_slab(soa, a, 0)
            out_p = take_slab(soa, a, hi_idx)

            # Forward the axis-a ring cells of every pending slab inside
            # widened payloads, and invalidate them at their source.
            blocks_m, blocks_p, fwd = [], [], []
            for slab, b, fb in pending:
                p_axes = [c for c in range(nd) if c != b]
                ap = p_axes.index(a)
                lo = {n: v[ring_index(ap, 0)] for n, v in slab.items()}
                hi = {n: v[ring_index(ap, hi_idx)] for n, v in slab.items()}
                nv = slab["valid"].clone()
                nv[ring_index(ap, 0)] = False
                nv[ring_index(ap, hi_idx)] = False
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
                    trailing = tuple(base.shape[g + 1:])
                    parts = [base]
                    for blk, bpos, fb in blocks:
                        v = blk[n]
                        z = torch.zeros(
                            face_grid + (v.shape[g - 1],) + trailing,
                            dtype=base.dtype, device=base.device)
                        z[ring_index(bpos, fb)] = v
                        parts.append(z)
                    out[n] = torch.cat(parts, dim=g)
                return out

            recv_p = comm.shift(wrap_pos(widen(out_p, blocks_p)), a, +1)
            recv_m = comm.shift(wrap_pos(widen(out_m, blocks_m)), a, -1)

            v = soa.valid.clone()
            v[ring_index(a, 0)] = False
            v[ring_index(a, hi_idx)] = False
            soa = soa.replace(valid=v)
            # recv_p came from the -a neighbour -> sits at my a-cell 1;
            # recv_m from the +a neighbour -> my a-cell h-2.
            pending = pending + [(recv_p, a, 1), (recv_m, a, h - 2)]

        base_attrs, base_valid = flat_view(soa)
        parts = [fl(slab) for slab, _, _ in pending]
        cat = {n: torch.cat([base_attrs[n]] + [p[0][n] for p in parts])
               for n in base_attrs}
        catv = torch.cat([base_valid] + [p[1] for p in parts])
        return bin_agents(geom, cat, catv, origin)

    # ------------------------------------------------------------------
    # Drivers
    # ------------------------------------------------------------------
    def _comm(self) -> LocalComm:
        return LocalComm(toroidal=self.geom.toroidal)

    def make_local_step(self):
        comm = self._comm()

        def step(state: SimState, full_halo: bool = True) -> SimState:
            return self.local_step(state, comm, full_halo)

        return step

    def make_segment_runner(self):
        """``seg(state, n_steps, full_first=True)`` runs ``n_steps``
        iterations.  Without delta encoding every step is a full refresh,
        so ``full_first`` changes nothing; it is kept for the reference's
        call signature."""
        comm = self._comm()

        def seg(state: SimState, n_steps: int, full_first: bool = True
                ) -> SimState:
            for _ in range(int(n_steps)):
                state = self.local_step(state, comm, True)
            return state

        return seg

    def drive(self, state: SimState, n_steps: int, step_fn=None,
              rebalancer=None, collect=None, mesh=None, fault_plan=None):
        """Low-level driver: ``n_steps`` through the segment runner, or one
        ``step_fn`` call per step when a ``step_fn`` or a per-step
        ``collect`` is given.  Returns ``(engine, state, series)``."""
        _unported("dynamic load balancing", rebalancer, "A8")
        _unported("a device mesh", mesh, "A7")
        _unported("fault plans", fault_plan, "A9")
        if step_fn is None and collect is None:
            return self, self.make_segment_runner()(state, n_steps), []
        if step_fn is None:
            step_fn = self.make_local_step()
        series = []
        for _ in range(n_steps):
            state = step_fn(state, full_halo=True)
            if collect is not None:
                series.append(collect(state))
        return self, state, series


def total_agents(state: SimState) -> int:
    return int(state.soa.valid.sum())
