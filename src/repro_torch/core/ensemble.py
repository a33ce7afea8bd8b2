"""The ensemble runner: R parameter points of one simulation family stepped
together (port of ``repro/core/ensemble.py``).

The reference vmaps its engine's segment body over a leading *replica*
axis, so R stacked replicas advance in one compiled dispatch, each with
its own traced parameters.  Here the replicas are *lanes*:
:class:`EnsembleState` stacks R solo states leaf-wise, ``(R, *mesh,
...)``, and one step of :class:`Ensemble` runs

1. each lane's aura exchange, written into one stacked aura-filled SoA;
2. one sweep a mesh device over every lane: on the card ONE ``pair_sweep``
   launch, its lanes read in place from the stacked SoA (a device's block
   of every lane is a strided view), each with its own params from a
   float32 device table built once a run (:func:`~repro_torch.kernels.
   neighbor_interaction.lane_table`); the devices are not folded into the
   lanes, so a mesh of M devices launches M times a step;
3. each lane's update, with its own step keys (``Engine.step_keys``): the
   RNG stays per lane, so a lane draws exactly what its solo run draws;
4. each lane's migration.

Steps 1, 3 and 4 are the solo engine's own halves of a step
(``Engine._aura`` and ``Engine._advance``); only the sweep is shared.  A
lane is the solo engine at its point: :meth:`Ensemble.solo_engine` rounds
every parameter to float32, and each lane's behaviour is ``behavior_fn``
of its own float32 scalars, so lane ``r`` equals the solo run of point
``r`` bit for bit (the property the tests pin).  Padding lanes
(``active=False``) tile lane 0 and are stepped like the rest; no reader
looks at them.

Runners are cached in a :class:`~repro_torch.core.compile_cache.
CompiledCache` keyed by the family fingerprint (+ mesh): the scenario
server (``launch/serve.py``) reports its hits, and CUDA graphs of a runner
will be keyed the same way.  An uneven ``Partition`` runs as on the solo
engine: the lanes' auras and updates are ``Engine._aura``/``_advance``,
which mask each device's block to its owned cells.  On a process mesh
(``run(..., mesh=)``, one process a device) each process runs its own
device's block of every lane: the lanes' states come from
``proto_engine().init_state(..., mesh=mesh)`` and the loops run over the
comm's one block.  ``guards=`` runs the guarded step on every lane (each
lane's halves are its solo engine's), and :func:`ensemble_health_counts`
reads the per-lane words, lanes independent.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.agent_soa import AgentSoA
from repro_torch.core.compile_cache import CompiledCache
from repro_torch.core.delta import DeltaConfig
from repro_torch.core.domain import Domain
from repro_torch.core.engine import Engine, SimState
from repro_torch.core.guards import (
    GUARD_CONSERVATION, NUM_GUARDS, GuardConfig, as_guard_config,
)
from repro_torch.core.neighbors import (
    resolve_sweep_backend, sweep_accumulate_lanes,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.neighbor_interaction import lane_table

# One process-wide cache of ensemble runners, keyed by family fingerprint
# (+ mesh); a server hosts few families at once.
_RUNNER_CACHE = CompiledCache("ensemble.runner", maxsize=16)


# ---------------------------------------------------------------------------
# Ensemble state: R stacked lanes + per-lane params + active mask
# ---------------------------------------------------------------------------

def _map_state(fn: Callable, *states: SimState) -> SimState:
    """``fn`` applied leaf by leaf across ``states``."""
    s0 = states[0]
    return SimState(
        soa=AgentSoA(
            attrs={n: fn(*[s.soa.attrs[n] for s in states])
                   for n in s0.soa.attrs},
            valid=fn(*[s.soa.valid for s in states])),
        refs={e: {f: fn(*[s.refs[e][f] for s in states]) for f in slab}
              for e, slab in s0.refs.items()},
        **{f.name: fn(*[getattr(s, f.name) for s in states])
           for f in dataclasses.fields(SimState)
           if f.name not in ("soa", "refs")})


def stack_states(states: Sequence[SimState]) -> SimState:
    """Stack R solo states leaf-wise into one (R, ...)-leading state."""
    return _map_state(lambda *xs: torch.stack(xs), *states)


def replica_state(state: SimState, r: int) -> SimState:
    """Lane ``r`` of a stacked state, in the solo layout (views)."""
    return _map_state(lambda x: x[r], state)


def ensemble_health_counts(estate: "EnsembleState", comm=None
                           ) -> np.ndarray:
    """Per-lane guard words, ``(R, NUM_GUARDS)`` int64: each lane reduced
    over its devices as the solo :func:`~repro_torch.core.guards.
    health_counts` (summed; the conservation word, a replicated global,
    the max), and with a process mesh's ``comm`` over every rank.  Lanes
    stay independent: one lane's NaN burst never shows in another's."""
    h = estate.state.health
    rr = h.shape[0]
    h = h.reshape(rr, -1, NUM_GUARDS).to(torch.int64)
    out = h.sum(1)
    cons = h[:, :, GUARD_CONSERVATION].max(1).values if h.shape[1] \
        else torch.zeros((rr,), dtype=torch.int64, device=h.device)
    if comm is not None:
        out = comm.sum_over_all_ranks(out)
        cons = comm.max_over_all_ranks(cons)
    out = out.cpu().numpy()
    out[:, GUARD_CONSERVATION] = cons.cpu().numpy()
    return out


@dataclasses.dataclass(frozen=True)
class EnsembleState:
    """R lanes of one simulation family, stacked.

    ``state`` is a :class:`SimState` whose every leaf carries a leading
    ``(R, ...)`` lane axis; ``params`` maps each family parameter name to
    an ``(R,)`` float32 tensor on the host (lane r's value at index r: the
    lanes' behaviours are built from them and the kernel's table copied
    from them once a run, with no wait on the card); ``active`` is a host
    ``(R,)`` bool mask - padding lanes (``False``) are stepped like any
    other, and every reader ignores them.
    """

    state: SimState
    params: Dict[str, torch.Tensor]
    active: np.ndarray

    @property
    def replicas(self) -> int:
        return int(self.active.shape[0])

    @property
    def n_active(self) -> int:
        return int(self.active.sum())


@dataclasses.dataclass(frozen=True)
class _Lanes:
    """The lanes of one run: each lane's solo engine at its point, and the
    kernel's per-lane table (on the card's kernel backend; else None)."""

    engines: Tuple[Engine, ...]
    table: Optional[torch.Tensor]


# ---------------------------------------------------------------------------
# The ensemble runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ensemble:
    """Batched runner for one compatibility family of simulations.

    ``behavior_fn(params)`` builds the family's :class:`Behavior` from a
    dict of scalars; everything structural (schema, radii, pair attrs,
    accumulators, spawn) must not depend on them, only the numbers may
    (:func:`repro_torch.analysis.check_ensemble` checks it).  Two
    ensembles are the same family iff their fingerprints match: the same
    Domain, ``behavior_fn`` *object*, parameter names, dt, codec, sweep
    backend, guards and device.
    """

    geom: Domain
    behavior_fn: Callable[[Dict[str, Any]], Any]
    param_names: Tuple[str, ...]
    dt: float = 1.0
    delta_cfg: DeltaConfig = DeltaConfig(enabled=False)
    sweep_backend: str = "auto"
    guards: GuardConfig = GuardConfig()
    family: str = ""              # display label (serve telemetry)
    device: Any = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "param_names",
                           tuple(sorted(self.param_names)))
        object.__setattr__(self, "guards", as_guard_config(self.guards))
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- identity ------------------------------------------------------

    @property
    def fingerprint(self) -> Tuple:
        """Hashable family identity - the runner cache key and the
        batching key of the scenario server."""
        return (self.geom, self.behavior_fn, self.param_names, self.dt,
                self.delta_cfg, self.sweep_backend, self.guards,
                self.device)

    # -- construction helpers -----------------------------------------

    def _engine(self, params: Dict[str, float]) -> Engine:
        return Engine(geom=self.geom, behavior=self.behavior_fn(params),
                      delta_cfg=self.delta_cfg, dt=self.dt,
                      sweep_backend=self.sweep_backend, guards=self.guards,
                      device=self.device)

    def proto_engine(self) -> Engine:
        """Solo :class:`Engine` of this family at parameters 0.0 - for
        ``init_state``, contract checks, and the structure every lane
        shares."""
        return self._engine({n: 0.0 for n in self.param_names})

    def solo_engine(self, params: Dict[str, float]) -> Engine:
        """Solo engine at one parameter point, every parameter rounded to
        float32 as the lanes see it, so a solo run equals the
        corresponding lane bit for bit."""
        return self._engine({n: float(np.float32(params[n]))
                             for n in self.param_names})

    def pack_params(self, points: Sequence[Dict[str, float]]
                    ) -> Dict[str, torch.Tensor]:
        """(R,) float32 host tensors from R parameter dicts (missing
        names raise - a family's lanes all sweep the same knobs)."""
        for p in points:
            missing = set(self.param_names) - set(p)
            if missing:
                raise ValueError(
                    f"replica missing family params {sorted(missing)}")
        return {n: torch.tensor([float(p[n]) for p in points],
                                dtype=torch.float32)
                for n in self.param_names}

    def init(self, states: Sequence[SimState],
             points: Sequence[Dict[str, float]]) -> EnsembleState:
        """Stack R solo states (from ``proto_engine().init_state``) with
        their R parameter points into one :class:`EnsembleState`."""
        if len(states) != len(points):
            raise ValueError(f"{len(states)} states vs {len(points)} "
                             "parameter points")
        if not states:
            raise ValueError("ensemble needs at least one replica")
        return EnsembleState(state=stack_states(states),
                             params=self.pack_params(points),
                             active=np.ones(len(states), dtype=bool))

    def pad_to(self, estate: EnsembleState, slots: int) -> EnsembleState:
        """Pad a partial batch to ``slots`` lanes by tiling lane 0 with
        ``active=False`` - inert lanes that keep the runner's shape fixed
        across batch occupancies."""
        r = estate.replicas
        if slots < r:
            raise ValueError(f"cannot pad {r} replicas down to {slots}")
        if slots == r:
            return estate
        idx = torch.tensor(np.r_[np.arange(r), np.zeros(slots - r, int)])

        def take(x):
            return torch.index_select(x, 0, idx.to(x.device))

        return EnsembleState(
            state=_map_state(take, estate.state),
            params={k: take(v) for k, v in estate.params.items()},
            active=np.r_[estate.active, np.zeros(slots - r, dtype=bool)])

    def lanes(self, params: Dict[str, torch.Tensor]) -> _Lanes:
        """Each lane's solo engine from the ``(R,)`` host params and, for
        the kernel on the card, the lanes' table."""
        host = {n: params[n].tolist() for n in self.param_names}
        count = len(host[self.param_names[0]]) if self.param_names else 0
        engines = tuple(self.solo_engine({n: host[n][r] for n in host})
                        for r in range(count))
        table = None
        if resolve_sweep_backend(self.sweep_backend, self.device) \
                == "kernel" and self.device.type == "cuda":
            table = lane_table([e.behavior.pair_fn for e in engines],
                               [e.behavior.params for e in engines],
                               self.device)
        return _Lanes(engines=engines, table=table)

    # -- the runner ------------------------------------------------------

    def _step(self, base: Engine, lanes: _Lanes, states: List[SimState],
              comm, full: bool, keys: List[torch.Tensor]
              ) -> List[SimState]:
        """One iteration of every lane (the module docstring's 1.-4.)."""
        geom = self.geom
        count = len(states)
        s0 = states[0].soa

        def stacked(a):
            return torch.empty((count,) + tuple(a.shape), dtype=a.dtype,
                               device=a.device)

        aura = AgentSoA(attrs={n: stacked(a) for n, a in s0.attrs.items()},
                        valid=stacked(s0.valid))

        def lane(r):
            return AgentSoA(attrs={n: a[r] for n, a in aura.attrs.items()},
                            valid=aura.valid[r])

        # 1. each lane's aura, into its lane of the stacked SoA
        auras = [eng._aura(st, comm, full, out=lane(r))
                 for r, (eng, st) in enumerate(zip(lanes.engines, states))]
        # 2. one sweep a mesh device over every lane (the comm's devices:
        # all of the virtual mesh, a process's own), keyed by coordinates
        beh = base.behavior
        accs = {}
        for c, g in comm.blocks():
            at = (slice(None),) + c
            blk = AgentSoA(attrs={n: a[at] for n, a in aura.attrs.items()},
                           valid=aura.valid[at])
            accs[g] = sweep_accumulate_lanes(
                geom, blk, [e.behavior.pair_fn for e in lanes.engines],
                beh.pair_attrs, beh.radius,
                [e.behavior.params for e in lanes.engines],
                backend=base.sweep_backend, table=lanes.table)
        del aura
        # 3.-4. each lane's update (its own step keys) and migration
        out = []
        for r, eng in enumerate(lanes.engines):
            out.append(eng._advance(
                states[r], auras[r], comm, keys[r],
                lambda c, blk, pre, r=r: {n: a[r]
                                          for n, a in accs[c].items()}))
        return out

    def _build_runner(self, mesh):
        base = self.proto_engine()
        comm = base._comm(mesh)
        delta_on = self.delta_cfg.enabled

        def run(state: SimState, lanes: _Lanes, n_steps: int,
                full_first: bool = True) -> SimState:
            cur = [replica_state(state, r)
                   for r in range(len(lanes.engines))]
            # each lane's step keys of the segment at once
            keys = [eng.step_keys(st, int(n_steps), comm)
                    for eng, st in zip(lanes.engines, cur)]
            for i in range(int(n_steps)):
                full = (not delta_on) or (full_first and i == 0)
                cur = self._step(base, lanes, cur, comm, full,
                                 [k[i] for k in keys])
            return stack_states(cur)

        return run

    def make_runner(self, mesh=None):
        """Cached runner ``run(stacked_state, lanes, n_steps, full_first)
        -> stacked_state`` (``lanes``: :meth:`lanes` of the params).  The
        key is the family fingerprint (+ mesh), so every request of a
        family after the first is a cache hit (``runner_cache_stats``)."""
        key = (self.fingerprint, mesh)
        return _RUNNER_CACHE.get_or_build(
            key, lambda: self._build_runner(mesh))

    def run(self, estate: EnsembleState, n_steps: int, *,
            mesh: Optional[Any] = None, full_first: bool = True,
            collect: Optional[Callable[[EnsembleState], Any]] = None,
            ) -> Tuple[EnsembleState, list]:
        """Advance every lane ``n_steps`` iterations.

        Without delta encoding the runner takes all ``n_steps`` at once.
        With delta encoding the host loops over refresh boundaries -
        segments of ``refresh_interval`` steps, each opening with a full
        aura refresh - as the reference does.  ``collect(estate)`` (if
        given) runs at every segment boundary and its non-None results
        are returned as the frame list.  With a process ``mesh`` every rank
        calls ``run`` alike on its own device's blocks of the lanes.
        """
        runner = self.make_runner(mesh)
        lanes = self.lanes(estate.params)
        frames: list = []
        state = estate.state
        seg = n_steps if not self.delta_cfg.enabled \
            else max(int(self.delta_cfg.refresh_interval), 1)
        done = 0
        ff = full_first
        while done < n_steps:
            n = min(seg, n_steps - done)
            state = runner(state, lanes, n, ff)
            done += n
            ff = True          # every later segment opens with a refresh
            if collect is not None:
                out = collect(dataclasses.replace(estate, state=state))
                if out is not None:
                    frames.append(out)
        return dataclasses.replace(estate, state=state), frames


def runner_cache_stats() -> Dict[str, Any]:
    """Hit/miss/evict snapshot of the ensemble runner cache."""
    return _RUNNER_CACHE.stats().as_dict()
