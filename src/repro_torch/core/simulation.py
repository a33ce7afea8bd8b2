"""The ``Simulation`` facade (port of ``repro/core/simulation.py``).

    sim = Simulation(dict(interior=(8, 8), cap=24), behavior, dt=0.1)
    sim.init(positions, attrs)
    sim.every(1, lambda s: s.n_agents(), name="agents")
    sim.run(100)
    sim.series["agents"], sim.engine, sim.state

The facade owns the engine, the state and the scheduled operations.  It
runs on the CUDA device unless ``device="cpu"`` is passed.  A geometry with
``mesh_shape`` other than all ones runs on the virtual device mesh of
``core.engine`` (the whole mesh on one card), on an equal split or an
uneven ``Partition`` (``Domain(partition=...)``).  An explicit ``mesh=``
(a ``DeviceMesh`` from :func:`repro_torch.launch.mesh.make_abm_mesh`,
shaped like the Domain's ``mesh_shape``) runs one process a device: every
rank builds the same facade, ``init`` keeps the rank's own agents, and
the exchanges cross between processes (:class:`~repro_torch.core.halo.
ProcessMeshComm`); ``n_agents`` and :meth:`Simulation.sum_over_all_ranks`
are global.  Not ported in this slice, and raising
``NotImplementedError`` when asked for: ``rebalance`` (A8),
``checkpoint`` (A6), ``guards``, ``supervised`` runs and fault plans
(A9).  A list of several behaviours
is composed (:func:`~repro_torch.core.behaviors.compose`), as the
reference does.  Of the construction-time
contracts only stencil soundness (``radius <= cell_size``) is ported; the
rest of the contract checker waits for A11.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.behaviors import Behavior, compose
from repro_torch.core.delta import DeltaConfig
from repro_torch.core.domain import Domain
from repro_torch.core.engine import (
    Engine, SimState, _unported, codec_overflow_count, total_agents,
)

# Geometry defaults applied when the first argument is a kwargs dict.
_GEOM_DEFAULTS = dict(cell_size=2.0, interior=(8, 8), mesh_shape=(1, 1),
                      cap=24, boundary="closed")


class ContractError(ValueError):
    """Raised at construction when an error-severity contract fails."""


def check_stencil(geom: Domain, behavior: Behavior, mode: str = "error"
                  ) -> List[str]:
    """Stencil soundness: the ``3**ndim`` sweep visits adjacent cells only,
    so ``radius > cell_size`` would silently drop interacting pairs.
    ``mode`` is ``"error"`` (raise), ``"warn"`` or ``"off"``; returns the
    findings."""
    if mode not in ("off", "warn", "error"):
        raise ValueError(
            f"check mode {mode!r} not in ('off', 'warn', 'error')")
    if mode == "off":
        return []
    leaves = behavior.children or (behavior,)
    errors = [
        f"stencil-soundness: interaction radius {float(b.radius):g} exceeds "
        f"cell_size {geom.cell_size:g}: the {3 ** geom.ndim}-cell "
        "neighbourhood sweep would drop pairs (raise cell_size or reduce "
        "the radius)"
        for b in leaves if float(b.radius) > float(geom.cell_size)]
    if errors and mode == "error":
        raise ContractError(
            "simulation contracts violated (pass check=\"warn\" or "
            "check=\"off\" to bypass):\n" + "\n".join(errors))
    for e in errors:
        warnings.warn(f"simcheck contract: {e}", stacklevel=3)
    return errors


@dataclasses.dataclass
class Operation:
    """One scheduled operation: ``fn(sim)`` every ``every`` iterations.
    ``pre`` operations run before the step on ticks with
    ``tick % every == 0``, post operations after it on ticks with
    ``(tick + 1) % every == 0``.  (The reference keeps this class in
    ``core/operations.py``, whose reducers are ported; the class moves
    there with ROADMAP A6.)"""

    fn: Callable[[Any], Any]
    every: int = 1
    name: str = ""
    pre: bool = False
    record: bool = True

    def due(self, tick: int) -> bool:
        if self.every <= 0:
            return False
        return (tick % self.every == 0) if self.pre \
            else ((tick + 1) % self.every == 0)


class Simulation:
    """Owner of engine, state, step function and scheduled operations.

    Args:
      geom: a :class:`Domain`, or a dict of Domain kwargs (defaults:
        ``cell_size=2.0, interior=(8, 8), mesh_shape=(1, 1), cap=24,
        boundary="closed"``).
      behaviors: one :class:`Behavior`, or a sequence of them, composed.
      mesh: ``None`` (the virtual mesh in this process), or a
        ``DeviceMesh`` of one process a device whose shape is the
        Domain's ``mesh_shape``.
      delta: a :class:`DeltaConfig`, or ``None`` (full refresh every
        step; ``sims.common.resolve_delta`` turns the int8 codec on for
        meshes).  With the codec on, the aura exchange is a full refresh
        every ``refresh_interval`` ticks and after any step that clipped
        under a fixed scale, and delta-encoded in between.
      dt: integration step.
      sweep_backend: ``"auto" | "reference" | "tiled" | "kernel"``;
        ``"auto"`` is the CUDA kernel on the card, the tiled sweep on the
        CPU.
      overlap: ``"auto"`` and ``"off"`` run the monolithic sweep (the
        virtual mesh has no wire to hide), ``"on"`` the interior/boundary
        split (bit-equal at every owned cell).
      check: stencil-soundness gate, ``"error"`` | ``"warn"`` | ``"off"``.
      device: ``"cuda"`` (default; raises without a GPU) or ``"cpu"``.
    """

    def __init__(self, geom: Union[Domain, Dict[str, Any]],
                 behaviors: Union[Behavior, Sequence[Behavior]], *,
                 mesh=None, delta: Optional[DeltaConfig] = None,
                 dt: float = 1.0, rebalance=None, checkpoint=None,
                 sweep_backend: str = "auto", overlap: str = "auto",
                 check: str = "error", guards=None, device="cuda"):
        _unported("rebalance", rebalance, "A8")
        _unported("checkpoint", checkpoint, "A6")
        _unported("guards", guards, "A9")
        if isinstance(geom, dict):
            geom = Domain(**{**_GEOM_DEFAULTS, **geom})
        if isinstance(behaviors, Behavior):
            behavior = behaviors
        else:
            behs = tuple(behaviors)
            behavior = behs[0] if len(behs) == 1 else compose(*behs)
        self.engine: Engine = Engine(
            geom=geom, behavior=behavior,
            delta_cfg=delta or DeltaConfig(enabled=False), dt=dt,
            sweep_backend=sweep_backend, overlap=overlap, device=device)
        check_stencil(geom, behavior, check)
        self._mesh = mesh
        # the process comm: collective host reads and SumOverAllRanks
        self._comm = None if mesh is None else self.engine._comm(mesh)
        if mesh is not None and mesh.device_type != self.engine.device.type:
            raise ValueError(
                f"a {mesh.device_type} mesh for an engine on "
                f"{self.engine.device}")
        self.state: Optional[SimState] = None
        self.series: Dict[str, List[Any]] = {}
        self._step_fn: Optional[Callable] = None   # set -> per-step loop
        self._seg_fn: Optional[Callable] = None    # segment runner
        self._ticks = 0          # step counter across run() calls
        self._force_full = False  # next aura exchange must be a full refresh
        self._ops: List[Operation] = []

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    @property
    def geom(self) -> Domain:
        return self.engine.geom

    @property
    def behavior(self) -> Behavior:
        return self.engine.behavior

    @property
    def mesh(self):
        """The live process mesh (None on the virtual mesh)."""
        return self._mesh

    @property
    def iteration(self) -> int:
        """The engine iteration counter."""
        if self.state is None:
            return 0
        return int(self.state.it.max())

    def n_agents(self) -> int:
        """Live agents of every device of the mesh."""
        return total_agents(self.state, self._comm)

    def sum_over_all_ranks(self, x):
        """The paper's ``SumOverAllRanks`` (section 3.4): ``x`` (a tensor
        reduced over this process's state) summed over every process of
        the mesh; ``x`` itself on the virtual mesh, whose state holds
        every device."""
        return x if self._comm is None else self._comm.sum_over_all_ranks(x)

    # ------------------------------------------------------------------
    # Setup
    # ------------------------------------------------------------------
    def init(self, positions: np.ndarray, attrs: Dict[str, np.ndarray],
             seed: int = 0) -> "Simulation":
        """Engine.init_state through the facade; returns self.  On a
        process mesh every rank passes the same full ``positions`` and
        keeps its own device's agents."""
        self.state = self.engine.init_state(positions, attrs, seed=seed,
                                            mesh=self._mesh)
        self._step_fn = None
        self._seg_fn = None
        return self

    def every(self, n: int, op: Callable, *, name: Optional[str] = None,
              pre: bool = False, record: bool = True) -> "Simulation":
        """Schedule ``op(sim)`` every ``n`` iterations; non-None results
        are appended to ``self.series[name]``.  Returns self."""
        self._ops.append(Operation(
            fn=op, every=n, pre=pre, record=record,
            name=name or getattr(op, "__name__", f"op{len(self._ops)}")))
        return self

    # ------------------------------------------------------------------
    # Running
    # ------------------------------------------------------------------
    def _fused_span(self, tick: int, remaining: int, ops) -> int:
        """Longest segment starting at ``tick`` with no scheduled
        operation due inside it and no delta full-refresh tick past its
        first step."""
        delta = self.engine.delta_cfg
        r = max(int(delta.refresh_interval), 1)
        n = 1
        while n < remaining:
            t = tick + n
            if any(op.pre and op.due(t) for op in ops):
                break
            if any((not op.pre) and op.due(t - 1) for op in ops):
                break
            if delta.enabled and t % r == 0:
                break
            n += 1
        return n

    def run(self, steps: int,
            collect: Optional[Callable[[SimState], Any]] = None,
            fused: bool = True, fault_plan=None,
            supervised=None) -> "Simulation":
        """Drive ``steps`` iterations: scheduled pre-ops, the step, then
        scheduled post-ops.  Steps between operations run as one segment
        (``fused=True``) or one step call each (``fused=False``); both give
        the same state.  ``collect(state)`` records under ``"collect"``
        every step.  Returns self."""
        if self.state is None:
            raise RuntimeError("Simulation.run() before init(): call "
                               "sim.init(positions, attrs) first")
        _unported("fault plans", fault_plan, "A9")
        _unported("supervised runs", supervised, "A9")
        ops = list(self._ops)
        if collect is not None:
            ops.append(Operation(fn=lambda sim: collect(sim.state),
                                 every=1, name="collect"))
        per_step = (self._step_fn is not None) or not fused
        if per_step and self._step_fn is None:
            self._step_fn = self.engine.make_local_step(self._mesh)
        if not per_step and self._seg_fn is None:
            self._seg_fn = self.engine.make_segment_runner(self._mesh)
        delta = self.engine.delta_cfg
        refresh = max(int(delta.refresh_interval), 1)
        # Fixed-scale codec clip fallback (see Engine.drive): when any
        # device's cumulative clipped-delta count grows, force the next
        # aura exchange to a full refresh (on a process mesh the count is
        # every rank's, so all ranks refresh together).
        track_clip = delta.enabled and delta.scale is not None
        clip_mark = codec_overflow_count(self.state, self._comm) \
            if track_clip else 0

        done = 0
        while done < int(steps):
            tick = self._ticks
            for op in ops:
                if op.pre and op.due(tick):
                    self._run_op(op)
            n = 1 if per_step else self._fused_span(
                tick, int(steps) - done, ops)
            full = (self._force_full or not delta.enabled
                    or tick % refresh == 0)
            self._force_full = False
            if per_step:
                self.state = self._step_fn(self.state, full_halo=full)
            else:
                self.state = self._seg_fn(self.state, n, full_first=full)
            if track_clip:
                cnt = codec_overflow_count(self.state, self._comm)
                if cnt > clip_mark:
                    self._force_full = True
                    clip_mark = cnt
            for t in range(tick, tick + n):
                for op in ops:
                    if not op.pre and op.due(t):
                        self._run_op(op)
            self._ticks += n
            done += n
        return self

    def _run_op(self, op: Operation) -> None:
        value = op.fn(self)
        if op.record and value is not None:
            self.series.setdefault(op.name, []).append(value)

    def step(self) -> "Simulation":
        """Single iteration through the full scheduled pipeline."""
        return self.run(1)
