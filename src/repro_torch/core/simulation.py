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
are global.  ``rebalance=`` (a :class:`Rebalance`) runs the dynamic load
balancer (``core.reshard``) as a scheduled operation: a re-shard swaps the
facade's engine, state, step and process mesh in place, so ``sim.engine``
and ``sim.state`` always match.  ``checkpoint=`` saves
logical ABM checkpoints (``distributed.checkpoint.save_abm``), and
:meth:`Simulation.restore` restores one onto any device count.
``guards=`` turns on the runtime health guards (``core.guards``), read at
the facade's control points; ``run(fault_plan=)`` injects a
``distributed.chaos.FaultPlan``'s faults, and ``run(supervised=)`` hands
the run to ``launch.supervise.Supervisor`` (periodic verified checkpoints,
rollback on a guard trip or an exception).  A list of several behaviours
is composed (:func:`~repro_torch.core.behaviors.compose`), as the
reference does.  Construction runs the whole static contract suite
(``analysis.contracts.enforce``: partition validity, stencil soundness,
one-hop migration, codec headroom) and a re-shard runs it again on the new
geometry; :meth:`Simulation.validate` runs the suite with the hot-path
lint and the step audit (``analysis.step_audit``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.analysis.contracts import ContractError, enforce
from repro_torch.core.behaviors import Behavior, compose
from repro_torch.core.delta import DeltaConfig
from repro_torch.core.domain import Domain
from repro_torch.core.engine import (
    Engine, SimState, codec_overflow_count, total_agents,
)
from repro_torch.core.guards import GuardConfig, check_health, health_counts
from repro_torch.core.operations import Operation, checkpoint_op
from repro_torch.core.reshard import Rebalancer, estimate_device_runtimes

__all__ = ["Checkpoint", "ContractError", "Rebalance", "Simulation"]

# Geometry defaults applied when the first argument is a kwargs dict.
_GEOM_DEFAULTS = dict(cell_size=2.0, interior=(8, 8), mesh_shape=(1, 1),
                      cap=24, boundary="closed")


@dataclasses.dataclass(frozen=True)
class Rebalance:
    """Dynamic load balancing policy of the facade (paper section 2.4.5).

    ``weighted=True`` feeds ``Rebalancer.runtimes`` from a measurement:
    the facade times the step right before each due tick (host clock,
    after a device synchronise; on a process mesh the slowest rank's) and
    splits it per device by measured pair work
    (``reshard.estimate_device_runtimes``); weighted checks wait for a
    measurement, so the first runs at iteration ``every``.
    ``ownership``: ``"equal"`` (equal-split meshes) or ``"rcb"``
    (box-granular uneven partitions).  ``transport``: the migration path
    of an applied re-shard (``"auto"``, ``"host"``, ``"device"``).
    ``defer=True`` plans one step after the snapshot (see
    ``Rebalancer``)."""

    every: int = 10
    threshold: float = 0.5
    min_gain: float = 1.5
    weighted: bool = False
    ownership: str = "equal"
    transport: str = "auto"
    defer: bool = False


@dataclasses.dataclass
class _RebalanceOp(Operation):
    """The scheduled rebalance check.  With a deferred plan pending it is
    due on every tick, so the plan lands one step after its snapshot and
    the segment scheduler breaks there."""

    rb: Optional[Rebalancer] = None

    def due(self, tick: int) -> bool:
        if self.rb is not None and self.rb.pending:
            return True
        return super().due(tick)


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    """Scheduled logical ABM checkpoints (``checkpoint.save_abm``), each
    restorable onto any device count (:meth:`Simulation.restore`)."""

    dir: str
    every: int = 100
    keep: int = 3


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
      rebalance: a :class:`Rebalance`, an int shorthand for
        ``Rebalance(every=n)``, or None.
      checkpoint: a :class:`Checkpoint`, a directory shorthand for
        ``Checkpoint(dir)``, or None.
      check: the construction-time contract gate
        (``analysis.contracts.enforce``), ``"error"`` (raise
        :class:`ContractError` on any error finding) | ``"warn"`` |
        ``"off"``; re-run on the new geometry after every re-shard.
      guards: the runtime health guards, a :class:`~repro_torch.core.
        guards.GuardConfig`, a policy string (``"warn"`` | ``"error"``)
        or None (off: the step computes none of them).  Read at the same
        control points as the codec's overflow word; under ``"error"`` a
        trip raises ``HealthError``, which a supervised run rolls back on.
      device: ``"cuda"`` (default; raises without a GPU) or ``"cpu"``.
    """

    def __init__(self, geom: Union[Domain, Dict[str, Any]],
                 behaviors: Union[Behavior, Sequence[Behavior]], *,
                 mesh=None, delta: Optional[DeltaConfig] = None,
                 dt: float = 1.0, rebalance=None, checkpoint=None,
                 sweep_backend: str = "auto", overlap: str = "auto",
                 check: str = "error",
                 guards: Union[GuardConfig, str, None] = None,
                 device="cuda"):
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
            sweep_backend=sweep_backend, overlap=overlap, guards=guards,
            device=device)
        enforce(self.engine, mode=check, mesh=mesh)
        self._check = check
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
        self._last_step_s: Optional[float] = None  # weighted-rebalance sample
        self._ops: List[Operation] = []

        if isinstance(rebalance, int):
            rebalance = Rebalance(every=rebalance)
        self._weighted = bool(rebalance and rebalance.weighted)
        self.rebalancer: Optional[Rebalancer] = None
        if rebalance is not None and rebalance.every > 0:
            self.rebalancer = Rebalancer(
                every=rebalance.every, threshold=rebalance.threshold,
                min_gain=rebalance.min_gain, ownership=rebalance.ownership,
                transport=rebalance.transport, defer=rebalance.defer,
                mesh=mesh)
            self._ops.append(_RebalanceOp(
                fn=Simulation._maybe_rebalance, every=rebalance.every,
                name="rebalance", pre=True, record=False,
                rb=self.rebalancer))

        if isinstance(checkpoint, str):
            checkpoint = Checkpoint(dir=checkpoint)
        if checkpoint is not None:
            self._ops.append(Operation(
                fn=checkpoint_op(checkpoint.dir, keep=checkpoint.keep),
                every=checkpoint.every, name="checkpoint", record=False))

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
        """The live process mesh (None on the virtual mesh); after a
        re-shard that changed the mesh's shape, the new one."""
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

    def validate(self, *, jaxpr: bool = True):
        """The full check suite over this simulation: the static contracts
        (stencil soundness, one-hop migration, aura sufficiency, codec
        headroom, partition validity), the hot-path lint of every leaf
        behaviour function and - unless ``jaxpr=False`` - the step audit
        (``analysis.step_audit``: shift edge lists, host syncs, dtype
        drift, narrow integer arithmetic, cache-key stability).  The
        keyword keeps the reference's name, so callers port unchanged; an
        eager engine has no jaxpr, and it now selects the step audit,
        which runs one full-refresh step (and, with the codec on, one
        delta step) of a seeded probe population on the engine's device.
        ``sim.state`` is not touched.  On a process mesh every rank calls
        it and audits its own step and edges.  Returns an
        ``analysis.Report``."""
        from repro_torch.analysis import (
            Report, audit_engine, check_engine, lint_behavior,
        )
        rep = Report()
        rep.extend(check_engine(self.engine, self._mesh))
        rep.extend(lint_behavior(self.behavior))
        if jaxpr:
            rep.extend(audit_engine(self.engine, self._mesh))
        return rep

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

    def with_state(self, engine: Engine, state: SimState) -> "Simulation":
        """Adopt an existing ``(engine, state)`` pair (e.g. from
        ``elastic.elastic_restore_abm``), keeping the facade's step and
        scheduled operations; the next exchange is a full refresh."""
        self.engine = engine
        self.state = state
        if self._mesh is not None:
            self._comm = engine._comm(self._mesh)
        self._step_fn = None
        self._seg_fn = None
        self._force_full = True
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
    def _maybe_rebalance(self) -> None:
        rb = self.rebalancer
        if self._weighted:
            if self._last_step_s is None:
                # weighted checks run on a fresh measurement only
                return
            rb.runtimes = estimate_device_runtimes(
                self.engine.geom, self.state, self._last_step_s, self._comm)
        eng, state, resharded = rb.maybe_reshard(self.engine, self.state)
        if resharded:
            # the one place a re-shard surfaces: the facade swaps its own
            # engine, state, step and mesh (the old state is freed here)
            self.engine, self.state = eng, state
            self._mesh = rb.mesh
            self._comm = None if rb.mesh is None else eng._comm(rb.mesh)
            self._step_fn = self.engine.make_local_step(self._mesh) \
                if self._step_fn else None
            self._seg_fn = None
            self._force_full = True
            # a narrower uneven slab can break the one-hop contract
            # mid-run: gate the new geometry at the caller's mode
            enforce(self.engine, mode=self._check, mesh=self._mesh)

    def _fused_span(self, tick: int, remaining: int, ops) -> int:
        """Longest segment starting at ``tick`` with no scheduled
        operation due inside it, no delta full-refresh tick past its
        first step, and no weighted-rebalance timing sample (which needs
        a step of its own)."""
        delta = self.engine.delta_cfg
        r = max(int(delta.refresh_interval), 1)
        rb = self.rebalancer
        weighted = self._weighted and rb is not None
        if weighted and rb.due(tick + 1):
            return 1  # this step is the timing sample: run it alone
        n = 1
        while n < remaining:
            t = tick + n
            if any(op.pre and op.due(t) for op in ops):
                break
            if any((not op.pre) and op.due(t - 1) for op in ops):
                break
            if delta.enabled and t % r == 0:
                break
            if weighted and rb.due(t + 1):
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
        every step.  Returns self.

        ``fault_plan`` (``distributed.chaos.FaultPlan``) fires its faults
        at their absolute iterations; segments end at pending fault
        steps.  ``supervised`` (a ``launch.supervise.Supervised``, or a
        checkpoint directory) hands the whole run to the supervisor:
        periodic verified checkpoints, and rollback with retries when a
        guard trips or the run raises."""
        if self.state is None:
            raise RuntimeError("Simulation.run() before init(): call "
                               "sim.init(positions, attrs) first")
        if supervised is not None:
            from repro_torch.launch.supervise import Supervised, Supervisor
            if isinstance(supervised, str):
                supervised = Supervised(dir=supervised)
            if collect is not None:
                raise ValueError(
                    "collect= is not supported under supervised runs "
                    "(a rollback would double-record); use scheduled "
                    "ops via sim.every(...)")
            Supervisor(self, supervised, fault_plan=fault_plan).run(
                int(steps), fused=fused)
            return self
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
        rb = self.rebalancer
        # Fixed-scale codec clip fallback (see Engine.drive): when any
        # device's cumulative clipped-delta count grows, force the next
        # aura exchange to a full refresh (on a process mesh the count is
        # every rank's, so all ranks refresh together).
        track_clip = delta.enabled and delta.scale is not None
        clip_mark = codec_overflow_count(self.state, self._comm) \
            if track_clip else 0
        # The health word is read at the same control points (a re-shard
        # or a restore resets it: the mark follows it down), before the
        # post-ops, so a scheduled checkpoint never captures a state a
        # guard just flagged.
        track_health = self.engine.guards.enabled
        hmark = health_counts(self.state, self._comm) \
            if track_health else None
        it0 = self.iteration if fault_plan is not None else 0

        done = 0
        while done < int(steps):
            tick = self._ticks
            for op in ops:
                if op.pre and op.due(tick):
                    self._run_op(op)
            if not per_step and self._seg_fn is None:
                # a pre-op re-sharded
                self._seg_fn = self.engine.make_segment_runner(self._mesh)
            if fault_plan is not None:
                self.state, fired = fault_plan.fire(
                    self.engine, self.state, it0 + done, comm=self._comm)
                if fired:
                    self._force_full = True
            n = 1 if per_step else self._fused_span(
                tick, int(steps) - done, ops)
            if fault_plan is not None and not per_step:
                nf = fault_plan.next_step(after=it0 + done)
                if nf is not None:
                    n = max(1, min(n, nf - (it0 + done)))
            full = (self._force_full or not delta.enabled
                    or tick % refresh == 0)
            self._force_full = False
            # time the step right before a weighted rebalance check, so
            # its runtimes signal is one step fresh
            sample = (self._weighted and rb is not None and n == 1
                      and rb.due(tick + 1))
            t0 = time.perf_counter() if sample else 0.0
            if per_step:
                self.state = self._step_fn(self.state, full_halo=full)
            else:
                self.state = self._seg_fn(self.state, n, full_first=full)
            if sample:
                if self.state.soa.valid.is_cuda:
                    torch.cuda.synchronize(self.state.soa.valid.device)
                wall = time.perf_counter() - t0
                if self._comm is not None:
                    # every rank must plan from the same histogram
                    wall = float(self._comm.max_over_all_ranks(
                        torch.tensor(wall, dtype=torch.float64)))
                self._last_step_s = wall
            if track_clip:
                cnt = codec_overflow_count(self.state, self._comm)
                if cnt > clip_mark:
                    self._force_full = True
                    clip_mark = cnt
            if track_health:
                hmark, _ = check_health(self.engine.guards, self.state,
                                        hmark, comm=self._comm)
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

    # ------------------------------------------------------------------
    # Checkpointing (on demand; scheduled saves go through Checkpoint)
    # ------------------------------------------------------------------
    def save(self, ckpt_dir: str, keep: int = 3) -> str:
        """One logical ABM checkpoint of the current engine and state (on
        a process mesh every rank calls it; rank 0 writes)."""
        from repro_torch.distributed.checkpoint import save_abm
        return save_abm(ckpt_dir, self.iteration, self.engine, self.state,
                        keep=keep, mesh=self._mesh)

    @classmethod
    def restore(cls, ckpt_dir: str,
                behaviors: Union[Behavior, Sequence[Behavior]], *,
                step: Optional[int] = None,
                n_devices: Optional[int] = None,
                delta: Optional[DeltaConfig] = None,
                dt: Optional[float] = None,
                rebalance: Union[Rebalance, int, None] = None,
                checkpoint: Union[Checkpoint, str, None] = None,
                ownership: Optional[str] = None,
                check: str = "error",
                guards: Union[GuardConfig, str, None] = None, mesh=None,
                device="cuda") -> "Simulation":
        """Elastic restore: a facade rebuilt from a logical checkpoint onto
        ``n_devices`` (default: one device, or the process ``mesh``'s
        size; on the virtual mesh any count).  ``ownership`` selects how
        the count is cut (``"equal"`` | ``"rcb"``); None keeps the
        checkpointed run's mode.  With a process ``mesh`` every rank calls
        it and holds its own block (``sim.mesh`` is the plan's shape)."""
        from repro_torch.core.reshard import process_mesh
        from repro_torch.distributed.elastic import elastic_restore_abm

        if not isinstance(behaviors, Behavior):
            behs = tuple(behaviors)
            behaviors = behs[0] if len(behs) == 1 else compose(*behs)
        engine, state, _ = elastic_restore_abm(
            ckpt_dir, behaviors, step=step, n_devices=n_devices,
            delta_cfg=delta, dt=dt, ownership=ownership, mesh=mesh,
            device=device)
        if mesh is not None:
            mesh = process_mesh(engine.geom.mesh_shape, mesh)
        engine = dataclasses.replace(engine, guards=guards)
        sim = cls(engine.geom, behaviors, delta=delta or engine.delta_cfg,
                  dt=engine.dt, rebalance=rebalance, checkpoint=checkpoint,
                  check=check, guards=guards, mesh=mesh, device=device)
        return sim.with_state(engine, state)
