"""Supervised runs (port of ``repro/launch/supervise.py``): periodic
verified checkpoints and automatic rollback.

The supervisor turns the resilience pieces into one loop: the runtime
guards (``core.guards``) detect corruption at the control points,
checksummed logical ABM checkpoints (``distributed.checkpoint``) bound
the blast radius, and the elastic restore (``distributed.elastic``)
re-cuts the domain onto the devices that survive::

    RUN --chunk ok--> CHECKPOINT --> RUN ...
     |
     +--guard trip / exception--> RECOVER
            |  retries exhausted --> raise
            +- wait for the in-flight save, optional backoff, elastic
               restore from the newest VERIFIED checkpoint (torn ones
               skipped) onto the surviving device count, the run's
               ownership mode inherited --> RUN (a replay; fire-once
               fault plans keep it clean)

Recovery resets the facade as ``Simulation.restore`` does (fresh steps,
the operation clock at zero, a full first exchange), so a recovered run
is bit-exact with an uninterrupted run resumed from the same checkpoint.
Every transition lands in ``Supervisor.log``.

Devices: the virtual mesh recovers onto the run's own device count (the
reference's ``min(n_devices, len(jax.devices()))``: the whole mesh lives
on the card), or onto a :class:`~repro_torch.distributed.chaos.
DeviceLost`'s survivors.  A process mesh (one process a device) recovers
onto the same ranks, or on a device loss onto the ranks of the devices
the reference keeps (``launch.mesh.survivor_ranks``): every rank, having
raised the same ``DeviceLost`` at the same control point, loads the
restore plan, and the survivors build their mesh in its shape, with a
group of their own (``launch.mesh.make_abm_mesh(ranks=...)``).  The
others log the recovery the survivors log, with ``left=True``, and stop
(``Supervisor.left``; their ``run`` returns).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from repro_torch.distributed import checkpoint as ckpt_lib
from repro_torch.distributed.chaos import DeviceLost


@dataclasses.dataclass(frozen=True)
class Supervised:
    """Supervision policy of ``Simulation.run(supervised=...)``:
    checkpoint directory, cadence (``every``) and retention (``keep``);
    ``max_retries`` consecutive failed recoveries (reset by any chunk that
    completes); ``backoff_s`` the base of an exponential backoff between
    retries (0: none); ``async_save`` overlaps a save's disk write with
    the next chunk (one process only: a process mesh saves in step);
    ``degrade`` allows restoring onto fewer devices after a device loss
    (False re-raises the :class:`DeviceLost`)."""

    dir: str
    every: int = 10
    keep: int = 5
    max_retries: int = 3
    backoff_s: float = 0.0
    async_save: bool = True
    degrade: bool = True


class Supervisor:
    """The RUN / CHECKPOINT / RECOVER loop around one
    :class:`~repro_torch.core.simulation.Simulation`.  Construction gates
    the ``supervised-recovery`` contract (``analysis.contracts.
    check_supervision``) at the simulation's ``check`` mode."""

    def __init__(self, sim, cfg: Supervised, fault_plan=None):
        from repro_torch.analysis.contracts import (
            check_supervision, enforce_diagnostics,
        )
        self.sim = sim
        self.cfg = cfg
        self.fault_plan = fault_plan
        self.log: List[Dict] = []
        self.left = False     # this rank's device was lost (a degrade)
        enforce_diagnostics(check_supervision(sim.engine, cfg),
                            mode=getattr(sim, "_check", "error"))
        self.ckptr = ckpt_lib.AsyncCheckpointer(cfg.dir, keep=cfg.keep)
        if self.ckptr.swept:
            self._event("swept_stale_tmp", paths=list(self.ckptr.swept))

    # ------------------------------------------------------------------
    def _event(self, kind: str, **kw) -> None:
        self.log.append({"kind": kind, "wall_time": time.time(), **kw})

    def events(self, kind: str) -> List[Dict]:
        return [e for e in self.log if e["kind"] == kind]

    def _comm(self):
        """The process mesh's comm of this rank (None on one process)."""
        sim = self.sim
        return None if sim.mesh is None else sim.engine._comm(sim.mesh)

    # ------------------------------------------------------------------
    def _save(self) -> None:
        sim = self.sim
        it = sim.iteration
        mesh = sim.mesh
        t0 = time.perf_counter()
        if mesh is None and self.cfg.async_save:
            self.ckptr.save_abm(it, sim.engine, sim.state)
        else:
            ckpt_lib.save_abm(self.cfg.dir, it, sim.engine, sim.state,
                              keep=self.cfg.keep, mesh=mesh)
        self._event("checkpoint", step=it,
                    seconds=time.perf_counter() - t0)
        if self.fault_plan is not None:
            # a torn-write fault needs bytes on disk before it can tear
            self.ckptr.wait()
            comm = self._comm()
            # on a process mesh the group's rank 0 tears, as it wrote
            torn = self.fault_plan.maybe_tear(
                self.cfg.dir, it, tear=comm is None or int(
                    comm.ranks[comm.mesh_coords]) == comm.global_rank(0))
            if comm is not None:
                comm.barrier()   # no rank reads before rank 0 tore
            if torn:
                self._event("torn_checkpoint", path=torn)

    def _recover(self, err: BaseException, retry: int) -> None:
        from repro_torch.core.reshard import process_mesh
        from repro_torch.distributed.elastic import (
            elastic_restore_abm, restore_plan,
        )

        sim = self.sim
        mesh = sim.mesh
        failed_at = sim.iteration
        t0 = time.perf_counter()
        try:
            self.ckptr.wait()  # surface an in-flight write failure too
        except Exception as werr:  # noqa: BLE001 - logged, not fatal
            self._event("checkpoint_write_failed", error=repr(werr))
        survivors: Optional[int] = getattr(err, "survivors", None)
        if survivors is not None and not self.cfg.degrade:
            raise err
        n = survivors if survivors is not None \
            else sim.engine.geom.n_devices
        if self.cfg.backoff_s > 0:
            time.sleep(self.cfg.backoff_s * 2 ** (retry - 1))
        plan = restore_plan(self.cfg.dir, n)   # ownership: the checkpoint's
        if mesh is not None and n < sim.engine.geom.n_devices:
            from repro_torch.launch.mesh import make_abm_mesh, survivor_ranks
            mesh = make_abm_mesh(plan.geom.mesh_shape,
                                 device_type=mesh.device_type,
                                 ranks=survivor_ranks(mesh, n))
            if mesh.get_coordinate() is None:   # this rank's device is lost
                self.left = True
                self._recovered(err, failed_at, plan.step, n, retry, t0,
                                left=True)
                return
        engine0, state, step_ = elastic_restore_abm(
            self.cfg.dir, sim.behavior, n_devices=n,
            delta_cfg=sim.engine.delta_cfg, dt=sim.engine.dt,
            mesh=mesh, device=sim.engine.device, plan=plan)
        # keep the run's knobs (guards, sweep backend, overlap): only the
        # geometry comes from the re-cut restore plan
        engine = dataclasses.replace(sim.engine, geom=engine0.geom)
        if mesh is not None:
            sim._mesh = process_mesh(engine.geom.mesh_shape, mesh)
        sim.with_state(engine, state)
        # reset the facade as Simulation.restore does: the operation clock
        # restarts at zero, so the replay is bit-exact with an
        # uninterrupted run resumed from this checkpoint
        sim._ticks = 0
        self._recovered(err, failed_at, step_, n, retry, t0)

    def _recovered(self, err, failed_at: int, step_: int, n: int,
                   retry: int, t0: float, **kw) -> None:
        self._event(
            "recovered", error=repr(err), error_type=type(err).__name__,
            failed_at=failed_at, rolled_back_to=step_, devices=n,
            retry=retry, replay_steps=failed_at - step_,
            seconds=time.perf_counter() - t0, **kw)

    # ------------------------------------------------------------------
    def run(self, steps: int, fused: bool = True):
        """Supervise ``steps`` iterations; returns the simulation."""
        sim = self.sim
        cfg = self.cfg
        target = sim.iteration + int(steps)
        if ckpt_lib.latest_step(cfg.dir) is None:
            self._save()  # a rollback target must exist before step one
        retries = 0
        while True:
            it = sim.iteration
            if it >= target:
                break
            chunk = min(cfg.every - (it % cfg.every), target - it)
            try:
                sim.run(chunk, fused=fused, fault_plan=self.fault_plan)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as err:  # noqa: BLE001 - bounded retry below
                retries += 1
                self._event("fault", error=repr(err),
                            error_type=type(err).__name__,
                            iteration=sim.iteration, retry=retries)
                if retries > cfg.max_retries:
                    self._event("giving_up", retries=retries)
                    raise
                if isinstance(err, DeviceLost) and not cfg.degrade:
                    self._event("giving_up", retries=retries,
                                reason="degrade disabled")
                    raise
                self._recover(err, retries)
                if self.left:
                    return sim
            else:
                retries = 0
                if sim.iteration % cfg.every == 0 or sim.iteration >= target:
                    self._save()
        self.ckptr.wait()
        self._event("completed", iteration=sim.iteration)
        return sim
