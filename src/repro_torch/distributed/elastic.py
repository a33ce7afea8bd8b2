"""Elastic restore (port of ``repro/distributed/elastic.py``): the
language-model half and the ABM half.

:func:`choose_lm_mesh` is the reference's largest ``(data, model)``
factorization of a (possibly degraded) device count, and
:func:`elastic_restore` restores a logical LM checkpoint onto the current
process mesh: every rank reads the whole arrays and keeps its blocks.

A logical ABM checkpoint (``checkpoint.save_abm``) holds mesh-independent
flattened agents and the occupancy histogram.  :func:`elastic_restore_abm`
cuts a fresh plan for the current device count from that histogram with
the load-balance planners, re-derives the :class:`Domain` and
re-initialises through ``Engine.init_state`` with the carry, the mid-run
re-shard's own path: a run resumes on whatever device count survives.
:func:`restore_plan` loads a checkpoint and cuts that plan alone, so every
rank of a process mesh can learn the survivors' mesh shape before the
ranks that leave stop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import checkpoint as ckpt_lib


def choose_lm_mesh(n_devices: int, model_parallel: int = 16
                   ) -> Tuple[Tuple[int, int], Tuple[str, str]]:
    """Largest (data, model) factorization for a (possibly degraded) device
    count: keep model parallelism at ``model_parallel`` if it divides, else
    fall back to the largest power-of-two divisor."""
    mp = model_parallel
    while mp > 1 and n_devices % mp:
        mp //= 2
    return (n_devices // mp, mp), ("data", "model")


def elastic_restore(ckpt_dir: str, model, *, n_devices: Optional[int] = None,
                    rules=None, step: Optional[int] = None,
                    device="cuda"):
    """Restore a logical checkpoint of the parameters onto the current
    device population: ``choose_lm_mesh`` of ``n_devices`` (default: the
    default group's ranks, 1 without a group), ``launch.mesh.make_mesh``
    over the ranks, and each rank's blocks of every leaf
    (``params_specs``).  Every rank calls it.  Returns ``(step, params,
    mesh, extras)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import params_specs
    from repro_torch.models.params import tree_map

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a restore onto {n} devices from {world} "
                         "processes: one process a device")
    shape, axes = choose_lm_mesh(n)
    mesh = make_mesh(shape, axes, device)
    abstract = params_specs(model, mesh, rules)
    shardings = tree_map(lambda a: a.sharding, abstract)
    step, params, extras = ckpt_lib.restore(
        ckpt_dir, step=step, like=abstract, shardings=shardings,
        device=mesh.device)
    return step, params, mesh, extras


@dataclasses.dataclass(frozen=True)
class RestorePlan:
    """A loaded checkpoint and the geometry a restore re-cuts it onto:
    its step, its leaves, its ``abm`` metadata and the plan's
    :class:`~repro_torch.core.domain.Domain`."""
    step: int
    flat: Dict[str, Any]
    meta: Dict[str, Any]
    geom: Any


def restore_plan(ckpt_dir: str, n_devices: int,
                 step: Optional[int] = None,
                 ownership: Optional[str] = None) -> RestorePlan:
    """Load the newest verified checkpoint (or ``step``) and cut its plan
    for ``n_devices``: the least imbalanced equal-split factorization for
    ``ownership="equal"``, a box-granular uneven rectilinear partition
    for ``"rcb"``; ``None`` keeps the checkpointed run's mode."""
    from repro_torch.core.domain import Domain
    from repro_torch.core.load_balance import choose_partition

    step_, flat, extras = ckpt_lib.restore(ckpt_dir, step=step)
    meta = extras["abm"]
    hist = np.asarray(flat["histogram"])
    if ownership is None:
        ownership = meta.get("ownership", "equal")
    global_cells = tuple(meta["global_cells"])
    boundary = meta["boundary"]   # str (older checkpoints) or per axis
    geom_kw = dict(
        cell_size=meta["cell_size"],
        cap=meta["cap"],
        boundary=boundary if isinstance(boundary, str) else tuple(boundary),
        box_factor=meta["box_factor"],
    )
    if ownership == "rcb":
        plan = choose_partition(hist, n_devices, ownership="rcb")
        part = plan.partition.scale(meta["box_factor"])
        geom = Domain(interior=part.max_widths, mesh_shape=part.mesh_shape,
                      partition=part, **geom_kw)
    else:
        mesh_shape = choose_partition(hist, n_devices,
                                      ownership="equal").mesh_shape
        geom = Domain(
            interior=tuple(g // m for g, m in zip(global_cells, mesh_shape)),
            mesh_shape=mesh_shape, **geom_kw)
    return RestorePlan(step=step_, flat=flat, meta=meta, geom=geom)


def elastic_restore_abm(ckpt_dir: str, behavior, *,
                        n_devices: Optional[int] = None,
                        step: Optional[int] = None,
                        delta_cfg=None, dt: Optional[float] = None,
                        rebalance_every: int = 0,
                        imbalance_threshold: float = 0.5,
                        ownership: Optional[str] = None,
                        mesh=None, device="cuda",
                        plan: Optional[RestorePlan] = None):
    """Restore an ABM checkpoint onto the current device population.

    ``choose_partition`` cuts a fresh plan for ``n_devices`` (default: one
    device, or the process ``mesh``'s size) over the stored histogram: the
    least imbalanced equal-split factorization for ``ownership="equal"``,
    a box-granular uneven rectilinear partition for ``"rcb"``; ``None``
    keeps the checkpointed run's mode.  The stored codec config is
    re-applied unless ``delta_cfg`` is given.  Global agent ids, the spawn
    counters' floors, the iteration counter, the RNG lineage and the
    cumulative drops carry over.

    With a process ``mesh`` every rank calls this and bins only its own
    block; the plan's mesh shape may differ from ``mesh``'s (the state's
    mesh is then ``core.reshard.process_mesh(engine.geom.mesh_shape,
    mesh)``).  ``plan`` (:func:`restore_plan`, for ``n_devices``) spares
    a caller that has loaded it already a second read.  Returns
    ``(engine, state, step)``."""
    from repro_torch.core.delta import DeltaConfig
    from repro_torch.core.engine import Engine
    from repro_torch.core.reshard import _add_dropped, process_mesh

    if n_devices is None:
        n_devices = 1 if mesh is None else int(mesh.mesh.numel())
    if plan is None:
        plan = restore_plan(ckpt_dir, n_devices, step=step,
                            ownership=ownership)
    step_, flat, meta, geom = plan.step, plan.flat, plan.meta, plan.geom
    if delta_cfg is None:
        # the quantized closed loop is part of the dynamics: a replay
        # restores with the checkpointed codec (none stored: codec off)
        dmeta = meta.get("delta")
        if dmeta is not None:
            delta_cfg = DeltaConfig(
                enabled=bool(dmeta["enabled"]),
                qdtype=getattr(torch, dmeta["qdtype"]),
                refresh_interval=int(dmeta["refresh_interval"]),
                scale=dmeta["scale"])
    engine = Engine(
        geom=geom, behavior=behavior,
        delta_cfg=delta_cfg or DeltaConfig(enabled=False),
        dt=meta["dt"] if dt is None else dt,
        rebalance_every=rebalance_every,
        imbalance_threshold=imbalance_threshold, device=device)
    if mesh is not None:
        mesh = process_mesh(geom.mesh_shape, mesh)
    attrs = {k.split("/", 1)[1]: v for k, v in flat.items()
             if k.startswith("attrs/")}
    state = engine.init_state(
        flat["positions"], attrs, gid_counters=flat["gid_counters"],
        it0=meta["it"], base_key=flat["base_key"], mesh=mesh)
    _add_dropped(state, int(meta["dropped_total"]),
                 None if mesh is None else engine._comm(mesh))
    return engine, state, step_
