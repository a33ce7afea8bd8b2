"""Shared scaffolding for the benchmark simulations (port of
``repro/sims/common.py``): ``make_sim`` wires the sims' geometry defaults
into the :class:`Simulation` facade.  The former ``make_engine`` /
``run_sim`` pairing survives only as deprecation shims with the one-line
facade equivalent in the warning text, as in the reference."""

from __future__ import annotations

import warnings
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.behaviors import Behavior
from repro_torch.core.delta import DeltaConfig
from repro_torch.core.domain import Domain, Partition
from repro_torch.core.engine import Engine, SimState
from repro_torch.core.simulation import Simulation


def resolve_delta(delta, n_devices: int) -> Optional[DeltaConfig]:
    """Per-sim codec knob -> the facade's ``DeltaConfig``.

    ``None`` (default) turns the int8 delta codec on exactly where a wire
    exists - multi-device meshes - and keeps single-device runs on a full
    refresh.  Shorthands: ``"int8"`` / ``"int16"`` pick the quantized
    payload width; a ``"+mig"`` suffix (``"int8+mig"``) also sends
    emigrant positions through the int16 migration codec;
    ``"full"``/``"off"`` force raw float32 slabs every step.  A
    :class:`DeltaConfig` passes through untouched.
    """
    if delta is None:
        if n_devices <= 1:
            return None
        return DeltaConfig(enabled=True)       # int8, refresh_interval=16
    if isinstance(delta, DeltaConfig):
        return delta
    if isinstance(delta, str):
        if delta in ("off", "full"):
            return DeltaConfig(enabled=False)
        base, _, mig = delta.partition("+")
        if base in ("int8", "int16") and mig in ("", "mig"):
            return DeltaConfig(
                enabled=True,
                qdtype=torch.int8 if base == "int8" else torch.int16,
                migration=torch.int16 if mig else None)
        raise ValueError(
            f"unknown delta quality {delta!r}; expected 'int8', 'int16', "
            "'int8+mig', 'int16+mig', 'full'/'off', a DeltaConfig, or "
            "None (auto)")
    raise TypeError(
        f"delta must be a DeltaConfig, a quality string, or None; "
        f"got {type(delta).__name__}")


def make_sim(
    behaviors,
    *,
    interior: Tuple[int, ...] = (8, 8),
    mesh_shape: Tuple[int, ...] = (1, 1),
    cell_size: float = 2.0,
    cap: int = 24,
    boundary: Union[str, Tuple[str, ...]] = "closed",
    domain: Optional[Domain] = None,
    partition: Optional[Partition] = None,
    delta: Union[DeltaConfig, str, None] = None,
    dt: float = 0.1,
    mesh=None,
    rebalance=None,
    checkpoint=None,
    sweep_backend: str = "auto",
    overlap: str = "auto",
    check: str = "error",
    guards=None,
    device="cuda",
) -> Simulation:
    """Facade builder with the sims' geometry defaults; ``domain=`` wins
    over the individual geometry kwargs.  ``partition=`` starts the run on
    an uneven ownership (cuts in cells): it sets the mesh shape and the
    padded per-device interior, so it overrides ``interior``/
    ``mesh_shape``."""
    if partition is not None:
        if domain is not None:
            raise ValueError("pass either domain= or partition=, not both")
        domain = Domain(
            cell_size=cell_size, interior=partition.max_widths,
            mesh_shape=partition.mesh_shape, cap=cap, boundary=boundary,
            partition=partition)
    geom = domain if domain is not None else Domain(
        cell_size=cell_size, interior=interior, mesh_shape=mesh_shape,
        cap=cap, boundary=boundary)
    return Simulation(
        geom, behaviors, mesh=mesh, delta=resolve_delta(delta, geom.n_devices),
        dt=dt, rebalance=rebalance, checkpoint=checkpoint,
        sweep_backend=sweep_backend, overlap=overlap, check=check,
        guards=guards, device=device)


def init_agents(sim: Simulation, positions: np.ndarray, attrs,
                seed: int = 0) -> Simulation:
    """Initialize a :class:`Simulation` with (positions, attrs)."""
    return sim.init(positions, attrs, seed=seed)


def uniform_positions(rng: np.random.Generator, n: int, geom: Domain,
                      margin: float = 0.5) -> np.ndarray:
    """Uniform positions over the domain interior, any dimensionality."""
    size = geom.domain_size
    lo = [margin] * geom.ndim
    hi = [s - margin for s in size]
    return rng.uniform(lo, hi, size=(n, geom.ndim)).astype(np.float32)


def disk_positions(rng: np.random.Generator, n: int, center, radius
                   ) -> np.ndarray:
    """Uniform positions inside a 2-D disk."""
    th = rng.uniform(0, 2 * np.pi, n)
    r = radius * np.sqrt(rng.uniform(0, 1, n))
    return np.stack([center[0] + r * np.cos(th),
                     center[1] + r * np.sin(th)], axis=1).astype(np.float32)


def ball_positions(rng: np.random.Generator, n: int, center, radius
                   ) -> np.ndarray:
    """Uniform positions inside a 3-D ball (the spheroid seeds)."""
    v = rng.normal(size=(n, 3))
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    r = radius * np.cbrt(rng.uniform(0, 1, n))[:, None]
    return (np.asarray(center)[None, :] + v * r).astype(np.float32)


# ---------------------------------------------------------------------------
# Deprecation shims
# ---------------------------------------------------------------------------

def make_engine(
    behavior: Behavior,
    *,
    interior: Tuple[int, ...] = (8, 8),
    mesh_shape: Tuple[int, ...] = (1, 1),
    cell_size: float = 2.0,
    cap: int = 24,
    boundary: Union[str, Tuple[str, ...]] = "closed",
    delta: Optional[DeltaConfig] = None,
    dt: float = 0.1,
    mesh=None,
    rebalance_every: int = 0,
    imbalance_threshold: float = 0.5,
    device="cuda",
) -> Engine:
    """DEPRECATED: build a raw Engine.  Use the facade instead:
    ``Simulation(dict(interior=..., mesh_shape=..., ...), behavior,
    delta=..., dt=..., rebalance=Rebalance(every=n, threshold=t))``.
    ``mesh`` is accepted and unused, as in the reference (``run_sim``
    takes the process mesh)."""
    warnings.warn(
        "make_engine is deprecated — use repro.core.Simulation("
        "dict(interior=..., mesh_shape=..., cap=...), behavior, delta=..., "
        "dt=..., rebalance=Rebalance(every=n, threshold=t)) instead",
        DeprecationWarning, stacklevel=2)
    geom = Domain(cell_size=cell_size, interior=interior,
                  mesh_shape=mesh_shape, cap=cap, boundary=boundary)
    return Engine(geom=geom, behavior=behavior,
                  delta_cfg=delta or DeltaConfig(enabled=False), dt=dt,
                  rebalance_every=rebalance_every,
                  imbalance_threshold=imbalance_threshold, device=device)


def _warn_if_stale_engine(old: Engine, new: Engine, had_handle: bool
                          ) -> None:
    """Warn when a run loop discards a re-sharded engine the caller has no
    handle to (the reference's ``warn_if_stale_engine``; the facade swaps
    its own engine in place, so only this shim can hit it)."""
    if new is not old and not had_handle:
        warnings.warn(
            f"a re-shard moved the state to mesh {new.geom.mesh_shape}; "
            f"the engine you hold (mesh {old.geom.mesh_shape}) no longer "
            "matches it — migrate to repro.core.Simulation, whose "
            "sim.engine/sim.state stay consistent across re-shards",
            stacklevel=3)


def run_sim(engine: Engine, state: SimState, steps: int, mesh=None,
            collect: Optional[Callable] = None, rebalancer=None):
    """DEPRECATED: drive a raw (engine, state) pair.  Use the facade instead:
    ``sim.run(steps, collect=...)`` - ``sim.engine``/``sim.state`` stay
    consistent across re-shards with no stale-handle contract to honor.
    With a process ``mesh`` (``launch.mesh.make_abm_mesh``) every rank
    calls it with its own block (``engine.init_state(..., mesh=mesh)``)."""
    warnings.warn(
        "run_sim is deprecated — use repro.core.Simulation: "
        "sim.run(steps, collect=...); read sim.state / sim.series",
        DeprecationWarning, stacklevel=2)
    step = engine.make_local_step(mesh)
    had_handle = rebalancer is not None
    eng, state, series = engine.drive(state, steps, step_fn=step,
                                      rebalancer=rebalancer, collect=collect,
                                      mesh=mesh)
    _warn_if_stale_engine(engine, eng, had_handle)
    return state, series
