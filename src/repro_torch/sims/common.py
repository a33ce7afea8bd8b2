"""Shared scaffolding for the benchmark simulations (port of part of
``repro/sims/common.py``): ``make_sim`` wires the sims' geometry defaults
into the :class:`Simulation` facade."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.delta import DeltaConfig
from repro_torch.core.domain import Domain, Partition
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
