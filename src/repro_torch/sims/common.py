"""Shared scaffolding for the benchmark simulations (port of part of
``repro/sims/common.py``): ``make_sim`` wires the sims' geometry defaults
into the :class:`Simulation` facade."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from repro_torch.core.delta import DeltaConfig
from repro_torch.core.domain import Domain
from repro_torch.core.simulation import Simulation


def resolve_delta(delta, n_devices: int) -> Optional[DeltaConfig]:
    """Per-sim codec knob -> the facade's ``DeltaConfig``.  ``None`` on one
    device and ``"off"``/``"full"`` mean a full refresh every step; the
    quantized codecs (the multi-device default) wait for ROADMAP A7."""
    if isinstance(delta, DeltaConfig):
        return delta
    if delta is None and n_devices <= 1:
        return None
    if delta in ("off", "full"):
        return DeltaConfig(enabled=False)
    raise NotImplementedError(
        f"delta={delta!r} on {n_devices} device(s): the delta codec and "
        "multi-device runs are not ported yet (ROADMAP A7)")


def make_sim(
    behaviors,
    *,
    interior: Tuple[int, ...] = (8, 8),
    mesh_shape: Tuple[int, ...] = (1, 1),
    cell_size: float = 2.0,
    cap: int = 24,
    boundary: Union[str, Tuple[str, ...]] = "closed",
    domain: Optional[Domain] = None,
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
    over the individual geometry kwargs."""
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
