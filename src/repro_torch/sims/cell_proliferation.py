"""Cell proliferation (paper section 3.1): cells grow and divide until
space saturates - the spawn path, capacity handling and migration (port
of ``repro/sims/cell_proliferation.py``).  The pair law is the soft-sphere
force with ``same_type_only = 0``, law 0 of the ``pair_sweep`` kernel."""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import operations, prng
from repro_torch.core.agent_soa import AgentSchema, POS
from repro_torch.core.behaviors import (
    Behavior, _f32, soft_repulsion_adhesion,
)
from repro_torch.core.simulation import Simulation
from repro_torch.sims.common import disk_positions, init_agents, make_sim

SCHEMA = AgentSchema.create({
    "diameter": ((), torch.float32),
    "ctype": ((), torch.int32),
})


def _update(attrs, valid, acc, key, params, dt):
    f = acc["force"]
    zero = _f32(0.0, f)
    norm = torch.sqrt((f * f).sum(dim=-1, keepdim=True) + _f32(1e-12, f))
    step = f * torch.minimum(_f32(params["max_step"], f) / norm,
                             _f32(dt, f))
    new = dict(attrs)
    new[POS] = attrs[POS] + torch.where(valid[..., None], step, zero)
    # growth
    d = attrs["diameter"] + torch.where(
        valid, _f32(params["growth"] * dt, f), zero)
    divide_ready = d >= _f32(params["div_diameter"], f)
    k1, k2 = prng.split(key)
    u = prng.uniform(k1, valid.shape)
    spawn = valid & divide_ready & (u < _f32(params["div_prob"], f))
    d = torch.where(spawn, d * _f32(0.5, f), d)
    new["diameter"] = d
    # child: half diameter, offset position
    off = _f32(0.25, f) * prng.normal(k2, new[POS].shape)
    child = dict(new)
    child[POS] = new[POS] + off
    child["diameter"] = torch.where(spawn, d, _f32(0.5, f))
    return new, valid, spawn, child


@functools.lru_cache(maxsize=8)
def behavior(radius=2.0) -> Behavior:
    return Behavior(
        schema=SCHEMA,
        pair_fn=soft_repulsion_adhesion,
        pair_attrs=("diameter", "ctype"),
        update_fn=_update,
        radius=radius,
        params={"repulsion": 2.0, "adhesion": 0.0, "same_type_only": 0.0,
                "max_step": 0.4, "growth": 0.4, "div_diameter": 1.0,
                "div_prob": 0.3},
        can_spawn=True,
    )


def init(sim: Simulation, n_agents: int, seed: int = 0) -> Simulation:
    """A disk of ``n_agents`` at the domain's centre, of radius ``min(L) /
    8``."""
    rng = np.random.default_rng(seed)
    lx, ly = sim.geom.domain_size
    pos = disk_positions(rng, n_agents, (lx / 2, ly / 2), min(lx, ly) / 8)
    attrs = {
        "diameter": np.full((n_agents,), 0.6, np.float32),
        "ctype": np.zeros((n_agents,), np.int32),
    }
    return init_agents(sim, pos, attrs, seed=seed)


def simulation(n_agents=50, seed=0, mesh=None, mesh_shape=(1, 1),
               interior=(8, 8), delta=None, rebalance=None,
               sweep_backend="auto", device="cuda") -> Simulation:
    sim = make_sim(behavior(), interior=interior, mesh_shape=mesh_shape,
                   cap=32, delta=delta, mesh=mesh, rebalance=rebalance,
                   sweep_backend=sweep_backend, device=device)
    return init(sim, n_agents, seed)


def run(n_agents=50, steps=20, seed=0, mesh=None, mesh_shape=(1, 1),
        interior=(8, 8), delta=None, rebalance=None, sweep_backend="auto",
        device="cuda"):
    sim = simulation(n_agents=n_agents, seed=seed, mesh=mesh,
                     mesh_shape=mesh_shape, interior=interior, delta=delta,
                     rebalance=rebalance, sweep_backend=sweep_backend,
                     device=device)
    n0 = sim.n_agents()
    sim.every(1, operations.agent_count, name="counts")
    sim.run(steps)
    counts = sim.series["counts"]
    return sim.state, {"n_initial": n0, "n_final": counts[-1],
                       "counts": counts}
