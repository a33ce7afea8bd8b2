"""Oncology use case (paper section 3.1, Figure 5): tumour spheroid
growth (port of ``repro/sims/oncology.py``).

Tumour cells proliferate under contact inhibition (the division
probability decays with local crowding) and adhere, growing a compact
spheroid.  The tumour diameter is the paper's approximate measurement,
the enclosing bounding box of all tumour cells.  The pair law ``_pair``
(the soft-sphere force plus a neighbour count) runs on the ``pair_sweep``
CUDA kernel on the card."""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.agent_soa import AgentSchema, POS
from repro_torch.core.behaviors import (
    Behavior, _f32, soft_repulsion_adhesion,
)
from repro_torch.core.engine import total_agents
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
    # contact inhibition: crowding = neighbour count
    crowd = acc["crowd"]
    p_div = _f32(params["div_prob"], f) * torch.exp(
        -crowd / _f32(params["crowd_scale"], f))
    k1, k2 = prng.split(key)
    u = prng.uniform(k1, valid.shape)
    spawn = valid & (u < p_div)
    child = dict(new)
    child[POS] = new[POS] + _f32(0.3, f) * prng.normal(k2, new[POS].shape)
    child["diameter"] = torch.full_like(attrs["diameter"], 0.9)
    return new, valid, spawn, child


def _pair(ai, aj, disp, dist2, params):
    out = soft_repulsion_adhesion(ai, aj, disp, dist2, params)
    out["crowd"] = torch.ones_like(dist2)
    return out


@functools.lru_cache(maxsize=8)
def behavior(radius=2.0) -> Behavior:
    return Behavior(
        schema=SCHEMA,
        pair_fn=_pair,
        pair_attrs=("diameter", "ctype"),
        update_fn=_update,
        radius=radius,
        params={"repulsion": 4.0, "adhesion": 0.05, "same_type_only": 0.0,
                "max_step": 0.3, "div_prob": 0.5, "crowd_scale": 14.0},
        can_spawn=True,
    )


def init(sim: Simulation, n_agents: int, seed: int = 0) -> Simulation:
    """A disk of ``n_agents`` of radius 1.2 at the domain's centre."""
    rng = np.random.default_rng(seed)
    lx, ly = sim.geom.domain_size
    pos = disk_positions(rng, n_agents, (lx / 2, ly / 2), 1.2)
    attrs = {
        "diameter": np.full((n_agents,), 0.9, np.float32),
        "ctype": np.ones((n_agents,), np.int32),
    }
    return init_agents(sim, pos, attrs, seed=seed)


def tumor_diameter(state) -> float:
    """The paper's approximate measurement: the enclosing bounding box."""
    v = state.soa.valid.reshape(-1)
    pos = state.soa.pos.reshape(v.shape[0], -1)[v]
    if pos.numel() == 0:
        return 0.0
    ext = pos.max(dim=0).values - pos.min(dim=0).values
    return float(ext.max())


def simulation(n_agents=30, seed=0, mesh=None, mesh_shape=(1, 1),
               interior=(10, 10), delta=None, rebalance=None,
               sweep_backend="auto", device="cuda") -> Simulation:
    sim = make_sim(behavior(), interior=interior, mesh_shape=mesh_shape,
                   cap=32, delta=delta, mesh=mesh, rebalance=rebalance,
                   sweep_backend=sweep_backend, device=device)
    return init(sim, n_agents, seed)


def run(n_agents=30, steps=25, seed=0, mesh=None, mesh_shape=(1, 1),
        interior=(10, 10), delta=None, rebalance=None, sweep_backend="auto",
        device="cuda"):
    sim = simulation(n_agents=n_agents, seed=seed, mesh=mesh,
                     mesh_shape=mesh_shape, interior=interior, delta=delta,
                     rebalance=rebalance, sweep_backend=sweep_backend,
                     device=device)
    d0 = tumor_diameter(sim.state)
    sim.run(steps, collect=lambda s: (total_agents(s), tumor_diameter(s)))
    return sim.state, {"diam_initial": d0, "series": sim.series["collect"]}
