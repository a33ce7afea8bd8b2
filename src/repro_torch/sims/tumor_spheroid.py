"""Tumour spheroid growth in 3-D (paper section 3.1, the oncology use
case on the N-D domain; port of ``repro/sims/tumor_spheroid.py``).

A composed behaviour stack, ``compose(mechanics, growth)``:

* **mechanics** - soft-sphere repulsion and adhesion with overdamped
  displacement (the shared :func:`soft_repulsion_adhesion` /
  :func:`displacement_update`; the pair math is dimension-agnostic);
* **growth** - nutrient-gated proliferation: each cell's ``nutrient``
  relaxes toward the supply and is depleted by crowding (its neighbours
  within the radius, an oxygen-consumption proxy); cells grow while fed
  and divide past the division diameter, so the spheroid develops a
  proliferating rim around a quiescent core.

On the card both pair laws run as one ``pair_sweep`` launch a step (the
stack of law 0 and the crowd count, law 4, at D = 3).  The spheroid
diameter is the paper's approximate measurement, the enclosing bounding
box of all tumour cells.  On a device mesh (``mesh_shape=(2, 2, 2)``) the
model is unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.agent_soa import AgentSchema, POS
from repro_torch.core.behaviors import (
    Behavior, _f32, compose, displacement_update, soft_repulsion_adhesion,
)
from repro_torch.core.engine import total_agents
from repro_torch.core.simulation import Simulation
from repro_torch.sims.common import ball_positions, init_agents, make_sim

# Spatial dimensionality of this sim's geometry (read by launch.simulate to
# size an all-ones --mesh; 2-D sims omit it).
NDIM = 3

MECH_SCHEMA = AgentSchema.create({
    "diameter": ((), torch.float32),
    "ctype": ((), torch.int32),
})

GROWTH_SCHEMA = AgentSchema.create({
    "diameter": ((), torch.float32),
    "nutrient": ((), torch.float32),
})


def _crowd_pair(ai, aj, disp, dist2, params):
    """Neighbour count - the local oxygen-consumption proxy."""
    return {"crowd": torch.ones_like(dist2)}


def _growth_update(attrs, valid, acc, key, params, dt):
    crowd = acc["crowd"]
    # nutrient relaxes toward supply and is depleted by crowding (both
    # multiply-adds rounded once, as XLA's CPU code fuses them)
    uptake = _f32(params["uptake"], crowd) * crowd
    inner = prng._fma(_f32(params["supply"], crowd),
                      _f32(1.0, crowd) - attrs["nutrient"], -uptake)
    nut = prng._fma(_f32(dt, crowd), inner, attrs["nutrient"])
    nut = torch.clamp(nut, 0.0, 1.0)
    fed = nut > _f32(params["nutrient_threshold"], crowd)
    # growth is nutrient-gated; starved cells go quiescent
    zero = _f32(0.0, crowd)
    d = attrs["diameter"] + torch.where(
        valid & fed, _f32(params["growth"] * dt, crowd), zero)
    divide_ready = d >= _f32(params["div_diameter"], crowd)
    k1, k2 = prng.split(key)
    u = prng.uniform(k1, valid.shape)
    spawn = valid & fed & divide_ready & (u < _f32(params["div_prob"], u))
    d = torch.where(spawn, d * _f32(0.5, d), d)
    new = dict(attrs)
    new["diameter"] = d
    new["nutrient"] = nut
    # child: sibling half of the division, offset in a random 3-D direction
    off = _f32(params["div_offset"], d) * prng.normal(k2, new[POS].shape)
    child = dict(new)
    child[POS] = new[POS] + off
    child["diameter"] = torch.where(spawn, d, _f32(0.5, d))
    child["nutrient"] = _f32(0.5, nut) * nut
    return new, valid, spawn, child


@functools.lru_cache(maxsize=8)
def behavior(radius=2.0, repulsion=4.0, adhesion=0.4) -> Behavior:
    """``compose(mechanics, growth)``: union schema {diameter, ctype,
    nutrient}, both pair laws over one 3^3 sweep."""
    mech = Behavior(
        schema=MECH_SCHEMA,
        pair_fn=soft_repulsion_adhesion,
        pair_attrs=("diameter", "ctype"),
        update_fn=displacement_update,
        radius=radius,
        params={"repulsion": repulsion, "adhesion": adhesion,
                "same_type_only": 0.0, "max_step": 0.3},
    )
    growth = Behavior(
        schema=GROWTH_SCHEMA,
        pair_fn=_crowd_pair,
        pair_attrs=("diameter",),
        update_fn=_growth_update,
        radius=radius,
        params={"growth": 0.35, "div_diameter": 1.0, "div_prob": 0.4,
                "div_offset": 0.25, "supply": 0.6, "uptake": 0.035,
                "nutrient_threshold": 0.3},
        can_spawn=True,
    )
    return compose(mech, growth)


def init(sim: Simulation, n_agents: int, seed: int = 0, center_frac=None
         ) -> Simulation:
    """Seed the spheroid: ``n_agents`` uniform in a ball of radius
    ``min(L) / 8``, centred at the per-axis fraction ``center_frac`` of
    the domain (default: the middle)."""
    rng = np.random.default_rng(seed)
    size = sim.geom.domain_size
    if center_frac is None:
        center_frac = (0.5,) * sim.geom.ndim
    center = tuple(s * f for s, f in zip(size, center_frac))
    pos = ball_positions(rng, n_agents, center, min(size) / 8)
    attrs = {
        "diameter": np.full((n_agents,), 0.8, np.float32),
        "ctype": np.ones((n_agents,), np.int32),
        "nutrient": np.full((n_agents,), 1.0, np.float32),
    }
    return init_agents(sim, pos, attrs, seed=seed)


def spheroid_diameter(state) -> float:
    """The paper's approximate measurement: the enclosing bounding box."""
    v = state.soa.valid.reshape(-1)
    pos = state.soa.pos.reshape(v.shape[0], -1)[v]
    if pos.numel() == 0:
        return 0.0
    ext = pos.max(dim=0).values - pos.min(dim=0).values
    return float(ext.max())


def simulation(n_agents=40, seed=0, mesh=None, mesh_shape=(1, 1, 1),
               interior=(6, 6, 6), delta=None, rebalance=None,
               sweep_backend="auto", center_frac=None, cap=32,
               device="cuda") -> Simulation:
    sim = make_sim(behavior(), interior=interior, mesh_shape=mesh_shape,
                   cap=cap, delta=delta, mesh=mesh, rebalance=rebalance,
                   sweep_backend=sweep_backend, device=device)
    return init(sim, n_agents, seed, center_frac=center_frac)


def run(n_agents=40, steps=15, seed=0, mesh=None, mesh_shape=(1, 1, 1),
        interior=(6, 6, 6), delta=None, rebalance=None, sweep_backend="auto",
        center_frac=None, cap=32, device="cuda"):
    sim = simulation(n_agents=n_agents, seed=seed, mesh=mesh,
                     mesh_shape=mesh_shape, interior=interior, delta=delta,
                     rebalance=rebalance, sweep_backend=sweep_backend,
                     center_frac=center_frac, cap=cap, device=device)
    d0 = spheroid_diameter(sim.state)
    sim.run(steps, collect=lambda s: (total_agents(s), spheroid_diameter(s)))
    return sim.state, {"diam_initial": d0, "series": sim.series["collect"]}
