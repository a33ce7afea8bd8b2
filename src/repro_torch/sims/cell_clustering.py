"""Cell clustering (paper section 3.1): two cell types with same-type
adhesion and short-range repulsion self-organize into clusters - the
paper's canonical benchmark (port of ``repro/sims/cell_clustering.py``).

Both pair laws here run on the ``pair_sweep`` CUDA kernel on the card:
``soft_repulsion_adhesion`` every step, ``_same_type_pair`` in the
clustering metric :func:`same_type_fraction`, once per device block the
state holds."""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.behaviors import (
    Behavior,
    displacement_update,
    soft_repulsion_adhesion,
)
from repro_torch.core.agent_soa import AgentSchema
from repro_torch.core.engine import device_block
from repro_torch.core.neighbors import sweep_accumulate
from repro_torch.core.simulation import Simulation
from repro_torch.sims.common import init_agents, make_sim, uniform_positions

SCHEMA = AgentSchema.create({
    "diameter": ((), torch.float32),
    "ctype": ((), torch.int32),
})


# Cached on the parameter tuple: repeated builds return the same Behavior.
@functools.lru_cache(maxsize=32)
def behavior(repulsion=2.0, adhesion=0.6, radius=2.0, max_step=0.5
             ) -> Behavior:
    return Behavior(
        schema=SCHEMA,
        pair_fn=soft_repulsion_adhesion,
        pair_attrs=("diameter", "ctype"),
        update_fn=displacement_update,
        radius=radius,
        params={"repulsion": repulsion, "adhesion": adhesion,
                "same_type_only": 1.0, "max_step": max_step},
    )


def init(sim: Simulation, n_agents: int, seed: int = 0) -> Simulation:
    """Initialize through the facade from a numpy generator seeded with
    ``seed`` (the same draws as the reference)."""
    rng = np.random.default_rng(seed)
    pos = uniform_positions(rng, n_agents, sim.geom)
    attrs = {
        "diameter": np.full((n_agents,), 1.0, np.float32),
        "ctype": rng.integers(0, 2, n_agents).astype(np.int32),
    }
    return init_agents(sim, pos, attrs, seed=seed)


def _same_type_pair(ai, aj, disp, dist2, params):
    same = (ai["ctype"] == aj["ctype"]).to(torch.float32)
    return {"same": same, "cnt": torch.ones_like(same)}


def same_type_fraction(state, engine) -> float:
    """Clustering metric: fraction of neighbour pairs with equal type, over
    every device's block that ``state`` holds, as it stands (its aura ring
    empty, as on one device: pairs across a device seam are not counted).
    On a process mesh that is this rank's block."""
    same = cnt = 0.0
    for c in np.ndindex(*state.it.shape):
        acc = sweep_accumulate(engine.geom, device_block(state.soa, c),
                               _same_type_pair, ("ctype",),
                               float(engine.behavior.radius), {},
                               backend="auto")
        same += float(acc["same"].sum())
        cnt += float(acc["cnt"].sum())
    return same / max(cnt, 1.0)


def simulation(n_agents=400, seed=0, mesh=None, mesh_shape=(1, 1),
               interior=(8, 8), delta=None, rebalance=None,
               sweep_backend="auto", device="cuda", **bparams) -> Simulation:
    """Build and initialize the clustering sim on the facade."""
    sim = make_sim(behavior(**bparams), interior=interior,
                   mesh_shape=mesh_shape, delta=delta, mesh=mesh,
                   rebalance=rebalance, sweep_backend=sweep_backend,
                   device=device)
    return init(sim, n_agents, seed)


def run(n_agents=400, steps=30, seed=0, mesh=None, mesh_shape=(1, 1),
        interior=(8, 8), delta=None, rebalance=None, sweep_backend="auto",
        device="cuda"):
    sim = simulation(n_agents=n_agents, seed=seed, mesh=mesh,
                     mesh_shape=mesh_shape, interior=interior, delta=delta,
                     rebalance=rebalance, sweep_backend=sweep_backend,
                     device=device)
    f0 = same_type_fraction(sim.state, sim.engine)
    sim.run(steps)
    f1 = same_type_fraction(sim.state, sim.engine)
    return sim.state, {"same_frac_initial": f0, "same_frac_final": f1}
