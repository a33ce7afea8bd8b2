"""Quickstart on the PyTorch port: define agents, behaviors, and run a
simulation - the paper's three-step modeling workflow (section 1) on the
``Simulation`` facade (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

``--device`` defaults to ``cuda`` and raises without a GPU.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import AgentSchema, Behavior, Simulation
from repro_torch.core import operations
from repro_torch.core.behaviors import (
    displacement_update, soft_repulsion_adhesion,
)
from repro_torch.sims.cell_clustering import same_type_fraction


def main(device="cuda", n_agents=400, steps=30, interior=(8, 8), seed=0
         ) -> dict:
    # 1. What is an agent?  A position plus these attributes:
    schema = AgentSchema.create({
        "diameter": ((), torch.float32),
        "ctype": ((), torch.int32),
    })
    # 2. How does it behave?  Same-type adhesion + soft-sphere repulsion,
    #    overdamped displacement dynamics:
    behavior = Behavior(
        schema=schema,
        pair_fn=soft_repulsion_adhesion,
        pair_attrs=("diameter", "ctype"),
        update_fn=displacement_update,
        radius=2.0,
        params={"repulsion": 2.0, "adhesion": 0.6, "same_type_only": 1.0,
                "max_step": 0.5},
    )
    # 3. Initial condition + run: the facade owns the engine, the device
    #    mesh, the state and any scheduled operations.
    sim = Simulation(dict(cell_size=2.0, interior=tuple(interior), cap=64),
                     behavior, dt=0.1, device=device)
    rng = np.random.default_rng(seed)
    side = 2.0 * interior[0]
    pos = rng.uniform(0.5, side - 0.5, size=(n_agents, 2)).astype(np.float32)
    sim.init(pos, {
        "diameter": np.full((n_agents,), 1.0, np.float32),
        "ctype": rng.integers(0, 2, n_agents).astype(np.int32),
    }, seed=seed)

    sim.every(10, operations.agent_count)   # scheduled SumOverAllRanks
    sim.run(steps)

    out = dict(n_agents=sim.n_agents(), iteration=sim.iteration,
               dropped=int(sim.state.dropped.sum()),
               counts=[int(c) for c in sim.series["agent_count"]],
               same_type=same_type_fraction(sim.state, sim.engine))
    print(f"agents: {out['n_agents']} (conserved), "
          f"iterations: {out['iteration']}, dropped: {out['dropped']}, "
          f"count series: {out['counts']}, same-type neighbour fraction: "
          f"{out['same_type']:.4f}")
    print("The same Simulation runs unchanged on a multi-device mesh - set "
          "mesh_shape=(2, 2) in the geometry (see "
          "examples_torch/epidemic_distributed.py) - and behaviors stack "
          "with compose() (see examples_torch/sir_mechanics_demo.py).")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
